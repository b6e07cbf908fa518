"""Launching across ranks over ``torch.distributed``. For split parallelism:
the 2-D (replica, split) mesh of process groups and the per-rank slicers
(``sharding``), and the launcher and the per-rank train step (``spmd``).
For the transformer: the (data, model) mesh and its counted collectives
(``mesh``) and the parameter, batch and cache specs with their slicers
(``sharding``). Also the reference's input shapes and the roofline
(``input_specs``, ``roofline``, ``shapes``)."""
