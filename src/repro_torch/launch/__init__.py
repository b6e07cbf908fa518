"""The spmd form of split parallelism over ``torch.distributed``: the 2-D
(replica, split) mesh of process groups and the per-rank slicers
(``sharding``), and the launcher and the per-rank train step (``spmd``)."""
