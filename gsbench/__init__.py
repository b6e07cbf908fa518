"""The benchmark of the GSplit port (``repro_torch``): one command runs one
cell once (``python3 -m gsbench --help``). It imports torch, numpy and the
port, and never JAX or the JAX package."""
