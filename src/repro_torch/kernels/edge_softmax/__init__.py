"""Per-destination edge softmax over host-packed dst-row blocks
(``segment_ops.edge_softmax(..., backend="packed")``): the CUDA kernel's
wrapper and its plain version, in ``ops``."""
