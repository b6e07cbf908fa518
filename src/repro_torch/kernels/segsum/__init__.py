"""Standalone masked segment sum over host-packed dst-row blocks
(``segment_ops.segment_sum(..., backend="packed")``): the CUDA kernel's
wrapper, its plain version and the packing, in ``ops``."""
