"""Fused gather->segment-aggregate over the plan's dst-sorted layout
(``layout.py``): CUDA kernels (``kernel.py``), their plain torch versions
(``ref.py``) and the differentiable ops (``ops.py``)."""
from repro_torch.kernels.gather_segsum.layout import AGG_ROWS, layer_layout
from repro_torch.kernels.gather_segsum.ops import (
    gather_segment_mean,
    gather_segment_sum,
    gather_weighted_segsum,
)

__all__ = [
    "AGG_ROWS",
    "layer_layout",
    "gather_segment_sum",
    "gather_segment_mean",
    "gather_weighted_segsum",
]
