"""Aggregation kernels: torch segment ops and the fused CUDA gather->segment
kernels (built from ``repro_torch/csrc`` at first use)."""
