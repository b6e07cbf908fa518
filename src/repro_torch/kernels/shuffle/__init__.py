"""The adjoint of the sim shuffle's send gather (and of the GNN layers'
self-row gather): the CUDA kernel's wrapper (``kernel.py``), its plain torch
version (``ref.py``) and the differentiable gathers that use it
(``ops.py``)."""
from repro_torch.kernels.shuffle.ops import self_gather, send_gather

__all__ = ["self_gather", "send_gather"]
