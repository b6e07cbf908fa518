"""Single-token GQA decode attention in the JAX ``ops.py`` layout — the
counterpart of ``repro/kernels/flash_decode/ops.py::decode_attention_pallas``.

Its kernel reads the (B, S, KV, D) cache where it lies, so unlike the JAX
wrapper it transposes nothing. Contract (``docs/KERNELS.md``): H is a
multiple of KV; cache positions at or past ``cache_len`` are masked out of
the softmax; softmax and accumulation run in f32; the output has q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import (
    flash_decode,
    flash_decode_partial,
)


def decode_attention(q, k, v, cache_len):
    """q (B, H, D), k (B, S, KV, D), v (B, S, KV, Dv) -> (B, H, Dv).

    ``cache_len`` is an int or an integer tensor of one element; a tensor
    already on q's device stays there (no host sync), as the decode loop
    passes it, and one that is already int32 is passed on as it is. On a
    CUDA tensor this launches the CUDA kernel or raises; on a CPU tensor it
    runs the plain version.
    """
    return flash_decode(q, k, v, _len_on(cache_len, q.device))


def decode_attention_partial(q, k, v, cache_len):
    """The partial output over these cache rows: (o (B, H, Dv), m (B, H),
    d (B, H)) float32 (``kernel.flash_decode_partial``); ``cache_len`` as
    in ``decode_attention``, and here it may be 0."""
    return flash_decode_partial(q, k, v, _len_on(cache_len, q.device))


def _len_on(n, device):
    """``cache_len`` as the kernel takes it: one int32 on ``device``."""
    if not (isinstance(n, torch.Tensor) and n.dtype == torch.int32
            and n.device == device):
        n = torch.as_tensor(n, device=device).reshape(1).to(torch.int32)
    return n
