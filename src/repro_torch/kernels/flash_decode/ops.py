"""Single-token GQA decode attention in the JAX ``ops.py`` layout — the
counterpart of ``repro/kernels/flash_decode/ops.py::decode_attention_pallas``.

Its kernel reads the (B, S, KV, D) cache where it lies, so unlike the JAX
wrapper it transposes nothing. Contract (``docs/KERNELS.md``): H is a
multiple of KV; cache positions at or past ``cache_len`` are masked out of
the softmax; softmax and accumulation run in f32; the output has q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode


def decode_attention(q, k, v, cache_len):
    """q (B, H, D), k (B, S, KV, D), v (B, S, KV, Dv) -> (B, H, Dv).

    ``cache_len`` is an int or an integer tensor of one element; a tensor
    already on q's device stays there (no host sync), as the decode loop
    passes it. On a CUDA tensor this launches the CUDA kernel or raises; on
    a CPU tensor it runs the plain version.
    """
    n = torch.as_tensor(cache_len, device=q.device).reshape(1).to(torch.int32)
    return flash_decode(q, k, v, n)
