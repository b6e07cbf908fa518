"""Plain torch version of single-token decode attention (GQA, masked cache):
the counterpart of ``repro/kernels/flash_decode/ref.py``, and what the
kernel's wrapper runs on a CPU tensor."""
from __future__ import annotations

import numpy as np
import torch


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, Dv)
    cache_len,  # () int — number of valid cache rows
) -> torch.Tensor:
    """-> (B, H, Dv) in q's dtype. Scores and softmax in float32, positions
    at or past ``cache_len`` masked with -1e30, the probabilities cast to
    q's dtype before the value product."""
    B, S, KV, D = k.shape
    H = q.shape[1]
    groups = H // KV
    kh = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vh = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    s = torch.einsum("bhd,bkhd->bhk", q, kh).float() / np.sqrt(D)
    valid = torch.arange(S, device=q.device) < torch.as_tensor(
        cache_len, device=q.device)
    s = torch.where(valid[None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p.to(q.dtype), vh)


def decode_attention_bound(q, k, v, cache_len, rtol=2e-4, atol=2e-5):
    """(want, bound): the result computed in float32 from these inputs, and
    the elementwise distance from it within which a version must lie that
    computes in float32 but rounds p (before the value product) and the
    output to q's dtype, as the kernel and the Pallas kernel do:
    ``u * (p @ |v|)`` for the rounding of p, ``u * |want|`` for the rounding
    of the output, plus the float32 tolerance ``rtol * |want| + atol``.
    ``u`` is q's dtype's unit roundoff (2^-8 in bf16); in float32 nothing is
    rounded, ``u`` is 0 and the bound is the float32 tolerance alone."""
    u = 0.0 if q.dtype == torch.float32 else torch.finfo(q.dtype).eps / 2
    q, k, v = q.float(), k.float(), v.float()
    want = decode_attention_ref(q, k, v, cache_len)
    scale = decode_attention_ref(q, k, v.abs(), cache_len)
    return want, u * scale + (u + rtol) * want.abs() + atol
