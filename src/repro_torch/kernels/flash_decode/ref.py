"""Plain torch version of single-token decode attention (GQA, masked cache):
the counterpart of ``repro/kernels/flash_decode/ref.py``, and what the
kernel's wrapper runs on a CPU tensor; also its partial output (o, m, d),
which a sequence-sharded decode computes on each rank's rows, and the merge
of the ranks' partials."""
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


def decode_attention_partial_ref(q, k, v, cache_len):
    """The partial output over these cache rows, as the kernel's partial call
    gives it: (o (B, H, Dv), m (B, H), d (B, H)), all float32. Scores in
    float32 (from q's dtype, as ``decode_attention_ref``), masked at or past
    ``cache_len``; m the largest valid score (-1e30 with none); p =
    exp(s - m) on the valid rows and 0 on the others, d its sum; o the value
    product of p cast to q's dtype, summed in float32, over max(d, 1e-30).
    A shard with no valid row gives o = 0, m = -1e30, d = 0."""
    B, S, KV, D = k.shape
    groups = q.shape[1] // KV
    kh = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vh = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    s = torch.einsum("bhd,bkhd->bhk", q, kh).float() / np.sqrt(D)
    valid = (torch.arange(S, device=q.device) < torch.as_tensor(
        cache_len, device=q.device))[None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    d = p.sum(dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p.to(q.dtype).float(), vh.float())
    return o / d.clamp(min=1e-30)[..., None], m, d


def merge_partials(o, m, d, dtype):
    """The attention output from R shards' partials, stacked on a leading
    axis: o (R, B, H, Dv), m and d (R, B, H), float32 -> (B, H, Dv) in
    ``dtype``. Each shard weighs exp(m_r - max_r m_r) * d_r (zero for a shard
    with no valid row, whose d is 0), the weighted outputs and denominators
    are summed in shard order in float32, the sum divided by the summed
    denominator (floored at 1e-30) and rounded once to ``dtype``."""
    w = torch.exp(m - m.amax(dim=0)) * d
    num = (w[..., None] * o).sum(dim=0)
    return (num / w.sum(dim=0).clamp(min=1e-30)[..., None]).to(dtype)


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
