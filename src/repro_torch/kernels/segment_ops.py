"""Segment operations in torch — the counterpart of ``repro.kernels.segment_ops``
(its ``backend="jnp"`` path; the standalone Pallas segsum and edge-softmax
kernels are off the main path and not ported yet).

Contract shared by all ops: ``dst (E,)`` int holds a destination row in
``[0, num_out)`` for every edge slot, including padding; ``mask (E,) bool``
marks the valid slots. Destinations whose incident edges are all masked out
("empty segments") yield *exact zeros* — never NaN — in every op and dtype:
the mask is applied with ``where`` in the softmax, the max-clamp is a finite
value of the input dtype (``finfo.min / 2``), counts are float32, and the
softmax denominator is clamped to ``finfo.tiny``.
"""
from __future__ import annotations

import torch


def segment_sum(contrib, dst, mask, num_out):
    """Masked per-destination sum of ``contrib (E, F)`` -> ``(num_out, F)``.

    Masked slots contribute exactly 0.0 (a ``*`` by the mask, as in the
    reference); empty segments are exact zeros. Output dtype ==
    ``contrib.dtype``.
    """
    w = mask.to(contrib.dtype)
    out = contrib.new_zeros((num_out,) + contrib.shape[1:])
    return out.index_add(0, dst.long(), contrib * w[:, None])


def segment_mean(contrib, dst, mask, num_out):
    """Masked per-destination mean -> ``(num_out, F)``.

    The denominator is counted in float32 regardless of ``contrib.dtype``
    and clamped to 1, so empty segments return exact zeros rather than 0/0.
    """
    total = segment_sum(contrib, dst, mask, num_out)
    count = torch.zeros(num_out, dtype=torch.float32, device=contrib.device)
    count = count.index_add(0, dst.long(), mask.to(torch.float32))
    return total / count.clamp(min=1.0).to(total.dtype)[:, None]


def edge_softmax(logits, dst, mask, num_out):
    """Per-destination softmax over incoming edges: ``(E, H) -> (E, H)``.

    Masked edges get weight exactly 0.0 and take no part in the
    normalization; a destination whose edges are all masked contributes only
    zeros. The per-segment max is a constant shift that cancels in the
    softmax, so it is taken without a gradient (the reference differentiates
    through it; the two agree to rounding).
    """
    dst = dst.long()
    neg = torch.finfo(logits.dtype).min / 2
    masked = torch.where(mask[:, None], logits, torch.full_like(logits, neg))
    with torch.no_grad():
        # starting from ``neg`` is the reference's max(segment_max, neg)
        # clamp: empty segments stay finite
        seg_max = torch.full(
            (num_out, logits.shape[1]), neg, dtype=logits.dtype,
            device=logits.device,
        )
        idx = dst[:, None].expand_as(masked)
        seg_max = seg_max.scatter_reduce(0, idx, masked, "amax")
    ex = torch.where(
        mask[:, None], torch.exp(masked - seg_max[dst]),
        torch.zeros_like(logits),
    )
    denom = torch.zeros_like(seg_max).index_add(0, dst, ex)
    tiny = torch.finfo(logits.dtype).tiny
    return ex / denom[dst].clamp(min=tiny)
