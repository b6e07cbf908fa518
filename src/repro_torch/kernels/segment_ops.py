"""Segment operations in torch — the counterpart of ``repro.kernels.segment_ops``,
with its backend dispatch.

``backend="torch"`` (the counterpart of ``"jnp"``, and what the model calls)
scatters with ``index_add``. ``backend="packed"`` (the counterpart of
``"pallas"``) packs on the host from a concrete ``dst``/``mask`` and runs the
packed kernels (``kernels.segsum``, ``kernels.edge_softmax``): on a CUDA
tensor the CUDA kernel, on a CPU tensor its plain version. It takes float32,
bfloat16 and float16, stores in the input dtype and accumulates in float32.
It is forward only: an input that needs a gradient raises on either device.

Contract shared by all ops: ``dst (E,)`` int holds a destination row in
``[0, num_out)`` for every edge slot, including padding; ``mask (E,) bool``
marks the valid slots. Destinations whose incident edges are all masked out
("empty segments") yield *exact zeros* — never NaN — in every op and dtype:
the mask is applied with ``where`` in the softmax, the max-clamp is a finite
value of the input dtype (``finfo.min / 2``; the packed kernel's is -1e30 in
float32), counts are float32, and the softmax denominator is clamped to
``finfo.tiny`` (the packed kernel's to 1e-30 in float32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.edge_softmax.ops import edge_softmax_from_pack
from repro_torch.kernels.segsum.ops import pack_edges, segment_sum_from_pack

BACKENDS = ("torch", "packed")


def _pack(dst, mask, num_out, backend):
    """The host-side pack of a concrete ``dst``/``mask`` for the packed
    backend; None for the torch backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown segment_ops backend {backend!r} {BACKENDS}")
    if backend == "torch":
        return None
    return pack_edges(np.asarray(torch.as_tensor(dst).cpu(), np.int32),
                      np.asarray(torch.as_tensor(mask).cpu(), bool), num_out)


def segment_sum(contrib, dst, mask, num_out, backend="torch"):
    """Masked per-destination sum of ``contrib (E, F)`` -> ``(num_out, F)``.

    Masked slots contribute exactly 0.0 (a ``*`` by the mask, as in the
    reference); empty segments are exact zeros. Output dtype ==
    ``contrib.dtype``.
    """
    pack = _pack(dst, mask, num_out, backend)
    if pack is not None:
        return segment_sum_from_pack(contrib, pack, num_out)
    w = mask.to(contrib.dtype)
    out = contrib.new_zeros((num_out,) + contrib.shape[1:])
    return out.index_add(0, dst.long(), contrib * w[:, None])


def segment_mean(contrib, dst, mask, num_out, backend="torch"):
    """Masked per-destination mean -> ``(num_out, F)``.

    The denominator is counted in float32 regardless of ``contrib.dtype``
    and clamped to 1, so empty segments return exact zeros rather than 0/0.
    """
    total = segment_sum(contrib, dst, mask, num_out, backend=backend)
    dst = torch.as_tensor(dst, device=contrib.device).long()
    mask = torch.as_tensor(mask, device=contrib.device)
    count = torch.zeros(num_out, dtype=torch.float32, device=contrib.device)
    count = count.index_add(0, dst, mask.to(torch.float32))
    return total / count.clamp(min=1.0).to(total.dtype)[:, None]


def edge_softmax(logits, dst, mask, num_out, backend="torch"):
    """Per-destination softmax over incoming edges: ``(E, H) -> (E, H)``.

    Masked edges get weight exactly 0.0 and take no part in the
    normalization; a destination whose edges are all masked contributes only
    zeros. The per-segment max is a constant shift that cancels in the
    softmax, so it is taken without a gradient (the reference differentiates
    through it; the two agree to rounding). The packed backend computes in
    float32 with the Pallas kernel's clamps, forward only (its CUDA
    kernel has no adjoint: it is off the training path, and logits that
    need a gradient raise).
    """
    pack = _pack(dst, mask, num_out, backend)
    if pack is not None:
        return edge_softmax_from_pack(logits, pack)
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
