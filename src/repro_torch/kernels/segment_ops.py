"""Segment operations in torch — the counterpart of ``repro.kernels.segment_ops``,
with its backend dispatch.

``backend="torch"`` (the counterpart of ``"jnp"``, and what the model calls)
sums each destination's run in a fixed order (``ordered_segment_sum``): no
float atomics, so on the card as on the CPU the result repeats bit for bit.
``backend="packed"`` (the counterpart of
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


def _run_totals(x, dst, num_out):
    """Per-destination totals of ``x (E, ...)`` in a fixed order: a stable
    sort by ``dst``, then an inclusive segmented scan by doubling (step ``d``
    adds the partial sum ``d`` positions back when it lies in the same run),
    so each run's last position holds the run's total, summed as a fixed
    tree. ``ceil(log2 E)`` elementwise steps, none with atomics and none that
    needs a host sync; the totals are copied to their rows (one writer each,
    the other positions write a dropped dump row)."""
    E = x.shape[0]
    out = x.new_zeros((num_out + 1,) + x.shape[1:])
    if E == 0:
        return out[:num_out]
    key, order = torch.sort(dst.long(), stable=True)
    run = x.index_select(0, order)
    bcast = (-1,) + (1,) * (x.dim() - 1)
    d = 1
    while d < E:
        same = (key[d:] == key[:-d]).view(bcast)
        run[d:] += torch.where(same, run[:-d], torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
        d *= 2
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    out.index_copy_(0, torch.where(last, key, num_out), run)
    return out[:num_out]


class _OrderedSegmentSum(torch.autograd.Function):
    """``_run_totals`` with its adjoint: the cotangent of each edge's row is
    its destination's cotangent row (a gather, also order-free)."""

    @staticmethod
    def forward(ctx, x, dst, num_out):
        ctx.save_for_backward(dst)
        return _run_totals(x, dst, num_out)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(0, dst.long()), None, None


def ordered_segment_sum(x, dst, num_out):
    """Per-destination sum of ``x (E, ...)`` -> ``(num_out, ...)`` in the
    input dtype, differentiable in ``x``; rows without edges are exact
    zeros. The summation order is fixed by a stable sort of ``dst``, so it
    repeats bit for bit on either device (``index_add`` adds with float
    atomics on the card, in an order that changes from run to run)."""
    return _OrderedSegmentSum.apply(x, dst, num_out)


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
    return ordered_segment_sum(contrib * w[:, None], dst, num_out)


def segment_mean(contrib, dst, mask, num_out, backend="torch"):
    """Masked per-destination mean -> ``(num_out, F)``.

    The denominator is counted in float32 regardless of ``contrib.dtype``
    and clamped to 1, so empty segments return exact zeros rather than 0/0.
    """
    total = segment_sum(contrib, dst, mask, num_out, backend=backend)
    dst = torch.as_tensor(dst, device=contrib.device).long()
    mask = torch.as_tensor(mask, device=contrib.device)
    count = ordered_segment_sum(mask.to(torch.float32), dst, num_out)
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
    denom = ordered_segment_sum(ex, dst, num_out)
    tiny = torch.finfo(logits.dtype).tiny
    return ex / denom[dst].clamp(min=tiny)
