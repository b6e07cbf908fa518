"""Differentiable fused gather->segment-aggregate ops, the counterpart of
``repro/kernels/gather_segsum/ops.py``.

The JAX ops take one split and are vmapped over P; these take all P splits at
once (``mixed (P, M, F)``, plan arrays with a leading P axis), so each layer
costs one launch per kernel. Two ``torch.autograd.Function``s wrap the
kernels, the analogs of the JAX custom VJPs: ``_FusedSum`` (forward +
adjoint w.r.t. the rows) and ``_FusedWeighted`` (GAT: adjoints w.r.t. the rows
and the per-slot weights). Both honour ``ctx.needs_input_grad``: an adjoint
nobody needs is never launched.

Contract (shared by all ops, per split):
  mixed      (P, M, F) f32 — mixed-frontier rows; padding rows' values are
                             irrelevant (never addressed by valid slots).
  edge_src   (P, E)    int32 — per-edge source row into ``mixed``.
  pack_perm  (P, DB, EB) int32 — slot -> edge index; padding slots arbitrary.
  pack_dst   (P, DB, EB) int32 — slot -> dst - db*R; **R marks padding**.
  num_out    int — destination rows; output is (P, num_out, F).

The kernels sum every output from 0 in packed slot order, as the packed plain
versions (``ref.*_packed``) do on a CPU tensor, and equal them bit for bit
there. The edge-order oracles (``ref.gather_segment_*_ref``) sum in another
order, so the ops match them to fp tolerance only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_segsum import kernel
from repro_torch.kernels.gather_segsum.layout import AGG_ROWS


def _pack_src(edge_src, pack_perm, pack_dst, mem_rows):
    """Per-slot source row (P, DB, EB) int32, derived from ``edge_src`` at
    step time so a repad's rebasing of ``edge_src`` always propagates.

    ``pack_perm`` padding holds the out-of-range sentinel E, and after a repad
    a stale entry may point at a masked edge, so the perm is clamped before
    indexing; padding slots (``pack_dst == AGG_ROWS``) get the sentinel
    ``mem_rows``, which no kernel ever dereferences.
    """
    P, E = edge_src.shape
    perm = pack_perm.reshape(P, -1).long().clamp(0, E - 1)
    src = torch.gather(edge_src, 1, perm).reshape(pack_perm.shape)
    return torch.where(
        pack_dst < AGG_ROWS, src, torch.full_like(src, mem_rows)
    ).to(torch.int32).contiguous()


class _FusedSum(torch.autograd.Function):
    """Unweighted fused sum; its adjoint builds the src-ordered walk on the
    card beside the kernel that reads it."""

    @staticmethod
    def forward(ctx, mixed, pack_src, pack_dst, num_out):
        out = kernel.gather_segsum_fwd(mixed, pack_src, pack_dst, None, num_out)
        ctx.mem_rows = mixed.shape[1]
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(pack_src, pack_dst)
        return out

    @staticmethod
    def backward(ctx, g):
        pack_src, pack_dst = ctx.saved_tensors
        gm = kernel.gather_segsum_bwd_mixed(
            g.contiguous(), pack_src, pack_dst, None, ctx.mem_rows
        )
        return gm, None, None, None


class _FusedWeighted(torch.autograd.Function):
    """GAT's weighted fused sum: cotangents for the rows and the per-slot
    weights. The weights arrive already packed (``w_packed``); the gather that
    packs them stays outside, so autograd routes their cotangent back to the
    per-edge alpha."""

    @staticmethod
    def forward(ctx, mixed, w_packed, pack_src, pack_dst, num_out):
        out = kernel.gather_segsum_fwd(
            mixed, pack_src, pack_dst, w_packed, num_out
        )
        ctx.save_for_backward(mixed, w_packed, pack_src, pack_dst)
        return out

    @staticmethod
    def backward(ctx, g):
        mixed, w_packed, pack_src, pack_dst = ctx.saved_tensors
        g = g.contiguous()
        gm = gw = None
        if ctx.needs_input_grad[0]:
            gm = kernel.gather_segsum_bwd_mixed(
                g, pack_src, pack_dst, w_packed, mixed.shape[1]
            )
        if ctx.needs_input_grad[1]:
            gw = kernel.gather_segsum_bwd_w(
                mixed, g, pack_src, pack_dst, w_packed.shape[-1]
            )
        return gm, gw, None, None, None


def gather_segment_sum(mixed, edge_src, pack_perm, pack_dst, num_out):
    """Fused ``segment_sum(mixed[edge_src], dst)`` per split -> (P, num_out, F).

    Never materializes the (E, F) per-edge buffer; padding slots contribute
    exactly 0. Differentiable w.r.t. ``mixed``.
    """
    pack_src = _pack_src(edge_src, pack_perm, pack_dst, mixed.shape[1])
    return _FusedSum.apply(
        mixed.contiguous(), pack_src, pack_dst.contiguous(), num_out
    )


def gather_segment_mean(mixed, edge_src, pack_perm, pack_dst, seg_offsets,
                        num_out):
    """Fused masked segment mean -> (P, num_out, F).

    The denominator comes from the plan's CSR offsets (exact integer counts);
    destinations with zero valid edges return exact zeros.
    """
    total = gather_segment_sum(mixed, edge_src, pack_perm, pack_dst, num_out)
    count = (seg_offsets[:, 1:] - seg_offsets[:, :-1]).to(total.dtype)
    return total / count.clamp(min=1.0)[:, :, None]


def gather_weighted_segsum(mixed, weights, edge_src, pack_perm, pack_dst,
                           num_out):
    """Fused ``segment_sum(weights[e, h] * mixed[src, h*dh:(h+1)*dh], dst)``.

    ``mixed (P, M, H*dh)`` has head-major columns; ``weights (P, E, H)`` is
    GAT's alpha. Differentiable w.r.t. both.
    """
    P, E, H = weights.shape
    if mixed.shape[-1] % H:
        raise ValueError("weighted segsum: feature dim must split across heads")
    pack_src = _pack_src(edge_src, pack_perm, pack_dst, mixed.shape[1])
    flat_perm = pack_perm.reshape(P, -1).long().clamp(0, E - 1)
    valid = (pack_dst.reshape(P, -1) < AGG_ROWS).to(weights.dtype)
    # pack the weights outside the Function (E*H traffic, tiny next to E*F):
    # their cotangent flows back through this gather to alpha, and padding
    # slots get exact zeros
    w_packed = torch.gather(
        weights, 1, flat_perm[:, :, None].expand(-1, -1, H)
    ) * valid[:, :, None]
    return _FusedWeighted.apply(
        mixed.contiguous(), w_packed.contiguous(), pack_src,
        pack_dst.contiguous(), num_out,
    )
