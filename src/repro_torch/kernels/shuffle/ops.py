"""The sim shuffle's send gather, and the GNN layers' self-row gather, as
differentiable ops.

``send_gather(h, send_idx, send_count)`` is ``h[q, send_idx[q, p, s]]``
(P, Q, S, F). Its forward is torch's gather, as the JAX package leaves it to
XLA; its adjoint is ``kernel.shuffle_bwd``: the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor, never torch's ``index_put_``. The wire
cast and the concatenation with the local rows stay outside, in
``core/shuffle.py``, so autograd adds the local rows' cotangent and carries
the wire cast's adjoint. ``self_gather`` is the same op with one group: a
split's destination rows, found at ``self_pos`` among its mixed rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.shuffle import kernel


class _SendGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, send_idx, send_count):
        owner = torch.arange(h.shape[0], device=h.device)[:, None, None]
        ctx.num_rows = h.shape[1]
        ctx.save_for_backward(send_idx, send_count)
        return h[owner, send_idx.long()]

    @staticmethod
    def backward(ctx, g):
        send_idx, send_count = ctx.saved_tensors
        dh = kernel.shuffle_bwd(g.contiguous(), send_idx, send_count, ctx.num_rows)
        return dh, None, None


def send_gather(h, send_idx, send_count) -> torch.Tensor:
    """``send[q, p, s] = h[q, send_idx[q, p, s]]`` (P, Q, S, F); ``send_idx``
    (P, Q, S) and ``send_count`` (P, Q) int32, the plan's true pair sizes.
    Differentiable w.r.t. ``h``."""
    return _SendGather.apply(h, send_idx.contiguous(), send_count.contiguous())


def self_gather(mixed, self_pos, dst_count) -> torch.Tensor:
    """``mixed[p, self_pos[p, i]]`` (P, N_i, F): each split's destination
    rows among its mixed rows. ``self_pos`` (P, N_i) int32 holds ascending
    rows at the ``dst_count`` (P,) int32 valid destinations (padding rows
    hold 0 and take a zero cotangent). Differentiable w.r.t. ``mixed``."""
    return send_gather(mixed, self_pos[:, None, :], dst_count[:, None])[:, 0]
