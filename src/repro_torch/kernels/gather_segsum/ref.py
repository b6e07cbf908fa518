"""Plain torch versions of the fused gather->segment-aggregate kernels.

Two families, both on any device:

* ``*_packed`` — the same functions as the three CUDA kernels, on the same
  inputs (the packed layout, all P splits at once), written as
  ``index_select`` + ``index_add_`` over the valid slots. The kernel wrappers
  use them for CPU tensors, and ``chip_smoke.py`` holds each kernel against
  its plain version on the card.
* ``gather_segment_*_ref`` — the counterparts of ``repro``'s jnp oracles
  (one split, edge order): they materialize the (E, F) per-edge buffer the
  kernels avoid.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import segment_ops
from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R


def _valid_slots(pack_dst):
    """Flat indices of the valid slots plus their split and dst-block index.

    ``pack_dst`` is (P, DB, EB); only ``pack_dst == R`` marks padding.
    """
    P, DB, EB = pack_dst.shape
    flat = torch.nonzero((pack_dst < R).reshape(-1)).squeeze(1)
    p = flat // (DB * EB)
    db = (flat // EB) % DB
    return flat, p, db


def _head_cols(w, F):
    """(S, H) per-slot head weights -> (S, F) per-column weights."""
    return w.repeat_interleave(F // w.shape[-1], dim=-1)


def gather_segsum_fwd_packed(mixed, pack_src, pack_dst, w, num_out):
    """out[p, db*R + r] = sum of (w *) mixed[p, pack_src] over slots with
    pack_dst == r: (P, M, F) -> (P, num_out, F)."""
    P, M, F = mixed.shape
    flat, p, db = _valid_slots(pack_dst)
    src = pack_src.reshape(-1)[flat].long() + p * M
    dst = pack_dst.reshape(-1)[flat].long() + db * R + p * num_out
    contrib = mixed.reshape(P * M, F).index_select(0, src)
    if w is not None:
        contrib = contrib * _head_cols(w.reshape(-1, w.shape[-1])[flat], F)
    out = mixed.new_zeros((P * num_out, F))
    return out.index_add_(0, dst, contrib).reshape(P, num_out, F)


def gather_segsum_bwd_mixed_packed(g, pack_src, pack_dst, w, mem_rows):
    """dmixed[p, s] = sum of (w *) g[p, db*R + pack_dst] over slots with
    pack_src == s: (P, num_out, F) -> (P, mem_rows, F)."""
    P, num_out, F = g.shape
    flat, p, db = _valid_slots(pack_dst)
    src = pack_src.reshape(-1)[flat].long() + p * mem_rows
    dst = pack_dst.reshape(-1)[flat].long() + db * R + p * num_out
    contrib = g.reshape(P * num_out, F).index_select(0, dst)
    if w is not None:
        contrib = contrib * _head_cols(w.reshape(-1, w.shape[-1])[flat], F)
    out = g.new_zeros((P * mem_rows, F))
    return out.index_add_(0, src, contrib).reshape(P, mem_rows, F)


def gather_segsum_bwd_w_packed(mixed, g, pack_src, pack_dst, num_heads):
    """dw[p, slot, h] = sum over head h's columns of mixed[p, pack_src] *
    g[p, db*R + pack_dst]; padding slots are exact zeros: -> (P, DB*EB, H)."""
    P, M, F = mixed.shape
    num_out = g.shape[1]
    flat, p, db = _valid_slots(pack_dst)
    src = pack_src.reshape(-1)[flat].long() + p * M
    dst = pack_dst.reshape(-1)[flat].long() + db * R + p * num_out
    prod = mixed.reshape(P * M, F)[src] * g.reshape(P * num_out, F)[dst]
    dw = prod.reshape(-1, num_heads, F // num_heads).sum(-1)
    out = mixed.new_zeros((pack_dst.numel(), num_heads))
    out[flat] = dw
    return out.reshape(P, -1, num_heads)


def block_row_offsets(pack_dst):
    """(P*DB, R+1) int32: row r of block (p, db) owns the slots
    ``[off[p*DB+db, r], off[p*DB+db, r+1])``.

    The slots of a block are dst-sorted with the padding (``>= R``) last, so
    one batched binary search over ``pack_dst`` finds every row's run; the
    last entry is the block's valid-slot count. The forward kernel finds the
    same runs in shared memory, where ``pack_dst`` changes.
    """
    P, DB, EB = pack_dst.shape
    keys = torch.arange(R + 1, dtype=torch.int32, device=pack_dst.device)
    return torch.searchsorted(
        pack_dst.reshape(P * DB, EB), keys.expand(P * DB, R + 1).contiguous(),
        out_int32=True,
    )


def src_sorted_csr_ref(pack_src, pack_dst, mem_rows, num_out):
    """``kernel.src_sorted_csr``'s plain version: a stable sort of the flat
    slots by flat source row ``p*M + pack_src``, padding slots (key ``P*M``)
    last. Returns ``(offsets (P*M+1,), sorted_grow, sorted_slot)``, int32."""
    P, DB, EB = pack_dst.shape
    n = P * mem_rows
    per_split = DB * EB
    split = torch.arange(P, device=pack_dst.device).repeat_interleave(per_split)
    dst = pack_dst.reshape(-1).long()
    key = torch.where(
        dst < R, split * mem_rows + pack_src.reshape(-1).long(), n
    )
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(n + 1, device=key.device), out_int32=True
    )
    db = (order // EB) % DB
    grow = (order // per_split) * num_out + db * R + dst[order]
    return offsets, grow.to(torch.int32), order.to(torch.int32)


# --------------------------------------------------------------------------- #
# edge-order oracles (one split), counterparts of repro's ref.py
# --------------------------------------------------------------------------- #
def gather_segment_sum_ref(mixed, edge_src, edge_dst, edge_mask, num_out):
    """Sum over incoming edges of mixed[src]: the unfused two-op path."""
    contrib = mixed[edge_src.long()]  # (E, F) — the buffer the kernel avoids
    return segment_ops.segment_sum(contrib, edge_dst, edge_mask, num_out)


def gather_segment_mean_ref(mixed, edge_src, edge_dst, edge_mask, num_out):
    """Masked mean; destinations with zero valid edges return exact zeros."""
    contrib = mixed[edge_src.long()]
    return segment_ops.segment_mean(contrib, edge_dst, edge_mask, num_out)


def gather_weighted_segsum_ref(mixed, weights, edge_src, edge_dst, edge_mask,
                               num_out):
    """Sum over edges of weights[e, h] * mixed[src, h*dh:(h+1)*dh]."""
    E, H = weights.shape
    F = mixed.shape[1]
    contrib = mixed[edge_src.long()].reshape(E, H, F // H) * weights[:, :, None]
    return segment_ops.segment_sum(
        contrib.reshape(E, F), edge_dst, edge_mask, num_out
    )
