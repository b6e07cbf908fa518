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


def head_tree_sum(prod, num_heads):
    """(S, F) f32 products -> (S, H): each head's sum in one stated order.

    1. A head's dh columns are cut into units of u = 4 columns (u = 1 when
       dh % 4 != 0); a unit's products are added left to right.
    2. The head's n = dh/u unit partials, padded with +0.0 to n2, the next
       power of two, are added by a halving tree: x[i] + x[i + n2/2] for
       i < n2/2, repeated until one value remains.

    Each add is one rounded f32 add on its own (no ``.sum``, whose order is
    the library's), so the result does not depend on the device or the
    vector width; the CUDA kernel adds in the same order (a lane group's xor
    butterfly is this tree) and its result equals this one bit for bit.
    """
    S, F = prod.shape
    dh = F // num_heads
    u = 4 if dh % 4 == 0 else 1
    n = dh // u
    x = prod.reshape(S, num_heads, n, u)
    part = x[..., 0]
    for e in range(1, u):
        part = part + x[..., e]
    n2 = 1 << (n - 1).bit_length()
    if n2 > n:
        part = torch.cat([part, part.new_zeros((S, num_heads, n2 - n))], dim=2)
    while part.shape[2] > 1:
        half = part.shape[2] // 2
        part = part[:, :, :half] + part[:, :, half:]
    return part[:, :, 0]


def gather_segsum_bwd_w_packed(mixed, g, pack_src, pack_dst, num_heads):
    """dw[p, slot, h] = sum over head h's columns of mixed[p, pack_src] *
    g[p, db*R + pack_dst], each product rounded once and the products added
    in ``head_tree_sum``'s order; padding slots are exact zeros:
    -> (P, DB*EB, H)."""
    P, M, F = mixed.shape
    num_out = g.shape[1]
    flat, p, db = _valid_slots(pack_dst)
    src = pack_src.reshape(-1)[flat].long() + p * M
    dst = pack_dst.reshape(-1)[flat].long() + db * R + p * num_out
    prod = mixed.reshape(P * M, F)[src] * g.reshape(P * num_out, F)[dst]
    out = mixed.new_zeros((pack_dst.numel(), num_heads))
    out[flat] = head_tree_sum(prod, num_heads)
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
