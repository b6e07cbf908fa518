"""Host-side dst-sorted edge layout for the fused aggregation kernels.

Numpy only — a copy of ``repro.kernels.gather_segsum.layout``, imported by
``core.splitting`` on the plan producer. The layout it produces is the
*kernel contract* documented in docs/KERNELS.md, and the port's CUDA kernels
(``csrc/gather_segsum.cu``) read it as it stands:

  * ``edge_perm (E,)``   — a true permutation of ``[0, E)``: all mask-valid
    edges first, stable-sorted by ``edge_dst``; masked (padding) edge slots
    follow in ascending order. Repadding the edge axis appends the new masked
    slot indices, so the permutation stays valid under HWM growth.
  * ``seg_offsets (num_out + 1,)`` — CSR offsets into the dst-sorted order:
    valid edges with destination ``n`` occupy sorted positions
    ``[seg_offsets[n], seg_offsets[n+1])``; ``seg_offsets[num_out]`` is the
    valid-edge count. ``counts = diff(seg_offsets)`` is the exact segment-mean
    denominator (empty segments -> 0). Repadding the destination axis appends
    copies of the final value (empty segments).
  * ``pack_perm / pack_dst (DB, EB)`` — the kernel-facing realization: block
    ``db`` holds (only) the dst-sorted edges whose destination lies in rows
    ``[db*R, (db+1)*R)``, padded to ``EB`` slots. ``pack_perm`` maps slot ->
    edge index (padding slots hold the sentinel ``E``); ``pack_dst`` holds
    ``dst - db*R`` in ``[0, R)`` with the sentinel ``R`` marking padding.
    **Only ``pack_dst == R`` marks a padding slot** — after edge-axis growth
    a stale ``pack_perm`` sentinel may point at a masked edge slot, which is
    harmless because the kernels kill the slot via the dst sentinel. Growing
    the dst axis appends whole sentinel blocks (the DB axis); growing the
    per-block width appends sentinel slots (the EB axis) — both pure appends,
    which is what makes the packed layout repad-stable.

``R`` (= ``AGG_ROWS``) is the destination tile height, fixed repo-wide so
plans and kernels never disagree on the block structure.
"""
from __future__ import annotations

import numpy as np

AGG_ROWS = 128  # R: destination rows per block, shared with the JAX package
EDGE_BLOCK_FLOOR = 16  # minimum EB; pow2 bucketing bounds jit signatures


def pow2_at_least(x: int, floor: int = EDGE_BLOCK_FLOOR) -> int:
    """Smallest power of two >= max(x, floor)."""
    p = floor
    while p < x:
        p <<= 1
    return p


def pack_dst_blocks(
    edge_dst: np.ndarray,  # (E,) int32
    edge_mask: np.ndarray,  # (E,) bool
    num_out: int,
    edge_block: int,
    rows: int = AGG_ROWS,
) -> tuple[np.ndarray, np.ndarray]:
    """Materialize the (DB, EB) packed realization of the dst-sorted layout.

    Returns ``(pack_perm, pack_dst)`` with the sentinel semantics documented
    in the module docstring. ``edge_block`` must be >= the largest per-block
    valid-edge count (callers bucket it with ``pow2_at_least``).
    """
    E = edge_dst.shape[0]
    DB = max(-(-num_out // rows), 1)
    EB = edge_block
    pack_perm = np.full((DB, EB), E, dtype=np.int32)
    pack_dst = np.full((DB, EB), rows, dtype=np.int32)

    valid = np.flatnonzero(edge_mask)
    if valid.size:
        order = np.argsort(edge_dst[valid], kind="stable")
        sorted_idx = valid[order]
        block_of = edge_dst[sorted_idx].astype(np.int64) // rows
        counts = np.bincount(block_of, minlength=DB)
        assert counts.max(initial=0) <= EB, "edge_block too small for layout"
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(sorted_idx.shape[0]) - starts[block_of]
        pack_perm[block_of, slot] = sorted_idx
        pack_dst[block_of, slot] = edge_dst[sorted_idx] - (
            block_of * rows
        ).astype(edge_dst.dtype)
    return pack_perm, pack_dst


def block_counts(
    edge_dst: np.ndarray, edge_mask: np.ndarray, num_out: int,
    rows: int = AGG_ROWS,
) -> np.ndarray:
    """Valid edges per dst row-block: (ceil(num_out / rows),)."""
    db = max(-(-num_out // rows), 1)
    return np.bincount(
        edge_dst[edge_mask].astype(np.int64) // rows, minlength=db
    )


def packed_layout(
    edge_dst: np.ndarray,  # (P, E) int32
    edge_mask: np.ndarray,  # (P, E) bool
    num_out: int,
    rows: int = AGG_ROWS,
) -> tuple[np.ndarray, np.ndarray]:
    """(P, DB, EB) ``pack_perm``/``pack_dst`` with one shared EB across P.

    The packed realization alone — no ``edge_perm``/``seg_offsets`` — for
    edge *subsets* that already have a full layout elsewhere: the local/
    remote halves of a layer's edge set (the overlap schedule) carry only
    their packed blocks, because the combined CSR offsets of the full layout
    supply the mean denominator. Zero-width edge axes are legal (an
    all-local or all-remote layer) and yield all-sentinel blocks.
    """
    P, E = edge_dst.shape
    DB = max(-(-num_out // rows), 1)
    eb = pow2_at_least(
        int(
            max(
                (
                    block_counts(edge_dst[p], edge_mask[p], num_out, rows).max(
                        initial=0
                    )
                    for p in range(P)
                ),
                default=0,
            )
        )
    )
    pack_perm = np.empty((P, DB, eb), dtype=np.int32)
    pack_dst = np.empty((P, DB, eb), dtype=np.int32)
    for p in range(P):
        pack_perm[p], pack_dst[p] = pack_dst_blocks(
            edge_dst[p], edge_mask[p], num_out, eb, rows
        )
    return pack_perm, pack_dst


def layer_layout(
    edge_dst: np.ndarray,  # (P, E) int32
    edge_mask: np.ndarray,  # (P, E) bool
    num_out: int,
    rows: int = AGG_ROWS,
) -> dict:
    """Build the full dst-sorted layout for one layer of a split plan.

    One shared ``EB`` across the device axis (the kernels need one static
    shape per layer); per device, the contract arrays plus the packed
    realization. Runs on the plan producer thread — the O(E log E) dst sort
    happens once per device here and every derived array (permutation, CSR
    offsets, packed blocks) reuses it; off the consumer's critical path
    under the pipelined source.
    """
    P, E = edge_dst.shape
    DB = max(-(-num_out // rows), 1)

    # one sort per device, shared by every derived array
    per_dev = []
    for p in range(P):
        valid = np.flatnonzero(edge_mask[p])
        invalid = np.flatnonzero(~edge_mask[p])
        order = np.argsort(edge_dst[p][valid], kind="stable")
        sorted_idx = valid[order]
        counts = np.bincount(
            edge_dst[p][sorted_idx].astype(np.int64), minlength=num_out
        )
        per_dev.append((sorted_idx, invalid, counts))

    # per-block populations derive from the per-destination counts (O(N))
    pad = (-num_out) % rows
    eb = pow2_at_least(
        int(
            max(
                np.pad(c, (0, pad)).reshape(DB, rows).sum(axis=1).max(initial=0)
                for _, _, c in per_dev
            )
        )
    )

    edge_perm = np.empty((P, E), dtype=np.int32)
    seg_off = np.empty((P, num_out + 1), dtype=np.int32)
    pack_perm = np.full((P, DB, eb), E, dtype=np.int32)
    pack_dst = np.full((P, DB, eb), rows, dtype=np.int32)
    for p, (sorted_idx, invalid, counts) in enumerate(per_dev):
        edge_perm[p, : sorted_idx.shape[0]] = sorted_idx
        edge_perm[p, sorted_idx.shape[0]:] = invalid
        seg_off[p, 0] = 0
        seg_off[p, 1:] = np.cumsum(counts)
        if sorted_idx.size:
            dst_sorted = edge_dst[p][sorted_idx].astype(np.int64)
            block_of = dst_sorted // rows
            bcounts = np.bincount(block_of, minlength=DB)
            starts = np.concatenate([[0], np.cumsum(bcounts)[:-1]])
            slot = np.arange(sorted_idx.shape[0]) - starts[block_of]
            pack_perm[p, block_of, slot] = sorted_idx
            pack_dst[p, block_of, slot] = (dst_sorted - block_of * rows).astype(
                np.int32
            )
    return {
        "edge_perm": edge_perm,
        "seg_offsets": seg_off,
        "pack_perm": pack_perm,
        "pack_dst": pack_dst,
    }
