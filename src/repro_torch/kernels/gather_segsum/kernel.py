"""Wrappers of the CUDA gather->segment-aggregate kernels
(``csrc/gather_segsum.cu``), one per Pallas kernel of
``repro/kernels/gather_segsum/kernel.py``.

Each wrapper takes all P splits at once (one launch per layer, P as a grid
axis — at the main path's shapes the kernels are launch-bound), checks device,
dtype, shape and contiguity and raises on anything else, allocates its output,
and counts its launches in ``LAUNCHES``. For a CUDA tensor it launches the
kernel or raises; for a CPU tensor it runs the plain version from ``ref.py``
(the only reason it ever does). What bounds each kernel on the card, and what
its design does about it, is noted beside each wrapper and in the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import INT as _I
from repro_torch.kernels.build import PTR as _P
from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import ptr as _ptr
from repro_torch.kernels.build import raise_on as _raise_on
from repro_torch.kernels.build import stream as _stream
from repro_torch.kernels.build import typed_library
from repro_torch.kernels.gather_segsum import ref
from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R

#: kernel launches per wrapper since the last ``reset_launches()``; only a
#: launch of the CUDA kernels counts, never a plain-version call
#: (``src_sorted_csr``: one build of the walk, three kernels)
LAUNCHES = {
    "gather_segsum_fwd": 0,
    "gather_segsum_bwd_mixed": 0,
    "gather_segsum_bwd_w": 0,
    "src_sorted_csr": 0,
}

_SIGNATURES = {
    # mixed, pack_src, pack_dst, w, out, P, M, F, DB, EB, num_out, H, dh, R
    "gss_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # pack_src, pack_dst, ws, offsets, valid_incl, placed, placed_grow,
    # sorted_grow, sorted_slot, P, M, DB, EB, num_out, R
    "gss_src_walk": [_P] * 9 + [_I] * 6 + [_P],
    # g, offsets, sorted_grow, sorted_slot, w, dmixed, num_rows, F, H, dh
    "gss_bwd_mixed": [_P] * 6 + [_I] * 4 + [_P],
    # mixed, g, pack_src, pack_dst, dw, P, M, F, DB, EB, num_out, H, dh, R
    "gss_bwd_w": [_P] * 5 + [_I] * 9 + [_P],
}
#: the walk's counters, zero between builds, one per (card, stream): the
#: build's last kernels count them back to zero
_walk_ws: dict = {}

#: the runs of each row of each pack block, as the forward kernel finds them
#: in shared memory (plain version, read by the tests)
block_row_offsets = ref.block_row_offsets


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    return typed_library("gather_segsum", _SIGNATURES)


def _check_pack(mixed, pack_src, pack_dst, w):
    device = mixed.device
    _check("pack_src", pack_src, torch.int32, 3, device)
    _check("pack_dst", pack_dst, torch.int32, 3, device)
    if pack_src.shape != pack_dst.shape or pack_src.shape[0] != mixed.shape[0]:
        raise ValueError(
            f"pack shapes {tuple(pack_src.shape)} / {tuple(pack_dst.shape)} "
            f"do not match {mixed.shape[0]} splits"
        )
    if w is not None:
        _check("w", w, torch.float32, 3, device)
        if w.shape[:2] != (pack_dst.shape[0], pack_dst.shape[1] * pack_dst.shape[2]):
            raise ValueError(f"w {tuple(w.shape)} does not match the pack")
        if mixed.shape[-1] % w.shape[-1]:
            raise ValueError("feature dim must split evenly across heads")


def gather_segsum_fwd(mixed, pack_src, pack_dst, w, num_out):
    """Fused forward, replacing ``gather_segsum_fwd`` (Pallas,
    repro/kernels/gather_segsum/kernel.py:190, body ``_fwd_body``).

    mixed (P, M, F) f32; pack_src / pack_dst (P, DB, EB) int32 (``pack_dst
    >= R`` marks padding); w (P, DB*EB, H) f32 or None ->
    (P, num_out, F) f32. Bound by bytes: indices, each needed row once and
    the output once. A block stages a pack block's indices and finds its 32
    rows' runs in shared memory (no ``searchsorted``); a warp owns a whole
    row and sums its run from 0 in packed order with 8 row loads in flight
    (4 when weighted at F > 128). One launch.
    """
    _check("mixed", mixed, torch.float32, 3, mixed.device)
    _check_pack(mixed, pack_src, pack_dst, w)
    if mixed.device.type == "cpu":
        return ref.gather_segsum_fwd_packed(
            mixed, pack_src, pack_dst, w, num_out
        )
    P, M, F = mixed.shape
    _, DB, EB = pack_dst.shape
    if DB * R < num_out:
        raise ValueError(f"{DB} dst blocks cannot hold {num_out} rows")
    _check_int32(P * DB * EB, P * M)
    H = w.shape[-1] if w is not None else 1
    out = torch.empty((P, num_out, F), dtype=torch.float32, device=mixed.device)
    rc = _lib().gss_fwd(
        _ptr(mixed), _ptr(pack_src), _ptr(pack_dst), _ptr(w), _ptr(out),
        P, M, F, DB, EB, num_out, H, F // H, R, _stream(mixed.device),
    )
    _raise_on(rc, "gss_fwd")
    LAUNCHES["gather_segsum_fwd"] += 1
    return out


def _check_int32(slots, rows):
    """The kernels index slots and flat source rows in 32 bits."""
    if slots >= 2**31 or rows >= 2**31 - 1:
        raise ValueError(f"{slots} slots / {rows} rows exceed 32-bit indices")


def _walk_workspace(device, size):
    """The walk's zeroed counters for this card and stream, grown to
    ``size`` entries (a new buffer is zeroed in stream order)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws = _walk_ws.get(key)
    if ws is None or ws.numel() < size:
        ws = torch.zeros(size, dtype=torch.int32, device=device)
        _walk_ws[key] = ws
    return ws


def src_sorted_csr(pack_src, pack_dst, mem_rows, num_out):
    """The src-ordered walk ``gather_segsum_bwd_mixed`` needs.

    Returns ``(offsets, sorted_grow, sorted_slot)``, all int32: the valid
    slots sorted stably by flat source row ``p*M + pack_src`` (padding slots
    last, in slot order, never read), CSR offsets over the P*M source rows,
    and per sorted slot the flat row of the output cotangent it reads and its
    flat slot index. The stable order fixes the order of every sum, so the
    adjoint repeats bit for bit. On the card three hand-written kernels build
    it (count + scan, place, order; no sort, no host sync) bitwise equal to
    the plain version (``ref.src_sorted_csr_ref``), which CPU tensors take.
    """
    if pack_dst.device.type == "cpu":
        return ref.src_sorted_csr_ref(pack_src, pack_dst, mem_rows, num_out)
    device = pack_dst.device
    _check("pack_src", pack_src, torch.int32, 3, device)
    _check("pack_dst", pack_dst, torch.int32, 3, device)
    P, DB, EB = pack_dst.shape
    S, n = P * DB * EB, P * mem_rows
    _check_int32(S, n)
    ws = _walk_workspace(device, 1 + P * DB + n)
    offsets, grow, slot = torch.empty(
        n + 1 + 2 * S, dtype=torch.int32, device=device).split([n + 1, S, S])
    # scratch, freed (in stream order) once the build is enqueued: the placed
    # slots and their cotangent rows, the pack blocks' inclusive valid counts
    placed, placed_grow, valid_incl = torch.empty(
        2 * S + P * DB, dtype=torch.int32, device=device).split([S, S, P * DB])
    rc = _lib().gss_src_walk(
        _ptr(pack_src), _ptr(pack_dst), _ptr(ws), _ptr(offsets),
        _ptr(valid_incl), _ptr(placed), _ptr(placed_grow), _ptr(grow), _ptr(slot),
        P, mem_rows, DB, EB, num_out, R, _stream(device),
    )
    _raise_on(rc, "gss_src_walk")
    LAUNCHES["src_sorted_csr"] += 1
    return offsets, grow, slot


def gather_segsum_bwd_mixed(g, pack_src, pack_dst, w, mem_rows, src_csr=None):
    """Adjoint w.r.t. ``mixed``, replacing ``gather_segsum_bwd_mixed``
    (Pallas, repro/kernels/gather_segsum/kernel.py:240, ``_bwd_mixed_body``).

    g (P, num_out, F) f32 -> (P, mem_rows, F) f32. ``src_csr`` is
    ``src_sorted_csr(...)`` (built here when not given; CUDA only). Bound by
    bytes: each needed cotangent row once, the indices and the output once.
    Instead of a scatter with float atomics, a warp owns two whole source
    rows in turn and sums each from 0 in the walk's fixed order, 8
    cotangent-row loads in flight (4 when weighted at F > 128), so every
    output row is written once and the result is deterministic.
    """
    _check("g", g, torch.float32, 3, g.device)
    _check_pack(g, pack_src, pack_dst, w)
    if g.device.type == "cpu":
        return ref.gather_segsum_bwd_mixed_packed(
            g, pack_src, pack_dst, w, mem_rows
        )
    P, num_out, F = g.shape
    if src_csr is None:
        src_csr = src_sorted_csr(pack_src, pack_dst, mem_rows, num_out)
    offsets, sorted_grow, sorted_slot = src_csr
    for name, t in zip(("offsets", "sorted_grow", "sorted_slot"), src_csr):
        _check(name, t, torch.int32, 1, g.device)
    if offsets.shape[0] != P * mem_rows + 1:
        raise ValueError("src_csr was built for another number of rows")
    H = w.shape[-1] if w is not None else 1
    out = torch.empty((P, mem_rows, F), dtype=torch.float32, device=g.device)
    rc = _lib().gss_bwd_mixed(
        _ptr(g), _ptr(offsets), _ptr(sorted_grow), _ptr(sorted_slot), _ptr(w),
        _ptr(out), P * mem_rows, F, H, F // H, _stream(g.device),
    )
    _raise_on(rc, "gss_bwd_mixed")
    LAUNCHES["gather_segsum_bwd_mixed"] += 1
    return out


def gather_segsum_bwd_w(mixed, g, pack_src, pack_dst, num_heads):
    """Adjoint w.r.t. the per-slot weights, replacing ``gather_segsum_bwd_w``
    (Pallas, repro/kernels/gather_segsum/kernel.py:293, ``_bwd_w_body``).

    mixed (P, M, F), g (P, num_out, F) -> (P, DB*EB, H) f32; padding slots
    are exact zeros. Bound by bytes: one mixed row per valid slot, each
    needed cotangent row once. A block stages a pack block's indices and
    finds its 32 rows' runs as the forward does; a warp loads a row's
    cotangent once and, 8 source rows in flight, adds each head in the
    order ``ref.head_tree_sum`` states (a lane group's xor butterfly), so
    the result equals the plain version's on a CPU tensor bit for bit.
    """
    _check("mixed", mixed, torch.float32, 3, mixed.device)
    _check("g", g, torch.float32, 3, mixed.device)
    _check_pack(mixed, pack_src, pack_dst, None)
    P, M, F = mixed.shape
    if g.shape[0] != P or g.shape[2] != F or F % num_heads:
        raise ValueError(
            f"g {tuple(g.shape)} / {num_heads} heads do not match mixed "
            f"{tuple(mixed.shape)}"
        )
    if mixed.device.type == "cpu":
        return ref.gather_segsum_bwd_w_packed(
            mixed, g, pack_src, pack_dst, num_heads
        )
    _, DB, EB = pack_dst.shape
    num_out = g.shape[1]
    out = torch.empty(
        (P, DB * EB, num_heads), dtype=torch.float32, device=mixed.device
    )
    rc = _lib().gss_bwd_w(
        _ptr(mixed), _ptr(g), _ptr(pack_src), _ptr(pack_dst), _ptr(out),
        P, M, F, DB, EB, num_out, num_heads, F // num_heads, R,
        _stream(mixed.device),
    )
    _raise_on(rc, "gss_bwd_w")
    LAUNCHES["gather_segsum_bwd_w"] += 1
    return out
