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
#: launch of the CUDA kernel counts, never a plain-version call
LAUNCHES = {
    "gather_segsum_fwd": 0,
    "gather_segsum_bwd_mixed": 0,
    "gather_segsum_bwd_w": 0,
}

_SIGNATURES = {
    # mixed, pack_src, row_off, w, out, P, M, F, DB, EB, num_out, H, dh, R
    "gss_fwd": [_P] * 5 + [_I] * 9 + [_P],
    # g, offsets, sorted_grow, sorted_slot, w, dmixed, num_rows, F, H, dh
    "gss_bwd_mixed": [_P] * 6 + [_I] * 4 + [_P],
    # mixed, g, pack_src, pack_dst, dw, P, M, F, DB, EB, num_out, H, dh, R
    "gss_bwd_w": [_P] * 5 + [_I] * 9 + [_P],
}


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


def block_row_offsets(pack_dst):
    """(P*DB, R+1) int32: row r of block (p, db) owns the slots
    ``[off[p*DB+db, r], off[p*DB+db, r+1])``.

    The slots of a block are dst-sorted with the padding (``R``) last, so
    one batched binary search over ``pack_dst`` finds every row's run on
    device (no host sync); the last entry is the block's valid-slot count.
    """
    P, DB, EB = pack_dst.shape
    keys = torch.arange(R + 1, dtype=torch.int32, device=pack_dst.device)
    return torch.searchsorted(
        pack_dst.reshape(P * DB, EB), keys.expand(P * DB, R + 1).contiguous(),
        out_int32=True,
    )


def gather_segsum_fwd(mixed, pack_src, pack_dst, w, num_out):
    """Fused forward, replacing ``gather_segsum_fwd`` (Pallas,
    repro/kernels/gather_segsum/kernel.py:190, body ``_fwd_body``).

    mixed (P, M, F) f32; pack_src / pack_dst (P, DB, EB) int32 (``pack_dst
    == R`` marks padding); w (P, DB*EB, H) f32 or None ->
    (P, num_out, F) f32. Bound by bytes: indices, each needed row once and
    the output once. Each warp owns 32 columns of a few output rows
    and sums each row's run of slots in a register, in packed order; padding
    slots are never visited.
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
    row_off = block_row_offsets(pack_dst)
    H = w.shape[-1] if w is not None else 1
    out = torch.empty((P, num_out, F), dtype=torch.float32, device=mixed.device)
    rc = _lib().gss_fwd(
        _ptr(mixed), _ptr(pack_src), _ptr(row_off), _ptr(w), _ptr(out),
        P, M, F, DB, EB, num_out, H, F // H, R, _stream(mixed.device),
    )
    _raise_on(rc, "gss_fwd")
    LAUNCHES["gather_segsum_fwd"] += 1
    return out


def src_sorted_csr(pack_src, pack_dst, mem_rows, num_out):
    """The src-ordered walk ``gather_segsum_bwd_mixed`` needs, built on device.

    Returns ``(offsets, sorted_grow, sorted_slot)``: a stable sort of the
    valid slots by flat source row ``p*M + pack_src`` (padding slots sort
    last and are never read), CSR offsets over the P*M source rows, and per
    sorted slot the flat row of the output cotangent it reads and its flat
    slot index. All int32, no host sync. The stable sort fixes the order of
    every sum, so the adjoint repeats bit for bit.
    """
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


def gather_segsum_bwd_mixed(g, pack_src, pack_dst, w, mem_rows, src_csr=None):
    """Adjoint w.r.t. ``mixed``, replacing ``gather_segsum_bwd_mixed``
    (Pallas, repro/kernels/gather_segsum/kernel.py:240, ``_bwd_mixed_body``).

    g (P, num_out, F) f32 -> (P, mem_rows, F) f32. ``src_csr`` is
    ``src_sorted_csr(...)`` (built here when not given; CUDA only). Bound by
    bytes: each needed cotangent row once, the indices and the output once.
    Instead of a scatter with float atomics, each warp owns 32 columns of a
    few source rows and sums their slots in the fixed src-sorted order, so
    every output row is written once and the result is deterministic.
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
    are exact zeros. Bound by bytes: one mixed row and one cotangent row per
    valid slot. One warp per slot reduces each head's columns with a fixed
    shuffle tree (deterministic by construction).
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
