"""Masked segment sum over dst-row-blocked packs — the counterpart of
``repro/kernels/segsum/ops.py`` and of its Pallas kernel
``repro/kernels/segsum/kernel.py::segment_sum_packed``.

``pack_edges`` (numpy, host side) groups the valid edges by destination
row block: block ``db`` holds, in edge order, the edges whose destination
lies in rows ``[db*R, (db+1)*R)``, padded to ``EB`` slots. The JAX and port
packs are bitwise equal. ``segment_sum_packed`` is the kernel's wrapper:
on a CUDA tensor it launches ``csrc/segsum_packed.cu`` or raises, on a CPU
tensor it runs the plain version ``segment_sum_packed_ref``.
``segment_sum_from_pack`` gathers the messages into packed order, runs it and
cuts the padding rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import INT, PTR, check_tensor, ptr, raise_on
from repro_torch.kernels.build import stream, typed_library
from repro_torch.kernels.gather_segsum.layout import pow2_at_least

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts, never a plain-version call
LAUNCHES = {"segment_sum_packed": 0}

#: the float types the packed kernels take (stored in, accumulated in f32)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_ROWS = 128  # R: dst rows of a block, a multiple of 32

# contrib, local_dst, out, DB, EB, F, R, dtype code, stream
_SIGNATURES = {"segsum_packed": [PTR] * 3 + [INT] * 5 + [PTR]}


def reset_launches() -> None:
    LAUNCHES["segment_sum_packed"] = 0


def pack_edges(
    dst: np.ndarray,  # (E,) int32
    mask: np.ndarray,  # (E,) bool
    num_out: int,
    rows: int = 128,
) -> dict:
    """Host-side packing: edges grouped by dst row-block, padded to EB slots.

    Returns perm (DB*EB,) indices into the edge axis (E = sentinel for
    padding -> callers append one zero row), local_dst (DB*EB, 1) with R as
    the padding sentinel, and the static dims.
    """
    E = dst.shape[0]
    DB = max((num_out + rows - 1) // rows, 1)
    valid = np.flatnonzero(mask)
    block_of = dst[valid] // rows
    order = np.argsort(block_of, kind="stable")
    valid = valid[order]
    block_of = block_of[order]
    counts = np.bincount(block_of, minlength=DB)
    EB = pow2_at_least(int(counts.max(initial=1)), 128)

    perm = np.full(DB * EB, E, dtype=np.int32)  # E = gather-a-zero-row sentinel
    local = np.full(DB * EB, rows, dtype=np.int32)  # rows = padding sentinel
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(valid.shape[0]) - np.repeat(starts, counts)
    pos = block_of * EB + slot
    perm[pos] = valid
    local[pos] = dst[valid] - block_of * rows
    return {
        "perm": perm,
        "local_dst": local.reshape(-1, 1),
        "rows": rows,
        "edge_block": EB,
        "num_blocks": DB,
    }


def check_packed(name, x, local_dst, rows: int, edge_block: int) -> None:
    """Raise unless ``x (DB*EB, W)`` and ``local_dst (DB*EB, 1)`` form a pack
    the packed kernels take. The kernels are forward only (no adjoint), so
    an ``x`` that needs a gradient raises too, on the CPU as on the card,
    rather than losing its gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"{name} requires grad, but the packed kernels are forward only: "
            "use segment_ops' torch backend, or call under torch.no_grad()"
        )
    check_tensor(name, x, tuple(DTYPES), 2, x.device)
    check_tensor("local_dst", local_dst, torch.int32, 2, x.device)
    total = x.shape[0]
    if local_dst.shape != (total, 1) or edge_block < 1 or total % edge_block:
        raise ValueError(
            f"{name} {tuple(x.shape)} / local_dst {tuple(local_dst.shape)} "
            f"is not a pack of {edge_block}-slot blocks"
        )
    if rows % 32 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"rows must be a multiple of 32 in (0, {MAX_ROWS}]")


def packed_rows(local_dst, rows: int, edge_block: int):
    """(slots,) int64 flat destination row of each slot, ``DB * R`` (one
    dump row past the output) for padding."""
    local = local_dst.reshape(-1).long()
    db = torch.arange(local.shape[0], device=local.device) // edge_block
    return torch.where(local < rows, db * rows + local, local.shape[0] // edge_block * rows)


def segment_sum_packed_ref(contrib_packed, local_dst, rows: int,
                           edge_block: int):
    """Plain version: (DB*EB, F) -> (DB*R, F) in the input dtype, summed in
    f32 in packed order; padding slots (``local_dst == R``) add nothing."""
    DB = contrib_packed.shape[0] // edge_block
    out = torch.zeros((DB * rows + 1, contrib_packed.shape[1]),
                      dtype=torch.float32, device=contrib_packed.device)
    out.index_add_(0, packed_rows(local_dst, rows, edge_block),
                   contrib_packed.float())
    return out[: DB * rows].to(contrib_packed.dtype)


def segment_sum_packed(contrib_packed, local_dst, rows: int, edge_block: int):
    """Masked per-dst sum over a dst-row-blocked pack, replacing
    ``segment_sum_packed`` (Pallas, repro/kernels/segsum/kernel.py:44).

    contrib_packed (DB*EB, F) f32/bf16/f16; local_dst (DB*EB, 1) int32 in
    [0, R], R marking padding anywhere in a block -> (DB*R, F) in the input
    dtype, accumulated in f32. Bound by bytes: the valid slots' rows once,
    the indices and the output once. Each block of the kernel sorts its
    pack block's slots by row, stably, and a warp sums each row with
    several row loads in flight; every output is summed from 0 in packed
    slot order, as ``index_add_`` sums it on a CPU tensor: the result equals
    the plain version's there bit for bit and repeats bit for bit (no float
    atomics).
    """
    check_packed("contrib_packed", contrib_packed, local_dst, rows, edge_block)
    if contrib_packed.device.type == "cpu":
        return segment_sum_packed_ref(contrib_packed, local_dst, rows, edge_block)
    total, F = contrib_packed.shape
    DB = total // edge_block
    out = torch.empty((DB * rows, F), dtype=contrib_packed.dtype,
                      device=contrib_packed.device)
    rc = typed_library("segsum_packed", _SIGNATURES).segsum_packed(
        ptr(contrib_packed), ptr(local_dst), ptr(out), DB, edge_block, F, rows,
        DTYPES[contrib_packed.dtype], stream(contrib_packed.device),
    )
    raise_on(rc, "segsum_packed")
    LAUNCHES["segment_sum_packed"] += 1
    return out


def gather_packed(x, perm):
    """``x (E, W)`` in packed order: padding slots (``perm == E``) read a
    zero row."""
    perm = torch.as_tensor(perm, device=x.device).long()
    x_z = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return x_z.index_select(0, perm)


def segment_sum_from_pack(contrib, pack: dict, num_out: int):
    """``contrib (E, F)`` -> (num_out, F) through the packed kernel."""
    packed = gather_packed(contrib, pack["perm"]).contiguous()
    local = torch.as_tensor(pack["local_dst"], device=contrib.device)
    out = segment_sum_packed(packed, local, rows=pack["rows"],
                             edge_block=pack["edge_block"])
    return out[:num_out]
