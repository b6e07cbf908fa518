"""Per-destination edge softmax over dst-row-blocked packs — the counterpart
of ``repro/kernels/edge_softmax/ops.py`` and of its Pallas kernel
``repro/kernels/edge_softmax/kernel.py::edge_softmax_packed``.

It shares the segment sum's packing (``segsum.ops.pack_edges``).
``edge_softmax_packed`` is the kernel's wrapper: on a CUDA tensor it launches
``csrc/edge_softmax_packed.cu`` or raises, on a CPU tensor it runs the plain
version ``edge_softmax_packed_ref``. ``edge_softmax_from_pack`` gathers the
logits into packed order, runs it and scatters the weights back to edge
order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import INT, PTR, ptr, raise_on, stream
from repro_torch.kernels.build import typed_library
from repro_torch.kernels.segsum.ops import (
    DTYPES,
    check_packed,
    gather_packed,
    packed_rows,
)

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts, never a plain-version call
LAUNCHES = {"edge_softmax_packed": 0}

#: the Pallas kernel's clamps: a finite floor for the segment max, and the
#: f32 denominator's lower bound
MAX_FLOOR = -1e30
DENOM_FLOOR = 1e-30

# logits, local_dst, out, DB, EB, H, R, dtype code, stream
_SIGNATURES = {"edge_softmax_packed": [PTR] * 3 + [INT] * 5 + [PTR]}


def reset_launches() -> None:
    LAUNCHES["edge_softmax_packed"] = 0


def edge_softmax_packed_ref(logits_packed, local_dst, rows: int,
                            edge_block: int):
    """Plain version: (DB*EB, H) -> (DB*EB, H) in the input dtype, computed
    in f32. Per block and head: the segment max (floored at -1e30), then
    ``exp(l - max) / max(sum, 1e-30)``; padding slots get exactly 0, and a
    row without slots gives nothing, never NaN."""
    DB = logits_packed.shape[0] // edge_block
    g = packed_rows(local_dst, rows, edge_block)
    valid = (g < DB * rows)[:, None]
    lf = logits_packed.float()
    H = lf.shape[1]
    seg_max = torch.full((DB * rows + 1, H), MAX_FLOOR, dtype=torch.float32,
                         device=lf.device)
    seg_max = seg_max.scatter_reduce(0, g[:, None].expand(-1, H), lf, "amax")
    ex = torch.where(valid, torch.exp(lf - seg_max[g]), 0.0)
    denom = torch.zeros_like(seg_max).index_add_(0, g, ex)
    out = torch.where(valid, ex / denom[g].clamp(min=DENOM_FLOOR), 0.0)
    return out.to(logits_packed.dtype)


def edge_softmax_packed(logits_packed, local_dst, rows: int, edge_block: int):
    """Per-dst softmax of packed edge logits, replacing ``edge_softmax_packed``
    (Pallas, repro/kernels/edge_softmax/kernel.py:61).

    logits_packed (DB*EB, H) f32/bf16/f16; local_dst (DB*EB, 1) int32, R
    marking padding -> (DB*EB, H) in the input dtype, f32 math, the Pallas
    kernel's clamps. Bound by bytes: the valid logits and the indices once,
    the output once. A block sorts its 32 rows' slots of a pack block in
    shared memory; a warp spreads a row's (slot, head) pairs over its lanes
    and sums the exponentials in slot order and a fixed tree (no atomics),
    so the result repeats bit for bit. Within 3e-5 of the plain version (the
    card's ``expf`` is not the CPU's).
    """
    check_packed("logits_packed", logits_packed, local_dst, rows, edge_block)
    if logits_packed.device.type == "cpu":
        return edge_softmax_packed_ref(logits_packed, local_dst, rows, edge_block)
    total, H = logits_packed.shape
    out = torch.empty_like(logits_packed)
    rc = typed_library("edge_softmax_packed", _SIGNATURES).edge_softmax_packed(
        ptr(logits_packed), ptr(local_dst), ptr(out), total // edge_block,
        edge_block, H, rows, DTYPES[logits_packed.dtype],
        stream(logits_packed.device),
    )
    raise_on(rc, "edge_softmax_packed")
    LAUNCHES["edge_softmax_packed"] += 1
    return out


def edge_softmax_from_pack(logits, pack: dict):
    """``logits (E, H)`` -> per-dst softmax weights (E, H) through the packed
    kernel; masked edges get exactly 0."""
    E, H = logits.shape
    perm = torch.as_tensor(pack["perm"], device=logits.device).long()
    packed = gather_packed(logits, perm).contiguous()
    local = torch.as_tensor(pack["local_dst"], device=logits.device)
    alpha = edge_softmax_packed(packed, local, rows=pack["rows"],
                                edge_block=pack["edge_block"])
    # padding slots (perm == E) all land in the dropped row E with weight 0
    out = logits.new_zeros((E + 1, H))
    out.index_copy_(0, perm, alpha)
    return out[:E]
