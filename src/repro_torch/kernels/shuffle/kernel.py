"""Wrapper of the CUDA shuffle adjoint kernel (``csrc/shuffle_bwd.cu``): the
adjoint of the sim shuffle's send gather for the local rows, which the JAX
package leaves to XLA's scatter-add (``repro/core/shuffle.py::sim_shuffle``),
and of the GNN layers' self-row gather, which has the same form.

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
the plain version (``ref.shuffle_bwd``), the only reason it ever does.
Launches are counted in ``LAUNCHES``. Bound on the card: bytes (the output
written once, the valid cotangent rows read once); padding slots are never
read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import INT, PTR, check_tensor, ptr, raise_on
from repro_torch.kernels.build import stream, typed_library
from repro_torch.kernels.shuffle import ref

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts, never a plain-version call
LAUNCHES = {"shuffle_bwd": 0}

#: the most index groups an owner may have (its shared table holds a row
#: range's slot for each group)
MAX_GROUPS = 32

# g, send_idx, send_count, dh, P, Q, N, S, F, stream
_SIGNATURES = {"shuffle_bwd": [PTR] * 4 + [INT] * 5 + [PTR]}


def reset_launches() -> None:
    LAUNCHES["shuffle_bwd"] = 0


def shuffle_bwd(g, send_idx, send_count, num_rows: int) -> torch.Tensor:
    """dh (P, num_rows, F) f32: the cotangent of the rows ``h`` of
    ``h[q, send_idx[q, p, s]]`` from its cotangent ``g`` (P, Q, S, F) f32;
    ``send_idx`` (P, Q, S) and ``send_count`` (P, Q) int32 on the same
    device (the shuffle: Q = P needers; the self rows: Q = 1). Within each
    (q, p) pair the valid slots must hold distinct rows in ascending order,
    as ``build_split_plan`` writes them (the kernel binary-searches them)."""
    device = g.device
    check_tensor("g", g, torch.float32, 4, device)
    check_tensor("send_idx", send_idx, torch.int32, 3, device)
    check_tensor("send_count", send_count, torch.int32, 2, device)
    P, Q, S, F = g.shape
    if send_idx.shape != (P, Q, S) or send_count.shape != (P, Q):
        raise ValueError(
            f"g {tuple(g.shape)}, send_idx {tuple(send_idx.shape)}, send_count "
            f"{tuple(send_count.shape)}: expected (P, Q, S, F), (P, Q, S), (P, Q)"
        )
    if device.type == "cpu":
        return ref.shuffle_bwd(g, send_idx, send_count, num_rows)
    if Q > MAX_GROUPS:
        raise ValueError(f"shuffle_bwd takes at most {MAX_GROUPS} groups, got {Q}")
    dh = torch.empty((P, num_rows, F), dtype=torch.float32, device=device)
    if dh.numel() == 0:
        return dh
    rc = typed_library("shuffle_bwd", _SIGNATURES).shuffle_bwd(
        ptr(g), ptr(send_idx), ptr(send_count), ptr(dh), P, Q, num_rows, S, F,
        stream(device),
    )
    raise_on(rc, "shuffle_bwd")
    LAUNCHES["shuffle_bwd"] += 1
    return dh
