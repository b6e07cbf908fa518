"""Wrapper of the CUDA wavefront-expansion kernel
(``csrc/wavefront_expand.cu``), replacing the Pallas kernel
``repro/sampler/kernel.py::wavefront_expand_kernel``.

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
the plain version (``ref.expand_codes``), the only reason it ever does.
Launches are counted in ``LAUNCHES``. Bound on the card: bytes (8 read and
``4 * fanout`` written a row), with the integer work (about 28 ops a slot
of a valid row, plus the dedup compare) close behind; no row-block
padding is needed. ``launch_floor`` launches an empty kernel on the same
grid, the floor the kernel's time is read against.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.build import INT, PTR, check_tensor, ptr, raise_on
from repro_torch.kernels.build import stream, typed_library
from repro_torch.sampler import ref

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts, never a plain-version call
LAUNCHES = {"wavefront_expand": 0}
# the pipelined device source launches from several producer threads
_LAUNCHES_LOCK = threading.Lock()

_SIGNATURES = {
    # vid, deg, key, out, B, fanout, stream
    "wavefront_expand": [PTR] * 4 + [INT] * 2 + [PTR],
    # B, fanout, stream
    "wavefront_expand_floor": [INT] * 2 + [PTR],
}


def reset_launches() -> None:
    LAUNCHES["wavefront_expand"] = 0


def wavefront_expand(vid, deg, key, fanout: int) -> torch.Tensor:
    """Slot codes (B, fanout) int32 (encoding in ``ref``).

    vid, deg (B,) int32 (``deg < 0`` marks an invalid row); key (2,) int64,
    the two uint32 lanes of the folded layer key, on the same device.
    """
    device = vid.device
    check_tensor("vid", vid, torch.int32, 1, device)
    check_tensor("deg", deg, torch.int32, 1, device)
    check_tensor("key", key, torch.int64, 1, device)
    if deg.shape != vid.shape or key.shape != (2,):
        raise ValueError(
            f"vid {tuple(vid.shape)}, deg {tuple(deg.shape)}, key "
            f"{tuple(key.shape)}: expected (B,), (B,), (2,)"
        )
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if device.type == "cpu":
        return ref.expand_codes(vid, deg, key[0], key[1], fanout)
    out = torch.empty((vid.shape[0], fanout), dtype=torch.int32, device=device)
    rc = typed_library("wavefront_expand", _SIGNATURES).wavefront_expand(
        ptr(vid), ptr(deg), ptr(key), ptr(out), vid.shape[0], fanout,
        stream(device),
    )
    raise_on(rc, "wavefront_expand")
    with _LAUNCHES_LOCK:
        LAUNCHES["wavefront_expand"] += 1
    return out


def launch_floor(B: int, fanout: int, device) -> None:
    """Launch an empty kernel on the grid ``wavefront_expand`` launches for
    (B, fanout): a measurement of the launch floor (not counted)."""
    rc = typed_library("wavefront_expand", _SIGNATURES).wavefront_expand_floor(
        B, fanout, stream(torch.device(device)))
    raise_on(rc, "wavefront_expand_floor")
