"""Where a run's device memory peaks: the caching allocator's history over a
region (``torch.cuda.memory._record_memory_history``), replayed to the
moment the bytes allocated in the region were most, and the largest
allocations alive then, each with the frame of this package that made it.

``peak_profile`` records on the card; ``peak_allocations`` is the replay,
a function of the trace alone. While it is on, the history keeps a Python
stack for every allocation, so it is for a profile run, not a timed one.

``LiveStorage`` is the same high-water mark on any device, ``meta``
included, where no allocator exists: a dispatch mode that adds the bytes
of every storage an operation's result holds and a finalizer on that
storage that takes them off when its last tensor dies (autograd's saved
tensors keep it alive, as on a card). ``launch/dryrun.py`` reads it over a
shape-only pass.
"""
from __future__ import annotations

import contextlib
import os
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: events the allocator keeps at most while recording
MAX_ENTRIES = 1_000_000
_PACKAGE = os.sep + "repro_torch" + os.sep


def _where(frames: list) -> str:
    """The innermost frame in this package, as ``path:line name`` with the
    path from the package's root; else the innermost frame."""
    for f in frames:
        name = f.get("filename", "")
        if _PACKAGE in name:
            path = name.split(_PACKAGE, 1)[1]
            return f"{path}:{f.get('line')} {f.get('name')}"
    if frames:
        f = frames[0]
        return f"{f.get('filename')}:{f.get('line')} {f.get('name')}"
    return "?"


def peak_allocations(trace: list, top: int = 6) -> dict:
    """From one device's trace (``_snapshot()["device_traces"][i]``, in
    order): ``peak_bytes``, the most bytes the allocations of the trace held
    at once (a free of a block allocated before the trace began is
    ignored), the ``events`` up to that moment, and ``top``: the largest
    allocations alive then, each ``{"bytes", "where"}``."""
    live, cur, best, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    largest = sorted(live.values(), key=lambda e: -e["size"])[:top]
    return {"peak_bytes": best, "events": at + 1,
            "top": [{"bytes": e["size"], "where": _where(e.get("frames", []))}
                    for e in largest]}


@contextlib.contextmanager
def peak_profile(device: torch.device, top: int = 6):
    """Record the allocator's history on ``device`` over the body; yields a
    dict that holds, after it, ``peak_allocations``' keys and
    ``allocated_before`` (the bytes allocated when the body began), so the
    device's peak over the body is their sum."""
    out = {"allocated_before": torch.cuda.memory_allocated(device)}
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=MAX_ENTRIES)
    try:
        yield out
        traces = torch.cuda.memory._snapshot()["device_traces"]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    out.update(peak_allocations(traces[device.index or 0], top))


class LiveStorage(TorchDispatchMode):
    """The bytes of the storages alive while the mode is on, and their most.

    ``LiveStorage(*args)`` first takes the storages of every tensor in
    ``args`` (any nesting of lists, tuples and dicts: a step's inputs) as
    alive: their bytes are ``base``. Under the mode, every operation's
    results add the bytes of each storage not yet alive; a storage leaves
    when its last tensor dies (a finalizer on the storage object, which
    PyTorch keeps for as long as the storage lives). ``live`` is the bytes
    alive now and ``peak`` the most at once since the start. Storages made
    outside the mode (before it, or by code that does not dispatch) are
    not seen."""

    def __init__(self, *args):
        super().__init__()
        self.live = self.peak = 0
        self._alive: set = set()
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.base = self.live

    def _add(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._alive:
            return
        n = s.nbytes()
        self._alive.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._drop, key, n)

    def _drop(self, key: int, n: int) -> None:
        self._alive.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out
