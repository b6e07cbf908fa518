"""Runtime recompile tracing: count a step's new call signatures — the
counterpart of ``repro/runtime/recompile.py``.

The reference's tracer diffs each jitted callable's compiled-trace cache
(``PjitFunction._cache_size``) once per step: growth is a cache miss, a
step that paid a retrace and a compile. The port has no jit and no trace
cache. What corresponds to one compiled trace is one distinct call
signature of a step callable: the (shape, dtype, device) of every tensor
(and numpy array) it is passed, found through lists, tuples, dicts and
dataclasses, plus the value of every other argument (``call_signature``).
``Traced(fn)`` wraps a callable with the set of signatures it has been
called with (a ``SignatureSet``, whose ``note`` adds a key the caller
takes itself) and exposes its size as ``_cache_size()``, so the tracer
reads a traced callable exactly as the reference reads a jitted one;
``register`` raises ``TypeError`` on any other callable, as the
reference's does. The key
is read from the arguments themselves, not from
``runtime/signature.py::plan_signature``: the tracer is the runtime witness
of the signature contract, not a restatement of it.

One difference from the reference's count: an ``int`` the reference traces
(the device sampler's ``n_targets``) counts here by value, so a short last
batch of an epoch counts one signature more than the reference's cache.

The steady-state contract (DESIGN.md §6) is the reference's: with
high-water-mark repadding and signature-keyed delivery, an epoch at fixed
caps sees new signatures on its first batches only, and none once warm.
The trainer exposes the per-epoch counts in ``EpochStats.recompiles`` when
``TrainConfig.trace_recompiles`` is set; off, nothing is wrapped or
noted, and the step runs as it does without the tracer.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field

import numpy as np
import torch


def _sig(x):
    """The part of a call signature one argument contributes."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, np.ndarray):
        return ("array", x.shape, str(x.dtype))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_sig(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _sig(v)) for k, v in x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _sig(getattr(x, f.name))) for f in dataclasses.fields(x)))
    try:
        hash(x)
    except TypeError:  # FT001: a hashability probe — unhashable IS the answer
        return ("value", repr(x))
    return ("value", x)


def call_signature(args: tuple, kwargs: dict) -> tuple:
    """The signature of one call: every argument's ``_sig``, keywords by
    name in sorted order."""
    return (_sig(args), tuple((k, _sig(kwargs[k])) for k in sorted(kwargs)))


class SignatureSet:
    """The distinct call signatures noted (``note``), their count as
    ``_cache_size()``: what the tracer reads. The trainer notes its step's
    key itself, since it stages and runs a mesh step's parts one at a time
    (one part's device inputs alive at once) where the reference's step is
    one call. Safe to use from producer threads."""

    def __init__(self):
        self.signatures: set = set()
        self._lock = threading.Lock()

    def note(self, key) -> None:
        with self._lock:
            self.signatures.add(key)

    def _cache_size(self) -> int:
        with self._lock:
            return len(self.signatures)


class Traced(SignatureSet):
    """A callable that notes the signature of every call
    (``call_signature``) and then calls ``fn``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        self.note(call_signature(args, kwargs))
        return self.fn(*args, **kwargs)


def cache_size(fn) -> int | None:
    """The signature-cache size of a traced callable, else ``None``."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:  # FT001: optional-API probe — None IS the answer
        return None


@dataclass(frozen=True)
class RecompileEvent:
    """One step that met at least one new signature."""

    step: int
    context: str
    misses: dict[str, int]  # fn name -> new signatures this step

    @property
    def total(self) -> int:
        return sum(self.misses.values())


@dataclass
class RecompileTracer:
    """Diffs registered signature caches once per step; records miss
    events."""

    steps: int = 0
    events: list[RecompileEvent] = field(default_factory=list)
    _fns: dict = field(default_factory=dict, repr=False)
    _last: dict = field(default_factory=dict, repr=False)

    def register(self, name: str, fn) -> None:
        """Track ``fn`` under ``name``; baselines at the current size."""
        size = cache_size(fn)
        if size is None:
            raise TypeError(
                f"cannot trace {name!r}: object exposes no _cache_size() "
                "(wrap it in runtime.recompile.Traced)"
            )
        self._fns[name] = fn
        self._last[name] = size

    def step(self, context: str = "") -> dict[str, int]:
        """Record one step boundary; returns this step's misses by name."""
        misses: dict[str, int] = {}
        for name, fn in self._fns.items():
            size = cache_size(fn)
            if size is None:
                continue
            grew = size - self._last[name]
            if grew > 0:
                misses[name] = grew
            self._last[name] = size
        if misses:
            self.events.append(RecompileEvent(self.steps, context, misses))
        self.steps += 1
        return misses

    # ---- windowed summaries (per-epoch reporting) ---------------------- #
    def mark(self) -> tuple[int, int]:
        """An opaque position: pass to ``since`` to summarize a window."""
        return (self.steps, len(self.events))

    def since(self, mark: tuple[int, int]) -> dict:
        """Summary of the window from ``mark`` to now."""
        step0, event0 = mark
        events = self.events[event0:]
        by_fn: dict[str, int] = {}
        for ev in events:
            for name, n in ev.misses.items():
                by_fn[name] = by_fn.get(name, 0) + n
        return {
            "steps": self.steps - step0,
            "misses": sum(by_fn.values()),
            "by_fn": by_fn,
            "miss_steps": [ev.step for ev in events],
        }

    @property
    def total_misses(self) -> int:
        return sum(ev.total for ev in self.events)

    def summary(self) -> dict:
        return self.since((0, 0))
