"""Structured tracing: per-thread span rings and Chrome-trace export — the
counterpart of ``repro/obs/trace.py``, with the same event schema, so a
trace written by either package reads with the other's report.

Spans are (name, thread, t_start, t_end, attrs) intervals on the host's
``perf_counter`` clock, recorded into per-thread ring buffers and exported
as one Chrome-trace / Perfetto timeline where a batch's producer build,
queue dwell, staging and device step are linked by flow arrows.

  * **One code path.** ``Span`` always measures its start and end (the
    trainer's ``IterStats`` read ``Span.duration``) and only *records* when
    a ``Tracer`` is attached.
  * **No cross-thread contention on the hot path.** Each thread owns a ring;
    the tracer's lock is taken on a thread's first event and at export.
    Rings are bounded: overflow drops the oldest events and counts them.
  * **Host clock, and the profiler's.** A span around device work ends
    when the host returns; the trainer's ``step/device`` span ends at the
    step's one sync. With a tracer attached, a span also opens a
    ``torch.profiler.record_function`` range of its name, entered and
    exited with it, so a ``torch.profiler`` trace holds the program's
    phases on the device trace's own clock, each kernel under the range
    that launched it. With no tracer, no range is entered.

Flows link a producer's ``plan/build`` span to the consumer ``step`` that
trains on its plan, keyed by the plan's ``(epoch, batch)``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass

from torch.profiler import record_function

__all__ = ["Span", "SpanEvent", "Tracer"]


@dataclass(frozen=True)
class SpanEvent:
    """One completed span as stored in a ring (times are ``perf_counter``)."""

    name: str
    t0: float
    t1: float
    attrs: dict | None = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Span:
    """Context manager that times a region and records it when a tracer is
    attached, inside a profiler range of its name; ``duration`` is valid
    after ``__exit__`` either way."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1", "_range")

    def __init__(self, tracer: "Tracer | None", name: str, attrs=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = 0.0
        self._range = None

    def __enter__(self) -> "Span":
        if self._tracer is None:
            self.t0 = time.perf_counter()
            return self
        self._tracer._enter()
        # the range's own cost is inside the span, so a parent span's
        # children account for it
        self.t0 = time.perf_counter()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._tracer is None:
            self.t1 = time.perf_counter()
            return
        self._range.__exit__(*exc)
        self.t1 = time.perf_counter()
        self._tracer._exit(self)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _ThreadRing:
    """Bounded event store owned by one recording thread."""

    __slots__ = ("tid", "thread_name", "events", "dropped", "open_depth")

    def __init__(self, tid: int, thread_name: str, capacity: int):
        self.tid = tid
        self.thread_name = thread_name
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.open_depth = 0  # spans entered but not yet exited

    def append(self, kind: str, payload) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1  # deque evicts the oldest on append
        self.events.append((kind, payload))


class Tracer:
    """Thread-safe span/flow recorder with Chrome-trace export. All
    timestamps are ``time.perf_counter()``, one clock for every thread."""

    def __init__(self, ring_capacity: int = 65536):
        if ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {ring_capacity}")
        self._capacity = ring_capacity
        self._lock = threading.Lock()
        # a list, not an ident-keyed dict: the OS recycles thread idents, so
        # a pool respawned next epoch would overwrite a dead worker's ring
        self._rings: list[_ThreadRing] = []
        self._local = threading.local()
        self.t_origin = time.perf_counter()  # export-relative zero

    # ---- hot path ----------------------------------------------------- #
    def _ring(self) -> _ThreadRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            ring = _ThreadRing(t.ident, t.name, self._capacity)
            self._local.ring = ring
            with self._lock:
                self._rings.append(ring)
        return ring

    def span(self, name: str, attrs=None) -> Span:
        return Span(self, name, attrs)

    def _enter(self) -> None:
        self._ring().open_depth += 1

    def _exit(self, span: Span) -> None:
        ring = self._ring()
        ring.open_depth -= 1
        ring.append("X", SpanEvent(span.name, span.t0, span.t1, span.attrs))

    def record(self, name: str, t0: float, t1: float, attrs=None) -> None:
        """Record a span with explicit ``perf_counter`` endpoints, for an
        interval that starts on one thread and ends on another (the queue
        dwell); it lands on the calling thread's lane."""
        self._ring().append("X", SpanEvent(name, t0, t1, attrs))

    def instant(self, name: str, attrs=None) -> None:
        """A zero-duration marker (Chrome ``i`` event) at the current time."""
        self._ring().append("i", SpanEvent(name, time.perf_counter(), 0.0, attrs))

    def flow_start(self, flow_id) -> None:
        """Mark the producer end of a flow (inside the producing span)."""
        self._ring().append("s", (flow_id, time.perf_counter()))

    def flow_end(self, flow_id) -> None:
        """Mark the consumer end of a flow (inside the consuming span)."""
        self._ring().append("f", (flow_id, time.perf_counter()))

    # ---- export ------------------------------------------------------- #
    def _snapshot(self) -> list[_ThreadRing]:
        with self._lock:
            return list(self._rings)

    def unclosed_spans(self) -> int:
        """Spans currently entered but not exited, summed over threads."""
        return sum(r.open_depth for r in self._snapshot())

    def dropped_events(self) -> int:
        return sum(r.dropped for r in self._snapshot())

    def to_chrome(self, metrics: dict | None = None) -> dict:
        """The Chrome-trace (Perfetto-loadable) JSON object.

        ``X`` events carry ts/dur in microseconds from the tracer's
        creation; flows are ``s``/``f`` pairs for ids with both endpoints
        (the others are counted in ``otherData``); thread-name metadata
        labels the lanes. ``otherData`` carries the metrics snapshot and the
        integrity counters ``validate`` checks.
        """
        events: list[dict] = []
        starts: dict = {}
        ends: dict = {}
        rings = self._snapshot()
        for ring in rings:
            events.append({
                "ph": "M", "pid": 0, "tid": ring.tid, "name": "thread_name",
                "args": {"name": ring.thread_name},
            })
            for kind, payload in list(ring.events):
                if kind in ("X", "i"):
                    ev: SpanEvent = payload
                    rec = {
                        "ph": kind, "pid": 0, "tid": ring.tid, "name": ev.name,
                        "ts": (ev.t0 - self.t_origin) * 1e6,
                    }
                    if kind == "X":
                        rec["dur"] = ev.duration * 1e6
                    else:
                        rec["s"] = "t"  # instant scoped to its thread
                    if ev.attrs:
                        rec["args"] = dict(ev.attrs)
                    events.append(rec)
                else:
                    flow_id, ts = payload
                    (starts if kind == "s" else ends)[flow_id] = (ring.tid, ts)
        resolved = sorted(
            (k for k in starts if k in ends), key=lambda k: starts[k][1]
        )
        for seq, flow_id in enumerate(resolved):
            for ph, (tid, ts) in (("s", starts[flow_id]), ("f", ends[flow_id])):
                rec = {
                    "ph": ph, "pid": 0, "tid": tid, "id": seq, "cat": "plan",
                    "name": "plan", "ts": (ts - self.t_origin) * 1e6,
                }
                if ph == "f":
                    rec["bp"] = "e"  # bind to the enclosing slice
                events.append(rec)
        unresolved = (set(starts) | set(ends)) - set(resolved)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "unclosed_spans": sum(r.open_depth for r in rings),
                "dropped_events": sum(r.dropped for r in rings),
                "unresolved_flows": len(unresolved),
                "metrics": metrics or {},
            },
        }

    def write(self, path, metrics: dict | None = None) -> None:
        """Write the Chrome-trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(metrics), f)
