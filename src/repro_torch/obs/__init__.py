"""repro_torch.obs — tracing and metrics for the port's runtime, the
counterpart of ``repro/obs/``.

  * :class:`Obs` bundles a span :class:`~repro_torch.obs.trace.Tracer` and a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` behind one switch.
    Disabled (``NULL_OBS``, the default everywhere) it records nothing and
    adds no sync: spans still time their region (``IterStats`` read those
    durations, one code path), metric calls return after one check.
  * ``python -m repro_torch.obs report trace.json`` summarizes a written
    trace: per-stage percentiles and a producer-bound / staging-bound /
    device-bound class per step.
  * ``python -m repro_torch.obs validate trace.json`` checks its schema.

The span and counter names are the JAX package's (``plan/build``,
``plan/sample``, ``plan/split``, ``plan/load``, ``plan/repad``,
``plan/queue_dwell``, ``step/wait``, ``step/stage``, ``step/device``,
``sig/hit|miss``, ``fault/*``, ``hwm/*``), and a trace written by either
package reads with the other's report. All spans are on the host's clock.
"""
from __future__ import annotations

import logging

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "MetricsRegistry",
    "NULL_OBS",
    "Obs",
    "Span",
    "Tracer",
    "note_hwm_growth",
]

log = logging.getLogger("repro_torch.obs")


class Obs:
    """Tracer + metrics behind one switch; ``NULL_OBS`` is the off state."""

    def __init__(self, enabled: bool = True, ring_capacity: int = 65536):
        self.enabled = enabled
        self.tracer: Tracer | None = Tracer(ring_capacity) if enabled else None
        self.metrics: MetricsRegistry | None = (
            MetricsRegistry() if enabled else None
        )

    # ---- spans -------------------------------------------------------- #
    def span(self, name: str, attrs=None) -> Span:
        """A timed region; recorded only when enabled, timed always."""
        return Span(self.tracer, name, attrs)

    def record(self, name: str, t0: float, t1: float, attrs=None) -> None:
        if self.tracer is not None:
            self.tracer.record(name, t0, t1, attrs)

    def instant(self, name: str, attrs=None) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, attrs)

    def flow_start(self, flow_id) -> None:
        if self.tracer is not None:
            self.tracer.flow_start(flow_id)

    def flow_end(self, flow_id) -> None:
        if self.tracer is not None:
            self.tracer.flow_end(flow_id)

    # ---- metrics ------------------------------------------------------ #
    def count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.count(name, n)

    def gauge(self, name: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.observe(name, value)

    def absorb(self, stats: dict, prefix: str = "") -> None:
        if self.metrics is not None:
            self.metrics.absorb(stats, prefix)

    # ---- export ------------------------------------------------------- #
    def write(self, path) -> None:
        """Write the Chrome trace with the metrics snapshot embedded."""
        if self.tracer is None:
            raise ValueError("obs is disabled — nothing was recorded")
        self.tracer.write(path, self.metrics.snapshot() if self.metrics else {})


#: The shared disabled instance, the default ``obs`` everywhere: one
#: singleton instead of None checks keeps the instrumented code on one path.
NULL_OBS = Obs(enabled=False)


def note_hwm_growth(obs: Obs, before: dict, hwm: dict, where: str) -> int:
    """Surface high-water-mark growth.

    Compares a snapshot of the shared ``hwm`` dict taken before a repad with
    its state after. A mark that *grows* means the plan just delivered is the
    largest yet on that axis, and every later step pays the wider shapes:
    expected while the marks settle, a red flag in steady state. Each growth
    logs a warning, counts ``hwm/growth`` and records a ``hwm/grow`` instant;
    a mark seen for the first time records only a ``hwm/init`` instant.

    Returns the number of grown marks.
    """
    grown = 0
    for key, new in hwm.items():
        old = before.get(key)
        if old is None:
            obs.instant("hwm/init", {"key": key, "value": int(new), "where": where})
            continue
        if new > old:
            grown += 1
            log.warning(
                "high-water mark %s grew %d -> %d at %s: later steps run at "
                "the wider shape — expected during warmup, a red flag in "
                "steady state",
                key, old, new, where,
            )
            obs.count("hwm/growth")
            obs.instant(
                "hwm/grow",
                {"key": key, "old": int(old), "new": int(new), "where": where},
            )
    return grown
