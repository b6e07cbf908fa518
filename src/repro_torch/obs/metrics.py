"""Named counters, gauges and histograms with percentile summaries — the
counterpart of ``repro/obs/metrics.py``.

Spans say *when* inside one step; metrics say *how much over the run*:
signature hits, prefetch occupancy, sampler fallbacks, high-water-mark
growth, fault counters. The registry absorbs the runtime's stat dicts
(``PrefetchStats.as_dict``, ``SignatureCache.as_dict``,
``DeviceSampler.stats``) through :meth:`MetricsRegistry.absorb`.

One registry lock guards creation and updates: every update is O(1) and the
producer threads touch metrics a handful of times a batch.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile"]


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (q in [0, 100])."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[int(rank)]


class Counter:
    """Monotonic sum."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def summary(self):
        return self.value


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def summary(self):
        return self.value


class Histogram:
    """All observed values; summarized as count/mean/percentiles/max."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def summary(self) -> dict:
        vals = sorted(self.values)
        n = len(vals)
        return {
            "count": n,
            "mean": sum(vals) / n if n else 0.0,
            "p50": percentile(vals, 50),
            "p90": percentile(vals, 90),
            "p99": percentile(vals, 99),
            "max": vals[-1] if n else 0.0,
        }


class MetricsRegistry:
    """Named metric store. A name is created on first use and keeps its
    first kind: re-using it as another kind raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics.setdefault(name, kind())
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not a {kind.__name__}"
            )
        return m

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._get(name, Counter).value += n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._get(name, Gauge).value = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._get(name, Histogram).values.append(value)

    def absorb(self, stats: dict, prefix: str = "") -> None:
        """Record a stats dict's numeric leaves as gauges (``prefix`` +
        key); other values are skipped."""
        for key, val in stats.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            self.gauge(f"{prefix}{key}", float(val))

    def snapshot(self) -> dict:
        """``{name: value-or-summary}`` for every metric, sorted by name."""
        with self._lock:
            return {
                name: m.summary()
                for name, m in sorted(self._metrics.items())
            }
