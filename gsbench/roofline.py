"""A kernel's share of its
roofline over the traced segment, the sum of its launches' least times over
the sum of their device times, in %. The launches come from the traced
steps' plans (``counts/step.py``); a trace whose launch count differs from
theirs reads nothing."""
import importlib

from gsbench.counts import peaks, step


def share(rec, kernel: str, extra_patterns=()):
    count = importlib.import_module(f"gsbench.counts.{kernel}")
    expected, least = 0, 0.0
    for summary in rec["plans"]:
        for launch in step.launches(summary, rec["model"])[kernel]:
            expected += 1
            least += peaks.least_seconds(*count.count(launch))
    if expected == 0:
        return None
    launched, seconds = rec["trace"].kernel_seconds(count.PATTERN)
    if launched != expected:
        return None
    for pattern in extra_patterns:
        n, s = rec["trace"].kernel_seconds(pattern)
        if n != expected:
            return None
        seconds += s
    return 100.0 * least / seconds
