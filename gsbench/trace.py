"""Reading a device trace: ``torch.profiler`` around a traced segment, the
union of the device's busy intervals, device time by kernel, and the idle
gaps named by the host span they fall in.

The segment runs inside a ``gsbench/traced_window`` annotation; its interval
in the trace is the window. Host spans come from the trace's own
annotations (``gsbench/*``) and from the program's ``obs`` spans, whose
``perf_counter`` times are moved onto the trace's clock by the window's
start, read on both clocks.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
import warnings
from dataclasses import dataclass, field

import torch

WINDOW = "gsbench/traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: tuple  # (start, end) in us on the trace's clock
    device: list  # (name, start, end) in us, kernels, copies and memsets
    host: list = field(default_factory=list)  # (name, start, end) in us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The device's busy time inside the window as disjoint intervals."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_seconds(self, pattern: str) -> tuple:
        """(launches, device seconds) of the device operations whose name
        contains ``pattern``."""
        durs = [e - s for name, s, e in self.device if pattern in name]
        return len(durs), sum(durs) * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_by_host_span(self, n: int = 10) -> list:
        """Idle device seconds inside the window, summed by the innermost
        host span that holds each gap's midpoint ("no span" outside all)."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy_intervals() for t in iv] + [hi]
        by: dict = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            holding = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
            name = min(holding)[1] if holding else "no span"
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def capture(segment, obs_spans=None) -> Trace:
    """Run ``segment()`` under the profiler and read its trace.
    ``obs_spans()``, called after the segment, returns the program's spans
    as ``(name, t0, t1)`` on the ``perf_counter`` clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    # the profiler warns on exit that it keeps one cycle's events
    with warnings.catch_warnings(), profile(activities=acts) as prof:
        warnings.simplefilter("ignore", UserWarning)
        with record_function(WINDOW):
            t_perf = time.perf_counter()
            segment()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window, device, host = None, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev["name"], s, e))
        elif cat == "user_annotation":
            if ev["name"] == WINDOW:
                window = (s, e)
            else:
                host.append((ev["name"], s, e))
    if window is None:
        raise RuntimeError("the traced window's annotation is not in the trace")
    if obs_spans is not None:
        shift = window[0] - t_perf * 1e6
        host += [(n, t0 * 1e6 + shift, t1 * 1e6 + shift)
                 for n, t0, t1 in obs_spans()]
    return Trace(window, device, host)
