"""The host's share of a run's steadiness.

A GSplit step is paced by one host thread, which stages the plan and
enqueues the step's kernels, so what else the process does on the host
shows in ``step_ms``. A run therefore keeps its load to one busy thread:
the math libraries' pools hold one thread (``few_threads``, called before
numpy or torch is imported), and over the window (``Quiet``) the set-up's
heap is frozen out of the garbage collector's passes, so a collection in
the window walks only what the window made, whatever the seed's set-up
left behind. ``Quiet.close`` reports the share of the window's wall the
stepping thread spent on a CPU.
"""
from __future__ import annotations

import gc
import os
import time

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def few_threads() -> None:
    """One thread in each math library's pool (call before importing them)."""
    for var in THREAD_VARS:
        os.environ[var] = "1"


class Quiet:
    """The window's host settings, from construction to ``close``."""

    def __init__(self):
        gc.collect()
        gc.freeze()
        self._t0 = (time.perf_counter(), time.thread_time())

    def close(self) -> dict:
        wall0, cpu0 = self._t0
        share = (time.thread_time() - cpu0) / (time.perf_counter() - wall0)
        gc.unfreeze()
        return {"on_cpu_share": share}
