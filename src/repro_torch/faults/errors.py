"""The fault taxonomy shared by the runtime, the trainer and the harness —
the counterpart of ``repro/faults/errors.py``.

Stdlib only: ``runtime.prefetch`` imports from here, and this module never
imports back.
"""
from __future__ import annotations


class RetryableError(Exception):
    """A failure marked *transient*: safe to retry the same work.

    Producer stages (sampling, splitting, feature loading) are pure
    functions of ``(seed, epoch, batch)``, so re-running a failed build gives
    the identical batch: that is what makes retry correct. Wrap the cause:

        raise RetryableError("shard read failed") from os_error

    Only this type (and subclasses) is retried by the supervised prefetcher;
    anything else is delivered to the consumer at the failing index.
    """


class WorkerCrash(BaseException):
    """Simulated hard death of a producer thread (fault injection).

    A ``BaseException``, so the prefetcher's result-capturing ``except``
    (which delivers ordinary failures to the consumer) does not swallow it:
    the worker thread unwinds and exits as if killed, its claimed index is
    requeued, and the consumer-side supervisor respawns a replacement
    (``OrderedPrefetcher``). Only :class:`repro_torch.faults.inject.FaultInjector`
    raises it.
    """


class PipelineStallError(RuntimeError):
    """The consumer watchdog fired: a batch failed to arrive in time.

    Raised by ``OrderedPrefetcher`` after ``stall_timeout_s`` of waiting on
    one index instead of blocking the epoch forever. The message is the
    diagnostic: the stuck index, how long the consumer waited, which worker
    threads are alive, the reorder-queue occupancy and the claim cursor.
    """

    def __init__(
        self,
        index: int,
        waited_s: float,
        live_threads: list[str],
        occupancy: int,
        next_claim: int,
        delivered: int,
    ):
        self.index = index
        self.waited_s = waited_s
        self.live_threads = list(live_threads)
        self.occupancy = occupancy
        self.next_claim = next_claim
        self.delivered = delivered
        super().__init__(
            f"prefetch stalled waiting for index {index}: no result after "
            f"{waited_s:.1f}s (stall_timeout_s exceeded); "
            f"live producer threads: {live_threads or ['<none>']}, "
            f"reorder-queue occupancy {occupancy}, claim cursor at "
            f"{next_claim}, {delivered} delivered so far"
        )


class CheckpointError(RuntimeError):
    """A checkpoint failed an integrity check (never silently ignored).

    Raised for: content-checksum mismatch, truncated/unreadable arrays, a
    manifest whose ``treedef`` does not match the restore template, a key
    set that differs from the template's, or a missing/garbled manifest.
    ``load_latest_checkpoint`` catches this per-directory and falls back to
    the previous good checkpoint; a direct ``load_checkpoint`` call
    propagates it.
    """


class FaultInjected(Exception):
    """A non-retryable injected failure (simulated process kill).

    Raised by a scheduled ``kill`` action: not a ``RetryableError``, so the
    pipeline delivers it to the consumer at the failing index and the
    training loop unwinds.
    """
