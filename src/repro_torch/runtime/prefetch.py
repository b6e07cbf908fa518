"""Bounded, order-preserving prefetch executor for host-side plan work —
the counterpart of ``repro/runtime/prefetch.py``.

Producer work (sampling -> online split -> feature load) is parallel across
mini-batches, since each batch keys its own draws, but the consumer (the
training step) must receive batches in epoch order so the updates match
serial execution exactly. ``OrderedPrefetcher`` runs ``fn(index)`` on a
small thread pool, holds completed items in a reorder buffer and hands them
out strictly by index. A ticket semaphore bounds how far the producers run
ahead (``depth`` items in flight), which bounds host memory for staged
feature blocks.

Supervision:

  * **Retry** — a build raising :class:`~repro_torch.faults.RetryableError`
    is re-attempted in place under a :class:`~repro_torch.faults.RetryPolicy`.
    It keeps its ticket and delivery slot, so ordering is untouched.
  * **Crash respawn** — a worker dying on
    :class:`~repro_torch.faults.WorkerCrash` requeues its index, releases its
    ticket and exits; the consumer-side supervisor (inside the delivery wait
    loop) spawns one replacement per crash.
  * **Watchdog** — with ``stall_timeout_s`` set, a delivery that waits
    longer raises :class:`~repro_torch.faults.PipelineStallError` naming the
    stuck index, the live threads and the reorder-queue occupancy.

Recovery events are counted in :class:`PrefetchStats` and as ``fault/*``
metrics. Other worker exceptions are re-raised at the *delivery point* of
the failing index. ``close()`` (also called by ``__exit__`` and when the
consumer stops) stops and joins the pool; threads that fail to join within
10 s are logged by name and counted as ``leaked_threads``.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.faults.errors import PipelineStallError, WorkerCrash
from repro_torch.faults.retry import RetryPolicy, retry_call
from repro_torch.obs import NULL_OBS

log = logging.getLogger("repro_torch.prefetch")

_JOIN_TIMEOUT_S = 10.0


@dataclass
class PrefetchStats:
    """Occupancy, wait and recovery counters for one prefetcher lifetime."""

    delivered: int = 0
    occupancy_sum: int = 0  # reorder-buffer size summed at each delivery
    consumer_waits: int = 0  # deliveries that blocked on an unfinished batch
    occupancy_max: int = 0
    retries: int = 0  # transient build failures re-attempted in place
    worker_crashes: int = 0  # producer threads that died (WorkerCrash)
    respawns: int = 0  # replacement workers started by the supervisor
    leaked_threads: int = 0  # threads that failed to join at close()

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.delivered if self.delivered else 0.0

    def as_dict(self) -> dict:
        return {
            "delivered": self.delivered,
            "mean_occupancy": self.mean_occupancy,
            "max_occupancy": self.occupancy_max,
            "consumer_waits": self.consumer_waits,
            "retries": self.retries,
            "worker_crashes": self.worker_crashes,
            "respawns": self.respawns,
            "leaked_threads": self.leaked_threads,
        }


class OrderedPrefetcher:
    """Run ``fn(i)`` for ``i in range(num_items)`` on ``workers`` threads,
    delivering results in index order with at most ``depth`` in flight."""

    def __init__(
        self,
        fn: Callable[[int], Any],
        num_items: int,
        depth: int = 4,
        workers: int = 2,
        retry: RetryPolicy | None = None,
        stall_timeout_s: float | None = None,
        obs=NULL_OBS,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be positive, got {stall_timeout_s}"
            )
        self._fn = fn
        self._num_items = num_items
        self._retry = retry or RetryPolicy()
        self._stall_timeout_s = stall_timeout_s
        self._obs = obs
        self._tickets = threading.Semaphore(depth)
        self._lock = threading.Condition()
        self._buffer: dict[int, tuple[Any, BaseException | None]] = {}
        self._next_claim = 0
        self._requeue: list[int] = []  # indices orphaned by crashed workers
        self._spawned = 0
        self._stop = threading.Event()
        self.stats = PrefetchStats()
        self._threads: list[threading.Thread] = []
        for _ in range(min(workers, max(num_items, 1))):
            self._spawn_worker()

    def _spawn_worker(self) -> None:
        t = threading.Thread(
            target=self._work,
            name=f"plan-producer-{self._spawned}",
            daemon=True,
        )
        self._spawned += 1
        self._threads.append(t)
        t.start()

    # ------------------------------------------------------------------ #
    def _claim(self) -> int:
        with self._lock:
            if self._requeue:
                return self._requeue.pop()
            if self._next_claim >= self._num_items:
                return -1
            idx = self._next_claim
            self._next_claim += 1
            return idx

    def _on_retry(self, attempt: int, err: BaseException) -> None:
        with self._lock:
            self.stats.retries += 1
        self._obs.count("fault/producer_retries", 1)
        log.warning(
            "transient producer fault (attempt %d, backing off %.3fs): %s",
            attempt, self._retry.delay_s(attempt), err,
        )

    def _work(self) -> None:
        while not self._stop.is_set():
            self._tickets.acquire()
            if self._stop.is_set():
                break
            idx = self._claim()
            if idx < 0:
                # let fellow workers observe exhaustion too
                self._tickets.release()
                break
            try:
                result, err = (
                    retry_call(
                        lambda i=idx: self._fn(i),
                        self._retry,
                        on_retry=self._on_retry,
                        cancel=self._stop,
                    ),
                    None,
                )
            except WorkerCrash:
                # simulated hard thread death: hand the batch back, free the
                # ticket and exit; the consumer-side supervisor respawns
                with self._lock:
                    self._requeue.append(idx)
                    self.stats.worker_crashes += 1
                    self._lock.notify_all()
                self._tickets.release()
                self._obs.count("fault/worker_crashes", 1)
                self._obs.instant(
                    "fault/worker_crash",
                    {"index": idx, "thread": threading.current_thread().name},
                )
                return
            except BaseException as e:  # noqa: BLE001 - delivered to consumer
                result, err = None, e
            with self._lock:
                self._buffer[idx] = (result, err)
                self._lock.notify_all()

    # ------------------------------------------------------------------ #
    def _supervise(self) -> None:
        """Respawn one worker per recorded crash. Caller holds ``_lock``."""
        while (
            self.stats.respawns < self.stats.worker_crashes
            and not self._stop.is_set()
        ):
            self.stats.respawns += 1
            self._obs.count("fault/worker_respawns", 1)
            self._spawn_worker()
            log.warning(
                "respawned producer worker (%d crash(es), %d respawn(s))",
                self.stats.worker_crashes, self.stats.respawns,
            )

    def _stall(self, idx: int, waited: float) -> PipelineStallError:
        """The watchdog's diagnostic. Caller holds ``_lock``."""
        self._obs.count("fault/pipeline_stalls", 1)
        self._obs.instant(
            "fault/pipeline_stall", {"index": idx, "waited_s": round(waited, 3)}
        )
        return PipelineStallError(
            index=idx,
            waited_s=waited,
            live_threads=[t.name for t in self._threads if t.is_alive()],
            occupancy=len(self._buffer),
            next_claim=self._next_claim,
            delivered=self.stats.delivered,
        )

    def __iter__(self):
        try:
            for idx in range(self._num_items):
                with self._lock:
                    # restore pool capacity for any crash recorded since the
                    # last delivery, even when a surviving worker already
                    # drained the requeue
                    self._supervise()
                    if idx not in self._buffer:
                        self.stats.consumer_waits += 1
                    waited_since = time.perf_counter()
                    while idx not in self._buffer:
                        if self._stop.is_set():
                            raise RuntimeError("prefetcher closed mid-iteration")
                        self._supervise()
                        self._lock.wait(timeout=0.1)
                        waited = time.perf_counter() - waited_since
                        if (
                            self._stall_timeout_s is not None
                            and waited > self._stall_timeout_s
                            and idx not in self._buffer
                        ):
                            raise self._stall(idx, waited)
                    self.stats.occupancy_sum += len(self._buffer)
                    self.stats.occupancy_max = max(
                        self.stats.occupancy_max, len(self._buffer)
                    )
                    self.stats.delivered += 1
                    result, err = self._buffer.pop(idx)
                # free the ticket before (possibly) raising, so close() never
                # deadlocks on a full queue
                self._tickets.release()
                if err is not None:
                    raise err
                yield result
        finally:
            self.close()

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Stop the producers and join them. Idempotent."""
        self._stop.set()
        # unblock any worker parked on the ticket semaphore
        for _ in self._threads:
            self._tickets.release()
        with self._lock:
            self._lock.notify_all()
        leaked = []
        for t in self._threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
            if t.is_alive():
                leaked.append(t.name)
        if leaked:
            log.warning(
                "prefetcher close(): %d thread(s) failed to join within "
                "%.0fs and are leaked: %s",
                len(leaked), _JOIN_TIMEOUT_S, ", ".join(leaked),
            )
            self.stats.leaked_threads = len(leaked)
            self._obs.count("fault/leaked_threads", len(leaked))
        self._threads = [t for t in self._threads if t.is_alive()]

    @property
    def closed(self) -> bool:
        return self._stop.is_set() and not self._threads

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
