"""repro_torch.faults — the fault-tolerance layer, the counterpart of
``repro/faults/``.

  * :mod:`~repro_torch.faults.errors` — the exception taxonomy:
    ``RetryableError`` (retried by the supervised prefetcher),
    ``WorkerCrash`` (a producer thread dies, its batch is requeued and a
    worker respawned), ``PipelineStallError`` (the consumer watchdog's
    diagnostic), ``FaultInjected`` (a non-retryable kill) and
    ``CheckpointError`` (a checkpoint failed validation).
  * :mod:`~repro_torch.faults.retry` — ``RetryPolicy`` (bounded attempts,
    deterministic exponential backoff) and ``retry_call``.
  * :mod:`~repro_torch.faults.inject` — schedule-driven fault hooks at exact
    ``(stage, epoch, batch)`` coordinates: transient, crash, kill, delay,
    poison; and file-level checkpoint corruption (``corrupt_checkpoint``,
    ``truncate_checkpoint``).

This package imports neither the runtime nor the trainer: it is the leaf
both depend on.
"""
from __future__ import annotations

from repro_torch.faults.errors import (
    CheckpointError,
    FaultInjected,
    PipelineStallError,
    RetryableError,
    WorkerCrash,
)
from repro_torch.faults.inject import (
    FaultAction,
    FaultInjector,
    corrupt_checkpoint,
    truncate_checkpoint,
)
from repro_torch.faults.retry import RetryPolicy, retry_call

__all__ = [
    "CheckpointError",
    "FaultAction",
    "FaultInjected",
    "FaultInjector",
    "PipelineStallError",
    "RetryPolicy",
    "RetryableError",
    "WorkerCrash",
    "corrupt_checkpoint",
    "retry_call",
    "truncate_checkpoint",
]
