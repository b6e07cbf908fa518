"""Deterministic fault injection: schedule-driven fault hooks — the
counterpart of ``repro/faults/inject.py``.

A :class:`FaultInjector` holds :class:`FaultAction` entries, each pinned to
an exact ``(stage, epoch, batch)`` coordinate. ``PlanProducer.build`` calls
``fire`` and ``maybe_poison`` under stage ``"build"``; when nothing matches
both are cheap no-ops. Every batch is a pure function of ``(seed, epoch,
batch)``, so a faulted run is as reproducible as a clean one: the same
faults hit the same batches, and a recovered trajectory can be held bitwise
against the clean one.

Action kinds
------------
  ``transient``  raise :class:`RetryableError` (retried under the policy) on
                 the first ``times`` attempts, then succeed.
  ``crash``      raise :class:`WorkerCrash`: the producer thread dies, its
                 batch is requeued, the supervisor respawns a worker.
  ``kill``       raise :class:`FaultInjected`: a non-retryable failure
                 delivered to the consumer.
  ``delay``      sleep ``delay_s`` before the stage runs (for the watchdog).
  ``poison``     write NaN into one feature entry via ``maybe_poison``, so
                 the gradients go non-finite (for ``skip_nonfinite``).

``corrupt_checkpoint`` and ``truncate_checkpoint`` damage a written
checkpoint's files directly (no schedule needed), for the checkpoint
module's integrity checks.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.faults.errors import FaultInjected, RetryableError, WorkerCrash

_KINDS = ("transient", "crash", "kill", "delay", "poison")


@dataclass(frozen=True)
class FaultAction:
    """One scheduled fault at an exact pipeline coordinate."""

    kind: str  # transient | crash | kill | delay | poison
    stage: str = "build"  # hook-point name (PlanProducer.build fires "build")
    epoch: int = 0
    batch: int = 0
    times: int = 1  # firings before the coordinate goes quiet
    delay_s: float = 0.0  # kind="delay": seconds to stall the stage

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} ({_KINDS})")
        if self.times < 1:
            raise ValueError("times must be >= 1")


@dataclass
class FaultInjector:
    """Fires scheduled faults; thread-safe, exactly ``times`` per action.

    ``fired`` records every firing as ``(kind, stage, epoch, batch)`` in fire
    order.
    """

    schedule: list = field(default_factory=list)  # [FaultAction]
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _counts: dict = field(default_factory=dict, repr=False)
    fired: list = field(default_factory=list)

    def _take(self, action: FaultAction) -> bool:
        """Claim one firing of ``action`` (False once ``times`` are spent)."""
        key = (action.kind, action.stage, action.epoch, action.batch)
        with self._lock:
            n = self._counts.get(key, 0)
            if n >= action.times:
                return False
            self._counts[key] = n + 1
            self.fired.append(key)
            return True

    def _matches(self, stage: str, epoch: int, batch: int, kinds):
        for a in self.schedule:
            if (a.stage, a.epoch, a.batch) == (stage, epoch, batch) and (
                a.kind in kinds
            ):
                yield a

    def fire(self, stage: str, epoch: int, batch: int) -> None:
        """Sleep or raise any fault scheduled at this coordinate: delays
        first (a slow-then-failing stage), then transient, crash, kill."""
        for a in self._matches(stage, epoch, batch, ("delay",)):
            if self._take(a):
                time.sleep(a.delay_s)
        for kind, exc, what in (
            ("transient", RetryableError, "transient fault"),
            ("crash", WorkerCrash, "worker crash"),
            ("kill", FaultInjected, "kill"),
        ):
            for a in self._matches(stage, epoch, batch, (kind,)):
                if self._take(a):
                    raise exc(f"injected {what} at {stage}/{epoch}/{batch}")

    def maybe_poison(
        self, stage: str, epoch: int, batch: int, feats: np.ndarray
    ) -> np.ndarray:
        """NaN-poison one feature block if scheduled (else return it as is).

        Writes NaN into the block's first element on a *copy*, so the
        producer's source arrays are never mutated.
        """
        for a in self._matches(stage, epoch, batch, ("poison",)):
            if self._take(a):
                feats = np.array(feats, copy=True)
                feats.reshape(-1)[0] = np.nan
        return feats


# --------------------------------------------------------------------- #
# checkpoint corruption (file-level chaos, no schedule needed)
# --------------------------------------------------------------------- #
def corrupt_checkpoint(ckpt_dir: str, filename: str = "params.npz") -> None:
    """Flip one byte in the middle of a checkpoint payload file.

    Leaves the file length intact: only the content checksum can catch
    this, which is exactly what the detection gate asserts.
    """
    path = os.path.join(ckpt_dir, filename)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty — nothing to corrupt")
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_checkpoint(ckpt_dir: str, filename: str = "params.npz") -> None:
    """Truncate a checkpoint payload to half its length (torn write)."""
    path = os.path.join(ckpt_dir, filename)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
