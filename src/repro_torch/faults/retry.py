"""Bounded retry with exponential backoff for transient host-side faults —
the counterpart of ``repro/faults/retry.py``.

``OrderedPrefetcher`` applies the policy inline in its worker loop (a
retried build keeps its queue ticket and its delivery slot); other host
stages can wrap themselves with ``retry_call``. Backoff is deterministic,
``base * mult**attempt`` with no jitter: fault runs assert on recovery, and
the producer pool is too small (2-4 threads) for a thundering herd.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.faults.errors import RetryableError


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a ``RetryableError`` and how long to wait.

    ``retries`` counts *re*-attempts after the first failure (0 = fail at
    once). The sleep before re-attempt ``k`` (1-based) is ``backoff_s *
    backoff_mult ** (k - 1)``, capped at ``max_backoff_s``.
    """

    retries: int = 0
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0

    def delay_s(self, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (1-based)."""
        return min(
            self.backoff_s * self.backoff_mult ** (attempt - 1),
            self.max_backoff_s,
        )


def retry_call(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    on_retry: Callable[[int, BaseException], None] | None = None,
    cancel: threading.Event | None = None,
) -> Any:
    """Run ``fn()`` under ``policy``: transient failures sleep and retry.

    Only :class:`RetryableError` is retried; anything else propagates at
    once. ``on_retry(attempt, err)`` runs before each backoff sleep (attempt
    1-based). ``cancel``, when set during a backoff, re-raises the last error
    instead of re-attempting, so a closing pipeline never waits on a retry.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except RetryableError as e:
            attempt += 1
            if attempt > policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = policy.delay_s(attempt)
            if cancel is not None:
                if cancel.wait(delay):
                    raise
            else:
                threading.Event().wait(delay)
