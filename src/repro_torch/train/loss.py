"""Loss functions (the counterpart of ``repro/train/loss.py``)."""
from __future__ import annotations

import torch


def masked_softmax_xent(logits, labels, mask, count=None):
    """Mean cross-entropy over valid (mask) rows; padding rows contribute 0.

    logits (..., N, C), labels (..., N) int, mask (..., N) bool. ``count``
    is the number of valid rows the mean divides by, ``mask.sum()`` unless
    given: a spmd rank holds one split's rows and divides by the count over
    every split (``launch.spmd``), so that the ranks' losses sum to the
    batch's.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    nll = nll * mask.to(logits.dtype)
    denom = (mask.sum() if count is None else count).clamp(min=1)
    return nll.sum() / denom.to(logits.dtype)


def masked_accuracy(logits, labels, mask):
    pred = logits.argmax(dim=-1)
    correct = (pred == labels.long()) & mask
    return correct.sum() / mask.sum().clamp(min=1)
