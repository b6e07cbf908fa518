"""Loss functions (the counterpart of ``repro/train/loss.py``)."""
from __future__ import annotations

import torch


def masked_softmax_xent(logits, labels, mask):
    """Mean cross-entropy over valid (mask) rows; padding rows contribute 0.

    logits (..., N, C), labels (..., N) int, mask (..., N) bool.
    """
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    nll = nll * mask.to(logits.dtype)
    denom = mask.sum().clamp(min=1)
    return nll.sum() / denom.to(logits.dtype)


def masked_accuracy(logits, labels, mask):
    pred = logits.argmax(dim=-1)
    correct = (pred == labels.long()) & mask
    return correct.sum() / mask.sum().clamp(min=1)
