"""Faults planted under a training cell's timed path, to show that the check
catches them. Each is a context manager that breaks one thing in the
program, for every trainer, and restores it on exit; none is ever active in
a benchmark run.

  * ``frozen``       -- a step takes its gradients and returns the
    parameters and the optimizer's state unchanged;
  * ``half_batch``   -- the loss keeps the first half of the batch's targets
    and takes its mean over them;
  * ``no_exchange``  -- the layer shuffles' exchange between splits delivers
    zeros (split cells only: a dp step exchanges nothing);
  * ``loss_altered`` -- the loss is scaled by 1.01 where it is produced.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen", "half_batch", "no_exchange", "loss_altered")


def faults_of(traffic: dict) -> tuple:
    """The faults a cell can have."""
    if traffic["mode"] == "split":
        return FAULTS
    return tuple(f for f in FAULTS if f != "no_exchange")


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.core import shuffle
    from repro_torch.train import trainer as trainer_mod

    if fault == "frozen":
        owner, name = trainer_mod.Trainer, "_dispatch_step"

        def broken(self, parts):
            loss, acc, _ = self._step_grads(parts)
            self.opt_state = self.opt_state._replace(step=self.opt_state.step + 1)
            return loss, acc, None
    elif fault in ("half_batch", "loss_altered"):
        owner, name = trainer_mod, "masked_softmax_xent"
        xent = trainer_mod.masked_softmax_xent

        def broken(logits, labels, mask, count=None):
            if fault == "loss_altered":
                return xent(logits, labels, mask, count) * 1.01
            flat = mask.reshape(-1)
            keep = torch.cumsum(flat.int(), 0) <= (int(flat.sum()) + 1) // 2
            return xent(logits, labels, (flat & keep).reshape(mask.shape), count)
    elif fault == "no_exchange":
        owner, name = shuffle.SimComm, "exchange"
        exchange = shuffle.SimComm.exchange

        def broken(self, send, wire_dtype=None):
            return torch.zeros_like(exchange(self, send.detach(), wire_dtype))
    else:
        raise ValueError(f"unknown fault {fault!r} (one of {FAULTS})")
    original = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, original)
