"""Optimizers with the JAX package's math (``repro/train/optimizer.py``):
SGD, Adam, AdamW. ``torch.optim`` is not used — its AdamW decays
the weights in a decoupled step, while the reference adds ``lr*wd*p`` to the
Adam step.

API: ``opt = adam(lr); state = opt.init(params); params, state = opt.update(
grads, state, params)`` with ``params`` a list of tensors. Unlike the
reference's pure functions, ``update`` writes the new values into the
parameter and slot tensors in place (no second copy of the model per step)
and returns the same objects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class OptimizerState(NamedTuple):
    step: int
    slots: Any  # optimizer-specific lists of tensors


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[list], OptimizerState]
    update: Callable[[list, OptimizerState, list], tuple[list, OptimizerState]]


def _zeros_like(params):
    return [torch.zeros_like(p) for p in params]


def sgd(lr: float) -> Optimizer:
    """Plain SGD, the reference's ``sgd`` at its default ``momentum=0``."""

    def init(params):
        return OptimizerState(0, ())

    @torch.no_grad()
    def update(grads, state, params):
        for p, g in zip(params, grads):
            p.sub_(lr * g)
        return params, OptimizerState(state.step + 1, ())

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay):
    def init(params):
        return OptimizerState(0, {"m": _zeros_like(params), "v": _zeros_like(params)})

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        # the reference takes the bias corrections in float32
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        for p, g, m, v in zip(params, grads, state.slots["m"], state.slots["v"]):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * (g * g))
            step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_ = step_ + lr * weight_decay * p
            p.sub_(step_)
        return params, OptimizerState(step, state.slots)

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=0.0)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay=weight_decay)
