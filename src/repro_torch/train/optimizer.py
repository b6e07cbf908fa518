"""Optimizers with the JAX package's math (``repro/train/optimizer.py``):
SGD (with momentum), Adam, AdamW. ``torch.optim`` is not used — its AdamW decays
the weights in a decoupled step, while the reference adds ``lr*wd*p`` to the
Adam step.

API: ``opt = adam(lr); state = opt.init(params); params, state = opt.update(
grads, state, params)`` with ``params`` a list of tensors. Unlike the
reference's pure functions, ``update`` writes the new values into the
parameter and slot tensors in place (no second copy of the model per step)
and returns the same objects. Every leaf keeps its dtype: the reference's
float32 step turns a bf16 weight into a float32 one, while the port rounds
it back to bf16 (ROADMAP Queue C).
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


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """SGD; with ``momentum`` a velocity slot per leaf (its dtype), updated
    as the reference's: ``v = momentum * v + g; p -= lr * v``."""

    def init(params):
        return OptimizerState(0, _zeros_like(params) if momentum else ())

    @torch.no_grad()
    def update(grads, state, params):
        if momentum:
            for p, g, v in zip(params, grads, state.slots):
                v.mul_(momentum).add_(g)
                p.sub_(lr * v)
        else:
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return params, OptimizerState(state.step + 1, state.slots)

    return Optimizer(init, update)


#: elements of a leaf that one pass of the Adam step updates: a bf16 leaf's
#: float32 temporaries stay 128 MiB each where DeepSeek-V2-236B's stacked
#: experts (1.26e9 elements a leaf) would take 5 GB each
SLICE = 1 << 25


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
            p, m, v = p.view(-1), m.view(-1), v.view(-1)
            g = g.reshape(-1)
            for a in range(0, p.numel(), SLICE):
                p_, g_, m_, v_ = (t[a:a + SLICE] for t in (p, g, m, v))
                m_.mul_(b1).add_((1 - b1) * g_)
                v_.mul_(b2).add_((1 - b2) * (g_ * g_))
                # float32 bias corrections make the reference's step
                # float32; a bf16 leaf takes it in float32, rounded once
                p32 = p_.float()
                step_ = lr * (m_.float() / bc1) / (torch.sqrt(v_.float() / bc2) + eps)
                if weight_decay:
                    step_ = step_ + lr * weight_decay * p32
                p_.copy_(p32 - step_)
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
