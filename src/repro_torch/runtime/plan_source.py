"""Plan sources: who builds the per-iteration ``SplitPlan`` and when — the
serial part of ``repro/runtime/plan_source.py``.

``SerialPlanSource`` builds each batch inline on the consumer thread. Every
batch's draws are keyed by ``(seed, epoch, index)``
(``NeighborSampler.sample_batch``), and padding to the running high-water
marks (``repad_plan``) is applied at delivery (``finalize``), on the ordered
side. The pipelined source, which builds ahead on producer threads with the
same keys and the same delivery step, comes with a later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.splitting import (
    SplitPlan,
    build_split_plan,
    pad_axis,
    repad_plan,
)
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.train.plan_io import load_features, load_labels


@dataclass
class PlanBatch:
    """One fully-staged mini-batch: plan + host feature/label blocks."""

    index: int
    epoch: int
    plan: SplitPlan
    feats: np.ndarray  # (P, N_L, F) float32
    labels: np.ndarray  # (P, N_0) int32, padding zeroed
    t_sample: float
    t_split: float
    t_load: float


class PlanProducer:
    """Builds one ``PlanBatch``: sample -> online split -> feature load
    (split mode, host sampler). Holds only read-only references, so any
    thread may build any batch; repadding is left to ``finalize``."""

    def __init__(
        self,
        sampler: NeighborSampler,
        features: np.ndarray,
        labels: np.ndarray,
        num_devices: int,
        pad_multiple: int,
        assignment: np.ndarray,
    ):
        self.sampler = sampler
        self.features = features
        self.labels = labels
        self.num_devices = num_devices
        self.pad_multiple = pad_multiple
        self.assignment = assignment

    def build(self, epoch: int, index: int, targets: np.ndarray) -> PlanBatch:
        t0 = time.perf_counter()
        sample = self.sampler.sample_batch(targets, epoch, index)
        t1 = time.perf_counter()
        plan = build_split_plan(
            sample, self.assignment, self.num_devices,
            pad_multiple=self.pad_multiple,
        )
        t2 = time.perf_counter()
        feats = load_features(plan, self.features)
        labels = load_labels(plan, self.labels)
        t3 = time.perf_counter()
        return PlanBatch(
            index=index, epoch=epoch, plan=plan, feats=feats, labels=labels,
            t_sample=t1 - t0, t_split=t2 - t1, t_load=t3 - t2,
        )


def finalize(batch: PlanBatch, hwm: dict) -> PlanBatch:
    """Order-sensitive delivery step: repad the plan to the high-water marks
    and pad the staged feature/label blocks to match."""
    t0 = time.perf_counter()
    repad_plan(batch.plan, hwm)
    batch.feats = pad_axis(batch.feats, 1, batch.plan.front_ids[-1].shape[1])
    batch.labels = pad_axis(batch.labels, 1, batch.plan.front_ids[0].shape[1])
    batch.t_split += time.perf_counter() - t0
    return batch


@dataclass
class SerialPlanSource:
    """Inline plan construction on the consumer thread."""

    producer: PlanProducer
    epoch: int
    batches: list
    hwm: dict

    def __iter__(self) -> Iterator[PlanBatch]:
        for idx, targets in enumerate(self.batches):
            yield finalize(self.producer.build(self.epoch, idx, targets), self.hwm)
