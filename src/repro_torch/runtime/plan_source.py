"""Plan sources: who builds the per-iteration ``SplitPlan`` and when — the
serial and device parts of ``repro/runtime/plan_source.py``.

``SerialPlanSource`` builds each batch inline on the consumer thread.
``DevicePlanSource`` delivers the same way with the sampling stage on the
device (``repro_torch.sampler``): the producer hands the targets to its
``DeviceSampler`` and builds the standard ``SplitPlan`` from the returned
sample, so repadding and the trainer are untouched. Its capacity growth is
applied when iteration starts (the epoch boundary), never mid-epoch. Every
batch's draws are keyed by ``(seed, epoch, index)``, and padding to the
running high-water marks (``repad_plan``) is applied at delivery
(``finalize``), on the ordered side. The pipelined sources, which build ahead
on producer threads with the same keys and the same delivery step, come with
a later slice.
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
    (split mode). Sampling runs on ``device_sampler`` when one is given,
    else on the host sampler. Holds only read-only references, so any thread
    may build any batch; repadding is left to ``finalize``."""

    def __init__(
        self,
        sampler: NeighborSampler,
        features: np.ndarray,
        labels: np.ndarray,
        num_devices: int,
        pad_multiple: int,
        assignment: np.ndarray,
        device_sampler=None,  # repro_torch.sampler.DeviceSampler | None
    ):
        self.sampler = sampler
        self.features = features
        self.labels = labels
        self.num_devices = num_devices
        self.pad_multiple = pad_multiple
        self.assignment = assignment
        self.device_sampler = device_sampler

    def build(self, epoch: int, index: int, targets: np.ndarray) -> PlanBatch:
        t0 = time.perf_counter()
        # both samplers are pure functions of (seed, epoch, index); the
        # device one falls back to the host's keyed API on cap overflow
        sampler = self.device_sampler or self.sampler
        sample = sampler.sample_batch(targets, epoch, index)
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

    def stats(self) -> dict:
        return {}


@dataclass
class DevicePlanSource(SerialPlanSource):
    """Inline delivery; sampling runs on the producer's ``DeviceSampler``."""

    def _device_sampler(self):
        eng = self.producer.device_sampler
        if eng is None:
            raise ValueError(
                "device plan source needs a PlanProducer with a device_sampler"
            )
        return eng

    def __iter__(self) -> Iterator[PlanBatch]:
        self._device_sampler().refresh_caps()
        yield from SerialPlanSource.__iter__(self)

    def stats(self) -> dict:
        return self._device_sampler().stats()


#: the plan sources this slice runs
PLAN_SOURCES = {"serial": SerialPlanSource, "device": DevicePlanSource}


def make_plan_source(kind: str, producer: PlanProducer, epoch: int,
                     batches: list, hwm: dict) -> SerialPlanSource:
    if kind not in PLAN_SOURCES:
        raise ValueError(
            f"unknown plan source {kind!r} ({' | '.join(PLAN_SOURCES)}; the "
            "pipelined sources come with a later slice)"
        )
    return PLAN_SOURCES[kind](producer, epoch, batches, hwm)
