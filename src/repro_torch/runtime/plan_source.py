"""Plan sources: who builds the per-iteration ``SplitPlan`` and when — the
counterpart of ``repro/runtime/plan_source.py`` (split, dp and pushpull
modes, and the 2-D (replica, split) mesh).

GSplit's cooperative pipeline (paper §5) overlaps the host stages of
mini-batch ``k+1`` (sampling, online splitting, feature loading) with the
device step of mini-batch ``k``:

  * ``SerialPlanSource``     -- builds each batch inline on the consumer
    thread; the reference for determinism tests.
  * ``PipelinedPlanSource``  -- a pool of producer threads builds batches
    ahead of the consumer through ``OrderedPrefetcher``; a bounded reorder
    queue keeps delivery in epoch order.
  * ``DevicePlanSource`` / ``DevicePipelinedPlanSource`` -- the same two
    disciplines with the sampling stage on the device
    (``repro_torch.sampler``): the producer hands the targets to its
    ``DeviceSampler`` and builds the standard ``SplitPlan`` from the
    returned sample. Capacity growth is applied when iteration starts (the
    epoch boundary), never mid-epoch. On a card, each producer thread of the
    pipelined one launches its sampling on a CUDA stream of its own.

Every batch's draws are keyed by ``(seed, epoch, index)``, so a batch does
not depend on which thread builds it, and padding to the running high-water
marks (``repad_plan``) is applied at *delivery* (``finalize``), on the
ordered side of the queue: padded shapes, signatures and float trajectories
are bit-for-bit the same from all four sources of one sampling kind. The
overlap schedule's edge halves are built by the producer with the plan
(``with_halves``), and with a serving feature cache the producer compiles
the batch's ``CachePlan`` and gathers only its miss rows; the cache plan is
grown to its own marks (``CM``/``CS``) at delivery too. In split mode the
producer records each sample in an ``EdgeTelemetry`` when given one and
reroutes replicated sources (``replication``); dp and pushpull stack
``num_devices`` keyed micro-batches (``build_dp_plan``) and sample on the
host only. With ``num_replicas >= 1`` (split mode) a global batch fans out
into R independently keyed per-replica plans over the one partition, one
``MeshPlanBatch``, repadded at delivery to shared marks in replica order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.splitting import (
    SplitPlan,
    build_dp_plan,
    build_split_plan,
    pad_axis,
    repad_plan,
)
from repro_torch.graph.cache import CachePlan, FeatureCache, LoadBreakdown
from repro_torch.faults.retry import RetryPolicy
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.obs import NULL_OBS, Obs, note_hwm_growth
from repro_torch.runtime.prefetch import OrderedPrefetcher
from repro_torch.runtime.signature import (
    SignatureCache,
    mesh_signature,
    plan_signature,
)
from repro_torch.train.plan_io import host_tensor, load_labels, stage_host_features


@dataclass
class PlanBatch:
    """One fully-loaded mini-batch: plan + host feature/label blocks.

    ``feats`` keeps the height the producer gathered; ``plan_io.stage_batch``
    pads it to the repadded plan's input height (with a cache plan: to its
    miss width) on the device.
    """

    index: int
    epoch: int
    plan: SplitPlan
    # (P, N_L, F) float32 host tensor, pinned for a card; with a cache plan
    # the (P, M, F) miss rows
    feats: torch.Tensor
    labels: np.ndarray  # (P, N_0) int32, padding zeroed
    t_sample: float
    t_split: float
    t_load: float
    # where the batch's input rows are served from (None without a cache)
    breakdown: LoadBreakdown | None = None
    cache_plan: CachePlan | None = None  # set when the cache serves
    signature: tuple = ()
    sig_hit: bool = False
    # producer-side completion time (perf_counter): delivery minus this is
    # the prefetch-queue dwell, exported as the ``plan/queue_dwell`` span
    t_built: float = 0.0


@dataclass
class MeshPlanBatch:
    """One global mini-batch fanned out across the replica axis.

    ``parts[r]`` is replica ``r``'s ``PlanBatch`` (its own sample, split
    plan, feature and label blocks) over the same P-way partition; the mesh
    step consumes all R parts and averages their gradients. Stage times are
    summed over the parts: the host cost of one global batch.
    """

    index: int
    epoch: int
    parts: list  # R PlanBatch, replica order
    t_sample: float = 0.0
    t_split: float = 0.0
    t_load: float = 0.0
    signature: tuple = ()
    sig_hit: bool = False
    t_built: float = 0.0

    @property
    def num_replicas(self) -> int:
        return len(self.parts)


#: the trainer modes a producer builds plans for
MODES = ("split", "dp", "pushpull")


class PlanProducer:
    """Builds one ``PlanBatch``: sample -> online split (or dp stacking) ->
    feature load. Sampling runs on ``device_sampler`` when one is given
    (split mode only), else on the host sampler. Holds only references that
    stay fixed within an epoch (the cache's tables included), so any thread
    may build any batch; repadding is left to ``finalize``. With ``pin`` the
    feature block is gathered into pinned memory, for staging to a card.
    ``with_halves`` builds the overlap schedule's edge halves; with
    ``cache`` and ``serve_cache`` the load stage gathers only the cache's
    misses. ``assignment``, ``replication`` and ``device_sampler`` are
    re-pointed by ``Trainer.refine_partition`` between epochs;
    ``telemetry.record`` is thread-safe. With ``num_replicas >= 1`` (split
    mode) ``build`` returns a ``MeshPlanBatch`` of R parts."""

    def __init__(
        self,
        sampler: NeighborSampler,
        features: np.ndarray,
        labels: np.ndarray,
        num_devices: int,
        pad_multiple: int,
        assignment: np.ndarray | None = None,
        cache: FeatureCache | None = None,
        serve_cache: bool = True,
        device_sampler=None,  # repro_torch.sampler.DeviceSampler | None
        with_halves: bool = False,  # build the §3a local/remote edge halves
        pin: bool = False,
        obs: Obs = NULL_OBS,
        injector=None,  # repro_torch.faults.FaultInjector | None
        mode: str = "split",
        replication=None,  # core.partition.ReplicationSet | None
        telemetry=None,  # core.partition.EdgeTelemetry | None
        num_replicas: int = 0,  # 0 = the 1-D path; >= 1 the (R, P) mesh
    ):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (one of {MODES})")
        if mode == "split" and assignment is None:
            raise ValueError("split mode needs a partition assignment")
        if device_sampler is not None and mode != "split":
            raise ValueError("device sampling is split-mode only")
        if replication is not None and mode != "split":
            raise ValueError("hot-vertex replication is split-mode only")
        if num_replicas < 0:
            raise ValueError(f"num_replicas must be >= 0, got {num_replicas}")
        if num_replicas >= 1 and mode != "split":
            raise ValueError("the (R, P) mesh composes with mode='split' only")
        self.num_replicas = num_replicas
        self.mode = mode
        self.replication = replication
        self.telemetry = telemetry
        self.sampler = sampler
        self.features = features
        self.labels = labels
        self.num_devices = num_devices
        self.pad_multiple = pad_multiple
        self.assignment = assignment
        self.cache = cache
        self.serve_cache = serve_cache
        self.device_sampler = device_sampler
        self.with_halves = with_halves
        self.pin = pin
        self.obs = obs
        self.injector = injector

    def build(self, epoch: int, index: int, targets: np.ndarray):
        """One ``PlanBatch``, or with ``num_replicas >= 1`` one
        ``MeshPlanBatch`` whose R parts each go through the 1-D path's split
        and load stages (spans ``plan/split`` and ``plan/load`` with a
        ``replica`` attribute)."""
        if self.injector is not None:
            # deterministic fault hook: raises or sleeps what is scheduled
            self.injector.fire("build", epoch, index)
        obs = self.obs
        mesh = self.num_replicas >= 1
        with obs.span("plan/build", {"epoch": epoch, "batch": index}):
            with obs.span("plan/sample") as sp_sample:
                samples = self._sample(epoch, index, targets)
            parts = [
                self._split_and_load(epoch, index, sample,
                                     {"replica": r} if mesh else None)
                for r, sample in enumerate(samples)
            ]
            # the producer end of the flow arrow that lands on the consumer
            # step training on this plan
            obs.flow_start(("plan", epoch, index))
        t_split = sum(p.t_split for p in parts)
        t_load = sum(p.t_load for p in parts)
        obs.observe("plan/sample_s", sp_sample.duration)
        obs.observe("plan/split_s", t_split)
        obs.observe("plan/load_s", t_load)
        if mesh:
            return MeshPlanBatch(
                index=index, epoch=epoch, parts=parts,
                t_sample=sp_sample.duration, t_split=t_split, t_load=t_load,
                t_built=time.perf_counter(),
            )
        batch = parts[0]
        batch.t_sample = sp_sample.duration
        batch.t_built = time.perf_counter()
        return batch

    def _sample(self, epoch: int, index: int, targets: np.ndarray) -> list:
        """The batch's samples, one a part: both samplers are pure functions
        of (seed, epoch, index), and the device one falls back to the
        host's keyed API on cap overflow. dp and pushpull sample their
        ``num_devices`` micro-batches as one part. On the mesh, R == 1 takes
        the unsuffixed key (the 1-D draw, so the degenerate mesh is
        bitwise the 1-D path); R > 1 keys host draws as
        ``sample_micro_batch`` does (an R x 1 mesh samples what dp over R
        devices samples), and the device sampler folds ``(replica, R)``
        into its flattened batch counter."""
        if self.mode != "split":
            return [self.sampler.sample_micro_batch(
                targets, self.num_devices, epoch, index)]
        R = self.num_replicas
        sampler = self.device_sampler or self.sampler
        if R <= 1:
            return [sampler.sample_batch(targets, epoch, index)]
        if self.device_sampler is None:
            return self.sampler.sample_micro_batch(targets, R, epoch, index)
        return [
            self.device_sampler.sample_batch(chunk, epoch, index, replica=r,
                                             num_replicas=R)
            for r, chunk in enumerate(np.array_split(targets, R))
        ]

    def _split_and_load(self, epoch: int, index: int, sample,
                        attrs: dict | None) -> PlanBatch:
        """Online split (or dp stacking) and the feature load of one part;
        its ``t_sample`` and ``t_built`` are left to ``build``."""
        obs = self.obs
        with obs.span("plan/split", attrs) as sp_split:
            if self.mode != "split":
                plan = build_dp_plan(sample, pad_multiple=self.pad_multiple,
                                     with_halves=self.with_halves)
            else:
                if self.telemetry is not None:
                    self.telemetry.record(sample)
                plan = build_split_plan(
                    sample, self.assignment, self.num_devices,
                    pad_multiple=self.pad_multiple,
                    with_halves=self.with_halves,
                    replication=self.replication,
                )
        with obs.span("plan/load", attrs) as sp_load:
            cache_plan, feats, breakdown = stage_host_features(
                plan, self.features, self.cache, self.serve_cache,
                self.pad_multiple, self.pin,
            )
            labels = load_labels(plan, self.labels)
        if self.injector is not None:
            # the injector claims a poison once: at most one part is hit
            rows = feats.numpy()
            poisoned = self.injector.maybe_poison("build", epoch, index, rows)
            if poisoned is not rows:
                feats = host_tensor(poisoned, self.pin)
        return PlanBatch(
            index=index, epoch=epoch, plan=plan, feats=feats, labels=labels,
            t_sample=0.0, t_split=sp_split.duration, t_load=sp_load.duration,
            breakdown=breakdown, cache_plan=cache_plan,
        )


def finalize_cache_plan(cp: CachePlan, hwm: dict, n_l: int) -> CachePlan:
    """Grow a cache plan to the running high-water marks (``CM``/``CS``).

    The single definition of the cache-plan marks, shared by the delivery
    side (``finalize``) and the trainer's inline ``train_iter``, so the two
    stay bit-identical. Its arrays are purely position-based, so growing
    them only appends masked entries — unlike ``edge_src``, nothing needs
    rebasing.
    """
    hwm["CM"] = max(hwm.get("CM", 0), cp.max_miss)
    hwm["CS"] = max(hwm.get("CS", 0), cp.max_send)
    return cp.pad_to(n_l, hwm["CM"], hwm["CS"])


def finalize(
    batch,
    hwm: dict,
    sig_cache: SignatureCache | None = None,
    sig_extra: tuple = (),
    obs: Obs = NULL_OBS,
):
    """Order-sensitive delivery step: repad the plan (and its cache plan) to
    the high-water marks, pad the labels to match, and record the signature.
    Observability rides the delivery point: the queue-dwell span (producer
    completion -> here), the repad span, any high-water-mark growth, and the
    signature counters. The feature block is padded on the device
    (``plan_io.stage_batch``).

    A ``MeshPlanBatch`` takes two passes over its R parts against the
    shared marks, in replica order: the first absorbs every part's widths,
    the second repads each part to the settled marks, so all R parts leave
    with one padded shape (a second pass only grows to the marks, so with
    R == 1 it changes nothing). One ``mesh_signature`` is recorded a
    delivery: the mesh step is one program.
    """
    if batch.t_built:
        obs.record("plan/queue_dwell", batch.t_built, time.perf_counter(),
                   {"epoch": batch.epoch, "batch": batch.index})
    mesh = isinstance(batch, MeshPlanBatch)
    parts = batch.parts if mesh else [batch]
    before = dict(hwm)
    with obs.span("plan/repad", {"epoch": batch.epoch, "batch": batch.index}) as sp:
        for _ in range(2 if mesh else 1):
            for part in parts:
                repad_plan(part.plan, hwm)
                if part.cache_plan is not None:
                    finalize_cache_plan(
                        part.cache_plan, hwm, part.plan.front_ids[-1].shape[1]
                    )
        for part in parts:
            part.labels = pad_axis(part.labels, 1,
                                   part.plan.front_ids[0].shape[1])
    note_hwm_growth(obs, before, hwm, f"epoch{batch.epoch}/batch{batch.index}")
    batch.t_split += sp.duration
    obs.observe("plan/repad_s", sp.duration)
    if mesh:
        batch.signature = mesh_signature(
            [(p.plan, p.cache_plan) for p in parts], sig_extra)
    else:
        batch.signature = plan_signature(batch.plan, batch.cache_plan,
                                         sig_extra)
    if sig_cache is not None:
        batch.sig_hit = sig_cache.record(batch.signature)
        obs.count("sig/hit" if batch.sig_hit else "sig/miss")
    return batch


class PlanSource:
    """Iterable of ``PlanBatch`` for one epoch. Subclasses choose *where*
    the producer work runs; delivery order and contents are identical."""

    def __iter__(self) -> Iterator[PlanBatch]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class SerialPlanSource(PlanSource):
    """Inline plan construction on the consumer thread."""

    producer: PlanProducer
    epoch: int
    batches: list
    hwm: dict
    sig_cache: SignatureCache | None = None
    # static program-structure key folded into every delivered signature
    sig_extra: tuple = ()
    obs: Obs = NULL_OBS
    # first batch's *global* index in the epoch: a resumed epoch slices
    # ``batches`` to the tail but keys each build by its original
    # (epoch, index), so the keyed draws match an uninterrupted run
    start: int = 0

    def __iter__(self) -> Iterator[PlanBatch]:
        for idx, targets in enumerate(self.batches):
            yield finalize(
                self.producer.build(self.epoch, idx + self.start, targets),
                self.hwm, self.sig_cache, self.sig_extra, self.obs,
            )

    def stats(self) -> dict:
        return dict(self.sig_cache.as_dict()) if self.sig_cache else {}


@dataclass
class PipelinedPlanSource(PlanSource):
    """Multi-worker lookahead plan construction behind a bounded queue."""

    producer: PlanProducer
    epoch: int
    batches: list
    hwm: dict
    sig_cache: SignatureCache | None = None
    sig_extra: tuple = ()
    obs: Obs = NULL_OBS
    start: int = 0  # global index of batches[0] (see SerialPlanSource)
    depth: int = 4
    workers: int = 2
    # producer supervision, forwarded to OrderedPrefetcher: the transient
    # build retry budget and the consumer-side stall watchdog
    retry: RetryPolicy | None = None
    stall_timeout_s: float | None = None
    _prefetcher: OrderedPrefetcher | None = field(
        default=None, repr=False, compare=False
    )

    def _build(self, idx: int, targets: np.ndarray) -> PlanBatch:
        return self.producer.build(self.epoch, idx + self.start, targets)

    def __iter__(self) -> Iterator[PlanBatch]:
        batches = list(self.batches)
        self._prefetcher = OrderedPrefetcher(
            lambda idx: self._build(idx, batches[idx]),
            len(batches),
            depth=self.depth,
            workers=self.workers,
            retry=self.retry,
            stall_timeout_s=self.stall_timeout_s,
            obs=self.obs,
        )
        try:
            for batch in self._prefetcher:
                yield finalize(
                    batch, self.hwm, self.sig_cache, self.sig_extra, self.obs
                )
        finally:
            self.close()

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()

    def stats(self) -> dict:
        out = {}
        if self._prefetcher is not None:
            out.update(self._prefetcher.stats.as_dict())
        if self.sig_cache is not None:
            out.update(self.sig_cache.as_dict())
        return out


class _DeviceSourceMixin:
    """Shared device-sampling discipline for both delivery flavours: the
    capacity table is frozen for the epoch, so which batches overflow (and
    fall back to the host sampler) does not depend on delivery order."""

    def _device_sampler(self):
        eng = self.producer.device_sampler
        if eng is None:
            raise ValueError(
                "device plan source needs a PlanProducer with a device_sampler"
            )
        return eng

    def stats(self) -> dict:
        out = super().stats()
        out.update(self._device_sampler().stats())
        return out


@dataclass
class DevicePlanSource(_DeviceSourceMixin, SerialPlanSource):
    """Inline delivery; sampling runs on the producer's ``DeviceSampler``."""

    def __iter__(self) -> Iterator[PlanBatch]:
        self._device_sampler().refresh_caps()
        yield from SerialPlanSource.__iter__(self)


@dataclass
class DevicePipelinedPlanSource(_DeviceSourceMixin, PipelinedPlanSource):
    """Pipelined delivery; the producer threads share the ``DeviceSampler``.

    On a card each producer thread samples on a CUDA stream of its own
    (``DeviceSampler.producer_stream``). The sampler returns host arrays,
    so no device tensor crosses streams.
    """

    def _build(self, idx: int, targets: np.ndarray) -> PlanBatch:
        eng = self._device_sampler()
        if eng.device.type != "cuda":
            return super()._build(idx, targets)
        with torch.cuda.stream(eng.producer_stream()):
            return super()._build(idx, targets)

    def __iter__(self) -> Iterator[PlanBatch]:
        self._device_sampler().refresh_caps()
        yield from PipelinedPlanSource.__iter__(self)


#: the four plan sources, by ``TrainConfig.plan_source``
PLAN_SOURCES = {
    "serial": SerialPlanSource,
    "pipelined": PipelinedPlanSource,
    "device": DevicePlanSource,
    "device_pipelined": DevicePipelinedPlanSource,
}


def make_plan_source(
    kind: str,
    producer: PlanProducer,
    epoch: int,
    batches: list,
    hwm: dict,
    sig_cache: SignatureCache | None = None,
    depth: int = 4,
    workers: int = 2,
    sig_extra: tuple = (),
    obs: Obs = NULL_OBS,
    start: int = 0,
    retry: RetryPolicy | None = None,
    stall_timeout_s: float | None = None,
) -> PlanSource:
    if kind not in PLAN_SOURCES:
        raise ValueError(
            f"unknown plan source {kind!r} ({' | '.join(PLAN_SOURCES)})"
        )
    args = (producer, epoch, batches, hwm, sig_cache, sig_extra, obs, start)
    if kind in ("serial", "device"):
        return PLAN_SOURCES[kind](*args)
    return PLAN_SOURCES[kind](*args, depth, workers, retry, stall_timeout_s)
