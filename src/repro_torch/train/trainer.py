"""Training runtime for the split-parallel main path — the counterpart of
``repro/train/trainer.py`` restricted to ``mode="split"`` with the serial or
device plan source and the blocking per-layer shuffle.

The P splits run in sim form, as a leading axis on one device. One step:
stage a plan to device tensors; per layer, shuffle (``sim_shuffle``) and
aggregate (the fused CUDA kernels by default); masked cross-entropy; backward;
the repo's own Adam. The loss/accuracy transfer at the end of the step is its
one sync point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.partition import partition_graph
from repro_torch.core.presample import presample
from repro_torch.core.shuffle import WIRE_DTYPES, sim_shuffle
from repro_torch.core.splitting import build_split_plan, repad_plan
from repro_torch.graph.datasets import GraphDataset
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.models.gnn.layers import GNN, GNNSpec, gnn_forward
from repro_torch.runtime.plan_source import PlanProducer, make_plan_source
from repro_torch.sampler import DeviceSampler
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loss import masked_accuracy, masked_softmax_xent
from repro_torch.train.plan_io import load_features, load_labels, plan_to_device


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields that this slice runs. The
    fields naming later slices accept only their off value."""

    mode: str = "split"  # dp | pushpull: later slice
    num_devices: int = 4
    fanouts: tuple[int, ...] = (15, 15, 15)
    batch_size: int = 1024
    lr: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd
    partition_method: str = "gsplit"  # node | edge | rand: later slice
    presample_epochs: int = 10
    pad_multiple: int = -1  # -1 = pow2 bucketing
    cache_mode: str = "none"  # distributed | partitioned: later slice
    plan_source: str = "serial"  # serial | device; pipelined: later slice
    shuffle_overlap: bool = False  # overlap schedule: later slice
    wire_dtype: str = "float32"  # float32 | bfloat16 | float16
    replication_budget: float = 0.0  # hot-vertex replication: later slice
    num_replicas: int = 0  # 2-D (replica, split) mesh: later slice
    seed: int = 0


#: config values this slice runs, and the slice each other value waits for
_SLICE = {
    "mode": (("split",), "the dp and pushpull modes"),
    "partition_method": (("gsplit",), "the partitioner ablation arms"),
    "plan_source": (("serial", "device"), "the pipelined plan sources"),
    "cache_mode": (("none",), "cache serving"),
    "shuffle_overlap": ((False,), "the overlap schedule"),
    "replication_budget": ((0.0,), "hot-vertex replication"),
    "num_replicas": ((0,), "the 2-D (replica, split) mesh"),
}

def check_config(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a value this slice of the port does not run."""
    for name, (values, what) in _SLICE.items():
        if getattr(cfg, name) not in values:
            raise ValueError(
                f"TrainConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                f"({what}: a later slice of the port; this slice runs "
                f"{name} in {values!r})"
            )
    if cfg.wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {cfg.wire_dtype!r} (one of {WIRE_DTYPES})"
        )


def resolve_device(device) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises rather
    than quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port runs on the card unless the "
            "caller asks for the CPU (device='cpu')"
        )
    return dev


@dataclass
class IterStats:
    loss: float
    accuracy: float
    t_sample: float
    t_split: float
    t_load: float
    t_compute: float  # staging + device step, ending in the loss sync
    loaded_rows: int
    computed_edges: int
    shuffle_rows: int


@dataclass
class EpochStats:
    iters: list[IterStats] = field(default_factory=list)
    t_wall: float = 0.0  # consumer wall time for the whole epoch
    pipeline: dict = field(default_factory=dict)  # plan source's stats()

    def totals(self) -> dict:
        agg = {
            "loss": float(np.mean([i.loss for i in self.iters])),
            "accuracy": float(np.mean([i.accuracy for i in self.iters])),
        }
        for k in (
            "t_sample", "t_split", "t_load", "t_compute", "loaded_rows",
            "computed_edges", "shuffle_rows",
        ):
            agg[k] = float(np.sum([getattr(i, k) for i in self.iters]))
        return agg


class Trainer:
    """End-to-end split-parallel mini-batch GNN training on one device.

    ``device=None`` is the card. ``model`` (a ``GNN``, e.g. from
    ``params_from_jax``) replaces the trainer's own initialization, which
    draws from a ``torch.Generator`` seeded with ``cfg.seed``. With
    ``cfg.plan_source="device"`` the batches are sampled on that device by
    ``self.device_sampler``, whose shards live there.
    """

    def __init__(
        self,
        dataset: GraphDataset,
        spec: GNNSpec,
        cfg: TrainConfig,
        device=None,
        model: GNN | None = None,
    ):
        check_config(cfg)
        self.device = resolve_device(device)
        self.ds = dataset
        # the config's execution knobs are authoritative over the spec's
        self.spec = spec = replace(spec, wire_dtype=cfg.wire_dtype)
        self.cfg = cfg
        self.sampler = NeighborSampler(
            dataset.graph, dataset.train_ids, list(cfg.fanouts),
            cfg.batch_size, seed=cfg.seed,
        )

        # ---- offline stage: presample + partition ------------------------
        t0 = time.perf_counter()
        self.weights = presample(
            dataset.graph, dataset.train_ids, list(cfg.fanouts),
            cfg.batch_size, num_epochs=cfg.presample_epochs, seed=cfg.seed + 1,
        )
        self.t_presample = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.partition = partition_graph(
            dataset.graph, cfg.num_devices, method=cfg.partition_method,
            weights=self.weights, seed=cfg.seed,
        )
        self.t_partition = time.perf_counter() - t0

        if model is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            model = GNN(spec, generator=gen)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.opt = getattr(opt_lib, cfg.optimizer)(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self._pad_hwm: dict = {}  # high-water-mark padding (stable shapes)
        self._epoch = 0  # epochs consumed via train_epoch (keyed RNG input)
        self.device_sampler = None
        if cfg.plan_source == "device":
            self.device_sampler = DeviceSampler(
                dataset.graph, self.partition.assignment, cfg.num_devices,
                list(cfg.fanouts), cfg.seed, host_sampler=self.sampler,
                device=self.device,
            )
        self.producer = PlanProducer(
            self.sampler, dataset.features, dataset.labels,
            num_devices=cfg.num_devices, pad_multiple=cfg.pad_multiple,
            assignment=self.partition.assignment,
            device_sampler=self.device_sampler,
        )

    # ------------------------------------------------------------------ #
    def _step(self, plan, feats: np.ndarray, labels: np.ndarray):
        """Stage one repadded plan and take one optimizer step; returns host
        ``(loss, acc)``."""
        dev = self.device
        plan_arrays = plan_to_device(plan, dev)
        feats_d = torch.as_tensor(feats, device=dev)
        labels_d = torch.as_tensor(labels, device=dev)
        layers = list(self.model.layers)
        logits = gnn_forward(self.spec, layers, feats_d, plan_arrays, sim_shuffle)
        mask = plan_arrays["target_mask"]
        loss = masked_softmax_xent(logits, labels_d, mask)
        acc = masked_accuracy(logits, labels_d, mask)
        grads = torch.autograd.grad(loss, self.params)
        self.params, self.opt_state = self.opt.update(
            grads, self.opt_state, self.params
        )
        # the step's one sync: both scalars in one transfer
        loss_v, acc_v = torch.stack([loss.detach(), acc.to(loss.dtype)]).tolist()
        return loss_v, acc_v

    def _iter_stats(self, plan, loss, acc, t_sample, t_split, t_load,
                    t_compute) -> IterStats:
        return IterStats(
            loss=loss,
            accuracy=acc,
            t_sample=t_sample,
            t_split=t_split,
            t_load=t_load,
            t_compute=t_compute,
            loaded_rows=plan.loaded_feature_rows(),
            computed_edges=plan.computed_edges(),
            shuffle_rows=plan.shuffle_rows(),
        )

    def train_iter(self, targets: np.ndarray) -> IterStats:
        """One step on ``targets`` with the streamed sampler RNG (draws in
        call order), like the JAX ``Trainer.train_iter``."""
        cfg = self.cfg
        t0 = time.perf_counter()
        sample = self.sampler.sample(targets)
        t1 = time.perf_counter()
        plan = build_split_plan(
            sample, self.partition.assignment, cfg.num_devices,
            pad_multiple=cfg.pad_multiple,
        )
        plan = repad_plan(plan, self._pad_hwm)
        t2 = time.perf_counter()
        feats = load_features(plan, self.ds.features)
        labels = load_labels(plan, self.ds.labels)
        t3 = time.perf_counter()
        loss, acc = self._step(plan, feats, labels)
        t4 = time.perf_counter()
        return self._iter_stats(plan, loss, acc, t1 - t0, t2 - t1, t3 - t2,
                                t4 - t3)

    def plan_source_for(self, epoch: int, max_iters: int | None = None):
        """The configured plan source over ``epoch``'s batches (the first
        ``max_iters``), delivering into the trainer's high-water marks."""
        batches = self.sampler.epoch_targets(epoch)
        if max_iters is not None:
            batches = batches[:max_iters]
        return make_plan_source(self.cfg.plan_source, self.producer, epoch,
                                batches, self._pad_hwm)

    def train_epoch(self, max_iters: int | None = None) -> EpochStats:
        """One epoch through the configured plan source: batches keyed by
        ``(seed, epoch, index)``, repadded at delivery."""
        source = self.plan_source_for(self._epoch, max_iters)
        stats = EpochStats()
        t_epoch = time.perf_counter()
        for batch in source:
            t0 = time.perf_counter()
            loss, acc = self._step(batch.plan, batch.feats, batch.labels)
            stats.iters.append(self._iter_stats(
                batch.plan, loss, acc, batch.t_sample, batch.t_split,
                batch.t_load, time.perf_counter() - t0,
            ))
        stats.t_wall = time.perf_counter() - t_epoch
        stats.pipeline = source.stats()
        self._epoch += 1
        return stats
