"""Training runtime — the counterpart of ``repro/train/trainer.py``: one
trainer, three parallelism paradigms, on any of the four plan sources (dp
and pushpull on the host ones), with the blocking or the overlap schedule,
with or without the device-resident feature cache, and with crash-consistent
checkpoints and bit-exact mid-epoch resume (``train/checkpoint.py``).

  * ``split``     -- the paper's split parallelism: one mini-batch, split
                     online by f_G, per-layer all-to-all shuffles; optionally
                     with hot-vertex replication (``replication_budget``) and
                     edge telemetry fed back by ``refine_partition``; and
                     the 2-D (replica, split) mesh (``num_replicas``).
  * ``dp``        -- data parallelism (the DGL/Quiver baseline): one
                     micro-batch per split, redundant loads and compute, no
                     shuffles.
  * ``pushpull``  -- the P3 hybrid; on one device its numerics equal dp's,
                     and the port builds the same plan (as the JAX package
                     does).

The P splits run in sim form, as a leading axis on one device; the spmd
form, one split a process over ``torch.distributed``, is this trainer with
its step's gradients taken on the rank's split
(``launch.spmd.SpmdTrainer``). One step:
stage a delivered plan to device tensors (``plan_io.stage_batch``: pinned,
``non_blocking`` copies on a card); with a serving cache, assemble the input
block from the resident block and the staged miss rows
(``gnn_forward_cached``); per layer, shuffle (``sim_shuffle``) and aggregate
(the fused CUDA kernels by default), or under ``shuffle_overlap`` aggregate
the local and remote edge halves apart over a chunked exchange; masked
cross-entropy; backward; the repo's own Adam. A mesh step runs the R
replica parts' forward and backward one after another through the same
code and averages their gradients, in replica order, before one update.
The loss/accuracy transfer at the end of the step is its one sync point.
``train_epoch`` records the spans of the JAX package's loop
(``step/wait``, ``step/stage``, ``step/device``) through
``repro_torch.obs`` when ``obs_trace`` is on, and the pipelined sources run
under the supervision of ``repro_torch.faults``.

A checkpoint (``save_checkpoint``, every ``ckpt_every`` steps of
``train_epoch``) holds the params, the optimizer state and the resume
cursor: the next batch's (epoch, index), the padding high-water marks, the
device sampler's capacity table and the telemetry counters. ``resume``
copies the arrays into the trainer's own parameter and slot tensors in
place: the model's forward, the gradient and the in-place optimizer all hold
those tensors, so rebinding them would split the three apart.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.partition import (
    PARTITION_METHODS,
    EdgeTelemetry,
    partition_graph,
)
from repro_torch.core.partition import refine_partition as _refine_partition
from repro_torch.core.presample import presample
from repro_torch.core.shuffle import WIRE_DTYPES
from repro_torch.core.splitting import build_dp_plan, build_split_plan, repad_plan
from repro_torch.faults.retry import RetryPolicy
from repro_torch.graph.cache import FeatureCache, LoadBreakdown
from repro_torch.graph.datasets import GraphDataset
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.models.gnn.layers import GNN, GNNSpec, gnn_forward, gnn_forward_cached
from repro_torch.obs import NULL_OBS, Obs, note_hwm_growth
from repro_torch.runtime.plan_source import (
    MODES,
    MeshPlanBatch,
    PlanBatch,
    PlanProducer,
    finalize_cache_plan,
    make_plan_source,
)
from repro_torch.runtime.recompile import (
    RecompileTracer,
    SignatureSet,
    Traced,
    call_signature,
)
from repro_torch.runtime.signature import SignatureCache
from repro_torch.sampler import DeviceSampler
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import checkpoint_name, load_latest_checkpoint
from repro_torch.train.checkpoint import save_checkpoint as _save_checkpoint
from repro_torch.train.loss import masked_accuracy, masked_softmax_xent
from repro_torch.train.plan_io import load_labels, stage_batch, stage_host_features

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig`` fields that the port runs, with the
    reference's defaults."""

    mode: str = "split"  # split | dp | pushpull
    num_devices: int = 4
    fanouts: tuple[int, ...] = (15, 15, 15)
    batch_size: int = 1024
    lr: float = 1e-3
    optimizer: str = "adam"  # adam | adamw | sgd
    # split mode: gsplit | node | edge | rand | telemetry
    partition_method: str = "gsplit"
    presample_epochs: int = 10
    # presample threads: 1 replays the single-generator stream; more run
    # the epochs keyed, in parallel — another stream, other weights
    presample_workers: int = 1
    pad_multiple: int = -1  # -1 = pow2 bucketing
    cache_mode: str = "none"  # none | distributed | partitioned
    cache_capacity_per_device: int = 0
    # serve hits from the device-resident block (False = accounting only: a
    # full host gather every step, the hits and misses counted)
    cache_serve: bool = True
    # serial | pipelined | device | device_pipelined: the device kinds sample
    # on the card (repro_torch.sampler); train_iter always samples on host
    plan_source: str = "serial"
    pipeline_depth: int = 4  # max in-flight batches (pipelined sources)
    plan_workers: int = 2  # producer threads (pipelined sources)
    # Overlap-aware shuffle schedule (DESIGN.md §3a). Execution knobs: the
    # trainer copies them onto the model spec, so the layer shuffles and the
    # cache's remote fetch agree on one wire format. fp32 wire is
    # bit-exact; bf16/fp16 quantize only bytes on the wire.
    shuffle_overlap: bool = False  # split local/remote aggregation per layer
    shuffle_chunks: int = 1  # feature-axis tiles per layer exchange
    wire_dtype: str = "float32"  # float32 | bfloat16 | float16
    # Hot-vertex replication: a fraction of |V| rows, the hottest
    # cross-split sources, resident on the device as one (R, F) block
    # appended past the recv region; their edges never enter the shuffle.
    # Split mode only (dp and pushpull plans ignore it); 0.0 = off.
    replication_budget: float = 0.0
    # record every split-mode sample's frontier/edge counts
    # (core.partition.EdgeTelemetry) for ``Trainer.refine_partition``
    record_telemetry: bool = False
    # Count new step-call signatures per step (the port's counterpart of
    # jit cache misses: runtime.recompile.RecompileTracer); per-epoch counts
    # land in ``EpochStats.recompiles``. A warm epoch at fixed caps has none.
    trace_recompiles: bool = False
    # Tracing + metrics (repro_torch.obs): spans for every host stage,
    # flow-linked per (epoch, batch), and the metrics registry. Off by
    # default; off, the same code records nothing and adds no sync.
    obs_trace: bool = False
    # with obs_trace, train_epoch rewrites this path with the cumulative
    # Chrome trace (metrics snapshot included) at every epoch end
    obs_path: str | None = None
    # 2-D (replica, split) mesh: 0 = the 1-D P-way split path (default);
    # R >= 1 runs R replica groups of ``num_devices`` splits each: every
    # global batch fans out into R independently sampled per-replica plans
    # over the *same* partition, and the mesh step runs R split-local
    # forward/backwards and averages the gradients across the replica axis.
    # R = 1 is the degenerate mesh, bitwise the 1-D path. Split mode only.
    num_replicas: int = 0
    # Crash-consistent checkpointing: with ckpt_dir set and ckpt_every > 0,
    # train_epoch writes a versioned checkpoint (params + optimizer state +
    # the full resume cursor) every ckpt_every optimizer steps;
    # Trainer.resume() restarts from the newest valid one mid-epoch,
    # bit-for-bit against an uninterrupted run.
    ckpt_dir: str | None = None
    ckpt_every: int = 0  # optimizer steps between checkpoints (0 = off)
    # Supervised producers (pipelined sources): a transient build failure
    # (faults.RetryableError) retries in place up to plan_retries times with
    # exponential backoff; a delivery blocked longer than stall_timeout_s
    # raises faults.PipelineStallError naming the stuck index. None = no
    # watchdog.
    plan_retries: int = 0
    plan_retry_backoff_s: float = 0.05
    stall_timeout_s: float | None = None
    # Non-finite guard: a NaN/Inf loss or gradient (one isfinite reduction
    # on the device, read in the step's one transfer) keeps the step's
    # params and optimizer state, counting fault/nonfinite_skips. The
    # skipped step reports its non-finite loss.
    skip_nonfinite: bool = False
    seed: int = 0


#: feature-cache placements (``graph.cache.FeatureCache``)
CACHE_MODES = ("none", "distributed", "partitioned")

#: plan sources that sample on the device (split mode only)
DEVICE_SOURCES = ("device", "device_pipelined")

#: the values each enumerated config field takes
_CHOICES = {
    "mode": MODES,
    "partition_method": PARTITION_METHODS,
    "plan_source": ("serial", "pipelined") + DEVICE_SOURCES,
}


def check_config(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for a config the trainer cannot run."""
    for name, values in _CHOICES.items():
        if getattr(cfg, name) not in values:
            raise ValueError(
                f"unknown TrainConfig.{name}={getattr(cfg, name)!r} (one of "
                f"{values!r})"
            )
    if cfg.num_replicas < 0:
        raise ValueError("num_replicas must be >= 0 (0 = 1D split path)")
    if cfg.num_replicas >= 1 and cfg.mode != "split":
        raise ValueError(
            "the (R, P) mesh composes with mode='split' only — dp and "
            "pushpull are already replica-style baselines"
        )
    if cfg.plan_source in DEVICE_SOURCES and cfg.mode != "split":
        raise ValueError(
            f"plan_source {cfg.plan_source!r} requires mode='split' (the "
            f"device sampler splits its batch; mode={cfg.mode!r} samples "
            "micro-batches on the host)"
        )
    if cfg.wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire_dtype {cfg.wire_dtype!r} (one of {WIRE_DTYPES})"
        )
    if cfg.shuffle_chunks < 1:
        raise ValueError("shuffle_chunks must be >= 1")
    if cfg.cache_mode not in CACHE_MODES:
        raise ValueError(
            f"unknown cache_mode {cfg.cache_mode!r} (one of {CACHE_MODES})"
        )


#: wire bytes per element for each supported wire dtype (DESIGN.md §3a)
_WIRE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def modeled_wire_bytes(plan, spec: GNNSpec, wire_dtype: str) -> int:
    """Bytes the per-layer shuffles put on the wire for one plan (modeled),
    as the JAX package's ``modeled_wire_bytes`` counts them.

    Counts only *true* cross-split rows (``LayerPlan.shuffle_rows``: padding
    slots are free on real all-to-allv hardware). Per row, the payload width
    depends on the schedule: the blocking path ships raw activations
    (``d_in``); the overlapped GAT path ships the transformed rows plus the
    eagerly exchanged a_src scores (``d_out + H``).
    """
    size = _WIRE_BYTES[wire_dtype]
    dims = spec.layer_dims()
    L = spec.num_layers
    total = 0
    for li, lp in enumerate(plan.layers):
        d_in, d_out = dims[L - 1 - li]
        if spec.model == "gat" and spec.overlap:
            per_row = d_out + spec.num_heads
        else:
            per_row = d_in
        total += lp.shuffle_rows() * per_row * size
    return total


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
    t_compute: float  # t_stage + t_device
    loaded_rows: int
    computed_edges: int
    shuffle_rows: int
    t_wait: float = 0.0  # blocked on the plan source (the step's wait_s)
    t_stage: float = 0.0  # staging + enqueueing the step (stage_s)
    t_device: float = 0.0  # the step's one sync (device_s)
    # where the input rows were served from (None without a cache)
    load_breakdown: LoadBreakdown | None = None
    wire_bytes: int = 0  # modeled shuffle bytes on the wire (see above)
    # the paper's split-quality counters (SplitPlan's accounting methods)
    padded_edge_slots: int = 0  # edge slots the padded step executes
    busiest_edges: int = 0  # true edges of the most-loaded split
    load_imbalance: float = 1.0  # max / mean edges per split
    cross_edge_fraction: float = 0.0  # edges reading the recv region


@dataclass
class EpochStats:
    iters: list[IterStats] = field(default_factory=list)
    pipeline: dict = field(default_factory=dict)  # plan source's stats()
    t_wall: float = 0.0  # consumer wall time for the whole epoch
    t_first_iter: float = 0.0  # to the end of the first step (pipeline fill)
    # new step-call signatures this epoch (trace_recompiles=True): {"steps",
    # "misses", "by_fn", "miss_steps"} from RecompileTracer.since()
    recompiles: dict = field(default_factory=dict)

    def steady_step_seconds(self) -> float:
        """Per-step wall time without the first step (the pipeline fill)."""
        n = len(self.iters)
        if n <= 1:
            return self.t_wall / max(n, 1)
        return (self.t_wall - self.t_first_iter) / (n - 1)

    def totals(self) -> dict:
        agg = {
            "loss": float(np.mean([i.loss for i in self.iters])),
            "accuracy": float(np.mean([i.accuracy for i in self.iters])),
        }
        for k in (
            "t_sample", "t_split", "t_load", "t_compute", "loaded_rows",
            "computed_edges", "shuffle_rows", "padded_edge_slots",
            "busiest_edges", "wire_bytes",
        ):
            agg[k] = float(np.sum([getattr(i, k) for i in self.iters]))
        for k in ("load_imbalance", "cross_edge_fraction"):
            agg[k] = float(np.mean([getattr(i, k) for i in self.iters]))
        if self.iters and self.iters[0].load_breakdown is not None:
            for k in ("local_hit", "remote_hit", "host_miss"):
                agg[f"load_{k}"] = int(np.sum(
                    [getattr(i.load_breakdown, k) for i in self.iters]))
        return agg


class Trainer:
    """End-to-end mini-batch GNN training with the chosen parallelism, all
    P splits on one device.

    ``device=None`` is the card. ``model`` (a ``GNN``, e.g. from
    ``params_from_jax``) replaces the trainer's own initialization, which
    draws from a ``torch.Generator`` seeded with ``cfg.seed``. With a
    ``device*`` plan source the batches are sampled on that device by
    ``self.device_sampler``, whose shards live there. ``injector`` (a
    ``faults.FaultInjector``) fires its schedule in the producers' builds.
    With ``cache_mode`` set, the ``FeatureCache`` is built once from the
    presample ranking, and when it serves, its (P, C, F) resident block is
    put on the device once (``self.cache_block``) and never staged again;
    likewise a replication set's (R, F) rows (``self.rep_block``).
    """

    def __init__(
        self,
        dataset: GraphDataset,
        spec: GNNSpec,
        cfg: TrainConfig,
        device=None,
        model: GNN | None = None,
        injector=None,
    ):
        check_config(cfg)
        self.device = resolve_device(device)
        self.ds = dataset
        # one obs sink per trainer when tracing, the shared disabled one
        # otherwise (one code path)
        self.obs = Obs(enabled=True) if cfg.obs_trace else NULL_OBS
        # the config's execution knobs are authoritative over the spec's
        self.spec = spec = replace(
            spec, overlap=cfg.shuffle_overlap,
            shuffle_chunks=cfg.shuffle_chunks, wire_dtype=cfg.wire_dtype,
        )
        self.cfg = cfg
        self.sampler = NeighborSampler(
            dataset.graph, dataset.train_ids, list(cfg.fanouts),
            cfg.batch_size, seed=cfg.seed,
        )

        # ---- offline stage: presample + partition (split mode) ------------
        self.weights = None
        self.partition = None
        t0 = time.perf_counter()
        if cfg.mode == "split" or cfg.cache_mode != "none":
            self.weights = presample(
                dataset.graph, dataset.train_ids, list(cfg.fanouts),
                cfg.batch_size, num_epochs=cfg.presample_epochs,
                seed=cfg.seed + 1, workers=cfg.presample_workers,
            )
        self.t_presample = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cfg.mode == "split":
            self.partition = partition_graph(
                dataset.graph, cfg.num_devices, method=cfg.partition_method,
                weights=self.weights, train_ids=dataset.train_ids,
                seed=cfg.seed, replication_budget=cfg.replication_budget,
            )
        self.t_partition = time.perf_counter() - t0
        # hot-vertex replication: the selected rows, resident on the device
        # as one (R, F) block appended past the recv region
        self._set_replication()
        self.telemetry = None
        if cfg.record_telemetry and cfg.mode == "split":
            self.telemetry = EdgeTelemetry(dataset.graph.num_nodes,
                                           dataset.graph.num_edges)

        self.cache = None
        self.cache_block = None  # (P, C, F) device-resident rows when serving
        if cfg.cache_mode != "none":
            self.cache = FeatureCache(
                dataset.graph.num_nodes, cfg.num_devices,
                cfg.cache_capacity_per_device,
                ranking=self.weights.vertex_weight, mode=cfg.cache_mode,
                partition_assignment=(
                    self.partition.assignment if self.partition else None),
            )
            if cfg.cache_serve and self.cache.serves:
                self.cache_block = torch.as_tensor(
                    self.cache.build_resident(dataset.features),
                    device=self.device,
                )

        if model is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            model = GNN(spec, generator=gen)
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.opt = getattr(opt_lib, cfg.optimizer)(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self._pad_hwm: dict = {}  # high-water-mark padding (stable shapes)
        self._epoch = 0  # epochs consumed via train_epoch (keyed RNG input)
        self._start_iter = 0  # resume cursor: first batch of the next epoch
        self.global_step = 0  # optimizer steps taken (checkpoint naming)
        self.nonfinite_skips = 0  # steps whose update the guard skipped
        self.injector = injector
        self.sig_cache = SignatureCache()
        self._set_recompile_tracer()
        self.device_sampler = None
        if cfg.plan_source in DEVICE_SOURCES:
            self.device_sampler = self._make_device_sampler()
            if self.recompiles is not None:
                self.recompiles.register("sample_device",
                                         self.device_sampler.sample_fn)
        self.producer = PlanProducer(
            self.sampler, dataset.features, dataset.labels,
            num_devices=cfg.num_devices, pad_multiple=cfg.pad_multiple,
            assignment=self.partition.assignment if self.partition else None,
            cache=self.cache,
            serve_cache=self.cache_block is not None,
            device_sampler=self.device_sampler,
            with_halves=cfg.shuffle_overlap,
            pin=self.device.type == "cuda",
            obs=self.obs,
            injector=injector,
            mode=cfg.mode,
            replication=self.replication,
            telemetry=self.telemetry,
            num_replicas=cfg.num_replicas,
        )

    def _set_replication(self) -> None:
        """Take the partition's replication set and put its rows on the
        device (``rep_block``, None without replication)."""
        self.replication = self.partition.replication if self.partition else None
        self.rep_block = None
        if self.replication is not None:
            self.rep_block = torch.as_tensor(
                self.ds.features[self.replication.vertices].astype(
                    np.float32, copy=False),
                device=self.device,
            )

    def _num_replicated(self) -> int:
        return self.replication.num_replicated if self.replication else 0

    def _make_device_sampler(self) -> DeviceSampler:
        """The device sampler over the current partition: its shards are
        uploaded to the trainer's device. When tracing recompiles, its loop
        is the trainer's one traced ``sample_device`` (a refined partition's
        new sampler keeps it, as the reference's module-level jit keeps its
        cache)."""
        cfg = self.cfg
        sampler = DeviceSampler(
            self.ds.graph, self.partition.assignment, cfg.num_devices,
            list(cfg.fanouts), cfg.seed, host_sampler=self.sampler,
            device=self.device,
        )
        sampler.obs = self.obs
        if self.recompiles is not None:
            fn = self._traced.setdefault("sample_device",
                                         Traced(sampler.sample_fn))
            sampler.sample_fn = fn
        return sampler

    def _set_recompile_tracer(self) -> None:
        """With ``trace_recompiles``, the tracer (``self.recompiles``) and
        the step's signature sets by the reference's names: ``step`` and
        ``cached_step`` (the 1-D path, uncached and served from the cache),
        and on the mesh ``mesh_step`` and ``mesh_cached_step``
        (``self._traced``). Off, ``self.recompiles`` is None and nothing is
        noted."""
        self.recompiles = None
        self._traced: dict = {}
        if not self.cfg.trace_recompiles:
            return
        self.recompiles = RecompileTracer()
        names = ["step", "cached_step"]
        if self.cfg.num_replicas >= 1:
            names += ["mesh_step", "mesh_cached_step"]
        for name in names:
            self._traced[name] = SignatureSet()
            self.recompiles.register(name, self._traced[name])

    # ------------------------------------------------------------------ #
    def _replica_grads(self, part, keys: list | None = None):
        """Stage one part (a ``PlanBatch``: the 1-D step's batch or one
        replica's) and run its forward, masked loss and gradients. With a
        cache plan ``feats`` is the miss block and the input is served from
        the one resident block; every part shares the one ``rep_block``.
        With ``keys``, the staged part's ``call_signature`` is appended."""
        feats_d, plan_arrays, labels_d = stage_batch(
            part.plan, part.feats, part.labels, self.device, part.cache_plan,
            with_halves=self.cfg.shuffle_overlap,
            num_replicated=self._num_replicated(),
        )
        if keys is not None:
            keys.append(call_signature((feats_d, plan_arrays, labels_d), {}))
        layers = list(self.model.layers)
        if part.cache_plan is not None:
            logits = gnn_forward_cached(self.spec, layers, self.cache_block,
                                        feats_d, plan_arrays,
                                        rep_block=self.rep_block)
        else:
            logits = gnn_forward(self.spec, layers, feats_d, plan_arrays,
                                 rep_block=self.rep_block)
        mask = plan_arrays["target_mask"]
        loss = masked_softmax_xent(logits, labels_d, mask)
        acc = masked_accuracy(logits, labels_d, mask)
        return loss, acc, torch.autograd.grad(loss, self.params)

    def _step_grads(self, parts: list):
        """The step's ``(loss, acc, grads)`` over ``parts``: the 1-D step's
        one batch, or a mesh batch's R replica parts. Each part runs the
        same ``_replica_grads``; the gradients, losses and accuracies are
        summed left to right in replica order and divided by R (the sim
        statement of the spmd psum's fixed order). A sum of one term and a
        division by 1 are exact, so the R = 1 mesh is bitwise the 1-D step;
        the division is skipped there. With ``trace_recompiles`` the step's
        signature (its staged parts' in replica order) is noted under the
        path's name: the key of the one call the reference's step is."""
        keys = None if self.recompiles is None else []
        grads = loss = acc = None
        for part in parts:
            loss_r, acc_r, grads_r = self._replica_grads(part, keys)
            if grads is None:
                loss, acc, grads = loss_r, acc_r, grads_r
            else:
                loss, acc = loss + loss_r, acc + acc_r
                grads = [a + b for a, b in zip(grads, grads_r)]
        if len(parts) > 1:
            num = len(parts)
            loss, acc = loss / num, acc / num
            grads = [g / num for g in grads]
        if keys is not None:
            name = "step" if parts[0].cache_plan is None else "cached_step"
            if self.cfg.num_replicas >= 1:
                name = "mesh_" + name
            self._traced[name].note(tuple(keys))
        return loss, acc, grads

    def _dispatch_step(self, parts: list):
        """Enqueue one optimizer step over ``parts``: the gradients of
        ``_step_grads``, then one update. Returns the step's device values
        ``(loss, acc, finite)``; ``finite`` is None unless ``skip_nonfinite``
        is on."""
        loss, acc, grads = self._step_grads(parts)
        if not self.cfg.skip_nonfinite:
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params
            )
            return loss, acc, None
        # the guarded step: one isfinite reduction on the device over the
        # (averaged) gradient, any replica's NaN poisoning it, and the
        # update kept or dropped by a select, with no host round trip
        with torch.no_grad():
            finite = torch.isfinite(loss)
            for g in grads:
                finite = finite & torch.isfinite(g).all()
            old = [t.clone() for t in self._opt_tensors()]
            self.params, self.opt_state = self.opt.update(
                grads, self.opt_state, self.params
            )
            for t, o in zip(self._opt_tensors(), old):
                t.copy_(torch.where(finite, t, o))
        return loss, acc, finite

    def _opt_tensors(self) -> list:
        """The params and the optimizer's slot tensors (updated in place)."""
        slots = self.opt_state.slots
        if isinstance(slots, dict):
            slots = [t for v in slots.values() for t in v]
        return [*self.params, *slots]

    def _sync_step(self, loss, acc, finite, step_before: int):
        """The step's one sync: one transfer brings both scalars, and the
        finite flag when the guard is on. A skipped step keeps the
        optimizer's step count (its tensors were kept on the device)."""
        vals = [loss.detach(), acc.to(loss.dtype)]
        if finite is not None:
            vals.append(finite.to(loss.dtype))
        out = torch.stack(vals).tolist()
        if finite is not None and not out[2]:
            self.opt_state = self.opt_state._replace(step=step_before)
            self.nonfinite_skips += 1
            self.obs.count("fault/nonfinite_skips", 1)
            self.obs.instant(
                "fault/nonfinite_skip",
                {"step": self.global_step, "loss": repr(out[0])},
            )
            log.warning(
                "non-finite loss/gradients at step %d — optimizer update "
                "skipped (loss=%r)", self.global_step, out[0],
            )
        return out[0], out[1]

    def _step(self, parts: list):
        """Stage and take one optimizer step over ``parts`` inside the
        ``step`` span; returns ``(loss, acc, t_stage, t_device)`` on the
        host."""
        step_before = self.opt_state.step
        with self.obs.span("step/stage") as sp_stage:
            loss, acc, finite = self._dispatch_step(parts)
        with self.obs.span("step/device") as sp_dev:
            loss, acc = self._sync_step(loss, acc, finite, step_before)
        self.global_step += 1
        return loss, acc, sp_stage.duration, sp_dev.duration

    def _iter_stats(self, parts, loss, acc, t_sample, t_split, t_load,
                    t_stage, t_device, t_wait=0.0) -> IterStats:
        """One step's ``IterStats`` over its parts (one on the 1-D path).
        The work counters (loaded rows, edges, shuffle rows, padded slots,
        wire bytes, the load breakdown) are summed over the parts, the real
        work of the global batch; ``busiest_edges`` is the max (all R*P
        splits run at once, so the busiest is the critical path); the
        balance ratios are means."""
        plans = [p.plan for p in parts]
        # one pass over each part's edge masks for the four split counters
        acct = [plan.edge_accounting() for plan in plans]
        breakdowns = [p.breakdown for p in parts]
        breakdown = None
        if all(b is not None for b in breakdowns):
            breakdown = LoadBreakdown(
                local_hit=sum(b.local_hit for b in breakdowns),
                remote_hit=sum(b.remote_hit for b in breakdowns),
                host_miss=sum(b.host_miss for b in breakdowns),
            )
        st = IterStats(
            loss=loss,
            accuracy=acc,
            t_sample=t_sample,
            t_split=t_split,
            t_load=t_load,
            t_compute=t_stage + t_device,
            loaded_rows=sum(p.loaded_feature_rows() for p in plans),
            computed_edges=sum(a[0] for a in acct),
            shuffle_rows=sum(p.shuffle_rows() for p in plans),
            t_wait=t_wait,
            t_stage=t_stage,
            t_device=t_device,
            load_breakdown=breakdown,
            wire_bytes=sum(modeled_wire_bytes(p, self.spec, self.cfg.wire_dtype)
                           for p in plans),
            padded_edge_slots=sum(p.padded_edge_slots() for p in plans),
            busiest_edges=max(a[1] for a in acct),
            load_imbalance=float(np.mean([a[2] for a in acct])),
            cross_edge_fraction=float(np.mean([a[3] for a in acct])),
        )
        self._emit_iter_metrics(st)
        return st

    def _emit_iter_metrics(self, st: IterStats) -> None:
        """Fold one step's IterStats into the metrics registry (no-op when
        obs is off), so a written trace is self-contained."""
        obs = self.obs
        if not obs.enabled:
            return
        obs.observe("step/compute_s", st.t_compute)
        obs.count("wire/bytes", st.wire_bytes)
        obs.count("plan/loaded_rows", st.loaded_rows)
        obs.count("plan/shuffle_rows", st.shuffle_rows)
        if st.load_breakdown is not None:
            obs.count("cache/local_hit", st.load_breakdown.local_hit)
            obs.count("cache/remote_hit", st.load_breakdown.remote_hit)
            obs.count("cache/host_miss", st.load_breakdown.host_miss)

    def train_iter(self, targets: np.ndarray) -> IterStats:
        """One step on ``targets`` with the streamed sampler RNG (draws in
        call order), like the JAX ``Trainer.train_iter``. On the mesh the R
        replica chunks (``[targets]`` for R == 1) draw from the shared
        generator in replica order, as ``sample_micro`` does for dp; two
        repad passes against the shared marks leave the R plans of one
        shape (the delivery side's discipline, ``plan_source.finalize``)."""
        cfg = self.cfg
        R = cfg.num_replicas
        with self.obs.span("plan/sample") as sp_sample:
            if cfg.mode != "split":
                samples = [self.sampler.sample_micro(targets, cfg.num_devices)]
            else:
                chunks = [targets] if R <= 1 else np.array_split(targets, R)
                samples = [self.sampler.sample(c) for c in chunks]
        passes = 2 if R >= 1 else 1
        with self.obs.span("plan/split") as sp_split:
            if cfg.mode != "split":
                plans = [build_dp_plan(samples[0], pad_multiple=cfg.pad_multiple,
                                       with_halves=cfg.shuffle_overlap)]
            else:
                plans = [
                    build_split_plan(
                        s, self.partition.assignment, cfg.num_devices,
                        pad_multiple=cfg.pad_multiple,
                        with_halves=cfg.shuffle_overlap,
                        replication=self.replication,
                    )
                    for s in samples
                ]
            before = dict(self._pad_hwm)
            for _ in range(passes):
                for plan in plans:
                    repad_plan(plan, self._pad_hwm)
        note_hwm_growth(self.obs, before, self._pad_hwm, "train_iter")
        with self.obs.span("plan/load") as sp_load:
            parts = []
            for plan in plans:
                cache_plan, feats, breakdown = stage_host_features(
                    plan, self.ds.features, self.cache,
                    serve_cache=self.cache_block is not None,
                    pad_multiple=cfg.pad_multiple, pin=self.producer.pin,
                )
                parts.append(PlanBatch(
                    index=0, epoch=0, plan=plan, feats=feats,
                    labels=load_labels(plan, self.ds.labels), t_sample=0.0,
                    t_split=0.0, t_load=0.0, breakdown=breakdown,
                    cache_plan=cache_plan,
                ))
            # cache widths follow the same marks as the plans, settled over
            # all R parts
            for _ in range(passes):
                for part in parts:
                    if part.cache_plan is not None:
                        finalize_cache_plan(part.cache_plan, self._pad_hwm,
                                            part.plan.front_ids[-1].shape[1])
        with self.obs.span("step", {"wait_s": 0.0}) as step_sp:
            loss, acc, t_stage, t_device = self._step(parts)
            step_sp.attrs.update(stage_s=t_stage, device_s=t_device)
        if self.recompiles is not None:
            self.recompiles.step("train_iter")
        return self._iter_stats(parts, loss, acc, sp_sample.duration,
                                sp_split.duration, sp_load.duration,
                                t_stage, t_device)

    def plan_source_for(self, epoch: int, max_iters: int | None = None,
                        start: int = 0):
        """The configured plan source over ``epoch``'s batches (the first
        ``max_iters``, from ``start`` on: every delivered batch keeps its
        global index for its draws), delivering into the trainer's
        high-water marks, with the retry policy and the stall watchdog."""
        batches = self.sampler.epoch_targets(epoch)
        if max_iters is not None:
            batches = batches[:max_iters]
        batches = batches[start:]
        retry = None
        if self.cfg.plan_retries > 0:
            retry = RetryPolicy(
                retries=self.cfg.plan_retries,
                backoff_s=self.cfg.plan_retry_backoff_s,
            )
        return make_plan_source(
            self.cfg.plan_source, self.producer, epoch, batches,
            self._pad_hwm, self.sig_cache,
            depth=self.cfg.pipeline_depth,
            workers=self.cfg.plan_workers,
            sig_extra=(self.cfg.wire_dtype, self.cfg.shuffle_chunks,
                       self.cfg.shuffle_overlap),
            obs=self.obs,
            start=start,
            retry=retry,
            stall_timeout_s=self.cfg.stall_timeout_s,
        )

    def train_epoch(self, max_iters: int | None = None) -> EpochStats:
        """One epoch through the configured plan source: batches keyed by
        ``(seed, epoch, index)``, repadded at delivery. With a pipelined
        source the producers build ahead behind a bounded queue and the
        consumer pays only its wait, the staging and the step. With
        ``ckpt_dir`` and ``ckpt_every`` a checkpoint is written every
        ``ckpt_every`` optimizer steps, naming the next batch."""
        # mid-epoch resume: the cursor's batch offset applies to exactly one
        # epoch (the one the checkpoint was taken in), then clears
        start, self._start_iter = self._start_iter, 0
        source = self.plan_source_for(self._epoch, max_iters, start=start)
        n_batches = start + len(source.batches)  # this epoch's global count
        stats = EpochStats()
        mark = self.recompiles.mark() if self.recompiles is not None else None
        t_epoch = time.perf_counter()
        try:
            it = iter(source)
            while True:
                # time blocked on the source: the producer-bound part of the
                # step (a serial source builds the whole batch here)
                with self.obs.span("step/wait") as sp_wait:
                    batch = next(it, None)
                if batch is None:
                    break
                with self.obs.span(
                    "step", {"epoch": batch.epoch, "batch": batch.index}
                ) as step_sp:
                    # close the flow arrow from this plan's producer span
                    self.obs.flow_end(("plan", batch.epoch, batch.index))
                    parts = (batch.parts if isinstance(batch, MeshPlanBatch)
                             else [batch])
                    loss, acc, t_stage, t_device = self._step(parts)
                    step_sp.attrs.update(
                        wait_s=sp_wait.duration, stage_s=t_stage,
                        device_s=t_device,
                    )
                stats.iters.append(self._iter_stats(
                    parts, loss, acc, batch.t_sample, batch.t_split,
                    batch.t_load, t_stage, t_device, sp_wait.duration,
                ))
                cfg = self.cfg
                if (cfg.ckpt_dir and cfg.ckpt_every > 0
                        and self.global_step % cfg.ckpt_every == 0):
                    next_batch = batch.index + 1
                    epoch, next_batch = (
                        (self._epoch + 1, 0) if next_batch >= n_batches
                        else (self._epoch, next_batch)
                    )
                    self.save_checkpoint(epoch=epoch, next_batch=next_batch)
                if self.recompiles is not None:
                    self.recompiles.step(f"epoch{self._epoch}")
                if stats.t_first_iter == 0.0:
                    stats.t_first_iter = time.perf_counter() - t_epoch
        finally:
            source.close()
        if mark is not None:
            stats.recompiles = self.recompiles.since(mark)
            self.obs.count("recompile/misses", stats.recompiles["misses"])
        stats.pipeline = source.stats()
        stats.t_wall = time.perf_counter() - t_epoch
        if self.obs.enabled:
            self.obs.absorb(stats.pipeline, prefix="source/")
            if self.cfg.obs_path:
                self.obs.write(self.cfg.obs_path)
        self._epoch += 1
        return stats

    # ------------------------------------------------------------------ #
    def _param_tree(self) -> list[dict]:
        """The parameters as the reference's tree, ``[{name: tensor}]`` a
        layer, named by ``model.named_parameters()`` (``layers.<i>.<name>``):
        the checkpoint keys are ``params/<i>/<name>``."""
        tree: list[dict] = [{} for _ in self.model.layers]
        for qual, p in self.model.named_parameters():
            _, i, name = qual.split(".")
            tree[int(i)][name] = p
        return tree

    def _opt_tree(self):
        """The optimizer state as the reference's tree: the step as an int32
        scalar (``opt/0``) and each slot list as a per-layer tree like the
        parameters' (``opt/1/m/<i>/<name>``; SGD has no slots). The slot
        tensors are the live ones, the i-th slot belonging to
        ``self.params[i]``."""
        slots = self.opt_state.slots
        if isinstance(slots, dict):
            index = {id(p): i for i, p in enumerate(self.params)}
            tree = self._param_tree()
            slots = {
                kind: [{name: tensors[index[id(p)]] for name, p in layer.items()}
                       for layer in tree]
                for kind, tensors in slots.items()
            }
        return opt_lib.OptimizerState(np.int32(self.opt_state.step), slots)

    def save_checkpoint(
        self,
        root: str | None = None,
        epoch: int | None = None,
        next_batch: int = 0,
    ) -> str:
        """Write one crash-consistent checkpoint (params + optimizer state +
        the full resume cursor) under ``root``/``cfg.ckpt_dir``.

        The cursor pins everything a bit-exact mid-epoch resume needs: the
        (epoch, batch) coordinate of the *next* batch, the global step, the
        seed, the padding high-water marks, the device sampler's capacity
        table (device sources), and the telemetry counters (as aux arrays).
        ``train_epoch`` calls this every ``ckpt_every`` steps, after the
        step's sync; it is also safe to call between epochs.
        """
        root = root if root is not None else self.cfg.ckpt_dir
        if not root:
            raise ValueError("no checkpoint directory (cfg.ckpt_dir unset)")
        cursor = {
            "epoch": int(self._epoch if epoch is None else epoch),
            "batch": int(next_batch),
            "global_step": int(self.global_step),
            "seed": int(self.cfg.seed),
            "hwm": {k: int(v) for k, v in self._pad_hwm.items()},
            "nonfinite_skips": int(self.nonfinite_skips),
            "sampler": (
                self.device_sampler.export_state()
                if self.device_sampler is not None
                else None
            ),
        }
        aux = {}
        if self.telemetry is not None:
            c = self.telemetry.counters()
            aux = {
                "telemetry_k_v": c["k_v"],
                "telemetry_k_e": c["k_e"],
                "telemetry_num_batches": np.asarray(c["num_batches"]),
            }
        path = os.path.join(root, checkpoint_name(self.global_step))
        _save_checkpoint(
            path, self._param_tree(), self.global_step,
            opt_state=self._opt_tree(), cursor=cursor, aux_arrays=aux,
        )
        self.obs.count("fault/checkpoints_written", 1)
        return path

    def resume(self, root: str | None = None):
        """Restore the newest valid checkpoint under ``root``/``cfg.ckpt_dir``.

        Rebuilds the mid-run state the cursor pinned — params, optimizer
        state, epoch/batch position, padding marks, sampler caps, telemetry
        counters — so the continued trajectory is bit-for-bit the
        uninterrupted one. The arrays are copied into the existing parameter
        and slot tensors on ``self.device``. Corrupt newest checkpoints are
        skipped with a warning (previous-good fallback). Returns the loaded
        ``Checkpoint``, or None when the directory holds no checkpoint at
        all (fresh start).
        """
        root = root if root is not None else self.cfg.ckpt_dir
        if not root:
            raise ValueError("no checkpoint directory (cfg.ckpt_dir unset)")
        params_like, opt_like = self._param_tree(), self._opt_tree()
        ck = load_latest_checkpoint(root, params_like, opt_like)
        if ck is None:
            return None
        cur = ck.cursor
        if "seed" in cur and int(cur["seed"]) != self.cfg.seed:
            log.warning(
                "resuming with seed %d but checkpoint was written with seed "
                "%d — the continued trajectory will NOT match the original",
                self.cfg.seed, int(cur["seed"]),
            )
        trees = [(params_like, ck.params)]
        if isinstance(opt_like.slots, dict):
            trees += [(opt_like.slots[k], ck.opt_state.slots[k])
                      for k in opt_like.slots]
        with torch.no_grad():
            for live_tree, saved_tree in trees:
                for live, saved in zip(live_tree, saved_tree, strict=True):
                    for name, t in live.items():
                        t.copy_(torch.from_numpy(saved[name]))
        self.opt_state = self.opt_state._replace(step=int(ck.opt_state.step))
        self.global_step = int(cur.get("global_step", ck.step))
        self._epoch = int(cur.get("epoch", 0))
        self._start_iter = int(cur.get("batch", 0))
        self.nonfinite_skips = int(cur.get("nonfinite_skips", 0))
        # cleared and refilled in place: the producer holds this dict
        self._pad_hwm.clear()
        self._pad_hwm.update(
            {k: int(v) for k, v in cur.get("hwm", {}).items()}
        )
        if self.device_sampler is not None and cur.get("sampler"):
            self.device_sampler.load_state(cur["sampler"])
        if self.telemetry is not None and "telemetry_k_v" in ck.aux:
            self.telemetry.load_counters({
                "k_v": ck.aux["telemetry_k_v"],
                "k_e": ck.aux["telemetry_k_e"],
                "num_batches": int(ck.aux["telemetry_num_batches"]),
            })
        self.obs.count("fault/resumes", 1)
        log.info(
            "resumed from %s at step %d (epoch %d, batch %d)",
            ck.path, self.global_step, self._epoch, self._start_iter,
        )
        return ck

    def refine_partition(self):
        """Telemetry-driven partition refinement (method="telemetry"), the
        JAX ``Trainer.refine_partition``.

        Call between epochs (no producer running) with
        ``record_telemetry=True``: the per-edge appearance rates of the
        recorded training batches replace the presample estimates, the
        boundary refinement re-runs from the current assignment, and the
        replication set is selected anew under ``cfg.replication_budget``.
        The producer, the resident block and the device sampler
        (whose shards are uploaded anew) follow the new partition; the
        padding high-water marks are kept. Returns the new ``Partition``.
        """
        if self.partition is None:
            raise ValueError("refine_partition needs mode='split'")
        if self.telemetry is None:
            raise ValueError(
                "refine_partition needs record_telemetry=True (no telemetry "
                "was collected)"
            )
        self.partition = _refine_partition(
            self.ds.graph, self.partition, self.telemetry.as_weights(),
            replication_budget=self.cfg.replication_budget,
        )
        self._set_replication()
        self.producer.assignment = self.partition.assignment
        self.producer.replication = self.replication
        if self.device_sampler is not None:
            self.device_sampler = self._make_device_sampler()
            self.producer.device_sampler = self.device_sampler
        return self.partition
