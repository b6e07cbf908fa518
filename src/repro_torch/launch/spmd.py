"""Split parallelism in spmd form over ``torch.distributed``: what
``shard_map`` gives the JAX package, stated in torch.

One process runs one split (one (replica, split) pair on the 2-D mesh of
``sharding.make_split_mesh``). ``launch`` spawns the ranks with
``torch.multiprocessing`` and meets them at a ``FileStore`` in a temporary
directory (no network port); each rank runs on the card (NCCL,
``cuda:<rank>``) unless the caller asks for ``device="cpu"``, which selects
gloo. Every process group has a timeout, the launcher joins all ranks
within its own, and a rank's exception fails the launcher: a collective
that one rank never reaches cannot hang the caller.

``SpmdTrainer`` is one rank's ``Trainer``. Every rank builds the same
delivered batch from the same seed with the trainer's plan source (the host
stages are deterministic), then one step (``spmd_step_grads``):

  1. stage only the rank's slice of its replica's part (``stage_split``),
  2. ``gnn_forward_spmd`` over its split group,
  3. the masked cross-entropy over the *global* valid-target count (an
     ``all_reduce`` of the count over the split group, outside autograd),
  4. the backward (each exchange's adjoint is the exchange of the
     cotangent),
  5. an ``all_reduce`` of the parameter gradients over the split group:
     each rank holds only the terms of the ops it ran (``shard_map``'s
     transpose of a replicated input makes this psum implicitly),
  6. ``replica_grad_mean`` over the replica group on a mesh with R > 1,
  7. the trainer's own optimizer update, the same on every rank.

``train_rank`` and ``sample_rank`` are rank functions for ``launch``: a
training run, and the spmd sampler's raw blocks. A rank function must be
importable by the spawned ranks, so that it pickles.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.shuffle import all_reduce_sum, replica_grad_mean
from repro_torch.graph.datasets import make_dataset
from repro_torch.launch.sharding import (
    make_split_mesh,
    sampler_shard_slice,
    split_slice,
)
from repro_torch.models.gnn.layers import gnn_forward_spmd
from repro_torch.sampler.engine import sample_minibatch_spmd, spmd_overflow
from repro_torch.sampler.engine import to_host
from repro_torch.sampler.shard import shards_to_device
from repro_torch.train.loss import masked_softmax_xent
from repro_torch.train.plan_io import batch_fields, stage_fields, staged_rows
from repro_torch.train.trainer import Trainer

#: the launcher's default limit for a whole run of ranks, and each process
#: group's limit for one collective
TIMEOUT_S = 300.0


def _rank_main(rank, world, rdv, out_dir, on_cpu, tasks, timeout_s):
    """One spawned rank: join the process group, run ``tasks`` in order,
    write their results for the launcher."""
    torch.set_num_threads(1)  # several ranks share the host's cores
    if on_cpu:
        device, backend, kw = torch.device("cpu"), "gloo", {}
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        # bound to its card, NCCL sets up its communicator here, so a
        # failing NCCL fails the rank at once
        backend, kw = "nccl", {"device_id": device}
    dist.init_process_group(
        backend, store=dist.FileStore(rdv, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=timeout_s), **kw,
    )
    try:
        results = [fn(device, *args) for fn, args in tasks]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def launch(tasks: list, world: int, device=None,
           timeout_s: float = TIMEOUT_S) -> list:
    """Run ``tasks``, a list of ``(fn, args)`` with ``fn`` importable, in
    ``world`` spawned ranks of one process group; rank ``r`` calls
    ``fn(device, *args)`` for each task in order. Returns ``results[rank]``,
    the list of its tasks' return values (host data).

    ``device=None`` is the card: NCCL, one card a rank. ``device="cpu"``
    runs gloo on the CPU. The ranks meet at a ``FileStore`` in a temporary
    directory. Each collective waits at most ``timeout_s``, and so does the
    launcher for the whole run: past it every rank is terminated and
    ``TimeoutError`` raised; a rank that raises fails the launcher, which
    stops the others."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: spmd ranks run on the card unless "
                "the caller asks for the CPU (device='cpu')"
            )
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} ranks need {world} cards (NCCL takes one card a "
                f"rank), this machine has {torch.cuda.device_count()}"
            )
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(world, os.path.join(tmp, "rdv"), tmp, on_cpu, tasks,
                  timeout_s),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} spmd ranks did not finish in {timeout_s} s"
                    )
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def stage_split(part, mesh, device, with_halves: bool = False,
                num_replicated: int = 0) -> tuple:
    """The rank's slice of one delivered ``PlanBatch`` on ``device``:
    ``stage_batch``'s ``(feats, plan dict, labels)`` for its split only
    (leading axis 1), by the same two pinned copies on a card."""
    fields = batch_fields(part.plan, part.labels, part.cache_plan, with_halves,
                          num_replicated)
    return stage_fields(
        [(place, key, split_slice(a, mesh)) for place, key, a in fields],
        split_slice(part.feats, mesh), staged_rows(part.plan, part.cache_plan),
        device, part.plan.num_layers,
    )


def spmd_step_grads(spec, model, mesh, part, device, cache_local=None,
                    rep_block=None, with_halves: bool = False):
    """One rank's share of a step on its replica's ``part``: stage its
    slice, run ``gnn_forward_spmd``, and return ``(logits, loss, acc,
    grads)``. ``logits`` are the rank's (1, N_0, C); ``loss`` and ``acc``
    the global batch's (summed over the split group, averaged over
    replicas), and ``grads`` the full gradients of ``model.parameters()``,
    the same on every rank. ``cache_local`` (the rank's resident block)
    serves the input when the part carries a cache plan."""
    num_replicated = 0 if rep_block is None else rep_block.shape[0]
    feats, pa, labels = stage_split(part, mesh, device, with_halves,
                                    num_replicated)
    if part.cache_plan is None:
        cache_local = None
    elif cache_local is None:
        raise ValueError("a batch with a cache plan needs the rank's resident "
                         "block (cache_local): its feats are the miss rows")
    logits = gnn_forward_spmd(spec, list(model.layers), feats, pa,
                              mesh.split_group, cache_local=cache_local,
                              rep_block=rep_block)
    mask = pa["target_mask"]
    with torch.no_grad():
        correct = (logits.argmax(dim=-1) == labels.long()) & mask
        counts = torch.stack([mask.sum(), correct.sum()])
        dist.all_reduce(counts, group=mesh.split_group)
    # every rank divides by the batch's count, so the ranks' losses (and
    # gradients) sum to the batch's
    loss = masked_softmax_xent(logits, labels, mask, count=counts[0])
    acc = counts[1] / counts[0].clamp(min=1)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    *grads, loss = all_reduce_sum([*grads, loss.detach()], mesh.split_group)
    *grads, loss, acc = replica_grad_mean([*grads, loss, acc],
                                          mesh.replica_group,
                                          mesh.num_replicas)
    return logits, loss, acc, grads


class SpmdTrainer(Trainer):
    """One rank's trainer in the spmd form of split parallelism (split mode
    only; no checkpointing yet).

    It is the ``Trainer`` of ``(dataset, spec, cfg)``: the same plan source,
    parameter initialization (from ``cfg.seed``, the same on every rank)
    and optimizer, whose update every rank applies to the same all-reduced
    gradients. ``mesh`` must be ``max(cfg.num_replicas, 1)`` x
    ``cfg.num_devices``. Only the step's gradients differ
    (``spmd_step_grads`` on the rank's split of its replica's part); the
    step's counters (``IterStats``) are the global batch's, as on the sim
    path. With a serving cache the rank reads its split of the resident
    block.
    """

    def __init__(self, dataset, spec, cfg, mesh, device=None, model=None):
        if cfg.mode != "split":
            raise ValueError(
                f"the spmd step runs mode='split' only, got {cfg.mode!r}")
        if cfg.ckpt_dir:
            raise ValueError("checkpointing is not ported to the spmd step")
        if (mesh.num_replicas, mesh.num_splits) != (max(cfg.num_replicas, 1),
                                                    cfg.num_devices):
            raise ValueError(
                f"mesh {mesh.num_replicas} x {mesh.num_splits} for a config "
                f"of R={cfg.num_replicas}, P={cfg.num_devices}"
            )
        super().__init__(dataset, spec, cfg, device=device, model=model)
        self.mesh = mesh
        self.cache_local = (None if self.cache_block is None
                            else split_slice(self.cache_block, mesh))

    def _step_grads(self, parts: list):
        if len(parts) != self.mesh.num_replicas:
            raise ValueError(
                f"{len(parts)} replica parts for a mesh of "
                f"{self.mesh.num_replicas}"
            )
        _, loss, acc, grads = spmd_step_grads(
            self.spec, self.model, self.mesh, parts[self.mesh.replica],
            self.device, self.cache_local, self.rep_block,
            with_halves=self.cfg.shuffle_overlap,
        )
        return loss, acc, grads


# ---------------------------------------------------------------------- #
# rank functions for ``launch``
# ---------------------------------------------------------------------- #
def train_rank(device, dataset, spec, cfg, epochs: int = 1,
               max_iters: int | None = None, model=None) -> dict:
    """Train ``epochs`` epochs of ``max_iters`` steps on this rank
    (``dataset`` a ``GraphDataset`` or a name for ``make_dataset``; ``model``
    an initial ``GNN`` for every rank, else the trainer's own). Returns the
    steps' losses and accuracies, each step's wait + stage + sync seconds,
    and the final parameters."""
    if isinstance(dataset, str):
        dataset = make_dataset(dataset)
    mesh = make_split_mesh(max(cfg.num_replicas, 1), cfg.num_devices)
    tr = SpmdTrainer(dataset, spec, cfg, mesh, device=device, model=model)
    iters = [it for _ in range(epochs)
             for it in tr.train_epoch(max_iters=max_iters).iters]
    return {
        "losses": [it.loss for it in iters],
        "accuracy": [it.accuracy for it in iters],
        "step_s": [it.t_wait + it.t_stage + it.t_device for it in iters],
        "params": [p.detach().cpu().numpy() for p in tr.params],
    }


def sample_rank(device, num_splits: int, cases: list) -> list:
    """Per case, this rank's ``sample_minibatch_spmd`` blocks (``to_host``'s
    ``(fronts, counts, layers, flags)``, its own flags) and the caps that
    overflowed on any rank (``spmd_overflow``). A case is a dict with
    ``shards`` (the ``GraphShards``), ``targets`` (B,) int32 zero-padded,
    ``n_targets``, ``layer_keys`` (L, 2), ``fanouts`` and ``caps``: one
    ``(name, size)`` tuple for every rank, or a list of P (a rank's own caps;
    only the ``X`` caps, which size the exchange, must agree)."""
    mesh = make_split_mesh(1, num_splits)
    out = []
    for case in cases:
        dev = sampler_shard_slice(shards_to_device(case["shards"], device),
                                  mesh)
        caps = case["caps"]
        if isinstance(caps, list):
            caps = caps[mesh.split]
        blocks = sample_minibatch_spmd(
            dev, torch.as_tensor(np.asarray(case["targets"], np.int32),
                                 device=device),
            case["n_targets"],
            torch.as_tensor(np.asarray(case["layer_keys"], np.int64),
                            device=device),
            caps=caps, fanouts=tuple(case["fanouts"]),
            group=mesh.split_group, num_parts=num_splits,
        )
        out.append({"blocks": to_host(blocks),
                    "overflow": spmd_overflow(blocks[3], mesh.split_group)})
    return out
