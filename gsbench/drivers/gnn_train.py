"""Driver ``gnn_train``: a GSplit training cell.

Set-up makes the graph and the weights from the seed, builds the program's
``Trainer`` (its presample and partition included), and builds a ring of
plans with the program's own ``PlanProducer.build`` and ``finalize``,
repadded to the trainer's marks so that every plan of the ring has one
shape. The trainer's ``plan_source_for`` is pointed at a source that
delivers the ring, so ``Trainer.train_epoch`` (the program's epoch loop:
staging, the layer shuffles, the fused aggregation, loss, backward and
Adam) runs over it unchanged. The first three steps are the checked ones:
the first gradient is read from Adam's state after step 1 and the weights'
change after step 3. The rest of the ring warms up, then the window calls
``train_epoch`` over the whole ring until its seconds have passed, under
the host settings of ``gsbench/host.py``.

After the window (and, with ``trace``, a profiled segment of two passes over
the ring) the program is freed and the reference follows the checked steps
from the same graph and weights.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gsbench import host
from gsbench import trace as trace_lib
from gsbench.counts import step as step_counts
from gsbench.data.rmat import make_graph
from gsbench.data.weights import make_weights, reference_model
from gsbench.reference import gnn as reference

#: Adam's first moment decay, as the configuration's optimizer states it
ADAM_B1 = 0.9
CHECKED_STEPS = 3


class RingSource:
    """The plans of one ``train_epoch`` call, taken from the ring in order.
    Has what the trainer reads of a plan source: ``batches``, iteration,
    ``stats`` and ``close``."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        yield from self.batches

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass


class Feeder:
    """Hands the trainer the ring's next plans, whatever epoch it asks for."""

    def __init__(self, ring):
        self.ring = ring
        self.cursor = 0

    def source(self, epoch, max_iters=None, start=0):
        n = len(self.ring) if max_iters is None else max_iters
        plans = [self.ring[(self.cursor + i) % len(self.ring)] for i in range(n)]
        self.cursor = (self.cursor + n) % len(self.ring)
        return RingSource(plans)


def _dataset(cfg, graph):
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.datasets import DatasetSpec, GraphDataset

    spec = DatasetSpec(cfg["name"], num_nodes=graph.num_nodes,
                       avg_degree=cfg["avg_degree"], feat_dim=cfg["feat_dim"],
                       num_classes=cfg["num_classes"],
                       train_fraction=cfg["train_fraction"])
    return GraphDataset(spec=spec, graph=CSRGraph(graph.indptr, graph.indices),
                        features=graph.features, labels=graph.labels,
                        train_ids=graph.train_ids)


def build_trainer(cfg, traffic, graph, weights, seed, device, obs_trace=False):
    from repro_torch.models.gnn.layers import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    spec = GNNSpec(model=cfg["kind"], in_dim=cfg["feat_dim"],
                   hidden_dim=cfg["hidden_dim"], out_dim=cfg["num_classes"],
                   num_layers=cfg["num_layers"],
                   num_heads=cfg.get("num_heads", 4))
    model = GNN(spec).to(device)
    named = dict(model.named_parameters())
    if set(named) != set(weights):
        raise ValueError(f"leaves {sorted(named)} != {sorted(weights)}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
    tc = TrainConfig(
        mode=traffic["mode"], num_devices=traffic["num_devices"],
        fanouts=tuple(traffic["fanouts"]), batch_size=traffic["batch_size"],
        lr=traffic["lr"], optimizer=traffic["optimizer"],
        partition_method=traffic.get("partition_method", "gsplit"),
        presample_epochs=traffic["presample_epochs"],
        pad_multiple=traffic["pad_multiple"], cache_mode=traffic["cache_mode"],
        cache_capacity_per_device=traffic["cache_capacity_per_device"],
        cache_serve=traffic["cache_serve"], wire_dtype=traffic["wire_dtype"],
        obs_trace=obs_trace, seed=seed,
    )
    return Trainer(_dataset(cfg, graph), spec, tc, device=device, model=model)


def ring_keys(trainer, size: int) -> list:
    """(epoch, index, targets) of the first ``size`` batches in the
    program's seeded batch order, across epochs where one is shorter."""
    keys, epoch = [], 0
    while len(keys) < size:
        batches = trainer.sampler.epoch_targets(epoch)
        keys += [(epoch, i, t) for i, t in enumerate(batches)]
        epoch += 1
    return keys[:size]


def build_ring(trainer, keys) -> tuple:
    """The ring's plans, built and delivered by the program's own producer
    and ``finalize``, then finalized again so that every plan is padded to
    the marks the whole ring reached. Returns the plans and each build's
    seconds (sample, split with its repad, load)."""
    from repro_torch.runtime.plan_source import finalize

    cfg = trainer.cfg
    extra = (cfg.wire_dtype, cfg.shuffle_chunks, cfg.shuffle_overlap)
    ring, seconds = [], []
    for epoch, index, targets in keys:
        batch = finalize(trainer.producer.build(epoch, index, targets),
                         trainer._pad_hwm, trainer.sig_cache, extra, trainer.obs)
        seconds.append(batch.t_sample + batch.t_split + batch.t_load)
        ring.append(batch)
    for batch in ring:
        finalize(batch, trainer._pad_hwm, None, extra)
    return ring, seconds


def program_readings(trainer, weights) -> dict:
    """The checked steps through ``train_epoch`` and the ring: each step's
    loss, each leaf's first gradient (Adam's first moment after step 1 over
    1 - b1) and each leaf's change after the last checked step."""
    names = [n for n, _ in trainer.model.named_parameters()]
    losses = [it.loss for it in trainer.train_epoch(max_iters=1).iters]
    with torch.no_grad():
        first = [float((m / (1 - ADAM_B1)).double().norm())
                 for m in trainer.opt_state.slots["m"]]
    losses += [it.loss for it in
               trainer.train_epoch(max_iters=CHECKED_STEPS - 1).iters]
    with torch.no_grad():
        change = [float((p - weights[n]).double().norm())
                  for n, p in zip(names, trainer.params)]
    return {"names": names, "losses": losses, "first_grad": first,
            "change": change}


def compare(prog: dict, ref: dict, detail: bool = False) -> dict:
    """The numbers a check may compare (its cell's limits file names those
    it does): the worst relative gap of a checked step's loss; the worst
    leaf's gap between the program's and the reference's first-gradient
    norms, and the median leaf's; and the worst leaf's gap of the change
    after the checked steps, over the leaves whose reference gradient is
    above a thousandth of the median leaf's (a leaf whose gradient is
    rounding moves under Adam by round-off alone). A leaf's gap is taken
    against its reference norm or the median leaf's, whichever is larger.
    ``detail`` adds each step's and each leaf's gap."""
    ref_at = {n: i for i, n in enumerate(ref["names"])}
    order = [ref_at[n] for n in prog["names"]]
    r_loss = np.asarray(ref["losses"], dtype=np.float64)
    loss_gaps = np.abs(np.asarray(prog["losses"], dtype=np.float64) - r_loss) / np.abs(r_loss)

    def gaps(p_norms, r_norms, keep):
        p_norms = np.asarray(p_norms, dtype=np.float64)
        r_norms = np.asarray(r_norms, dtype=np.float64)[order]
        scale = np.maximum(r_norms, np.median(r_norms[keep]))
        return np.where(keep, np.abs(p_norms - r_norms) / scale, np.nan)

    r_grad = np.asarray(ref["first_grad"], dtype=np.float64)[order]
    every = np.ones(len(order), dtype=bool)
    moving = r_grad > 1e-3 * np.median(r_grad)
    grad = gaps(prog["first_grad"], ref["first_grad"], every)
    change = gaps(prog["change"], ref["change"], moving)
    out = {"loss_gap": float(np.nanmax(loss_gaps)),
           "grad_gap": float(np.nanmax(grad)),
           "change_gap": float(np.nanmax(change)),
           "grad_median_gap": float(np.nanmedian(grad))}
    if detail:
        out["detail"] = {"loss": loss_gaps.tolist(),
                         "grad": dict(zip(prog["names"], grad.tolist())),
                         "change": dict(zip(prog["names"], change.tolist()))}
    return out


def obs_spans(trainer):
    def spans():
        out = []
        for ring in trainer.obs.tracer._snapshot():
            for kind, ev in ring.events:
                if kind == "X" and ev.name.startswith("step"):
                    out.append((ev.name, ev.t0, ev.t1))
        return out
    return spans


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, reference_precision: str = "float32") -> dict:
    """One run of a cell; returns the record the metric readers read and
    the check's numbers (``checks``), against the reference computed in
    ``reference_precision``."""
    device = torch.device(device)
    graph = make_graph(cfg, seed)
    weights = make_weights(cfg, seed, device)
    init = {n: w.clone() for n, w in weights.items()}
    trainer = build_trainer(cfg, traffic, graph, weights, seed, device,
                            obs_trace=trace)
    keys = ring_keys(trainer, traffic["ring"])
    ring, build_s = build_ring(trainer, keys)
    feeder = Feeder(ring)
    trainer.plan_source_for = feeder.source
    prog = program_readings(trainer, weights)
    trainer.train_epoch(max_iters=len(ring) - CHECKED_STEPS)  # the warm-up
    _sync(device)
    quiet = host.Quiet()
    from repro_torch.kernels.build import build_seconds

    rec = {"setup_s": time.perf_counter() - t_start, "build_s": build_s,
           "kernel_build_s": sum(build_seconds.values()),
           "t_presample": trainer.t_presample,
           "t_partition": trainer.t_partition, "model": cfg,
           "traffic": traffic}

    steps = []
    t0 = time.perf_counter()
    while True:
        steps += trainer.train_epoch(max_iters=len(ring)).iters
        if time.perf_counter() - t0 >= seconds:
            break
    rec["window_s"] = time.perf_counter() - t0
    rec["host"] = quiet.close()
    rec["steps"] = steps
    if trace:
        passes = 2

        def segment():
            for _ in range(passes):
                with torch.profiler.record_function("gsbench/train_epoch"):
                    trainer.train_epoch(max_iters=len(ring))

        rec["trace"] = trace_lib.capture(segment, obs_spans(trainer))
        rec["traced_steps"] = passes * len(ring)
        rec["plans"] = [step_counts.summarize(b.plan) for b in ring] * passes
    rec["hwm"] = dict(trainer._pad_hwm)
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    del trainer, ring, feeder, weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference.train_steps(
        reference_model(cfg), init, graph, traffic, seed,
        [(e, i) for e, i, _ in keys[:CHECKED_STEPS]], device,
        precision=reference_precision)
    rec["checks"] = compare(prog, ref, detail=True)
    rec["losses_finite"] = bool(np.all(np.isfinite([s.loss for s in steps])))
    return rec


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
