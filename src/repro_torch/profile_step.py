"""Where one training step's time goes on the card: ``torch.profiler`` over
steady steps of the main path.

    PYTHONPATH=src python -m repro_torch.profile_step [--model sage] [--steps 2]
        [--plan-source serial|pipelined|device|device_pipelined] [--shapes]
        [--overlap-chunks K] [--cache-mode partitioned|distributed]
        [--cache-capacity C] [--dataset papers-s|tiny]

Builds the papers-s trainer of ``chip_smoke.py``'s main path (SAGE 128 ->
256 -> 256 -> 16, fan-outs 15,15,15, batch 1024, P=4, presample cut to 2
epochs; ``--dataset tiny``: 2 layers, hidden 32, fan-outs 4,4, batch 16) on
the chosen plan source (``device*``: sampling on the card; ``*pipelined``:
producer threads build ahead), with the overlap schedule at K chunks
(``--overlap-chunks``, 0 = blocking) and the feature cache at C rows a split
(``--cache-mode``, ``--cache-capacity``), takes one warm-up epoch of one
step, then profiles an epoch of ``--steps`` steps with CPU and CUDA
activities (a pipelined epoch starts with its pipeline filling). Prints the
top operators by device time, then one JSON line: the host wall time of the
profiled steps, the device time summed over kernels and copies, the device
idle share over the window (one less the union of the device's kernel, copy
and memset intervals over the wall: work that overlaps counts once), a
step's top-level torch calls and device operations (kernels, copies,
memsets), the device time of torch's indexing adjoint
(``indexing_backward_kernel``) and of the port's shuffle adjoint
(``shuffle_bwd``), the host-to-device copies of the window by kind
(``pageable`` or ``pinned``: count and device ms), and each step's wait,
staging and sync times, the phases of its staging (pack, forward, backward,
optimizer), its accounting and the bytes its staging copies carried.
``--shapes`` records input
shapes (at some host cost) and splits the indexing adjoints' device time by
the shapes of their ``index_put`` calls, which tells the shuffle's (values
(P, P, S, F)) from the other gathers'. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.graph.datasets import make_dataset
from repro_torch.models.gnn import GNNSpec
from repro_torch.train.trainer import TrainConfig, Trainer


def index_put_by_shape(prof) -> list:
    """[input shapes, calls, device ms] of the outermost ``index_put`` calls
    (the adjoint of an advanced-index gather), grouped by input shapes,
    largest device time first."""
    groups: dict = {}
    for e in prof.events():
        if "index_put" not in e.name:
            continue
        parent = e.cpu_parent
        while parent is not None and "index_put" not in parent.name:
            parent = parent.cpu_parent
        if parent is not None:
            continue
        key = f"{e.name} {e.input_shapes}"
        calls, us = groups.get(key, (0, 0.0))
        groups[key] = (calls + 1, us + e.device_time_total)
    return sorted(([k, c, us / 1e3] for k, (c, us) in groups.items()),
                  key=lambda row: -row[2])


def h2d_copies(events) -> dict:
    """Host-to-device copies in ``key_averages()`` rows, by the kind of host
    memory: ``{kind: {"count", "device_ms"}}`` (kinds ``pageable`` and
    ``pinned``, from the profiler's ``Memcpy HtoD (... -> Device)`` names)."""
    out = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if not e.key.startswith("Memcpy HtoD"):
            continue
        kind = ("pinned" if "Pinned" in e.key
                else "pageable" if "Pageable" in e.key else e.key)
        row = out.setdefault(kind, {"count": 0, "device_ms": 0.0})
        row["count"] += e.count
        row["device_ms"] += e.self_device_time_total / 1e3
    return out


#: the trace categories of the device's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_us(prof) -> float:
    """The union of the device's kernel, copy and memset intervals in the
    profile (us), read from its Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="sage", choices=("sage", "gcn", "gat"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--plan-source", default="serial",
                    choices=("serial", "pipelined", "device", "device_pipelined"))
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--overlap-chunks", type=int, default=0)
    ap.add_argument("--cache-mode", default="none",
                    choices=("none", "partitioned", "distributed"))
    ap.add_argument("--cache-capacity", type=int, default=0)
    ap.add_argument("--dataset", default="papers-s", choices=("papers-s", "tiny"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    ds = make_dataset(args.dataset)
    if args.dataset == "tiny":
        fanouts, batch = (4, 4), 16
        spec = GNNSpec(model=args.model, in_dim=ds.spec.feat_dim, hidden_dim=32,
                       out_dim=ds.spec.num_classes, num_layers=2, num_heads=4)
    else:
        fanouts, batch = (15, 15, 15), 1024
        spec = GNNSpec(model=args.model)
    cfg = TrainConfig(num_devices=4, fanouts=fanouts, batch_size=batch,
                      presample_epochs=2, plan_source=args.plan_source,
                      shuffle_overlap=args.overlap_chunks > 0,
                      shuffle_chunks=max(args.overlap_chunks, 1),
                      cache_mode=args.cache_mode,
                      cache_capacity_per_device=args.cache_capacity)
    tr = Trainer(ds, spec, cfg)
    tr.train_epoch(max_iters=1)  # warm-up: library init, allocator growth
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=args.shapes) as prof:
        t0 = time.perf_counter()
        stats = tr.train_epoch(max_iters=args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    # device rows only (kernels, copies): an operator's row repeats the time
    # of the kernels it launched
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us = device_busy_us(prof)
    # top-level torch calls on the host, and what the card ran: kernels,
    # copies and memsets
    calls = sum(1 for e in prof.events() if e.cpu_parent is None
                and e.device_type == torch.autograd.DeviceType.CPU)
    device_ops = sum(e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)

    def kernel_ms(part):
        return sum(e.self_device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and part in e.key) / 1e3
    print(json.dumps({"profile": {
        "model": args.model,
        "plan_source": args.plan_source,
        "dataset": args.dataset,
        "overlap_chunks": args.overlap_chunks,
        "cache_mode": args.cache_mode,
        "cache_capacity": args.cache_capacity,
        "resident_bytes": (0 if tr.cache_block is None
                           else tr.cache_block.numel() * 4),
        "steps": len(stats.iters),
        "wall_ms": 1e3 * wall,
        "device_ms": device_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "host_stage_ms": 1e3 * sum(
            i.t_sample + i.t_split + i.t_load for i in stats.iters
        ),
        "compute_ms": 1e3 * sum(i.t_compute for i in stats.iters),
        "torch_calls_per_step": calls / max(len(stats.iters), 1),
        "device_ops_per_step": device_ops / max(len(stats.iters), 1),
        "indexing_backward_ms": kernel_ms("indexing_backward"),
        "shuffle_bwd_ms": kernel_ms("shuffle_bwd"),
        "h2d_copies": h2d_copies(events),
        "wait_ms": [1e3 * i.t_wait for i in stats.iters],
        "stage_ms": [1e3 * i.t_stage for i in stats.iters],
        **{f"{k}_ms": [1e3 * getattr(i, f"t_{k}") for i in stats.iters]
           for k in ("pack", "forward", "backward", "optimizer", "stats")},
        "h2d_bytes": [i.h2d_bytes for i in stats.iters],
        "device_sync_ms": [1e3 * i.t_device for i in stats.iters],
        "device": torch.cuda.get_device_name(0),
    }}))
    if args.shapes:
        print(json.dumps({"index_put_by_shape": index_put_by_shape(prof)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
