"""Partitioner ablation (paper §7.3 / Fig. 5): compare Rand / Edge / Node /
GSplit on load balance and communication — the counterpart of
``examples/partition_study.py``.

    python -m repro_torch.partition_study [--dataset papers-s]
    python -m repro_torch.partition_study --device cpu --dataset tiny

The study computes on the host (presample, partition, split plans: numpy),
as the example does. ``--device`` is checked as every entry point of the
port checks it: without a card it raises unless ``--device cpu`` asks for
a machine without one. ``main`` returns what it printed: the lines and
each method's means at full precision.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.partition import partition_graph
from repro_torch.core.presample import presample
from repro_torch.core.splitting import build_split_plan
from repro_torch.graph.datasets import make_dataset
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.train.trainer import resolve_device

METHODS = ("rand", "edge", "node", "gsplit")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="papers-s")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the machine the study is "
                         "for (it computes on the host)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    ds = make_dataset(args.dataset)
    fanouts, batch = [15, 15, 15], 512
    say(f"pre-sampling {args.dataset} (10 epochs)...")
    weights = presample(ds.graph, ds.train_ids, fanouts, batch, num_epochs=10)
    sampler = NeighborSampler(ds.graph, ds.train_ids, fanouts, batch, seed=2)

    say(f"{'method':8s} {'imbalance':>10s} {'cross-edges':>12s} "
        f"{'shuffle rows/iter':>18s}")
    results = {}
    for method in METHODS:
        part = partition_graph(
            ds.graph, args.devices, method=method, weights=weights,
            train_ids=ds.train_ids, seed=0,
        )
        imb, cross, shuf = [], [], []
        for i, targets in enumerate(sampler.epoch_batches()):
            if i >= args.iters:
                break
            plan = build_split_plan(
                sampler.sample(targets), part.assignment, args.devices
            )
            imb.append(plan.load_imbalance())
            cross.append(plan.cross_edge_fraction())
            shuf.append(plan.shuffle_rows())
        results[method] = {"imbalance": float(np.mean(imb)),
                           "cross_edges": float(np.mean(cross)),
                           "shuffle_rows": float(np.mean(shuf))}
        say(
            f"{method:8s} {np.mean(imb):10.3f} {np.mean(cross):11.1%} "
            f"{np.mean(shuf):18.0f}"
        )
    say(
        "\nexpected (paper Fig. 5): Rand balanced but ~75% cross; GSplit both "
        "balanced and low-cross; Edge low-cross but imbalanced."
    )
    return {"lines": lines, "methods": results}


if __name__ == "__main__":
    main()
