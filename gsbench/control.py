"""The readings a training cell's check limits are set from, on the card at
the cell's own size (no measured window):

    python3 -m gsbench.control --workload <cell> --seeds 1,2,3 [--program 1] [--faults 1]

For each seed it takes the checked steps of the reference in TF32 (the
control: the nearest precision below the configuration's float32 with TF32
off) and compares them with the reference in the precision the cell's
limits name (float32 unless they say otherwise). With ``--program 1`` it
also builds the cell's trainer and the first plans of its ring as a run
does, and takes the checked steps of the program as it is (the lower
reading) and, with ``--faults 1``, of the program with each fault the cell
can have planted (``gsbench/faults.py``). With ``--repeats N`` the
program's and the reference's checked steps are taken N times, each against
the first reference, which tells the side of a gap that moves from run to
run. One JSON line a seed, with each step's and each leaf's gap.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from gsbench import run


def checked_keys(graph, traffic: dict, seed: int, count: int) -> list:
    """(epoch, index) of the first ``count`` batches of the seeded order."""
    from gsbench.reference import gnn as reference

    keys, epoch = [], 0
    while len(keys) < count:
        batches = reference.epoch_targets(graph.train_ids, traffic["batch_size"],
                                          seed, epoch)
        keys += [(epoch, i) for i in range(len(batches))]
        epoch += 1
    return keys[:count]


def readings(workload: str, seed: int, device="cuda", program: bool = True,
             with_faults: bool = True, repeats: int = 1,
             witness: str | None = None) -> dict:
    import torch

    from gsbench import faults
    from gsbench.data.rmat import make_graph
    from gsbench.data.weights import make_weights, reference_model
    from gsbench.drivers import gnn_train as drv
    from gsbench.reference import gnn as reference

    _, _, cfg, traffic, limits = run.cell(workload)
    precision = limits.get("reference", "float32")
    device = torch.device(device)
    t0 = time.perf_counter()
    graph = make_graph(cfg, seed)
    weights = make_weights(cfg, seed, device)
    init = {n: w.clone() for n, w in weights.items()}
    checked = checked_keys(graph, traffic, seed, drv.CHECKED_STEPS)
    runs, again = {}, []
    if program:
        trainer = drv.build_trainer(cfg, traffic, graph, weights, seed, device)
        keys = drv.ring_keys(trainer, drv.CHECKED_STEPS)
        if [(e, i) for e, i, _ in keys] != checked:
            raise AssertionError(f"the program's batch order {keys} is not {checked}")
        ring, _ = drv.build_ring(trainer, keys)
        feeder = drv.Feeder(ring)
        trainer.plan_source_for = feeder.source

        def steps():
            with torch.no_grad():
                for n, p in trainer.model.named_parameters():
                    p.copy_(init[n])
            trainer.opt_state = trainer.opt.init(trainer.params)
            trainer.global_step = 0
            feeder.cursor = 0
            return drv.program_readings(trainer, init)

        runs["program"] = steps()
        again = [steps() for _ in range(repeats - 1)]
        if with_faults:
            for fault in faults.faults_of(traffic):
                with faults.planted(fault):
                    runs[fault] = steps()
        del trainer, ring, feeder
    setup = time.perf_counter() - t0
    del weights
    gc.collect()
    model = reference_model(cfg)
    ref = reference.train_steps(model, init, graph, traffic, seed, checked, device,
                                precision=precision)
    runs["control"] = reference.train_steps(model, init, graph, traffic, seed,
                                            checked, device, precision="tf32")
    out = {"workload": workload, "seed": seed, "reference": precision,
           "setup_s": setup}
    out.update({k: drv.compare(v, ref, detail=True) for k, v in runs.items()})
    if witness:
        wit = reference.train_steps(model, init, graph, traffic, seed, checked,
                                    device, precision=witness)
        out["witness"] = {"precision": witness,
                          "reference": drv.compare(wit, ref, detail=True)}
        if program:
            out["witness"]["program"] = drv.compare(runs["program"], wit,
                                                    detail=True)
    if again:
        refs = [reference.train_steps(model, init, graph, traffic, seed, checked,
                                      device, precision=precision) for _ in again]
        out["repeats"] = {"program": [drv.compare(p, ref) for p in again],
                          "reference": [drv.compare(r, ref) for r in refs]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    ap.add_argument("--faults", type=int, choices=(0, 1), default=1)
    ap.add_argument("--repeats", type=int, default=1,
                    help="take the program's and the reference's steps this "
                         "many times, each against the first reference")
    ap.add_argument("--witness", default=None,
                    help="also take the reference in this precision")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, "cuda", bool(args.program),
                                  bool(args.faults), args.repeats,
                                  args.witness)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
