"""End-to-end run: train a 3-layer GraphSAGE on the scaled Orkut mirror
for a few hundred steps with split parallelism, checkpointing, and a
validation of the paper's dedup claim against a data-parallel run — the
counterpart of ``examples/train_gnn_e2e.py``, on the card by default.

    python -m repro_torch.train_gnn_e2e [--steps 200]          # on the card
    python -m repro_torch.train_gnn_e2e --device cpu --dataset tiny --steps 8

The options are the example's, and ``--device``. Two asserts close a run,
as in the example: over 40 or more steps the last 20 losses average below
the first 20, and the dp arm loads more feature rows than the split one.
``main`` returns what it printed: the lines, and their numbers at full
precision.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.graph.datasets import make_dataset
from repro_torch.models.gnn import GNNSpec
from repro_torch.train.trainer import TrainConfig, Trainer, resolve_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dataset", default="orkut-s")
    ap.add_argument(
        "--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "gsplit_ckpt"),
        help="checkpoint directory (crash-consistent; docs/ROBUSTNESS.md)",
    )
    ap.add_argument(
        "--ckpt-every", type=int, default=0,
        help="optimizer steps between periodic checkpoints (0 = only the "
        "final one); each is params + optimizer state + resume cursor",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="restart from the newest valid checkpoint under --ckpt-dir "
        "(corrupt ones are skipped); the continued run is bit-exact vs "
        "an uninterrupted one",
    )
    ap.add_argument(
        "--cache-mode", default="partitioned",
        choices=["none", "partitioned", "distributed"],
        help="feature-cache placement for the split trainer (§2.2)",
    )
    ap.add_argument(
        "--cache-capacity", type=int, default=None,
        help="cached rows per device (default: num_nodes // 8)",
    )
    ap.add_argument(
        "--no-cache-serve", action="store_true",
        help="accounting-only cache (full host gather, pre-serving behavior)",
    )
    ap.add_argument(
        "--plan-source", default="serial",
        choices=["serial", "pipelined", "device", "device_pipelined"],
        help="where plans are built: host (serial/pipelined) or the "
        "device-resident sampler; device modes apply to the split "
        "trainer's epoch loop",
    )
    ap.add_argument(
        "--overlap", action="store_true",
        help="overlap-aware shuffle: split local/remote aggregation per "
        "layer (DESIGN.md §3a)",
    )
    ap.add_argument(
        "--shuffle-chunks", type=int, default=1,
        help="feature-axis tiles per layer all-to-all (double-buffered "
        "exchange; >1 only meaningful with --overlap)",
    )
    ap.add_argument(
        "--wire-dtype", default="float32",
        choices=["float32", "bfloat16", "float16"],
        help="wire format for shuffled rows (fp32 accumulation throughout)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    ds = make_dataset(args.dataset)
    spec = GNNSpec(
        model="sage",
        in_dim=ds.spec.feat_dim,
        hidden_dim=128,
        out_dim=ds.spec.num_classes,
        num_layers=3,
    )
    base = dict(
        num_devices=4, fanouts=(10, 10, 10),
        batch_size=min(256, len(ds.train_ids)),
        presample_epochs=5, lr=2e-3,
        cache_capacity_per_device=(
            args.cache_capacity
            if args.cache_capacity is not None
            else ds.graph.num_nodes // 8
        ),
        cache_serve=not args.no_cache_serve,
    )
    split_tr = Trainer(
        ds, spec, TrainConfig(mode="split", cache_mode=args.cache_mode,
                              plan_source=args.plan_source,
                              shuffle_overlap=args.overlap,
                              shuffle_chunks=args.shuffle_chunks,
                              wire_dtype=args.wire_dtype,
                              ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every, **base),
        device=device,
    )
    dp_tr = Trainer(ds, spec, TrainConfig(mode="dp", cache_mode="distributed",
                                          **base), device=device)
    out = {"lines": lines, "device": str(device), "resumed_step": None}
    if args.resume:
        ck = split_tr.resume()
        if ck is None:
            say(f"no checkpoint under {args.ckpt_dir}; starting fresh")
        else:
            out["resumed_step"] = split_tr.global_step
            say(f"resumed from {ck.path} at step {split_tr.global_step}")

    steps_done, t0 = split_tr.global_step, time.perf_counter()
    split_loaded = dp_loaded = 0
    losses, dp_losses = [], []
    if args.plan_source == "serial":
        while steps_done < args.steps:
            for targets in split_tr.sampler.epoch_batches():
                if steps_done >= args.steps:
                    break
                st = split_tr.train_iter(targets)
                dp_st = dp_tr.train_iter(targets)
                split_loaded += st.loaded_rows
                dp_loaded += dp_st.loaded_rows
                losses.append(st.loss)
                dp_losses.append(dp_st.loss)
                steps_done += 1
                if steps_done % 25 == 0:
                    say(
                        f"step {steps_done:4d} loss={st.loss:.4f} "
                        f"acc={st.accuracy:.2%} "
                        f"split_loads={split_loaded} dp_loads={dp_loaded} "
                        f"({time.perf_counter()-t0:.0f}s)"
                    )
    else:
        # pipelined / device plan sources run through the epoch loop; the dp
        # comparison arm trains epochs of matching length on its own keyed
        # batch stream
        while steps_done < args.steps:
            st = split_tr.train_epoch(max_iters=args.steps - steps_done)
            dp_st = dp_tr.train_epoch(max_iters=len(st.iters))
            split_loaded += sum(i.loaded_rows for i in st.iters)
            dp_loaded += sum(i.loaded_rows for i in dp_st.iters)
            losses += [i.loss for i in st.iters]
            dp_losses += [i.loss for i in dp_st.iters]
            steps_done += len(st.iters)
            sampler_note = ""
            if "sampler_epoch_batches" in st.pipeline:
                eb = st.pipeline["sampler_epoch_batches"]
                ef = st.pipeline["sampler_epoch_fallbacks"]
                sampler_note = f" device_sampled={eb - ef}/{eb}"
            say(
                f"step {steps_done:4d} loss={st.iters[-1].loss:.4f} "
                f"acc={st.iters[-1].accuracy:.2%} "
                f"split_loads={split_loaded} dp_loads={dp_loaded}"
                f"{sampler_note} ({time.perf_counter()-t0:.0f}s)"
            )

    path = split_tr.save_checkpoint()
    say(f"checkpoint written to {path}")
    out.update(steps=steps_done, losses=losses, dp_losses=dp_losses,
               split_loaded=split_loaded, dp_loaded=dp_loaded,
               checkpoint=path, seconds=time.perf_counter() - t0)
    if len(losses) >= 40:  # a resumed tail may be too short to window
        first = sum(losses[:20]) / 20
        last = sum(losses[-20:]) / 20
        out.update(first20=first, last20=last)
        say(f"loss first20={first:.4f} last20={last:.4f}")
        if not last < first:  # the example's asserts, kept under -O too
            raise AssertionError("training must reduce loss")
    if split_loaded > 0:  # a fully-caught-up resume trains zero steps
        ratio = dp_loaded / split_loaded
        out["dedup_ratio"] = ratio
        say(f"dedup: data parallelism loaded {ratio:.2f}x more feature rows")
        if not ratio > 1.0:
            raise AssertionError("data parallelism must load more rows")
    return out


if __name__ == "__main__":
    main()
