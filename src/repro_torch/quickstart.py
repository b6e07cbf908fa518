"""Quickstart: split-parallel GNN training in ~30 lines of public API — the
counterpart of ``examples/quickstart.py``, on the card by default.

    python -m repro_torch.quickstart                 # on the card
    python -m repro_torch.quickstart --device cpu

``main`` returns what it printed: the lines, the offline seconds and each
epoch's totals.
"""
from __future__ import annotations

import argparse

from repro_torch.graph.datasets import make_dataset
from repro_torch.models.gnn import GNNSpec
from repro_torch.train.trainer import TrainConfig, Trainer, resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    ds = make_dataset("tiny")
    spec = GNNSpec(
        model="sage",
        in_dim=ds.spec.feat_dim,
        hidden_dim=64,
        out_dim=ds.spec.num_classes,
        num_layers=2,
    )
    cfg = TrainConfig(
        mode="split",  # the paper's split parallelism
        num_devices=4,
        fanouts=(10, 10),
        batch_size=64,
        partition_method="gsplit",  # presample-weighted min-cut (§5)
        presample_epochs=5,
        plan_source="serial",  # "pipelined": overlap plan building w/ compute
        lr=5e-3,
    )
    trainer = Trainer(ds, spec, cfg, device=device)
    say(
        f"offline: presample={trainer.t_presample:.2f}s "
        f"partition={trainer.t_partition:.2f}s"
    )
    epochs = []
    for epoch in range(5):
        st = trainer.train_epoch().totals()
        epochs.append(st)
        say(
            f"epoch {epoch}: loss={st['loss']:.4f} acc={st['accuracy']:.2%} "
            f"loaded={st['loaded_rows']:.0f} rows "
            f"shuffled={st['shuffle_rows']:.0f} rows "
            f"imbalance={st['load_imbalance']:.3f}"
        )
    return {"lines": lines, "device": str(device),
            "t_presample": trainer.t_presample,
            "t_partition": trainer.t_partition, "epochs": epochs}


if __name__ == "__main__":
    main()
