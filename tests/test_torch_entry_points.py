"""The port's entry points (``repro_torch.quickstart``, ``train_gnn_e2e``,
``partition_study``) against the JAX package, on the CPU, on ``tiny``.

The entry points build their own trainers; here each port ``Trainer`` they
make is built beside a JAX ``Trainer`` of the same config and spec (JAX's
``jnp`` aggregation, no checkpointing) and starts from its weights, and the
JAX trainers are driven in the example's own loop. Per-step losses follow
within rtol 1e-4, atol 1e-6 (``tests/test_torch_trainer.py``'s tolerance:
the aggregation sums in another order, and Adam's normalised step amplifies
the difference); loaded rows are equal as integers. A run killed after a
checkpoint and resumed with ``--resume`` continues bit for bit as the run
that was not killed. ``partition_study``'s numbers are bitwise equal to
the same calls in ``repro``.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro.core import partition_graph, presample
from repro.core.splitting import build_split_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec
from repro.train.trainer import TrainConfig, Trainer
from repro_torch import partition_study, quickstart, train_gnn_e2e
from repro_torch.models.gnn import params_from_jax
from repro_torch.train import trainer as t_trainer

TOL = dict(rtol=1e-4, atol=1e-6)


class Paired:
    """Stands in for the port's ``Trainer`` in an entry point's module: each
    trainer it makes starts from the weights of a JAX ``Trainer`` built
    with the same config (checkpointing off), kept in ``jax`` by mode."""

    def __init__(self):
        self.jax, self.port = {}, {}

    def __call__(self, ds, spec, cfg, device=None):
        jcfg = TrainConfig(**{f.name: getattr(cfg, f.name)
                              for f in fields(TrainConfig) if hasattr(cfg, f.name)})
        jcfg.ckpt_dir, jcfg.ckpt_every = None, 0
        jspec = GNNSpec(**{f.name: getattr(spec, f.name) for f in fields(spec)})
        jtr = Trainer(make_dataset(ds.spec.name), jspec, jcfg)
        np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
        tr = t_trainer.Trainer(ds, spec, cfg, device=device,
                               model=params_from_jax(np_params, spec, "cpu"))
        self.jax[cfg.mode], self.port[cfg.mode] = jtr, tr
        return tr


@pytest.fixture
def paired(monkeypatch):
    pair = Paired()
    monkeypatch.setattr(quickstart, "Trainer", pair)
    monkeypatch.setattr(train_gnn_e2e, "Trainer", pair)
    return pair


def test_quickstart_follows_the_jax_trainer(paired):
    out = quickstart.main(["--device", "cpu"])
    assert out["device"] == "cpu" and len(out["epochs"]) == 5
    assert len(out["lines"]) == 6 and out["lines"][1].startswith("epoch 0: loss=")
    jtr = paired.jax["split"]
    want = [jtr.train_epoch().totals() for _ in range(5)]
    np.testing.assert_allclose([e["loss"] for e in out["epochs"]],
                               [e["loss"] for e in want], **TOL)
    for got, w in zip(out["epochs"], want):
        assert (int(got["loaded_rows"]), int(got["shuffle_rows"])) == (
            int(w["loaded_rows"]), int(w["shuffle_rows"]))


def _jax_e2e(pair, steps, source, start=0):
    """The example's loop over the JAX trainers: (split losses, dp losses,
    split loaded rows, dp loaded rows)."""
    split, dp = pair.jax["split"], pair.jax["dp"]
    losses, dp_losses, split_loaded, dp_loaded = [], [], 0, 0
    done = start
    while done < steps:
        if source == "serial":
            for targets in split.sampler.epoch_batches():
                if done >= steps:
                    break
                st, dst = split.train_iter(targets), dp.train_iter(targets)
                losses.append(st.loss)
                dp_losses.append(dst.loss)
                split_loaded += st.loaded_rows
                dp_loaded += dst.loaded_rows
                done += 1
        else:
            st = split.train_epoch(max_iters=steps - done)
            dst = dp.train_epoch(max_iters=len(st.iters))
            losses += [i.loss for i in st.iters]
            dp_losses += [i.loss for i in dst.iters]
            split_loaded += sum(i.loaded_rows for i in st.iters)
            dp_loaded += sum(i.loaded_rows for i in dst.iters)
            done += len(st.iters)
    return losses, dp_losses, split_loaded, dp_loaded


@pytest.mark.parametrize("source", ["serial", "pipelined"])
def test_train_gnn_e2e_follows_the_jax_trainer(paired, source, tmp_path):
    steps = 5
    out = train_gnn_e2e.main(["--device", "cpu", "--dataset", "tiny",
                              "--steps", str(steps), "--plan-source", source,
                              "--ckpt-dir", str(tmp_path)])
    assert out["steps"] == steps and out["device"] == "cpu"
    assert out["checkpoint"].startswith(str(tmp_path))
    assert out["lines"][-1].startswith("dedup: data parallelism loaded")
    losses, dp_losses, split_loaded, dp_loaded = _jax_e2e(paired, steps, source)
    np.testing.assert_allclose(out["losses"], losses, **TOL)
    np.testing.assert_allclose(out["dp_losses"], dp_losses, **TOL)
    assert (out["split_loaded"], out["dp_loaded"]) == (split_loaded, dp_loaded)
    assert out["dedup_ratio"] == dp_loaded / split_loaded > 1.0


def test_train_gnn_e2e_resumes_after_a_kill(paired, monkeypatch, tmp_path):
    """Pipelined, a checkpoint every 2 steps, killed in step 5 (after the
    checkpoint of step 4): ``--resume`` trains steps 5 and 6 bit for bit as
    the run that was not killed, and both follow the JAX trainer."""
    args = ["--device", "cpu", "--dataset", "tiny", "--steps", "6",
            "--plan-source", "pipelined", "--ckpt-every", "2"]
    whole = train_gnn_e2e.main(args + ["--ckpt-dir", str(tmp_path / "whole")])
    want = _jax_e2e(paired, 6, "pipelined")[0]
    np.testing.assert_allclose(whole["losses"], want, **TOL)

    killed = tmp_path / "killed"
    epoch = t_trainer.Trainer.train_epoch
    calls = {"split": 0}

    def dies_in_step_5(self, max_iters=None):
        if self.cfg.mode == "split":
            calls["split"] += 1
            if calls["split"] == 5:
                raise KeyboardInterrupt("killed in step 5")
        return epoch(self, max_iters)

    monkeypatch.setattr(t_trainer.Trainer, "train_epoch", dies_in_step_5)
    with pytest.raises(KeyboardInterrupt):
        train_gnn_e2e.main(args + ["--ckpt-dir", str(killed)])
    monkeypatch.setattr(t_trainer.Trainer, "train_epoch", epoch)
    resumed = train_gnn_e2e.main(args + ["--ckpt-dir", str(killed), "--resume"])
    assert resumed["resumed_step"] == 4
    assert resumed["lines"][0].startswith("resumed from ")
    assert resumed["losses"] == whole["losses"][4:]


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, partition_study.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gnn_e2e.main(["--dataset", "tiny", "--steps", "1"])


def test_partition_study_equals_the_reference_bitwise():
    out = partition_study.main(["--device", "cpu", "--dataset", "tiny",
                                "--iters", "3"])
    ds = make_dataset("tiny")
    fanouts, batch = [15, 15, 15], 512
    weights = presample(ds.graph, ds.train_ids, fanouts, batch, num_epochs=10)
    sampler = NeighborSampler(ds.graph, ds.train_ids, fanouts, batch, seed=2)
    for method in partition_study.METHODS:
        part = partition_graph(ds.graph, 4, method=method, weights=weights,
                               train_ids=ds.train_ids, seed=0)
        imb, cross, shuf = [], [], []
        for i, targets in enumerate(sampler.epoch_batches()):
            if i >= 3:
                break
            plan = build_split_plan(sampler.sample(targets), part.assignment, 4)
            imb.append(plan.load_imbalance())
            cross.append(plan.cross_edge_fraction())
            shuf.append(plan.shuffle_rows())
        assert out["methods"][method] == {
            "imbalance": float(np.mean(imb)), "cross_edges": float(np.mean(cross)),
            "shuffle_rows": float(np.mean(shuf))}
    assert len(out["lines"]) == 2 + len(partition_study.METHODS) + 1
