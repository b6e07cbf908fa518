"""The port's host stages and trainer against the JAX package's.

* The copied numpy stages (datasets, sampling, presample, partition,
  splitting, layout) give bitwise-equal weights, partitions and repadded
  plans for the same seed.
* A ``train_iter`` trajectory and a ``train_epoch`` match the JAX ``Trainer``
  on the Pallas path (interpret mode) from the same carried weights, per-step
  loss rtol 1e-4 atol 1e-6: the aggregation sums in another order (index_add
  vs one-hot matmul) and Adam's normalised step amplifies the difference.
* The port imports nothing of JAX or of the JAX package; its trainer runs on
  the card unless asked for the CPU; unported settings raise.
"""
import ast
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import build_split_plan, partition_graph, presample
from repro.core.splitting import repad_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core import build_split_plan as t_build_split_plan
from repro_torch.core import partition_graph as t_partition_graph
from repro_torch.core import presample as t_presample
from repro_torch.core import repad_plan as t_repad_plan
from repro_torch.core.splitting import LayerPlan as TLayerPlan
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.train import trainer as t_trainer

ROOT = Path(__file__).resolve().parents[1]


def _assert_same_plan(a, b):
    for name in ("front_ids", "node_mask", "node_count"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.stats == b.stats
    for la, lb in zip(a.layers, b.layers):
        for f in fields(TLayerPlan):
            x, y = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name
        # the JAX plan's other fields are off on the blocking split path
        assert la.num_replicated == 0 and not la.has_halves


@pytest.mark.parametrize("name,fanouts,batch", [
    ("tiny", [4, 4], 16),
    ("orkut-s", [4, 4], 64),
])
def test_host_stages_bitwise_equal(name, fanouts, batch):
    ds, tds = make_dataset(name), t_make_dataset(name)
    assert np.array_equal(ds.features, tds.features)
    assert np.array_equal(ds.graph.indices, tds.graph.indices)
    w = presample(ds.graph, ds.train_ids, fanouts, batch, num_epochs=1, seed=1)
    tw = t_presample(tds.graph, tds.train_ids, fanouts, batch, num_epochs=1,
                     seed=1)
    assert np.array_equal(w.edge_weight, tw.edge_weight)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    tpart = t_partition_graph(tds.graph, 4, method="gsplit", weights=tw)
    assert np.array_equal(part.assignment, tpart.assignment)
    s = NeighborSampler(ds.graph, ds.train_ids, fanouts, batch, seed=3)
    ts = TNeighborSampler(tds.graph, tds.train_ids, fanouts, batch, seed=3)
    hwm, thwm = {}, {}
    for i, targets in enumerate(s.epoch_targets(0)[:3]):
        plan = repad_plan(build_split_plan(
            s.sample_batch(targets, 0, i), part.assignment, 4, pad_multiple=-1
        ), hwm)
        tplan = t_repad_plan(t_build_split_plan(
            ts.sample_batch(targets, 0, i), tpart.assignment, 4,
            pad_multiple=-1,
        ), thwm)
        _assert_same_plan(plan, tplan)
    assert hwm == thwm


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_trainer_trajectory_matches_jax(model):
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=64,
              out_dim=ds.spec.num_classes, num_layers=2)
    ckw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3)
    jtr = Trainer(ds, GNNSpec(agg_backend="pallas", **kw), TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(**ckw), device="cpu",
        model=params_from_jax(np_params, tspec, "cpu"),
    )
    targets = [ds.train_ids[i * 16:(i + 1) * 16] for i in range(3)]
    jl = [jtr.train_iter(t).loss for t in targets]
    tl = [ttr.train_iter(t).loss for t in targets]
    je, te = jtr.train_epoch(), ttr.train_epoch()
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    assert len(jl) == len(tl) == 7
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for a, b in zip(je.iters, te.iters):
        assert (a.loaded_rows, a.computed_edges, a.shuffle_rows) == (
            b.loaded_rows, b.computed_edges, b.shuffle_rows
        )


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    assert {
        "src/repro_torch/sampler/engine.py",
        "src/repro_torch/kernels/segsum/ops.py",
        "src/repro_torch/kernels/edge_softmax/ops.py",
        "src/repro_torch/kernels/flash_decode/kernel.py",
        "src/repro_torch/models/transformer/model.py",
        "src/repro_torch/configs/smollm_135m.py",
        "src/repro_torch/serve.py",
    } <= scanned
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_trainer_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = t_make_dataset("tiny")
    spec = TGNNSpec(in_dim=ds.spec.feat_dim, hidden_dim=8,
                    out_dim=ds.spec.num_classes, num_layers=2)
    cfg = t_trainer.TrainConfig(fanouts=(3, 3), batch_size=16,
                                presample_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_trainer.Trainer(ds, spec, cfg)
    with pytest.raises(RuntimeError):
        t_trainer.Trainer(ds, spec, cfg, device="cuda")
    tr = t_trainer.Trainer(ds, spec, cfg, device="cpu")
    st = tr.train_epoch(max_iters=2)
    assert len(st.iters) == 2 and np.isfinite(st.totals()["loss"])
    assert next(tr.model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("mode", "dp"),
    ("mode", "pushpull"),
    ("partition_method", "node"),
    ("partition_method", "rand"),
    ("plan_source", "pipelined"),
    ("plan_source", "device_pipelined"),
    ("cache_mode", "partitioned"),
    ("shuffle_overlap", True),
    ("replication_budget", 0.05),
    ("num_replicas", 2),
    ("wire_dtype", "int8"),
])
def test_unported_config_values_raise(field, value):
    cfg = t_trainer.TrainConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        t_trainer.check_config(cfg)
