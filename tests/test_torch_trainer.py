"""The port's host stages and trainer against the JAX package's.

* The copied numpy stages (datasets, sampling, presample, partition,
  splitting, layout) give bitwise-equal weights, partitions and repadded
  plans for the same seed.
* A ``train_iter`` trajectory and a ``train_epoch`` match the JAX ``Trainer``
  on the Pallas path (interpret mode) from the same carried weights, per-step
  loss rtol 1e-4 atol 1e-6: the aggregation sums in another order (index_add
  vs one-hot matmul) and Adam's normalised step amplifies the difference.
* The port imports nothing of JAX or of the JAX package; its trainer runs on
  the card unless asked for the CPU; unknown settings raise, ported ones
  pass ``check_config``.
"""
import ast
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import build_dp_plan, build_split_plan, partition_graph, presample
from repro.core.splitting import repad_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core import build_dp_plan as t_build_dp_plan
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
        # halves only on plans built with them (tests/test_torch_overlap.py
        # holds those field by field); num_replicated is a field above
        assert la.has_halves == lb.has_halves
    for name in ("padded_edge_slots", "busiest_edges", "load_imbalance",
                 "cross_edge_fraction"):
        assert getattr(a, name)() == getattr(b, name)(), name


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
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w,
                           replication_budget=0.05)
    tpart = t_partition_graph(tds.graph, 4, method="gsplit", weights=tw,
                              replication_budget=0.05)
    assert np.array_equal(part.assignment, tpart.assignment)
    rep, trep = part.replication, tpart.replication
    assert rep.num_replicated == trep.num_replicated > 0
    assert np.array_equal(rep.slot_of, trep.slot_of)
    s = NeighborSampler(ds.graph, ds.train_ids, fanouts, batch, seed=3)
    ts = TNeighborSampler(tds.graph, tds.train_ids, fanouts, batch, seed=3)
    # split plans without and with replication, and dp plans of keyed
    # micro-batches, each against its own high-water marks
    hwm = [{}, {}, {}]
    thwm = [{}, {}, {}]
    for i, targets in enumerate(s.epoch_targets(0)[:3]):
        sample, tsample = s.sample_batch(targets, 0, i), ts.sample_batch(
            targets, 0, i)
        micro = s.sample_micro_batch(targets, 4, 0, i)
        tmicro = ts.sample_micro_batch(targets, 4, 0, i)
        plans = (
            build_split_plan(sample, part.assignment, 4, pad_multiple=-1),
            build_split_plan(sample, part.assignment, 4, pad_multiple=-1,
                             replication=rep),
            build_dp_plan(micro, pad_multiple=-1),
        )
        tplans = (
            t_build_split_plan(tsample, tpart.assignment, 4, pad_multiple=-1),
            t_build_split_plan(tsample, tpart.assignment, 4, pad_multiple=-1,
                               replication=trep),
            t_build_dp_plan(tmicro, pad_multiple=-1),
        )
        for plan, tplan, h, th in zip(plans, tplans, hwm, thwm):
            _assert_same_plan(repad_plan(plan, h), t_repad_plan(tplan, th))
        assert tplans[1].layers[-1].num_replicated == trep.num_replicated
        assert tplans[1].shuffle_rows() < tplans[0].shuffle_rows()
        assert tplans[2].shuffle_rows() == 0
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
        "src/repro_torch/kernels/shuffle/kernel.py",
        "src/repro_torch/kernels/shuffle/ops.py",
        "src/repro_torch/kernels/shuffle/ref.py",
        "src/repro_torch/models/transformer/model.py",
        "src/repro_torch/models/transformer/blocks.py",
        "src/repro_torch/models/transformer/moe.py",
        "src/repro_torch/models/transformer/ssm.py",
        "src/repro_torch/models/transformer/layers.py",
        "src/repro_torch/train/optimizer.py",
        "src/repro_torch/profile_train.py",
        "src/repro_torch/profile_decode.py",
        "src/repro_torch/configs/smollm_135m.py",
        "src/repro_torch/configs/deepseek_v2_236b.py",
        "src/repro_torch/configs/deepseek_v2_lite_16b.py",
        "src/repro_torch/configs/mamba2_2p7b.py",
        "src/repro_torch/configs/hymba_1p5b.py",
        "src/repro_torch/configs/musicgen_medium.py",
        "src/repro_torch/configs/llava_next_mistral_7b.py",
        "src/repro_torch/serve.py",
        "src/repro_torch/runtime/prefetch.py",
        "src/repro_torch/obs/trace.py",
        "src/repro_torch/faults/inject.py",
        "src/repro_torch/graph/cache.py",
        "src/repro_torch/launch/sharding.py",
        "src/repro_torch/launch/spmd.py",
        "src/repro_torch/launch/roofline.py",
        "src/repro_torch/launch/input_specs.py",
        "src/repro_torch/launch/shapes.py",
        "src/repro_torch/train_gnn_e2e.py",
        "src/repro_torch/quickstart.py",
        "src/repro_torch/partition_study.py",
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
    ("wire_dtype", "int8"),
])
def test_unported_config_values_raise(field, value):
    cfg = t_trainer.TrainConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        t_trainer.check_config(cfg)


@pytest.mark.parametrize("field,value", [
    ("mode", "dp"),
    ("mode", "pushpull"),
    ("partition_method", "node"),
    ("partition_method", "rand"),
    ("partition_method", "edge"),
    ("partition_method", "telemetry"),
    ("replication_budget", 0.05),
    ("record_telemetry", True),
    ("num_replicas", 1),
    ("num_replicas", 2),
    ("ckpt_every", 1),
    ("ckpt_dir", "/tmp/ckpt"),
    ("presample_workers", 4),
])
def test_ported_config_values_accepted(field, value):
    t_trainer.check_config(t_trainer.TrainConfig(**{field: value}))


@pytest.mark.parametrize("mode", ["dp", "pushpull"])
@pytest.mark.parametrize("source", ["device", "device_pipelined"])
def test_device_source_needs_split_mode(mode, source):
    cfg = t_trainer.TrainConfig(mode=mode, plan_source=source)
    with pytest.raises(ValueError, match="plan_source"):
        t_trainer.check_config(cfg)
