"""The data-parallel (dp) and pushpull modes in the port, against the JAX
package.

* Bitwise: ``sample_micro`` and ``sample_micro_batch``; ``build_dp_plan``
  with and without edge halves, fresh and repadded, with its accounting
  counters; a dp plan's packed staging buffer (zero-width ``send_idx``)
  equal to the per-array staging.
* The dp forward and the masked cross-entropy's gradients against JAX's
  ``gnn_forward``: SAGE, GCN and GAT, both port backends, blocking and
  overlap; logits rtol 3e-5, gradients 3e-4. A dp step launches the
  shuffle adjoint only for the self rows: SAGE L-1 times, GAT L, GCN never.
* Trajectories of dp and pushpull against the JAX ``Trainer`` (rtol 1e-4).
  Inside the port: pushpull ≡ dp, the replication knob leaves dp unchanged,
  serial ≡ pipelined, all bitwise; split loads fewer rows than dp; a device
  source refuses dp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_dp_plan, sim_shuffle
from repro.core.splitting import repad_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec, init_gnn_params
from repro.models.gnn.layers import gnn_forward
from repro.train.loss import masked_softmax_xent
from repro.train.plan_io import load_features, load_labels, plan_to_device
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core import build_dp_plan as t_build_dp_plan
from repro_torch.core import repad_plan as t_repad_plan
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
from repro_torch.kernels.shuffle import kernel as sh_kernel
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import gnn_forward as t_gnn_forward
from repro_torch.models.gnn import params_from_jax
from repro_torch.train import plan_io as t_plan_io
from repro_torch.train import trainer as t_trainer
from repro_torch.train.loss import masked_softmax_xent as t_xent
from test_torch_replication import assert_same_plan

NDEV = 4
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)


def assert_same_samples(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.target_ids, y.target_ids)
        for fx, fy in zip(x.frontiers, y.frontiers, strict=True):
            assert fx.dtype == fy.dtype and np.array_equal(fx, fy)
        for lx, ly in zip(x.layers, y.layers, strict=True):
            for f in ("src", "dst", "edge_id"):
                u, v = getattr(lx, f), getattr(ly, f)
                assert u.dtype == v.dtype and np.array_equal(u, v), f


@pytest.fixture(scope="module")
def ds():
    return make_dataset("tiny")


@pytest.fixture(scope="module")
def tds():
    return t_make_dataset("tiny")


def _samplers(ds, tds, fanouts=(3, 3), batch=32, seed=5):
    return (NeighborSampler(ds.graph, ds.train_ids, list(fanouts), batch,
                            seed=seed),
            TNeighborSampler(tds.graph, tds.train_ids, list(fanouts), batch,
                             seed=seed))


# --------------------------------------------------------------------- #
# host stages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("num_devices", [1, 3, 4])
def test_micro_batch_samples_bitwise(ds, tds, num_devices):
    s, ts = _samplers(ds, tds)
    for i, targets in enumerate(s.epoch_targets(1)[:2]):
        assert_same_samples(s.sample_micro_batch(targets, num_devices, 1, i),
                            ts.sample_micro_batch(targets, num_devices, 1, i))
        # the streamed API: both generators advance in the same call order
        assert_same_samples(s.sample_micro(targets, num_devices),
                            ts.sample_micro(targets, num_devices))


@pytest.mark.parametrize("with_halves", [False, True])
@pytest.mark.parametrize("pad_multiple", [8, -1])
def test_dp_plans_bitwise_fresh_and_repadded(ds, tds, with_halves,
                                             pad_multiple):
    """Micro-batches of three batch sizes, in an order that grows the marks
    and then repads a smaller batch: field by field equal to JAX's."""
    s, ts = _samplers(ds, tds)
    hwm, thwm = {}, {}
    for i, n in enumerate((32, 64, 12)):
        targets = ds.train_ids[8 * i:8 * i + n]
        plan = build_dp_plan(s.sample_micro_batch(targets, NDEV, 0, i),
                             pad_multiple=pad_multiple, with_halves=with_halves)
        tplan = t_build_dp_plan(ts.sample_micro_batch(targets, NDEV, 0, i),
                                pad_multiple=pad_multiple,
                                with_halves=with_halves)
        assert_same_plan(plan, tplan)
        assert tplan.shuffle_rows() == 0 and tplan.cross_edge_fraction() == 0
        assert all(lp.send_idx.shape == (NDEV, NDEV, 0)
                   for lp in tplan.layers)
        if with_halves:
            assert all(lp.redge_src.shape[1] == 0 for lp in tplan.layers)
        assert_same_plan(repad_plan(plan, hwm), t_repad_plan(tplan, thwm))
    assert hwm == thwm


def test_dp_plan_packed_staging_equals_plain(ds, tds):
    """The packed staging buffer of a dp plan: the zero-width ``send_idx``
    takes no bytes and every view equals the per-array staging."""
    _, ts = _samplers(ds, tds)
    targets = tds.train_ids[:32]
    plan = t_build_dp_plan(ts.sample_micro_batch(targets, NDEV, 0, 0),
                           with_halves=True)
    labels = t_plan_io.load_labels(plan, tds.labels)
    buf, spans = t_plan_io.pack_host(plan, labels, pin=False, with_halves=True)
    got, got_labels = t_plan_io.unpack(buf, spans, plan.num_layers)
    want = t_plan_io.plan_to_device(plan, "cpu", with_halves=True)
    assert torch.equal(got_labels, torch.as_tensor(labels))
    for lg, lw in zip(got["layers"], want["layers"], strict=True):
        assert lg.keys() == lw.keys()
        for k in lw:
            assert lg[k].dtype == lw[k].dtype and torch.equal(lg[k], lw[k]), k
        assert lg["send_idx"].shape == (NDEV, NDEV, 0)


# --------------------------------------------------------------------- #
# the dp forward and its gradients
# --------------------------------------------------------------------- #
def _dp_plan(ds, with_halves):
    """A dp plan repadded after a larger one."""
    s = NeighborSampler(ds.graph, ds.train_ids, [3, 3], 32, seed=2)
    hwm: dict = {}
    repad_plan(build_dp_plan(s.sample_micro_batch(ds.train_ids[:64], NDEV, 0,
                                                  0),
                             with_halves=with_halves), hwm)
    return repad_plan(build_dp_plan(
        s.sample_micro_batch(ds.train_ids[64:96], NDEV, 0, 1),
        with_halves=with_halves), hwm)


def _port_out_and_grads(tspec, np_params, feats, pa, labels):
    gnn = params_from_jax(np_params, tspec, "cpu")
    out = t_gnn_forward(tspec, list(gnn.layers), feats, pa)
    t_xent(out, torch.as_tensor(labels), pa["target_mask"]).backward()
    return out.detach().numpy(), [
        {k: p.grad.numpy() for k, p in layer.items()} for layer in gnn.layers
    ]


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("overlap", [False, True], ids=["blocking", "overlap"])
def test_dp_forward_and_grads_match_jax(ds, model, backend, overlap):
    plan = _dp_plan(ds, overlap)
    feats, labels = load_features(plan, ds.features), load_labels(plan,
                                                                  ds.labels)
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16, out_dim=4,
              num_layers=2, num_heads=2, overlap=overlap,
              shuffle_chunks=2 if overlap else 1)
    jspec = GNNSpec(agg_backend="pallas" if backend == "fused" else "jnp", **kw)
    params = init_gnn_params(jax.random.PRNGKey(0), jspec)
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in params]
    pa = plan_to_device(plan, with_halves=overlap)

    def loss(p):
        out = gnn_forward(jspec, p, jnp.asarray(feats), pa, sim_shuffle)
        return masked_softmax_xent(out, jnp.asarray(labels),
                                   pa["target_mask"]), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    got, got_g = _port_out_and_grads(
        TGNNSpec(agg_backend=backend, **kw), np_params, torch.as_tensor(feats),
        t_plan_io.plan_to_device(plan, "cpu", with_halves=overlap), labels)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    for a, b in zip(got_g, want_g, strict=True):
        for k in b:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), **GRAD_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("model,calls", [("sage", 1), ("gcn", 0), ("gat", 2)])
@pytest.mark.parametrize("overlap", [False, True], ids=["blocking", "overlap"])
def test_dp_launches_only_self_row_adjoints(ds, monkeypatch, model, calls,
                                            overlap):
    """S = 0: the shuffle returns its rows, so a dp step's shuffle adjoints
    are the self rows' alone (2 layers: SAGE 1, GAT 2, GCN none)."""
    seen = []
    real = sh_kernel.shuffle_bwd

    def counting(g, send_idx, send_count, num_rows):
        seen.append(tuple(send_idx.shape))
        return real(g, send_idx, send_count, num_rows)

    monkeypatch.setattr(sh_kernel, "shuffle_bwd", counting)
    plan = _dp_plan(ds, overlap)
    spec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=4, num_layers=2, num_heads=2, overlap=overlap)
    np_params = [{k: np.asarray(v) for k, v in d.items()}
                 for d in init_gnn_params(jax.random.PRNGKey(0), GNNSpec(
                     model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                     out_dim=4, num_layers=2, num_heads=2))]
    _port_out_and_grads(spec, np_params,
                        torch.as_tensor(load_features(plan, ds.features)),
                        t_plan_io.plan_to_device(plan, "cpu",
                                                 with_halves=overlap),
                        load_labels(plan, ds.labels))
    assert len(seen) == calls, seen
    assert all(len(shape) == 3 and shape[1] == 1 for shape in seen)


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #
def _kw(ds, model="sage"):
    return dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)


@pytest.mark.parametrize("mode,model", [("dp", "sage"), ("pushpull", "sage"),
                                        ("dp", "gat")])
def test_dp_trajectory_matches_jax(ds, tds, mode, model):
    ckw = dict(mode=mode, num_devices=NDEV, fanouts=(4, 4), batch_size=32,
               presample_epochs=2, lr=5e-3)
    jtr = Trainer(ds, GNNSpec(agg_backend="pallas", **_kw(ds, model)),
                  TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**_kw(ds, model))
    ttr = t_trainer.Trainer(tds, tspec, t_trainer.TrainConfig(**ckw),
                            device="cpu",
                            model=params_from_jax(np_params, tspec, "cpu"))
    assert ttr.partition is None and ttr.weights is None
    targets = [ds.train_ids[i * 32:(i + 1) * 32] for i in range(2)]
    jl = [jtr.train_iter(t).loss for t in targets]
    tl = [ttr.train_iter(t).loss for t in targets]
    je, te = jtr.train_epoch(max_iters=3), ttr.train_epoch(max_iters=3)
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    assert len(tl) == len(jl) == 4  # two inline steps, a 2-batch epoch
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for a, b in zip(je.iters, te.iters, strict=True):
        for name in ("loaded_rows", "computed_edges", "shuffle_rows",
                     "wire_bytes", "padded_edge_slots", "busiest_edges",
                     "load_imbalance", "cross_edge_fraction"):
            assert getattr(a, name) == getattr(b, name), name
        assert b.shuffle_rows == 0 and b.wire_bytes == 0


def _trajectory(tds, model="sage", **over):
    kw = dict(mode="dp", num_devices=NDEV, fanouts=(4, 4), batch_size=32,
              presample_epochs=2, pipeline_depth=3, plan_workers=2, seed=7,
              stall_timeout_s=30.0)
    tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds, model)),
                           t_trainer.TrainConfig(**{**kw, **over}),
                           device="cpu")
    traj, last = [], None
    for _ in range(2):
        last = tr.train_epoch(max_iters=3)
        traj += [(i.loss, i.accuracy, i.loaded_rows) for i in last.iters]
    return traj, last


def test_dp_run_invariants(tds):
    """Bitwise: pushpull ≡ dp; the replication knob (and telemetry) leave
    dp unchanged; pipelined ≡ serial, also with overlap."""
    base, _ = _trajectory(tds)
    assert len(base) == 4  # 2 epochs of the tiny graph's 2 batches
    assert _trajectory(tds, mode="pushpull")[0] == base
    assert _trajectory(tds, replication_budget=0.25,
                       record_telemetry=True)[0] == base
    piped, last = _trajectory(tds, plan_source="pipelined", plan_workers=3)
    assert piped == base and last.pipeline["leaked_threads"] == 0
    over, _ = _trajectory(tds, shuffle_overlap=True, shuffle_chunks=2)
    over_p, _ = _trajectory(tds, shuffle_overlap=True, shuffle_chunks=2,
                            plan_source="pipelined")
    assert over == over_p


def test_split_loads_less_than_dp(tds):
    """Table 1: split parallelism removes the redundant loads (the
    counterpart of the JAX package's ``test_split_loads_less_than_dp``)."""
    stats = {}
    for mode in ("split", "dp"):
        cfg = t_trainer.TrainConfig(mode=mode, num_devices=NDEV, fanouts=(4, 4),
                                    batch_size=32, presample_epochs=2, seed=11)
        tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), cfg, device="cpu")
        stats[mode] = tr.train_epoch(max_iters=3).totals()
    assert stats["split"]["loaded_rows"] < stats["dp"]["loaded_rows"]
    assert stats["split"]["computed_edges"] <= stats["dp"]["computed_edges"]
    assert stats["dp"]["shuffle_rows"] == 0 < stats["split"]["shuffle_rows"]
    assert stats["dp"]["cross_edge_fraction"] == 0.0


def test_device_source_refuses_dp(tds):
    cfg = t_trainer.TrainConfig(mode="dp", plan_source="device", fanouts=(3, 3),
                                batch_size=16, presample_epochs=1)
    with pytest.raises(ValueError, match="plan_source"):
        t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), cfg, device="cpu")
