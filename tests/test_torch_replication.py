"""Hot-vertex replication, edge telemetry and the partitioner's method arms in
the port, against the JAX package.

* Bitwise: ``select_replication``; ``partition_graph`` for all five methods,
  with and without a replication budget; ``EdgeTelemetry``'s counters and
  ``as_weights`` (also recorded from 2 threads against serially);
  ``refine_partition``; split plans built with a replication set, fresh and
  repadded after growth in N and S (a property test), their signatures and
  the four accounting counters.
* The forward and the masked cross-entropy's gradients with ``rep_block``
  against JAX's ``gnn_forward``: SAGE, GCN and GAT, both port backends,
  blocking and overlap; logits rtol 3e-5, gradients 3e-4. Inside the port,
  replicated ≡ unreplicated bitwise for blocking SAGE and GCN.
* The staging guard: a replicated plan staged for another block height
  raises.
* The trainer: a replicated trajectory against the JAX ``Trainer`` (rtol
  1e-4), and after ``refine_partition`` a bitwise-equal refined assignment
  and replication set; serial ≡ pipelined with replication and telemetry
  (equal counters), device ≡ device_pipelined with replication, cached ≡
  uncached with replication, all bitwise.
"""
import threading
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_split_plan, partition_graph, presample, sim_shuffle
from repro.core.partition import EdgeTelemetry, refine_partition, select_replication
from repro.core.splitting import repad_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import sample_minibatch
from repro.models.gnn import GNNSpec, init_gnn_params
from repro.models.gnn.layers import gnn_forward
from repro.runtime import plan_signature as j_plan_signature
from repro.testing import given, settings, st
from repro.train.loss import masked_softmax_xent
from repro.train.plan_io import load_features, load_labels, plan_to_device
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core import partition as t_partition
from repro_torch.core import build_split_plan as t_build_split_plan
from repro_torch.core import presample as t_presample
from repro_torch.core import repad_plan as t_repad_plan
from repro_torch.core.splitting import LayerPlan as TLayerPlan
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import sample_minibatch as t_sample_minibatch
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import gnn_forward as t_gnn_forward
from repro_torch.models.gnn import params_from_jax
from repro_torch.runtime.signature import plan_signature
from repro_torch.train import plan_io as t_plan_io
from repro_torch.train import trainer as t_trainer
from repro_torch.train.loss import masked_softmax_xent as t_xent

NDEV = 4
BUDGET = 0.10  # tiny graph: a 5% budget replicates too few rows to exercise
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
METHODS = ("gsplit", "rand", "node", "edge", "telemetry")


def assert_same_plan(a, b):
    """A JAX plan and a port plan equal field by field, bitwise, with equal
    accounting counters."""
    for name in ("front_ids", "node_mask", "node_count"):
        for x, y in zip(getattr(a, name), getattr(b, name), strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.stats == b.stats
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in fields(TLayerPlan):
            x, y = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f.name
            else:
                assert x == y, f.name
    for name in ("padded_edge_slots", "busiest_edges", "load_imbalance",
                 "cross_edge_fraction", "shuffle_rows", "computed_edges",
                 "loaded_feature_rows"):
        assert getattr(a, name)() == getattr(b, name)(), name


def assert_same_replication(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.budget_rows == b.budget_rows
    for name in ("vertices", "slot_of"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.fixture(scope="module")
def ds():
    return make_dataset("tiny")


@pytest.fixture(scope="module")
def tds():
    return t_make_dataset("tiny")


@pytest.fixture(scope="module")
def weights(ds, tds):
    w = presample(ds.graph, ds.train_ids, [3, 3], 16, num_epochs=1)
    tw = t_presample(tds.graph, tds.train_ids, [3, 3], 16, num_epochs=1)
    assert np.array_equal(w.edge_weight, tw.edge_weight)
    return w, tw


@pytest.fixture(scope="module")
def part(ds, weights):
    return partition_graph(ds.graph, NDEV, method="gsplit", weights=weights[0],
                           replication_budget=BUDGET)


# --------------------------------------------------------------------- #
# the partitioner, replication and telemetry
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("budget", [0.0, 0.01, 0.1, 0.5])
@pytest.mark.parametrize("weighted", [True, False])
def test_select_replication_bitwise(ds, tds, weights, part, budget, weighted):
    w, tw = weights
    got = t_partition.select_replication(
        tds.graph, NDEV, part.assignment, tw if weighted else None, budget)
    want = select_replication(ds.graph, NDEV, part.assignment,
                              w if weighted else None, budget)
    assert_same_replication(want, got)
    if budget >= 0.1:
        assert got.num_replicated > 0 and got.num_replicated <= got.budget_rows


@pytest.mark.parametrize("budget", [0.0, BUDGET])
@pytest.mark.parametrize("method", METHODS)
def test_partition_methods_bitwise(ds, tds, weights, method, budget):
    w, tw = weights
    want = partition_graph(ds.graph, NDEV, method=method, weights=w,
                           train_ids=ds.train_ids, seed=3,
                           replication_budget=budget)
    got = t_partition.partition_graph(tds.graph, NDEV, method=method,
                                      weights=tw, train_ids=tds.train_ids,
                                      seed=3, replication_budget=budget)
    assert got.method == want.method == method
    assert got.assignment.dtype == want.assignment.dtype
    assert np.array_equal(got.assignment, want.assignment)
    assert_same_replication(want.replication, got.replication)
    assert (got.replication is not None) == (budget > 0)
    assert got.cut_weight(tds.graph, tw.edge_weight) == want.cut_weight(
        ds.graph, w.edge_weight)
    assert np.array_equal(got.loads(tw.vertex_weight),
                          want.loads(w.vertex_weight))


def test_unknown_partition_method_raises(tds, weights):
    with pytest.raises(ValueError, match="unknown partition method"):
        t_partition.partition_graph(tds.graph, NDEV, method="metis",
                                    weights=weights[1])


def _samples(graph, train_ids, sample_fn, n=6):
    return [sample_fn(graph, train_ids[16 * i:16 * i + 16], [3, 3],
                      np.random.default_rng(i)) for i in range(n)]


def _assert_same_counters(a, b):
    assert a["num_batches"] == b["num_batches"]
    for k in ("k_v", "k_e"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("flush_every", [1, 4, 64])
def test_edge_telemetry_bitwise(ds, tds, monkeypatch, flush_every):
    monkeypatch.setattr(EdgeTelemetry, "_FLUSH_EVERY", flush_every)
    monkeypatch.setattr(t_partition.EdgeTelemetry, "_FLUSH_EVERY", flush_every)
    js = _samples(ds.graph, ds.train_ids, sample_minibatch)
    ts = _samples(tds.graph, tds.train_ids, t_sample_minibatch)
    jt = EdgeTelemetry(ds.graph.num_nodes, ds.graph.num_edges)
    tt = t_partition.EdgeTelemetry(tds.graph.num_nodes, tds.graph.num_edges)
    for a, b in zip(js, ts):
        jt.record(a)
        tt.record(b)
    _assert_same_counters(jt.counters(), tt.counters())
    jw, tw = jt.as_weights(), tt.as_weights()
    for k in ("vertex_weight", "edge_weight"):
        assert np.array_equal(getattr(jw, k), getattr(tw, k)), k
    assert jw.num_epochs == tw.num_epochs == len(ts)
    # a self-loop's sentinel edge id (-1) counts as no edge
    assert tt.counters()["k_e"].sum() == sum(
        int((l.edge_id >= 0).sum()) for s in ts for l in s.layers)
    restored = t_partition.EdgeTelemetry(tds.graph.num_nodes,
                                         tds.graph.num_edges)
    restored.load_counters(tt.counters())
    _assert_same_counters(restored.counters(), tt.counters())


def test_edge_telemetry_two_threads_equal_serial(tds, monkeypatch):
    monkeypatch.setattr(t_partition.EdgeTelemetry, "_FLUSH_EVERY", 3)
    samples = _samples(tds.graph, tds.train_ids, t_sample_minibatch, n=12)
    serial = t_partition.EdgeTelemetry(tds.graph.num_nodes, tds.graph.num_edges)
    for s in samples:
        serial.record(s)
    threaded = t_partition.EdgeTelemetry(tds.graph.num_nodes,
                                         tds.graph.num_edges)
    workers = [threading.Thread(target=lambda part: [threaded.record(s)
                                                     for s in part],
                                args=(samples[k::2],)) for k in range(2)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    _assert_same_counters(serial.counters(), threaded.counters())


@pytest.mark.parametrize("budget", [0.0, BUDGET])
def test_refine_partition_bitwise(ds, tds, weights, part, budget):
    js = _samples(ds.graph, ds.train_ids, sample_minibatch)
    ts = _samples(tds.graph, tds.train_ids, t_sample_minibatch)
    jt = EdgeTelemetry(ds.graph.num_nodes, ds.graph.num_edges)
    tt = t_partition.EdgeTelemetry(tds.graph.num_nodes, tds.graph.num_edges)
    for a, b in zip(js, ts):
        jt.record(a)
        tt.record(b)
    tpart = t_partition.partition_graph(tds.graph, NDEV, method="gsplit",
                                        weights=weights[1],
                                        replication_budget=BUDGET)
    assert np.array_equal(tpart.assignment, part.assignment)
    want = refine_partition(ds.graph, part, jt.as_weights(),
                            replication_budget=budget)
    tw = tt.as_weights()
    got = t_partition.refine_partition(tds.graph, tpart, tw,
                                       replication_budget=budget)
    assert got.method == "telemetry"
    assert np.array_equal(got.assignment, want.assignment)
    assert_same_replication(want.replication, got.replication)
    # the refinement never raises the cut under the weights it descends
    w_e = tw.edge_weight + 1e-9
    assert got.cut_weight(tds.graph, w_e) <= tpart.cut_weight(tds.graph, w_e)


# --------------------------------------------------------------------- #
# replicated plans
# --------------------------------------------------------------------- #
def _plan_pair(ds, tds, part, n_targets, seed, with_halves, replication=True,
               pad_multiple=8):
    rep = part.replication if replication else None
    mb = sample_minibatch(ds.graph, ds.train_ids[:n_targets], [3, 3],
                          np.random.default_rng(seed))
    tmb = t_sample_minibatch(tds.graph, tds.train_ids[:n_targets], [3, 3],
                             np.random.default_rng(seed))
    plan = build_split_plan(mb, part.assignment, NDEV, with_halves=with_halves,
                            replication=rep, pad_multiple=pad_multiple)
    tplan = t_build_split_plan(tmb, part.assignment, NDEV,
                               with_halves=with_halves, replication=rep,
                               pad_multiple=pad_multiple)
    return plan, tplan


@pytest.mark.parametrize("with_halves", [False, True])
def test_replicated_plans_bitwise_fresh_and_repadded(ds, tds, part,
                                                     with_halves):
    """A small batch delivered after a large one: the repad grows N and S
    and shifts the replicated region (and the local half's replicated
    sources); both packages agree field by field, and on the signature."""
    R = part.replication.num_replicated
    hwm, thwm = {}, {}
    grew = set()
    for n, seed in ((48, 3), (12, 0), (16, 1)):
        # unpadded widths, so the later, smaller batches grow in S too
        plan, tplan = _plan_pair(ds, tds, part, n, seed, with_halves,
                                 pad_multiple=1)
        assert_same_plan(plan, tplan)
        assert tplan.layers[-1].num_replicated == R
        assert all(lp.num_replicated == 0 for lp in tplan.layers[:-1])
        stats = (tplan.cross_edge_fraction(), tplan.shuffle_rows(),
                 tplan.computed_edges())
        before = {i: (lp.n_local, lp.send_idx.shape[2])
                  for i, lp in enumerate(tplan.layers)}
        repad_plan(plan, hwm)
        t_repad_plan(tplan, thwm)
        assert_same_plan(plan, tplan)
        # the counters do not move under repadding
        assert stats == (tplan.cross_edge_fraction(), tplan.shuffle_rows(),
                         tplan.computed_edges())
        extra = ("float32", 2, with_halves)
        assert plan_signature(tplan, extra=extra) == j_plan_signature(
            plan, extra=extra)
        for i, lp in enumerate(tplan.layers):
            grew |= {k for k, old, new in (
                ("N", before[i][0], lp.n_local),
                ("S", before[i][1], lp.send_idx.shape[2])) if old != new}
    assert grew == {"N", "S"} and hwm == thwm


def test_replication_lowers_cross_edges_and_shuffle_rows(ds, tds, part):
    plan0, tplan0 = _plan_pair(ds, tds, part, 32, 2, False, replication=False)
    _, tplan1 = _plan_pair(ds, tds, part, 32, 2, False)
    for f0, f1 in zip(tplan0.front_ids, tplan1.front_ids):
        assert np.array_equal(f0, f1)  # the loads do not change
    assert tplan1.shuffle_rows() < tplan0.shuffle_rows()
    assert tplan1.cross_edge_fraction() < tplan0.cross_edge_fraction()
    assert tplan1.computed_edges() == tplan0.computed_edges()


def test_replication_staging_guard(ds, tds, part):
    """A replicated plan staged with a block height that does not match is a
    silent wrong gather: staging raises, on either path."""
    plan, tplan = _plan_pair(ds, tds, part, 16, 0, False)
    plan0, tplan0 = _plan_pair(ds, tds, part, 16, 0, False, replication=False)
    R = part.replication.num_replicated
    feats = t_plan_io.gather_features(tplan, tds.features)
    labels = t_plan_io.load_labels(tplan, tds.labels)
    for bad, height in ((tplan, 0), (tplan, R + 1), (tplan0, R)):
        with pytest.raises(ValueError, match="replicated"):
            t_plan_io.plan_to_device(bad, "cpu", num_replicated=height)
        with pytest.raises(ValueError, match="replicated"):
            t_plan_io.stage_batch(bad, feats, labels, "cpu",
                                  num_replicated=height)
        with pytest.raises(ValueError, match="replicated"):
            t_plan_io.pack_host(bad, labels, pin=False, num_replicated=height)
    t_plan_io.plan_to_device(tplan, "cpu", num_replicated=R)


# --------------------------------------------------------------------- #
# the forward and its gradients
# --------------------------------------------------------------------- #
def _setup(ds, tds, part, with_halves):
    """A replicated plan repadded after a larger one (N and S grown), its
    features, labels, and the replicated block."""
    plan, _ = _plan_pair(ds, tds, part, 16, 0, with_halves, pad_multiple=1)
    big, _ = _plan_pair(ds, tds, part, 48, 3, with_halves, pad_multiple=1)
    hwm: dict = {}
    repad_plan(big, hwm)
    repad_plan(plan, hwm)
    rep_block = ds.features[part.replication.vertices].astype(np.float32)
    return (plan, load_features(plan, ds.features),
            load_labels(plan, ds.labels), rep_block)


def _jax_params(ds, model):
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                   out_dim=4, num_layers=2, num_heads=2)
    return init_gnn_params(jax.random.PRNGKey(0), spec)


def _jax_out_and_grads(spec, params, feats, pa, labels, rep_block):
    def loss(p):
        out = gnn_forward(spec, p, feats, pa, sim_shuffle, rep_block=rep_block)
        return masked_softmax_xent(out, jnp.asarray(labels),
                                   pa["target_mask"]), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), [{k: np.asarray(v) for k, v in g.items()}
                             for g in grads]


def _port_out_and_grads(tspec, np_params, feats, pa, labels, rep_block):
    gnn = params_from_jax(np_params, tspec, "cpu")
    out = t_gnn_forward(tspec, list(gnn.layers), feats, pa,
                        rep_block=rep_block)
    t_xent(out, torch.as_tensor(labels), pa["target_mask"]).backward()
    return out.detach().numpy(), [
        {k: p.grad.numpy() for k, p in layer.items()} for layer in gnn.layers
    ]


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("overlap", [False, True], ids=["blocking", "overlap"])
def test_replicated_forward_and_grads_match_jax(ds, tds, part, model, backend,
                                                overlap):
    plan, feats, labels, rep_block = _setup(ds, tds, part, overlap)
    R = part.replication.num_replicated
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16, out_dim=4,
              num_layers=2, num_heads=2, overlap=overlap,
              shuffle_chunks=2 if overlap else 1)
    jspec = GNNSpec(agg_backend="pallas" if backend == "fused" else "jnp", **kw)
    params = init_gnn_params(jax.random.PRNGKey(0), jspec)
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in params]
    want, want_g = _jax_out_and_grads(
        jspec, params, jnp.asarray(feats),
        plan_to_device(plan, with_halves=overlap, num_replicated=R), labels,
        jnp.asarray(rep_block))
    got, got_g = _port_out_and_grads(
        TGNNSpec(agg_backend=backend, **kw), np_params,
        torch.as_tensor(feats),
        t_plan_io.plan_to_device(plan, "cpu", with_halves=overlap,
                                 num_replicated=R),
        labels, torch.as_tensor(rep_block))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for a, b in zip(got_g, want_g, strict=True):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_port_replicated_equals_unreplicated(ds, tds, part, model, backend):
    """The same batch with and without replication in the port: blocking
    SAGE and GCN bitwise (rerouting a source leaves every dst's edge order
    and the gathered bits unchanged), GAT within tolerance (its weight
    gradient sums over another row set); the overlap schedule within 5e-5."""
    plan1, tplan1 = _plan_pair(ds, tds, part, 32, 2, True)
    _, tplan0 = _plan_pair(ds, tds, part, 32, 2, True, replication=False)
    R = part.replication.num_replicated
    feats = torch.as_tensor(load_features(plan1, ds.features))
    labels = load_labels(plan1, ds.labels)
    rep_block = torch.as_tensor(
        tds.features[part.replication.vertices].astype(np.float32))
    np_params = [{k: np.asarray(v) for k, v in d.items()}
                 for d in _jax_params(ds, model)]
    spec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=4, num_layers=2, num_heads=2, agg_backend=backend)
    pa0 = t_plan_io.plan_to_device(tplan0, "cpu", with_halves=True)
    pa1 = t_plan_io.plan_to_device(tplan1, "cpu", with_halves=True,
                                   num_replicated=R)
    out0, g0 = _port_out_and_grads(spec, np_params, feats, pa0, labels, None)
    out1, g1 = _port_out_and_grads(spec, np_params, feats, pa1, labels,
                                   rep_block)
    pairs = [(out1, out0)] + [(a[k], b[k]) for a, b in zip(g1, g0) for k in b]
    for a, b in pairs:
        if model == "gat":
            np.testing.assert_allclose(a, b, **GRAD_TOL)
        else:
            assert np.array_equal(a, b)
    ospec = replace(spec, overlap=True, shuffle_chunks=3)
    out2, _ = _port_out_and_grads(ospec, np_params, feats, pa1, labels,
                                  rep_block)
    np.testing.assert_allclose(out2, out0, rtol=5e-5, atol=5e-5)


@settings(max_examples=6, deadline=None)
@given(lo=st.integers(0, 40), width=st.integers(4, 24),
       seed=st.integers(0, 1000))
def test_repadded_replicated_plans_preserve_forward(ds, tds, part, lo, width,
                                                    seed):
    """Property (the counterpart of the JAX package's): a small batch
    repadded to a larger batch's marks, with replication and the overlap
    halves, equals its fresh plan in the counters and in the port's overlap
    forward; and the repadded plan equals JAX's bitwise."""
    rep = part.replication
    plans = []
    for g, sample_fn, build, repad in (
        (ds, sample_minibatch, build_split_plan, repad_plan),
        (tds, t_sample_minibatch, t_build_split_plan, t_repad_plan),
    ):
        rng = np.random.default_rng(seed)
        big = sample_fn(g.graph, g.train_ids[:48], [4, 4], rng)
        small = sample_fn(g.graph, g.train_ids[lo:lo + width], [4, 4], rng)
        hwm: dict = {}
        repad(build(big, part.assignment, NDEV, with_halves=True,
                    replication=rep), hwm)
        plans.append(repad(build(small, part.assignment, NDEV,
                                 with_halves=True, replication=rep), hwm))
    fresh = t_build_split_plan(small, part.assignment, NDEV, with_halves=True,
                               replication=rep)
    repadded = plans[1]
    assert_same_plan(plans[0], repadded)
    for name in ("cross_edge_fraction", "shuffle_rows", "computed_edges"):
        assert getattr(repadded, name)() == getattr(fresh, name)(), name
    spec = TGNNSpec(model="sage", in_dim=tds.spec.feat_dim, hidden_dim=16,
                    out_dim=4, num_layers=2, overlap=True, shuffle_chunks=2)
    np_params = [{k: np.asarray(v) for k, v in d.items()}
                 for d in _jax_params(ds, "sage")]
    gnn = params_from_jax(np_params, spec, "cpu")
    rep_block = torch.as_tensor(
        tds.features[rep.vertices].astype(np.float32))
    outs = []
    with torch.no_grad():
        for plan in (fresh, repadded):
            out = t_gnn_forward(
                spec, list(gnn.layers),
                torch.as_tensor(load_features(plan, tds.features)),
                t_plan_io.plan_to_device(plan, "cpu", with_halves=True,
                                         num_replicated=rep.num_replicated),
                rep_block=rep_block).numpy()
            mask = fresh.node_mask[0]
            outs.append(out[:mask.shape[0], :mask.shape[1]][mask])
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #
def _kw(ds, model="sage"):
    return dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)


def test_replicated_trajectory_and_refinement_match_jax(ds, tds):
    """Split with replication and telemetry: a train_iter + train_epoch
    trajectory against the JAX ``Trainer`` (rtol 1e-4); then
    ``refine_partition`` on both gives bitwise-equal assignments and
    replication sets, and the next epoch still matches."""
    ckw = dict(num_devices=NDEV, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, replication_budget=BUDGET,
               record_telemetry=True)
    jtr = Trainer(ds, GNNSpec(agg_backend="pallas", **_kw(ds)),
                  TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**_kw(ds))
    ttr = t_trainer.Trainer(tds, tspec, t_trainer.TrainConfig(**ckw),
                            device="cpu",
                            model=params_from_jax(np_params, tspec, "cpu"))
    assert_same_replication(jtr.replication, ttr.replication)
    assert ttr.rep_block.shape == (ttr.replication.num_replicated,
                                   tds.spec.feat_dim)
    targets = [ds.train_ids[i * 16:(i + 1) * 16] for i in range(2)]
    jl = [jtr.train_iter(t).loss for t in targets]
    tl = [ttr.train_iter(t).loss for t in targets]
    je, te = jtr.train_epoch(), ttr.train_epoch()
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    for a, b in zip(je.iters, te.iters, strict=True):
        for name in ("loaded_rows", "computed_edges", "shuffle_rows",
                     "wire_bytes", "padded_edge_slots", "busiest_edges",
                     "load_imbalance", "cross_edge_fraction"):
            assert getattr(a, name) == getattr(b, name), name
    _assert_same_counters(jtr.telemetry.counters(), ttr.telemetry.counters())
    jpart, tpart = jtr.refine_partition(), ttr.refine_partition()
    assert np.array_equal(jpart.assignment, tpart.assignment)
    assert_same_replication(jpart.replication, tpart.replication)
    assert torch.equal(ttr.rep_block, torch.as_tensor(
        tds.features[tpart.replication.vertices]))
    assert ttr.producer.assignment is tpart.assignment
    je, te = jtr.train_epoch(), ttr.train_epoch()
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    assert len(tl) == len(jl) > 4
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def _trajectory(tds, source, epochs=2, refine=False, **over):
    kw = dict(num_devices=NDEV, fanouts=(4, 4), batch_size=16,
              presample_epochs=2, plan_source=source, pipeline_depth=3,
              plan_workers=2, seed=7, stall_timeout_s=30.0,
              replication_budget=BUDGET)
    tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)),
                           t_trainer.TrainConfig(**{**kw, **over}),
                           device="cpu")
    traj, last = [], None
    for e in range(epochs):
        last = tr.train_epoch(max_iters=3)
        traj += [(i.loss, i.accuracy, i.cross_edge_fraction)
                 for i in last.iters]
        if refine and e == 0:
            tr.refine_partition()
    return traj, last, tr


@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_replicated_pipelined_equal_serial_bitwise(tds, serial, pipelined):
    """With replication and telemetry, and a refinement after the first
    epoch: the pipelined source equals the serial one bitwise, and records
    the same telemetry."""
    a, _, tra = _trajectory(tds, serial, record_telemetry=True, refine=True)
    b, last, trb = _trajectory(tds, pipelined, record_telemetry=True,
                               refine=True, plan_workers=3)
    assert len(a) == len(b) == 6
    assert a == b
    assert last.pipeline["leaked_threads"] == 0
    _assert_same_counters(tra.telemetry.counters(), trb.telemetry.counters())
    assert np.array_equal(tra.partition.assignment, trb.partition.assignment)
    if serial == "device":
        # the rebuilt sampler samples over the refined partition
        assert tra.device_sampler.stats()["sampler_batches"] == 3


def test_replication_changes_no_loss_and_lowers_wire(tds):
    """Blocking SAGE in the trainer: the same losses bit for bit with and
    without replication, fewer wire bytes and a lower cross-edge fraction at
    every step; cached ≡ uncached with replication."""
    a, _, _ = _trajectory(tds, "serial", replication_budget=0.0)
    b, lb, _ = _trajectory(tds, "serial")
    assert [x[:2] for x in a] == [x[:2] for x in b]
    assert all(y[2] < x[2] for x, y in zip(a, b))
    _, la, _ = _trajectory(tds, "serial", epochs=1, replication_budget=0.0)
    assert lb.totals()["wire_bytes"] < la.totals()["wire_bytes"]
    c, _, _ = _trajectory(tds, "serial", cache_mode="partitioned",
                          cache_capacity_per_device=24)
    assert c == b


def test_refine_partition_needs_telemetry(tds):
    tr = t_trainer.Trainer(
        tds, TGNNSpec(**_kw(tds)),
        t_trainer.TrainConfig(num_devices=NDEV, fanouts=(3, 3), batch_size=16,
                              presample_epochs=1), device="cpu")
    with pytest.raises(ValueError, match="record_telemetry"):
        tr.refine_partition()
    assert tr.replication is None and tr.rep_block is None
