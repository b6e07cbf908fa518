"""The overlap schedule in the port (DESIGN.md §3a) against the JAX package's.

* The host stages: ``packed_layout``, ``split_edge_halves`` (``recv_width``
  included) and plans built ``with_halves`` are bitwise equal to JAX's, fresh
  and after ``repad_plan`` grows N and S; so are ``chunk_slices``,
  ``plan_signature`` of a plan with halves and ``modeled_wire_bytes``.
* ``_gnn_layer_overlap`` (through ``gnn_forward`` with ``overlap``) from the
  same carried weights against JAX's overlap forward on both backends, at 1
  and 3 chunks: logits rtol 3e-5, the gradients of the trainer's masked
  cross-entropy rtol 3e-4 (docs/KERNELS.md §6); against the port's own
  blocking forward 5e-5, a bf16 wire 5e-2.
* A ``train_epoch`` trajectory with overlap against the JAX ``Trainer``:
  loss rtol 1e-4 atol 1e-6; inside the port serial ≡ pipelined and device ≡
  device_pipelined bitwise with overlap and the cache.
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_split_plan, partition_graph, presample, sim_shuffle
from repro.core.shuffle import chunk_slices
from repro.core.splitting import repad_plan, split_edge_halves
from repro.graph.datasets import make_dataset
from repro.graph.sampling import sample_minibatch
from repro.kernels.gather_segsum.layout import packed_layout
from repro.models.gnn import GNNSpec, init_gnn_params
from repro.models.gnn.layers import gnn_forward
from repro.runtime import plan_signature as j_plan_signature
from repro.train.loss import masked_softmax_xent
from repro.train.plan_io import load_features, load_labels, plan_to_device
from repro.train.trainer import TrainConfig, Trainer
from repro.train.trainer import modeled_wire_bytes as j_wire_bytes
from repro_torch.core import build_split_plan as t_build_split_plan
from repro_torch.core import partition_graph as t_partition_graph
from repro_torch.core import presample as t_presample
from repro_torch.core import repad_plan as t_repad_plan
from repro_torch.core.shuffle import chunk_slices as t_chunk_slices
from repro_torch.core.splitting import LayerPlan as TLayerPlan
from repro_torch.core.splitting import split_edge_halves as t_split_edge_halves
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import sample_minibatch as t_sample_minibatch
from repro_torch.kernels.gather_segsum.layout import packed_layout as t_packed_layout
from repro_torch.kernels.shuffle import kernel as sh_kernel
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import gnn_forward as t_gnn_forward
from repro_torch.models.gnn import params_from_jax
from repro_torch.models.gnn.layers import _half_sum, _half_weighted
from repro_torch.runtime.signature import plan_signature
from repro_torch.train import plan_io as t_plan_io
from repro_torch.train import trainer as t_trainer
from repro_torch.train.loss import masked_softmax_xent as t_xent

FWD_TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
BLOCKING_TOL = dict(rtol=5e-5, atol=5e-5)
WIRE_TOL = dict(rtol=5e-2, atol=5e-2)
HALF_FIELDS = ("ledge_src", "ledge_dst", "ledge_mask", "ledge_ids",
               "lpack_perm", "lpack_dst", "redge_src", "redge_dst",
               "redge_mask", "redge_ids", "rpack_perm", "rpack_dst")


def assert_same_plan(a, b):
    """A JAX plan and a port plan equal field by field, bitwise (the half
    fields when both carry them)."""
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
        assert la.num_replicated == 0 and la.has_halves == lb.has_halves


@pytest.fixture(scope="module")
def ds():
    return make_dataset("tiny")


@pytest.fixture(scope="module")
def part(ds):
    w = presample(ds.graph, ds.train_ids, [3, 3], 16, num_epochs=1)
    return partition_graph(ds.graph, 4, method="gsplit", weights=w)


def _plan(ds, part, n_targets=16, seed=0, num_devices=4):
    mb = sample_minibatch(ds.graph, ds.train_ids[:n_targets], [3, 3],
                          np.random.default_rng(seed))
    assignment = part.assignment if num_devices == 4 else np.zeros_like(
        part.assignment)
    return build_split_plan(mb, assignment, num_devices, with_halves=True)


# --------------------------------------------------------------------- #
# host stages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,P,E,N,keep", [
    (0, 4, 300, 200, 0.8),
    (1, 2, 0, 50, 0.5),  # a zero-width half
    (2, 3, 40, 700, 0.1),  # many empty dst blocks
    (3, 1, 500, 64, 1.0),
])
def test_packed_layout_bitwise(seed, P, E, N, keep):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, size=(P, E)).astype(np.int32)
    mask = rng.random((P, E)) < keep
    for x, y in zip(packed_layout(dst, mask, N), t_packed_layout(dst, mask, N),
                    strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("recv_width", [None, "exact", "short"])
def test_split_edge_halves_bitwise(recv_width):
    """Random mixed-buffer sources; ``short`` puts some sources past the
    recv region (the static block the local half takes)."""
    rng = np.random.default_rng(5)
    P, E, n_local, S, N = 4, 200, 30, 8, 90
    src = rng.integers(0, n_local + P * S, size=(P, E)).astype(np.int32)
    dst = rng.integers(0, N, size=(P, E)).astype(np.int32)
    mask = rng.random((P, E)) < 0.7
    rw = {None: None, "exact": P * S, "short": P * S - 5}[recv_width]
    a = split_edge_halves(src, dst, mask, n_local, N, 8, recv_width=rw)
    b = t_split_edge_halves(src, dst, mask, n_local, N, 8, recv_width=rw)
    assert a.keys() == b.keys() == set(HALF_FIELDS)
    for k in HALF_FIELDS:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name,fanouts,batch", [
    ("tiny", [4, 4], 16),
    ("orkut-s", [4, 4], 64),
])
def test_plans_with_halves_bitwise_fresh_and_repadded(name, fanouts, batch):
    """Plans with halves equal JAX's fresh, and after a repad that grows the
    fronts (N) and the send width (S) of a small batch delivered after a
    large one, with equal high-water marks."""
    ds, tds = make_dataset(name), t_make_dataset(name)
    w = presample(ds.graph, ds.train_ids, fanouts, batch, num_epochs=1, seed=1)
    tw = t_presample(tds.graph, tds.train_ids, fanouts, batch, num_epochs=1,
                     seed=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    tpart = t_partition_graph(tds.graph, 4, method="gsplit", weights=tw)
    assert np.array_equal(part.assignment, tpart.assignment)
    hwm, thwm = {}, {}
    grew = set()
    for k, n in enumerate((4 * batch, batch // 2, batch)):
        targets = ds.train_ids[k * batch:k * batch + n]
        mb = sample_minibatch(ds.graph, targets, fanouts,
                              np.random.default_rng(k))
        tmb = t_sample_minibatch(tds.graph, targets, fanouts,
                                 np.random.default_rng(k))
        plan = build_split_plan(mb, part.assignment, 4, pad_multiple=-1,
                                with_halves=True)
        tplan = t_build_split_plan(tmb, tpart.assignment, 4, pad_multiple=-1,
                                   with_halves=True)
        assert tplan.layers[0].has_halves
        assert_same_plan(plan, tplan)
        before = {i: (lp.n_local, lp.send_idx.shape[2])
                  for i, lp in enumerate(tplan.layers)}
        repad_plan(plan, hwm)
        t_repad_plan(tplan, thwm)
        assert_same_plan(plan, tplan)
        for i, lp in enumerate(tplan.layers):
            if lp.n_local != before[i][0]:
                grew.add("N")
            if lp.send_idx.shape[2] != before[i][1]:
                grew.add("S")
    assert hwm == thwm and {"EL0", "ER0", "LEB0", "REB0"} <= set(thwm)
    assert grew == {"N", "S"}


@pytest.mark.parametrize("width,chunks,align", [
    (16, 1, 1), (16, 3, 1), (256, 4, 1), (16, 3, 8), (256, 4, 64),
    (128, 4, 32), (8, 3, 8), (5, 2, 1), (256, 3, 64),
])
def test_chunk_slices_match_jax(width, chunks, align):
    assert t_chunk_slices(width, chunks, align) == chunk_slices(width, chunks,
                                                               align)


def test_signature_with_halves_matches_jax(ds, part):
    extra = ("float32", 3, True)
    plans = [_plan(ds, part, n, seed) for n, seed in ((48, 3), (16, 0))]
    hwm = {}
    for plan in plans:
        repad_plan(plan, hwm)
        sig = plan_signature(plan, extra=extra)
        assert sig == j_plan_signature(plan, extra=extra)
        assert len(sig[3][0]) == 9  # the layer key holds the half widths


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_modeled_wire_bytes_matches_jax(ds, part, model, overlap, wire):
    plan = _plan(ds, part, 48, 3)
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16, out_dim=4,
              num_layers=2, num_heads=2, overlap=overlap)
    got = t_trainer.modeled_wire_bytes(plan, TGNNSpec(**kw), wire)
    assert got == j_wire_bytes(plan, GNNSpec(**kw), wire) > 0


# --------------------------------------------------------------------- #
# the overlap forward and its gradients
# --------------------------------------------------------------------- #
def _setup(ds, part, model):
    """A plan repadded after a larger one (grown, rebased layouts), its
    features, and JAX weights for ``model``."""
    plan = _plan(ds, part)
    big = _plan(ds, part, n_targets=48, seed=3)
    hwm: dict = {}
    repad_plan(big, hwm)
    repad_plan(plan, hwm)
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                   out_dim=4, num_layers=2, num_heads=2)
    params = init_gnn_params(jax.random.PRNGKey(0), spec)
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in params]
    return plan, spec, params, np_params


def _jax_out_and_grads(spec, params, feats, pa, labels):
    """Logits and the gradients of the trainer's loss, the masked
    cross-entropy over the targets."""

    def loss(p):
        out = gnn_forward(spec, p, feats, pa, sim_shuffle)
        return masked_softmax_xent(out, jnp.asarray(labels),
                                   pa["target_mask"]), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), [{k: np.asarray(v) for k, v in g.items()}
                             for g in grads]


def _port_out_and_grads(tspec, np_params, feats, pa, labels):
    gnn = params_from_jax(np_params, tspec, "cpu")
    out = t_gnn_forward(tspec, list(gnn.layers), feats, pa)
    t_xent(out, torch.as_tensor(labels), pa["target_mask"]).backward()
    return out.detach().numpy(), [
        {k: p.grad.numpy() for k, p in layer.items()} for layer in gnn.layers
    ]


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("chunks", [1, 3])
def test_overlap_forward_and_grads_match_jax(ds, part, model, backend, chunks):
    plan, spec, params, np_params = _setup(ds, part, model)
    jax_backend = "pallas" if backend == "fused" else "jnp"
    jspec = replace(spec, overlap=True, shuffle_chunks=chunks,
                    agg_backend=jax_backend)
    feats = load_features(plan, ds.features)
    labels = load_labels(plan, ds.labels)
    want, want_g = _jax_out_and_grads(
        jspec, params, jnp.asarray(feats), plan_to_device(plan, with_halves=True),
        labels)
    tspec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                     out_dim=4, num_layers=2, num_heads=2, agg_backend=backend,
                     overlap=True, shuffle_chunks=chunks)
    got, got_g = _port_out_and_grads(
        tspec, np_params, torch.as_tensor(feats),
        t_plan_io.plan_to_device(plan, "cpu", with_halves=True), labels)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for a, b in zip(got_g, want_g, strict=True):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_overlap_matches_port_blocking(ds, part, model, backend):
    """Overlap (1 and 3 chunks) against the port's own blocking forward:
    5e-5; a bf16 wire at 2 chunks: 5e-2."""
    plan, _, _, np_params = _setup(ds, part, model)
    feats = torch.as_tensor(load_features(plan, ds.features))
    pa = t_plan_io.plan_to_device(plan, "cpu", with_halves=True)
    spec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=4, num_layers=2, num_heads=2, agg_backend=backend)
    gnn = params_from_jax(np_params, spec, "cpu")
    with torch.no_grad():
        ref = t_gnn_forward(spec, list(gnn.layers), feats, pa).numpy()
        for chunks in (1, 3):
            got = t_gnn_forward(replace(spec, overlap=True,
                                        shuffle_chunks=chunks),
                                list(gnn.layers), feats, pa).numpy()
            np.testing.assert_allclose(got, ref, **BLOCKING_TOL)
        bf = replace(spec, overlap=True, shuffle_chunks=2,
                     wire_dtype="bfloat16")
        got = t_gnn_forward(bf, list(gnn.layers), feats, pa).numpy()
    np.testing.assert_allclose(got, ref, **WIRE_TOL)


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_zero_width_halves_give_exact_zeros(ds, part, model):
    """P=1: no remote edge, a remote half of width 0 and S=0. The halves'
    ops return exact zeros statically and the overlap forward equals JAX's."""
    plan = _plan(ds, part, num_devices=1)
    assert all(lp.redge_src.shape[1] == 0 and lp.send_idx.shape[2] == 0
               for lp in plan.layers)
    pa = t_plan_io.plan_to_device(plan, "cpu", with_halves=True)
    lp = pa["layers"][0]
    spec = TGNNSpec(model=model, agg_backend="fused")
    rows = torch.randn(1, 10, 8)
    for got in (_half_sum(spec, rows, lp, "r", 7),
                _half_weighted(spec, rows, torch.randn(1, 0, 2), lp, "r", 7, 4)):
        assert got.shape == (1, 7, 8) and not got.any()
    _, jspec, params, np_params = _setup(ds, part, model)
    feats = load_features(plan, ds.features)
    labels = load_labels(plan, ds.labels)
    want, _ = _jax_out_and_grads(
        replace(jspec, overlap=True, shuffle_chunks=2), params,
        jnp.asarray(feats), plan_to_device(plan, with_halves=True), labels)
    tspec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                     out_dim=4, num_layers=2, num_heads=2, overlap=True,
                     shuffle_chunks=2)
    got, _ = _port_out_and_grads(tspec, np_params, torch.as_tensor(feats), pa,
                                 labels)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("model,calls", [("sage", 2), ("gcn", 1), ("gat", 6)])
def test_chunked_sends_reach_one_shuffle_adjoint(ds, part, monkeypatch, model,
                                                 calls):
    """Three chunks of one send buffer: autograd's slice adjoint sums their
    cotangents into one ``shuffle_bwd`` call a layer (SAGE: the send and the
    self rows of layer 0; GCN: the send; GAT: send, scores and self rows of
    both layers)."""
    seen = []
    real = sh_kernel.shuffle_bwd

    def counting(g, send_idx, send_count, num_rows):
        seen.append(tuple(g.shape))
        return real(g, send_idx, send_count, num_rows)

    monkeypatch.setattr(sh_kernel, "shuffle_bwd", counting)
    plan, _, _, np_params = _setup(ds, part, model)
    tspec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                     out_dim=4, num_layers=2, num_heads=2, overlap=True,
                     shuffle_chunks=3)
    _port_out_and_grads(tspec, np_params,
                        torch.as_tensor(load_features(plan, ds.features)),
                        t_plan_io.plan_to_device(plan, "cpu", with_halves=True),
                        load_labels(plan, ds.labels))
    assert len(seen) == calls, seen


def test_plan_without_halves_refuses_the_overlap_staging(ds, part):
    mb = sample_minibatch(ds.graph, ds.train_ids[:16], [3, 3],
                          np.random.default_rng(0))
    plan = t_build_split_plan(mb, part.assignment, 4)
    with pytest.raises(ValueError, match="without edge halves"):
        t_plan_io.plan_to_device(plan, "cpu", with_halves=True)


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("model,chunks", [("sage", 2), ("gat", 2)])
def test_overlap_trajectory_matches_jax(model, chunks):
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
              out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)
    ckw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, shuffle_overlap=True,
               shuffle_chunks=chunks)
    jtr = Trainer(ds, GNNSpec(agg_backend="pallas", **kw), TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(**ckw), device="cpu",
        model=params_from_jax(np_params, tspec, "cpu"),
    )
    assert ttr.spec.overlap and ttr.spec.shuffle_chunks == chunks
    targets = [ds.train_ids[i * 16:(i + 1) * 16] for i in range(2)]
    jl = [jtr.train_iter(t).loss for t in targets]
    tl = [ttr.train_iter(t).loss for t in targets]
    je, te = jtr.train_epoch(), ttr.train_epoch()
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    assert len(jl) == len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for a, b in zip(je.iters, te.iters, strict=True):
        assert a.wire_bytes == b.wire_bytes > 0
    assert te.pipeline["signatures"] == je.pipeline["signatures"]


def _trajectory(tds, model, source, **over):
    spec = TGNNSpec(model=model, in_dim=tds.spec.feat_dim, hidden_dim=16,
                    out_dim=tds.spec.num_classes, num_layers=2, num_heads=2)
    kw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
              presample_epochs=2, plan_source=source, pipeline_depth=3,
              plan_workers=2, seed=7, stall_timeout_s=30.0,
              shuffle_overlap=True, shuffle_chunks=3,
              cache_mode="partitioned", cache_capacity_per_device=24)
    tr = t_trainer.Trainer(tds, spec, t_trainer.TrainConfig(**{**kw, **over}),
                           device="cpu")
    traj, last = [], None
    for _ in range(2):
        last = tr.train_epoch(max_iters=3)
        traj += [(i.loss, i.accuracy) for i in last.iters]
    return traj, last


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_overlap_and_cache_pipelined_equal_serial_bitwise(model, serial,
                                                          pipelined):
    tds = t_make_dataset("tiny")
    a, _ = _trajectory(tds, model, serial)
    b, last = _trajectory(tds, model, pipelined, plan_workers=3)
    assert len(a) == len(b) == 6
    assert a == b
    assert last.pipeline["leaked_threads"] == 0
    assert last.totals()["load_local_hit"] > 0


def test_overlap_config_checks():
    with pytest.raises(ValueError, match="shuffle_chunks"):
        t_trainer.check_config(t_trainer.TrainConfig(shuffle_chunks=0))
    t_trainer.check_config(t_trainer.TrainConfig(shuffle_overlap=True,
                                                 shuffle_chunks=4))
