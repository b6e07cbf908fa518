"""The 2-D (replica, split) mesh in sim form in the port, against the JAX
package's sim mesh (``tests/test_mesh.py``'s set-up: the tiny graph, 2
layers, hidden 16, P = 2, batch 32).

* Bitwise, inside the port: the R = 1 mesh equals the 1-D path for SAGE,
  GCN and GAT, blocking and overlap, fp32 and bf16 wire; with the cache and
  replication; on the inline ``train_iter`` path with a forced repad. At
  R = 2, serial ≡ pipelined and device ≡ device_pipelined.
* Bitwise, against JAX: R = 2 mesh deliveries (plans, labels, cache plans,
  feature blocks and ``mesh_signature``) of the JAX ``PlanProducer``; the
  replica-keyed ``DeviceSampler.sample_batch``; ``sim_alltoall(axis=1)``.
* R = 2 trajectories within rtol 1e-4 of the JAX sim mesh ``Trainer`` from
  carried weights (the aggregation sums in another order); an R x 1 mesh
  within rtol 2e-4 / atol 1e-5 of the port's dp (the mesh averages R
  per-replica means where dp takes one joint mean).
* ``EpochStats.t_first_iter`` and ``steady_step_seconds()`` as the JAX
  ``Trainer`` has them, on the same tiny serial run.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.shuffle import sim_alltoall as j_sim_alltoall
from repro.graph.datasets import make_dataset
from repro.models.gnn import GNNSpec
from repro.runtime import mesh_signature as j_mesh_signature
from repro.runtime.plan_source import _finalize as j_finalize
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core.shuffle import sim_alltoall
from repro_torch.faults import FaultAction, FaultInjector
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.runtime import mesh_signature, plan_signature
from repro_torch.runtime.plan_source import MeshPlanBatch, PlanProducer, finalize
from repro_torch.train import trainer as t_trainer
from test_torch_cache import assert_same_cache_plan
from test_torch_replication import assert_same_plan

BASE = dict(mode="split", num_devices=2, fanouts=(3, 3), batch_size=32,
            presample_epochs=1, plan_source="serial", seed=7)


@pytest.fixture(scope="module")
def ds():
    return make_dataset("tiny")


@pytest.fixture(scope="module")
def tds():
    return t_make_dataset("tiny")


def _kw(ds, model="sage"):
    return dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)


def _cfg(num_replicas, **over):
    # every pipelined source is watched, so no producer can hang the test
    return t_trainer.TrainConfig(**{**BASE, "num_replicas": num_replicas,
                                    "pipeline_depth": 3, "plan_workers": 2,
                                    "stall_timeout_s": 30.0, **over})


def _trajectory(tds, num_replicas, model="sage", epochs=2, iters=2, **over):
    tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds, model)),
                           _cfg(num_replicas, **over), device="cpu")
    traj, last = [], None
    for _ in range(epochs):
        last = tr.train_epoch(max_iters=iters)
        traj += [(i.loss, i.accuracy) for i in last.iters]
    return tr, traj, last


def _same_params(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a._opt_tensors(),
                                                 b._opt_tensors(), strict=True))


# --------------------------------------------------------------------- #
# R = 1 mesh ≡ the 1-D path, bitwise
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("overlap", [False, True], ids=["blocking", "overlap"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_r1_mesh_bitwise_identical_to_1d(tds, model, overlap, wire):
    """Two epochs, so epoch 2's plans are repadded against epoch 1's marks;
    params, Adam slots and the signature counts equal too."""
    kw = dict(shuffle_overlap=overlap, wire_dtype=wire,
              shuffle_chunks=2 if overlap else 1)
    tr0, t0, last0 = _trajectory(tds, 0, model, **kw)
    tr1, t1, last1 = _trajectory(tds, 1, model, **kw)
    assert len(t0) == len(t1) == 4
    assert t0 == t1
    assert _same_params(tr0, tr1)
    assert last0.pipeline == last1.pipeline


def test_r1_mesh_bitwise_with_cache_and_replication(tds):
    kw = dict(cache_mode="distributed", cache_capacity_per_device=24,
              replication_budget=0.05)
    tr0, t0, _ = _trajectory(tds, 0, **kw)
    tr1, t1, _ = _trajectory(tds, 1, **kw)
    assert t0 == t1 and _same_params(tr0, tr1)
    # the cached step and the replicated block really ran
    assert tr1.cache_block is not None and tr1.rep_block is not None


def test_r1_mesh_bitwise_on_inline_path_with_forced_repad(tds):
    """A big batch raises every mark, then a small one is repadded to them."""
    results = []
    for r in (0, 1):
        tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), _cfg(r),
                               device="cpu")
        s1 = tr.train_iter(tds.train_ids[:48])
        marks = dict(tr._pad_hwm)
        s2 = tr.train_iter(tds.train_ids[48:60])
        assert tr._pad_hwm == marks
        results.append((s1.loss, s1.accuracy, s2.loss, s2.accuracy,
                        s2.loaded_rows, s2.padded_edge_slots))
    assert results[0] == results[1]


# --------------------------------------------------------------------- #
# R = 2 against the JAX sim mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("source", ["serial", "device"])
def test_r2_trajectory_matches_jax(ds, tds, source):
    """The JAX sim mesh ``Trainer`` and the port's, from the same weights:
    losses and accuracies within rtol 1e-4, the work counters and the
    signature counts equal."""
    over = dict(plan_source=source, num_replicas=2, lr=5e-3)
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **_kw(ds)),
                  TrainConfig(**{**BASE, **over}, sampler_backend="jnp"))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**_kw(tds))
    ttr = t_trainer.Trainer(tds, tspec, _cfg(**over), device="cpu",
                            model=params_from_jax(np_params, tspec, "cpu"))
    jl, tl = [], []
    for _ in range(2):
        je, te = jtr.train_epoch(max_iters=2), ttr.train_epoch(max_iters=2)
        jl += [(s.loss, s.accuracy) for s in je.iters]
        tl += [(s.loss, s.accuracy) for s in te.iters]
        for a, b in zip(je.iters, te.iters, strict=True):
            for name in ("loaded_rows", "computed_edges", "shuffle_rows",
                         "wire_bytes", "padded_edge_slots", "busiest_edges",
                         "load_imbalance", "cross_edge_fraction"):
                assert getattr(a, name) == getattr(b, name), name
        for k in ("signatures", "hits", "misses"):
            assert te.pipeline[k] == je.pipeline[k], k
    assert len(tl) == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


def _producers(ds, tds, sampler, cache):
    """The JAX and port producers of one R = 2 trainer configuration."""
    over = dict(num_replicas=2, plan_source=sampler)
    if cache:
        over.update(cache_mode="distributed", cache_capacity_per_device=24,
                    replication_budget=0.05, shuffle_overlap=True)
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **_kw(ds)),
                  TrainConfig(**{**BASE, **over}, sampler_backend="jnp"))
    ttr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), _cfg(**over),
                            device="cpu")
    return jtr, ttr


@pytest.mark.parametrize("sampler,cache", [("serial", False), ("device", False),
                                           ("serial", True)],
                         ids=["host", "device", "host-cache-rep-halves"])
def test_r2_deliveries_bitwise_equal_to_jax(ds, tds, sampler, cache):
    """Three R = 2 batches of a grown batch size, through each package's
    producer and delivery: every part's plan, labels, feature rows and
    cache plan, the shared marks and each ``mesh_signature`` equal."""
    jtr, ttr = _producers(ds, tds, sampler, cache)
    assert isinstance(ttr.producer, PlanProducer)
    extra = ("float32", 1, cache)
    jhwm, thwm = {}, {}
    for i, n in enumerate((32, 64, 24)):
        targets = ds.train_ids[8 * i:8 * i + n]
        jb = j_finalize(jtr.producer.build(0, i, targets), jhwm, None, extra)
        tb = finalize(ttr.producer.build(0, i, targets), thwm, None, extra)
        assert isinstance(tb, MeshPlanBatch) and tb.num_replicas == 2
        for jp, tp in zip(jb.parts, tb.parts, strict=True):
            assert_same_plan(jp.plan, tp.plan)
            assert np.array_equal(jp.labels, tp.labels)
            rows = tp.feats.numpy()
            assert np.array_equal(jp.feats[:, :rows.shape[1]], rows)
            assert not jp.feats[:, rows.shape[1]:].any()
            assert (jp.cache_plan is None) == (tp.cache_plan is None) == (
                not cache)
            if cache:
                assert_same_cache_plan(jp.cache_plan, tp.cache_plan)
        assert thwm == jhwm
        assert tb.signature == jb.signature
        assert tb.signature == j_mesh_signature(
            [(p.plan, p.cache_plan) for p in tb.parts], extra)


def test_mesh_signature_keys_on_mesh_shape(tds):
    """The R = 1 key differs from the 1-D key of the same plan and from the
    R = 2 key; delivery leaves both R = 2 parts of one shape."""
    tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), _cfg(2), device="cpu")
    source = tr.plan_source_for(0, max_iters=1)
    batch = next(iter(source))
    source.close()
    parts = [(p.plan, p.cache_plan) for p in batch.parts]
    sig2 = mesh_signature(parts, ("x",))
    sig1 = mesh_signature(parts[:1], ("x",))
    flat = plan_signature(parts[0][0], parts[0][1], ("x",))
    assert sig2 == batch.signature[:3] + (("x",),)
    assert sig2 != sig1 and flat not in (sig1, sig2)
    assert sig2[:2] == ("mesh", 2) and sig1[:2] == ("mesh", 1)
    assert sig2[2][0] == sig2[2][1]


def test_rx1_mesh_matches_dp_trajectory(tds):
    """R x 1 (P = 1) samples the micro-batches dp over R devices samples
    (both key chunk r as ``sample_micro_batch``): losses within rtol 2e-4 /
    atol 1e-5, accuracies within 1e-6, loaded rows equal."""
    _, mesh, _ = _trajectory(tds, 2, num_devices=1, iters=3)
    tr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)),
                           _cfg(0, mode="dp", num_devices=2), device="cpu")
    dp = []
    for _ in range(2):
        dp += [(i.loss, i.accuracy) for i in tr.train_epoch(max_iters=3).iters]
    assert len(mesh) == len(dp) == 4
    np.testing.assert_allclose([l for l, _ in mesh], [l for l, _ in dp],
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose([a for _, a in mesh], [a for _, a in dp],
                               atol=1e-6)


@pytest.mark.parametrize("extra", [{}, dict(
    cache_mode="partitioned", cache_capacity_per_device=24,
    shuffle_overlap=True, shuffle_chunks=2)], ids=["plain", "cache-overlap"])
def test_r2_pipelined_sources_bitwise_equal_to_inline_ones(tds, extra):
    """serial ≡ pipelined and device ≡ device_pipelined at R = 2: the keyed
    draws and the shared-mark repad on the ordered side of the queue."""
    runs = {}
    for source in ("serial", "pipelined", "device", "device_pipelined"):
        _, runs[source], last = _trajectory(tds, 2, plan_source=source, **extra)
        assert last.pipeline.get("leaked_threads", 0) == 0
    assert runs["serial"] == runs["pipelined"]
    assert runs["device"] == runs["device_pipelined"]
    assert len(runs["serial"]) == 4


def test_mesh_guard_skips_a_poisoned_replica_and_traces_parts(tds):
    """skip_nonfinite on the mesh: a NaN in one replica's rows poisons the
    averaged gradient, so the update is dropped and params and Adam slots
    stay bitwise as they were; the trace holds a ``plan/split`` and a
    ``plan/load`` span a replica."""
    inj = FaultInjector(schedule=[FaultAction("poison", epoch=0, batch=0)])
    spec = TGNNSpec(**_kw(tds))
    tr = t_trainer.Trainer(tds, spec, _cfg(2, skip_nonfinite=True,
                                           obs_trace=True,
                                           plan_source="pipelined"),
                           device="cpu", injector=inj)
    fresh = t_trainer.Trainer(tds, spec, _cfg(2, skip_nonfinite=True),
                              device="cpu")
    st = tr.train_epoch(max_iters=1)
    assert tr.nonfinite_skips == 1 and not np.isfinite(st.iters[0].loss)
    assert tr.opt_state.step == 0 and _same_params(tr, fresh)
    events = tr.obs.tracer.to_chrome()["traceEvents"]
    for name in ("plan/split", "plan/load"):
        reps = sorted(e["args"]["replica"] for e in events
                      if e["ph"] == "X" and e["name"] == name)
        assert reps == [0, 1], name


# --------------------------------------------------------------------- #
# keying, the exchange's axis, validation
# --------------------------------------------------------------------- #
def test_device_sampler_replica_keying(ds, tds):
    """``(replica, R)`` folds into the flattened counter ``batch*R +
    replica``, equal to JAX's replica-keyed draw; defaults keep the key."""
    jtr, ttr = _producers(ds, tds, "device", False)
    teng, jeng = ttr.device_sampler, jtr.device_sampler
    t = ds.train_ids[:16]
    a = teng.sample_batch(t, epoch=0, batch=1, replica=1, num_replicas=2)
    flat = teng.sample_batch(t, epoch=0, batch=3)
    ref = jeng.sample_batch(t, epoch=0, batch=1, replica=1, num_replicas=2)
    base = teng.sample_batch(t, epoch=0, batch=1, replica=0, num_replicas=1)
    for other in (flat, ref):
        for la, lb in zip(a.layers, other.layers, strict=True):
            for f in ("src", "dst", "edge_id"):
                assert np.array_equal(getattr(la, f), getattr(lb, f)), f
        for fa, fb in zip(a.frontiers, other.frontiers, strict=True):
            assert np.array_equal(fa, fb)
    default = teng.sample_batch(t, epoch=0, batch=1)
    for la, lb in zip(base.layers, default.layers, strict=True):
        assert np.array_equal(la.src, lb.src)
    for bad in ((2, 2), (-1, 2), (1, 1)):
        with pytest.raises(ValueError, match="out of range"):
            teng.sample_batch(t, epoch=0, batch=0, replica=bad[0],
                              num_replicas=bad[1])


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_sim_alltoall_axis1_confined_per_replica(wire):
    rng = np.random.default_rng(0)
    send = rng.normal(size=(3, 4, 4, 5, 2)).astype(np.float32)
    got = sim_alltoall(torch.as_tensor(send), wire, axis=1)
    want = torch.stack([sim_alltoall(torch.as_tensor(send[r]), wire)
                        for r in range(3)])
    assert torch.equal(got, want)
    assert np.array_equal(
        got.numpy(), np.asarray(j_sim_alltoall(jnp.asarray(send), wire, axis=1)))


@pytest.mark.parametrize("mode", ["dp", "pushpull"])
def test_mesh_rejects_non_split_modes(tds, mode):
    spec = TGNNSpec(**_kw(tds))
    with pytest.raises(ValueError, match="split"):
        t_trainer.Trainer(tds, spec, _cfg(2, mode=mode), device="cpu")
    with pytest.raises(ValueError, match="num_replicas"):
        t_trainer.check_config(_cfg(-1))
    sampler = TNeighborSampler(tds.graph, tds.train_ids, [3, 3], 32)
    with pytest.raises(ValueError, match="split"):
        PlanProducer(sampler, tds.features, tds.labels, 2, -1, mode=mode,
                     num_replicas=1)


# --------------------------------------------------------------------- #
# EpochStats' steady-step time
# --------------------------------------------------------------------- #
def test_epoch_stats_steady_step_matches_jax(ds, tds):
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **_kw(ds)), TrainConfig(**BASE))
    ttr = t_trainer.Trainer(tds, TGNNSpec(**_kw(tds)), _cfg(0), device="cpu")
    jst, tst = jtr.train_epoch(max_iters=2), ttr.train_epoch(max_iters=2)
    jfields = {f.name for f in dataclasses.fields(jst)} - {"recompiles"}
    assert {f.name for f in dataclasses.fields(tst)} == jfields
    for st in (jst, tst, t_trainer.EpochStats(iters=tst.iters[:1],
                                              t_wall=0.5, t_first_iter=0.5),
               t_trainer.EpochStats(t_wall=0.25)):
        n = len(st.iters)
        want = ((st.t_wall - st.t_first_iter) / (n - 1) if n > 1
                else st.t_wall / max(n, 1))
        assert st.steady_step_seconds() == want
    for st in (jst, tst):
        assert len(st.iters) == 2 and 0 < st.t_first_iter <= st.t_wall
        assert st.steady_step_seconds() > 0
