"""Cache serving in the port (paper §2.2/§7.1) against the JAX package's.

* ``graph/cache.py`` is a copy: ``FeatureCache``'s placement tables, resident
  block, ``build_plan``/``classify_plan`` and ``CachePlan.pad_to`` are bitwise
  equal to JAX's for ``partitioned`` and ``distributed`` at capacities 0,
  partial and every row.
* ``sim_serve_features`` is bitwise equal to JAX's and equal to
  ``load_features``, fresh and after repad; the pinned staging of a cached
  plan with halves is byte-equal to the per-array staging.
* A ``train_epoch`` with the partitioned cache against the JAX ``Trainer``:
  loss rtol 1e-4 atol 1e-6; inside the port cached ≡ uncached bitwise (fp32
  wire); the obs counters ``cache/*`` and ``wire/bytes`` equal the stats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import partition_graph
from repro.core.presample import presample
from repro.core.shuffle import sim_serve_features
from repro.core.splitting import build_split_plan, repad_plan
from repro.graph.cache import FeatureCache
from repro.graph.datasets import make_dataset
from repro.graph.sampling import sample_minibatch
from repro.models.gnn import GNNSpec
from repro.runtime import plan_signature as j_plan_signature
from repro.train.plan_io import cache_plan_to_device, load_features
from repro.train.plan_io import load_miss_features
from repro.train.plan_io import stage_host_features as j_stage_host_features
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core.shuffle import sim_serve_features as t_serve
from repro_torch.graph.cache import FeatureCache as TFeatureCache
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.obs.report import load_trace
from repro_torch.runtime.plan_source import finalize_cache_plan
from repro_torch.runtime.signature import plan_signature
from repro_torch.train import plan_io as t_plan_io
from repro_torch.train import trainer as t_trainer

NDEV = 4
CP_FIELDS = ("local_slot", "local_mask", "send_slot", "recv_pos", "recv_mask",
             "miss_ids", "miss_pos", "miss_mask")
CASES = [
    ("partitioned", 0),
    ("partitioned", 16),
    ("partitioned", 1_000_000),
    ("distributed", 0),
    ("distributed", 16),
    ("distributed", 1_000_000),
]


@pytest.fixture(scope="module")
def setup():
    ds = make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, [4, 4], 32, num_epochs=2)
    part = partition_graph(ds.graph, NDEV, method="gsplit", weights=w, seed=0)
    return ds, w, part


def _caches(ds, w, part, mode, capacity):
    kw = dict(ranking=w.vertex_weight, mode=mode,
              partition_assignment=part.assignment)
    return (FeatureCache(ds.graph.num_nodes, NDEV, capacity, **kw),
            TFeatureCache(ds.graph.num_nodes, NDEV, capacity, **kw))


def _plan(ds, part, lo, hi, seed, with_halves=False):
    mb = sample_minibatch(ds.graph, ds.train_ids[lo:hi], [4, 4],
                          np.random.default_rng(seed))
    return build_split_plan(mb, part.assignment, NDEV, with_halves=with_halves)


def _bd(b):
    """A ``LoadBreakdown`` of either package as a tuple."""
    return (b.local_hit, b.remote_hit, b.host_miss)


def assert_same_cache_plan(a, b):
    for k in CP_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("mode,capacity", CASES)
def test_cache_tables_and_plans_bitwise(setup, mode, capacity):
    ds, w, part = setup
    jc, tc = _caches(ds, w, part, mode, capacity)
    assert np.array_equal(jc.cached_on, tc.cached_on)
    assert np.array_equal(jc.cache_slot, tc.cache_slot)
    assert (jc.serves, jc.block_rows) == (tc.serves, tc.block_rows)
    assert np.array_equal(jc.build_resident(ds.features),
                          tc.build_resident(ds.features))
    hwm = {}
    for lo, hi, seed in ((0, 48, 1), (48, 60, 2)):
        plan = _plan(ds, part, lo, hi, seed)
        repad_plan(plan, hwm)
        jp, tp = jc.build_plan(plan), tc.build_plan(plan)
        assert_same_cache_plan(jp, tp)
        assert _bd(jc.classify_plan(plan)) == _bd(tc.classify_plan(plan))
        assert _bd(tc.classify_plan(plan)) == _bd(tp.breakdown())
        assert tp.breakdown().total == plan.loaded_feature_rows()
        # pad_to grows both the same way: what the delivery side does
        n, m, s = plan.front_ids[-1].shape[1] + 8, tp.max_miss + 3, tp.max_send + 8
        assert_same_cache_plan(jp.pad_to(n, m, s), tp.pad_to(n, m, s))


@pytest.mark.parametrize("mode,capacity", CASES[1:3] + CASES[4:])
def test_served_block_bitwise_fresh_and_after_repad(setup, mode, capacity):
    """The port's served block equals JAX's bit for bit and
    ``load_features``, on a fresh plan and on a small plan delivered after a
    large one (plan repadded, cache plan grown to CM/CS)."""
    ds, w, part = setup
    jc, tc = _caches(ds, w, part, mode, capacity)
    block = tc.build_resident(ds.features)
    hwm = {}
    for lo, hi, seed in ((0, 48, 1), (48, 60, 2)):
        plan = _plan(ds, part, lo, hi, seed)
        repad_plan(plan, hwm)
        cp = tc.build_plan(plan)
        finalize_cache_plan(cp, hwm, plan.front_ids[-1].shape[1])
        miss = t_plan_io.load_miss_features(cp, ds.features)
        assert np.array_equal(miss, load_miss_features(cp, ds.features))
        got = t_serve(torch.as_tensor(block),
                      t_plan_io.cache_plan_to_device(cp, "cpu"),
                      torch.as_tensor(miss)).numpy()
        want = np.asarray(sim_serve_features(
            jnp.asarray(block), cache_plan_to_device(cp), jnp.asarray(miss)))
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(got, load_features(plan, ds.features))
    assert {"CM", "CS"} <= set(hwm)


def test_partitioned_has_no_remote_hits_distributed_has(setup):
    ds, w, part = setup
    plan = _plan(ds, part, 0, 32, 3)
    _, part_cache = _caches(ds, w, part, "partitioned", 1_000_000)
    cp = part_cache.build_plan(plan)
    assert cp.breakdown().remote_hit == 0 and not cp.recv_mask.any()
    assert cp.breakdown().local_hit == plan.loaded_feature_rows()
    _, dist = _caches(ds, w, part, "distributed", 32)
    assert dist.build_plan(plan).breakdown().remote_hit > 0


@pytest.mark.parametrize("mode,serve", [("partitioned", True),
                                        ("distributed", True),
                                        ("distributed", False)])
def test_stage_host_features_matches_jax(setup, mode, serve):
    ds, w, part = setup
    jc, tc = _caches(ds, w, part, mode, 16)
    plan = _plan(ds, part, 0, 32, 5)
    jcp, jfeats, jbd = j_stage_host_features(plan, ds.features, jc, serve)
    tcp, tfeats, tbd = t_plan_io.stage_host_features(plan, ds.features, tc,
                                                     serve)
    assert _bd(jbd) == _bd(tbd) and (jcp is None) == (tcp is None) == (not serve)
    if serve:
        assert_same_cache_plan(jcp, tcp)
    assert np.array_equal(tfeats.numpy(), jfeats)


def test_cached_signature_matches_jax(setup):
    ds, w, part = setup
    _, tc = _caches(ds, w, part, "distributed", 16)
    extra = ("float32", 2, True)
    hwm = {}
    for lo, hi, seed in ((0, 48, 1), (48, 60, 2)):
        plan = _plan(ds, part, lo, hi, seed, with_halves=True)
        repad_plan(plan, hwm)
        cp = finalize_cache_plan(tc.build_plan(plan), hwm,
                                 plan.front_ids[-1].shape[1])
        sig = plan_signature(plan, cp, extra)
        assert sig == j_plan_signature(plan, cp, extra)
        assert sig[4] == (cp.local_slot.shape, cp.send_slot.shape,
                          cp.miss_ids.shape)


def test_packed_staging_with_cache_and_halves_is_byte_equal(setup):
    ds, w, part = setup
    _, tc = _caches(ds, w, part, "distributed", 16)
    plan = _plan(ds, part, 0, 32, 6, with_halves=True)
    cp = tc.build_plan(plan)
    labels = np.arange(np.prod(plan.front_ids[0].shape), dtype=np.int32)
    labels = labels.reshape(plan.front_ids[0].shape)
    buf, spans = t_plan_io.pack_host(plan, labels, pin=False, cache_plan=cp,
                                     with_halves=True)
    got, got_labels = t_plan_io.unpack(buf, spans, plan.num_layers)
    want = t_plan_io.plan_to_device(plan, "cpu", cp, with_halves=True)
    assert torch.equal(got_labels, torch.as_tensor(labels))
    assert got.keys() == want.keys() == {"layers", "target_mask",
                                         "input_mask", "cache"}
    assert set(got["cache"]) == set(t_plan_io.CACHE_KEYS)
    for a, b in zip([got, got["cache"]] + got["layers"],
                    [want, want["cache"]] + want["layers"], strict=True):
        for k, t in b.items():
            if k in ("layers", "cache"):
                continue
            assert a[k].dtype == t.dtype and a[k].shape == t.shape, k
            assert a[k].is_contiguous() and torch.equal(a[k], t), k
    assert "ledge_src" in got["layers"][0]
    # staging pads the miss block on the device to the cache plan's width
    miss = t_plan_io.gather_miss_features(cp, ds.features)
    cp.pad_to(plan.front_ids[-1].shape[1], cp.max_miss + 5, cp.max_send)
    f_d, pa, _ = t_plan_io.stage_batch(plan, miss, labels, "cpu", cp, True)
    assert f_d.shape == (NDEV, cp.max_miss, ds.features.shape[1])
    assert pa["cache"]["miss_pos"].shape == (NDEV, cp.max_miss)


# --------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_cached_trajectory_matches_jax(model):
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
              out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)
    ckw = dict(num_devices=NDEV, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, cache_mode="partitioned",
               cache_capacity_per_device=24)
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **kw), TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(**ckw), device="cpu",
        model=params_from_jax(np_params, tspec, "cpu"),
    )
    assert np.array_equal(ttr.cache_block.numpy(), np.asarray(jtr.cache_block))
    targets = [ds.train_ids[i * 16:(i + 1) * 16] for i in range(2)]
    jl = [jtr.train_iter(t).loss for t in targets]
    tl = [ttr.train_iter(t).loss for t in targets]
    je, te = jtr.train_epoch(), ttr.train_epoch()
    jl += [s.loss for s in je.iters]
    tl += [s.loss for s in te.iters]
    assert len(jl) == len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for a, b in zip(je.iters, te.iters, strict=True):
        assert _bd(a.load_breakdown) == _bd(b.load_breakdown)
    jt, tt = je.totals(), te.totals()
    for k in ("load_local_hit", "load_remote_hit", "load_host_miss",
              "wire_bytes"):
        assert tt[k] == jt[k], k
    assert te.pipeline["signatures"] == je.pipeline["signatures"]


def _losses(tds, model, source, epochs=2, **over):
    spec = TGNNSpec(model=model, in_dim=tds.spec.feat_dim, hidden_dim=16,
                    out_dim=tds.spec.num_classes, num_layers=2, num_heads=2)
    kw = dict(num_devices=NDEV, fanouts=(4, 4), batch_size=16,
              presample_epochs=2, plan_source=source, seed=3,
              stall_timeout_s=30.0)
    tr = t_trainer.Trainer(tds, spec, t_trainer.TrainConfig(**{**kw, **over}),
                           device="cpu")
    stats = [tr.train_epoch(max_iters=3) for _ in range(epochs)]
    stats.append(tr.train_iter(tds.train_ids[:16]))
    losses = [i.loss for st in stats[:-1] for i in st.iters] + [stats[-1].loss]
    return tr, losses, stats


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("source", ["serial", "device_pipelined"])
def test_cached_equals_uncached_bitwise(model, source):
    """fp32 wire: the served input block equals the host gather, so every
    loss is the same bits, with a partitioned and a distributed cache and
    with the accounting-only cache (``cache_serve=False``)."""
    tds = t_make_dataset("tiny")
    _, plain, _ = _losses(tds, model, source)
    for over in (dict(cache_mode="partitioned", cache_capacity_per_device=24),
                 dict(cache_mode="distributed", cache_capacity_per_device=12),
                 dict(cache_mode="distributed", cache_capacity_per_device=12,
                      cache_serve=False)):
        tr, cached, stats = _losses(tds, model, source, **over)
        assert cached == plain, over
        assert (tr.cache_block is not None) == over.get("cache_serve", True)
        bd = stats[0].iters[0].load_breakdown
        assert bd.total == stats[0].iters[0].loaded_rows and bd.local_hit > 0
        if over["cache_mode"] == "partitioned":
            assert bd.remote_hit == 0


def test_obs_counters_equal_the_breakdown(tmp_path):
    tds = t_make_dataset("tiny")
    path = tmp_path / "cached.json"
    tr, _, stats = _losses(tds, "gat", "pipelined", epochs=1,
                           cache_mode="distributed",
                           cache_capacity_per_device=12, shuffle_overlap=True,
                           shuffle_chunks=2, obs_trace=True,
                           obs_path=str(path))
    totals = stats[0].totals()
    snap = load_trace(path)["otherData"]["metrics"]
    assert snap["cache/local_hit"] == totals["load_local_hit"]
    assert snap["cache/remote_hit"] == totals["load_remote_hit"] > 0
    assert snap["cache/host_miss"] == totals["load_host_miss"]
    assert snap["wire/bytes"] == totals["wire_bytes"] > 0
    assert tr.obs.metrics.snapshot()["cache/local_hit"] == (
        totals["load_local_hit"] + stats[-1].load_breakdown.local_hit)


def test_cache_config_checks():
    with pytest.raises(ValueError, match="cache_mode"):
        t_trainer.check_config(t_trainer.TrainConfig(cache_mode="lru"))
    for mode in ("none", "partitioned", "distributed"):
        t_trainer.check_config(t_trainer.TrainConfig(
            cache_mode=mode, cache_capacity_per_device=8, cache_serve=False))
