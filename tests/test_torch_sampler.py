"""The port's device sampler (``repro_torch.sampler``) against the JAX
package's (``repro.sampler``), on the CPU.

Every integer result is bitwise equal: the key folding and the hash words
(including words whose int64 products overflow), the wavefront expansion
against the Pallas kernel in interpret mode, the static-cap frontier ops
(overflow included), the shards, one ``_sample_device`` call against the JAX
one on its ``jnp`` backend (``tests/test_sampler.py`` pins Pallas to jnp),
and ``DeviceSampler``'s caps, batches and keyed host fallback. The
device-source trainer builds the JAX trainer's plans bitwise and its
per-step losses agree to rtol 1e-4, atol 1e-6 from carried weights (the
aggregation sums in another order, as in ``tests/test_torch_trainer.py``).
Inputs come from seeded numpy.
"""
import re
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition_graph, presample
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec
from repro.sampler import DeviceSampler, build_shards, shards_to_device
from repro.sampler.engine import _sample_device
from repro.sampler.frontier import bucket_by_owner, sorted_unique_capped
from repro.sampler.ops import wavefront_expand
from repro.sampler.rng import draw_u32, fold_key_pair
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core.splitting import pad_axis
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.runtime.plan_source import PLAN_SOURCES, make_plan_source
from repro_torch.sampler import DeviceSampler as TDeviceSampler
from repro_torch.sampler import build_shards as t_build_shards
from repro_torch.sampler import engine as t_engine
from repro_torch.sampler import frontier as t_frontier
from repro_torch.sampler import kernel as t_kernel
from repro_torch.sampler import rng as t_rng
from repro_torch.sampler.shard import shards_to_device as t_shards_to_device
from repro_torch.train import trainer as t_trainer

NDEV = 4
WORDS = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def samplers():
    """The JAX and port device samplers over one tiny partition (fan-outs
    4, 3, batch 32, seed 7) and the host samplers behind their fallback."""
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    fan = [4, 3]
    w = presample(ds.graph, ds.train_ids, fan, 32, num_epochs=1)
    part = partition_graph(ds.graph, NDEV, method="gsplit", weights=w)
    host = NeighborSampler(ds.graph, ds.train_ids, fan, 32, seed=7)
    thost = TNeighborSampler(tds.graph, tds.train_ids, fan, 32, seed=7)
    jeng = DeviceSampler(ds.graph, part.assignment, NDEV, fan, 7, host,
                         backend="jnp")
    teng = TDeviceSampler(tds.graph, part.assignment, NDEV, fan, 7, thost,
                          device="cpu")
    return ds, tds, part, host, thost, jeng, teng


def _same_sample(a, b):
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in ("src", "dst", "edge_id"):
            x, y = getattr(la, f), getattr(lb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for fa, fb in zip(a.frontiers, b.frontiers, strict=True):
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
    assert np.array_equal(a.target_ids, b.target_ids)


# --------------------------------------------------------------------- #
# rng
# --------------------------------------------------------------------- #
def test_fold_key_pair_matches_jax():
    rng = np.random.default_rng(0)
    cases = [(0,), (7, 0x5A3D, 0, 0, 0), (2**32 - 1, 2**31, 2**40 + 5)]
    cases += [tuple(int(x) for x in rng.integers(0, 2**62, 5)) for _ in range(20)]
    for parts in cases:
        assert t_rng.fold_key_pair(*parts) == fold_key_pair(*parts)


@pytest.mark.parametrize("key_lo,key_hi", [
    (0, 0), (2**31, 2**32 - 1), (2**32 - 1, 2**31), (0x9E3779B9, 12345),
])
def test_draw_u32_matches_jax(key_lo, key_hi):
    """Words at 0, 2**31 and 2**32-1 (whose products with the mixing
    constants overflow int64) and random words, against every slot word."""
    rng = np.random.default_rng(key_lo ^ key_hi)
    vid = np.concatenate([WORDS, rng.integers(0, 2**32, 58, dtype=np.uint64)])
    slot = np.concatenate([WORDS, rng.integers(0, 2**32, 10, dtype=np.uint64)])
    want = np.asarray(draw_u32(
        jnp.asarray(vid.astype(np.uint32))[:, None],
        jnp.asarray(slot.astype(np.uint32))[None, :],
        jnp.uint32(key_lo), jnp.uint32(key_hi),
    ))
    got = t_rng.draw_u32(_t(vid.astype(np.int64))[:, None],
                         _t(slot.astype(np.int64))[None, :], key_lo, key_hi)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # int32 ids are reinterpreted as uint32, as ``astype`` does
    as_i32 = _t(vid.astype(np.uint32).view(np.int32))[:, None]
    assert torch.equal(t_rng.draw_u32(as_i32, _t(slot.astype(np.int64))[None, :],
                                      key_lo, key_hi), got)


# --------------------------------------------------------------------- #
# wavefront expansion
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fanout", [1, 4, 15, 33])
def test_expand_codes_matches_jax_pallas(fanout):
    """deg < 0, 0, <= fanout and > fanout; B not a multiple of 128."""
    rng = np.random.default_rng(fanout)
    B = 301
    vid = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    deg = rng.integers(-3, 3 * fanout + 4, B).astype(np.int32)
    deg[:4] = [-1, 0, fanout, fanout + 1]
    key = rng.integers(0, 2**32, 2, dtype=np.uint64)
    want = np.asarray(wavefront_expand(
        jnp.asarray(vid), jnp.asarray(deg), jnp.asarray(key.astype(np.uint32)),
        fanout, backend="pallas", interpret=True,
    ))
    assert {-2, -1} <= set(np.unique(want)) or fanout == 1
    got = t_kernel.wavefront_expand(_t(vid), _t(deg), _t(key.astype(np.int64)),
                                    fanout)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_wavefront_wrapper_checks_and_counts():
    vid = torch.zeros(8, dtype=torch.int32)
    key = torch.zeros(2, dtype=torch.int64)
    t_kernel.reset_launches()
    t_kernel.wavefront_expand(vid, vid, key, 3)  # CPU: the plain version
    assert t_kernel.LAUNCHES["wavefront_expand"] == 0
    with pytest.raises(TypeError):
        t_kernel.wavefront_expand(vid.long(), vid, key, 3)
    with pytest.raises(ValueError):
        t_kernel.wavefront_expand(vid, vid[:4], key, 3)
    with pytest.raises(ValueError):
        t_kernel.wavefront_expand(vid, vid, key, 0)


# --------------------------------------------------------------------- #
# frontier set operations
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cap", [4, 120, 200])
def test_sorted_unique_capped_matches_jax(cap):
    """Batched over a leading axis of 3 problems; cap 4 overflows."""
    rng = np.random.default_rng(cap)
    vals = rng.integers(0, 120, (3, 150)).astype(np.int32)
    valid = rng.random((3, 150)) < 0.5
    got = t_frontier.sorted_unique_capped(_t(vals), _t(valid), cap, 120)
    for p in range(3):
        want = sorted_unique_capped(jnp.asarray(vals[p]), jnp.asarray(valid[p]),
                                    cap, 120)
        for g, w in zip(got, want):
            assert np.array_equal(g[p].numpy(), np.asarray(w))
            assert g.dtype == (torch.bool if w.dtype == bool else torch.int32)
    assert bool(got[2].any()) == (cap == 4)


@pytest.mark.parametrize("cap", [3, 64, 128])
def test_bucket_by_owner_matches_jax(cap):
    rng = np.random.default_rng(cap)
    V, P = 100, 4
    owner = rng.integers(0, P, V).astype(np.int32)
    vals = rng.integers(0, V, (2, 120)).astype(np.int32)
    valid = rng.random((2, 120)) < 0.6
    got = t_frontier.bucket_by_owner(_t(vals), _t(valid), _t(owner), P, cap, V)
    for p in range(2):
        want = bucket_by_owner(jnp.asarray(vals[p]), jnp.asarray(valid[p]),
                               jnp.asarray(owner), P, cap, V)
        for g, w in zip(got, want):
            assert np.array_equal(g[p].numpy(), np.asarray(w))
    assert bool(got[2].any()) == (cap == 3)


@pytest.mark.parametrize("name", ["tiny", "orkut-s"])
def test_build_shards_bitwise_equal(name):
    ds, tds = make_dataset(name), t_make_dataset(name)
    assignment = np.random.default_rng(1).integers(0, NDEV, ds.graph.num_nodes)
    a = build_shards(ds.graph, assignment, NDEV)
    b = t_build_shards(tds.graph, assignment, NDEV)
    b.validate()
    for f in ("indptr", "indices", "edge_id", "owner", "local_row", "num_local"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    dev = t_shards_to_device(b, "cpu")
    assert all(t.dtype == torch.int32 for t in dev.values())


# --------------------------------------------------------------------- #
# the cooperative loop and DeviceSampler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,fanouts,batch", [
    ("tiny", (4, 3), 32),
    ("orkut-s", (5, 4), 64),
])
def test_sample_device_matches_jax(name, fanouts, batch):
    """One ``_sample_device`` call, every output array, bitwise — with caps
    small enough that some flags are raised."""
    ds, tds = make_dataset(name), t_make_dataset(name)
    w = presample(ds.graph, ds.train_ids, list(fanouts), batch, num_epochs=1)
    part = partition_graph(ds.graph, NDEV, method="gsplit", weights=w)
    host = NeighborSampler(ds.graph, ds.train_ids, list(fanouts), batch, seed=3)
    eng = DeviceSampler(ds.graph, part.assignment, NDEV, list(fanouts), 3, host,
                        backend="jnp")
    targets = host.epoch_targets(0)[0]
    keys = eng.layer_keys(0, 0)
    B = 2 * batch
    tpad = np.zeros(B, np.int32)
    tpad[:batch] = targets
    for caps in (eng.caps_tuple(), tuple((k, 16) for k, _ in eng.caps_tuple())):
        want = _sample_device(
            shards_to_device(eng.shards), jnp.asarray(tpad), jnp.int32(batch),
            jnp.asarray(keys), caps=caps, fanouts=fanouts, backend="jnp",
            interpret=True,
        )
        got = t_engine.to_host(t_engine._sample_device(
            t_shards_to_device(t_build_shards(tds.graph, part.assignment, NDEV),
                               "cpu"),
            _t(tpad), batch, _t(keys.astype(np.int64)), caps=caps,
            fanouts=fanouts,
        ))
        wf, wc, wl, wflags = want
        gf, gc, gl, gflags = got
        for a, b in zip(list(wf) + list(wc), gf + gc, strict=True):
            assert np.array_equal(np.asarray(a), b)
        for la, lb in zip(wl, gl, strict=True):
            for k in ("dst", "src", "eid", "valid"):
                assert np.array_equal(np.asarray(la[k]), lb[k]), k
        assert {k: bool(v) for k, v in wflags.items()} == gflags
    assert any(gflags.values())  # the 16-slot caps overflow


def test_device_sampler_matches_jax(samplers):
    ds, tds, part, host, thost, jeng, teng = samplers
    assert teng.caps_tuple() == jeng.caps_tuple()
    assert np.array_equal(teng.layer_keys(3, 5), jeng.layer_keys(3, 5))
    for i, targets in enumerate(host.epoch_targets(0)[:3]):
        _same_sample(teng.sample_batch(targets, 0, i),
                     jeng.sample_batch(targets, 0, i))
    assert teng.hwm == jeng.hwm
    assert teng.fallbacks == jeng.fallbacks == 0


def test_device_sampler_later_epoch_matches_jax(samplers):
    """Another epoch's keys draw other batches, still bitwise the JAX
    sampler's."""
    ds, tds, part, host, thost, jeng, teng = samplers
    for i, targets in enumerate(host.epoch_targets(1)[:2]):
        _same_sample(teng.sample_batch(targets, 1, i),
                     jeng.sample_batch(targets, 1, i))


def test_bigger_caps_change_shapes_not_content(samplers):
    """Draws key on vertex ids, never buffer positions: doubling every cap
    pads the blocks but samples the same batch."""
    ds, tds, part, host, thost, _, teng = samplers
    big = TDeviceSampler(tds.graph, part.assignment, NDEV, [4, 3], 7, thost,
                         device="cpu")
    big._caps = {k: 2 * v for k, v in teng._caps.items()}
    targets = host.epoch_targets(0)[1]
    _same_sample(big.sample_batch(targets, 3, 1), teng.sample_batch(targets, 3, 1))


def test_overflow_falls_back_to_keyed_host_sampler(samplers):
    ds, tds, part, host, thost, _, _ = samplers
    jeng = DeviceSampler(ds.graph, part.assignment, NDEV, [4, 3], 7, host,
                         backend="jnp")
    teng = TDeviceSampler(tds.graph, part.assignment, NDEV, [4, 3], 7, thost,
                          device="cpu")
    jeng._caps["N1"] = teng._caps["N1"] = 16  # force an overflow on a real batch
    targets = host.epoch_targets(0)[0]
    got = teng.sample_batch(targets, 0, 0)
    _same_sample(got, jeng.sample_batch(targets, 0, 0))
    _same_sample(got, thost.sample_batch(targets, 0, 0))
    assert teng.stats()["sampler_fallbacks"] == 1  # counted, never silent
    # the flagged cap doubles at the epoch boundary and stops overflowing
    teng.refresh_caps()
    jeng.refresh_caps()
    assert teng.caps_tuple() == jeng.caps_tuple()
    assert teng._caps["N1"] >= 32
    _same_sample(teng.sample_batch(targets, 0, 0), jeng.sample_batch(targets, 0, 0))
    st = teng.stats()
    assert (st["sampler_batches"], st["sampler_fallbacks"]) == (2, 1)
    assert (st["sampler_epoch_batches"], st["sampler_epoch_fallbacks"]) == (1, 0)


# --------------------------------------------------------------------- #
# the device plan source in the trainer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_device_source_trainer_matches_jax(model):
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=32,
              out_dim=ds.spec.num_classes, num_layers=2)
    ckw = dict(num_devices=NDEV, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, plan_source="device")
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **kw),
                  TrainConfig(sampler_backend="jnp", **ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(**ckw), device="cpu",
        model=params_from_jax(np_params, tspec, "cpu"),
    )
    # the plans of epoch 0, from fresh sources of both trainers
    n = 0
    for a, b in zip(jtr.plan_source_for(0, None), ttr.plan_source_for(0, None),
                    strict=True):
        for x, y in zip(a.plan.front_ids + a.plan.node_mask,
                        b.plan.front_ids + b.plan.node_mask):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        for la, lb in zip(a.plan.layers, b.plan.layers):
            for f in ("edge_src", "edge_dst", "edge_mask", "send_idx",
                      "pack_perm", "pack_dst"):
                assert np.array_equal(getattr(la, f), getattr(lb, f)), f
        # the port pads the feature block on the device, at staging
        assert np.array_equal(
            a.feats, pad_axis(b.feats.numpy(), 1, a.feats.shape[1])
        )
        n += 1
    assert n == 4
    jl, tl = [], []
    for _ in range(2):
        je, te = jtr.train_epoch(), ttr.train_epoch()
        jl += [s.loss for s in je.iters]
        tl += [s.loss for s in te.iters]
    assert len(tl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    for k in ("sampler_batches", "sampler_fallbacks", "sampler_caps"):
        assert te.pipeline[k] == je.pipeline[k], k


@pytest.mark.parametrize("kind", ["pipelined", "device_pipelined"])
def test_pipelined_sources_still_raise(kind):
    """The pipelined sources are ported: the config accepts them and
    ``make_plan_source`` builds them; a kind outside the four still raises,
    naming all four."""
    t_trainer.check_config(t_trainer.TrainConfig(plan_source=kind))
    assert type(make_plan_source(kind, None, 0, [], {})) is PLAN_SOURCES[kind]
    with pytest.raises(ValueError, match=re.escape(
            "serial | pipelined | device | device_pipelined")):
        make_plan_source(kind + "_threads", None, 0, [], {})

