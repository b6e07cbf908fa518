"""The port's pipelined runtime: the ordered bounded prefetcher, the plan
sources, plan signatures, and staging.

* ``pipelined`` is bitwise equal to ``serial``, and ``device_pipelined`` to
  ``device``, for SAGE and GAT.
* The pipelined trajectory matches the JAX package's ``pipelined`` one from
  the same weights (``params_from_jax``), per-step loss rtol 1e-4 / atol 1e-6,
  as ``test_trainer_trajectory_matches_jax`` holds the serial one.
* ``plan_signature`` of the port's plan equals the JAX package's on the
  bitwise-equal reference plan.
* The packed staging buffer's views are byte-equal to the per-array staging,
  and the device-side feature padding to the host's ``pad_axis``.

Every test that starts producer threads closes them or sets a
``stall_timeout_s``.
"""
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import build_split_plan, partition_graph, presample
from repro.core.splitting import pad_axis, repad_plan
from repro.graph.datasets import make_dataset
from repro.graph.sampling import NeighborSampler
from repro.models.gnn import GNNSpec
from repro.runtime import SignatureCache as JSignatureCache
from repro.runtime import plan_signature as j_plan_signature
from repro.train.plan_io import load_features as j_load_features
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.core import build_split_plan as t_build_split_plan
from repro_torch.core import partition_graph as t_partition_graph
from repro_torch.core import presample as t_presample
from repro_torch.core import repad_plan as t_repad_plan
from repro_torch.graph.cache import FeatureCache as TFeatureCache
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.runtime.plan_source import (
    DevicePipelinedPlanSource,
    PlanSource,
    make_plan_source,
)
from repro_torch.runtime.prefetch import OrderedPrefetcher
from repro_torch.runtime.signature import SignatureCache, plan_signature
from repro_torch.train import plan_io
from repro_torch.train import trainer as t_trainer


# --------------------------------------------------------------------- #
# prefetcher semantics
# --------------------------------------------------------------------- #
def test_prefetcher_delivers_in_order_with_bounded_lookahead():
    in_flight = []
    lock = threading.Lock()
    peak = [0]

    def fn(i):
        with lock:
            in_flight.append(i)
            peak[0] = max(peak[0], len(in_flight))
        time.sleep(0.002 * ((i * 7) % 3))  # jitter completion order
        with lock:
            in_flight.remove(i)
        return i * i

    pf = OrderedPrefetcher(fn, 20, depth=3, workers=4, stall_timeout_s=30.0)
    assert list(pf) == [i * i for i in range(20)]
    assert peak[0] <= 3  # never more than `depth` claimed at once
    assert pf.closed
    assert pf.stats.delivered == 20


def test_prefetcher_raises_at_failing_index_and_shuts_down():
    def fn(i):
        if i == 2:
            raise ValueError("boom at 2")
        return i

    pf = OrderedPrefetcher(fn, 6, depth=2, workers=2, stall_timeout_s=30.0)
    it = iter(pf)
    seen = [next(it), next(it)]
    with pytest.raises(ValueError, match="boom at 2"):
        next(it)
    assert seen == [0, 1]
    assert pf.closed  # the generator's finally joined the workers


def test_prefetcher_stats_under_out_of_order_completion():
    """Four gated workers released 3, 2, 1, 0 fill the reorder buffer before
    item 0 lands; delivery then drains it 4 -> 1: occupancy max 4, mean 2.5,
    no consumer wait."""
    gates = [threading.Event() for _ in range(4)]

    def fn(i):
        gates[i].wait(timeout=10.0)
        return i

    pf = OrderedPrefetcher(fn, 4, depth=4, workers=4)
    try:
        for i in (3, 2, 1, 0):
            gates[i].set()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with pf._lock:
                if len(pf._buffer) == 4:
                    break
            time.sleep(0.001)
        assert list(pf) == [0, 1, 2, 3]
    finally:
        for g in gates:
            g.set()
        pf.close()
    assert pf.stats.delivered == 4
    assert pf.stats.occupancy_max == 4
    assert pf.stats.mean_occupancy == pytest.approx(2.5)
    assert pf.stats.consumer_waits == 0
    assert pf.stats.as_dict()["max_occupancy"] == 4


def test_prefetcher_counts_consumer_waits_when_producer_lags():
    gates = [threading.Event() for _ in range(4)]

    def fn(i):
        gates[i].wait(timeout=10.0)
        return i

    pf = OrderedPrefetcher(fn, 4, depth=4, workers=4, stall_timeout_s=30.0)
    got = []
    t = threading.Thread(target=lambda: got.extend(pf))
    t.start()
    try:
        for i in range(4):
            # release item i only once the consumer is provably blocked
            deadline = time.monotonic() + 10.0
            while pf.stats.consumer_waits < i + 1:
                assert time.monotonic() < deadline, "consumer never blocked"
                time.sleep(0.001)
            gates[i].set()
        t.join(timeout=10.0)
        assert not t.is_alive()
    finally:
        for g in gates:
            g.set()
        pf.close()
    assert got == [0, 1, 2, 3]
    assert pf.stats.consumer_waits == 4
    assert pf.stats.occupancy_max == 1
    assert pf.stats.mean_occupancy == pytest.approx(1.0)


def test_prefetcher_close_midstream_joins_workers():
    def fn(i):
        time.sleep(0.001)
        return i

    pf = OrderedPrefetcher(fn, 50, depth=4, workers=3)
    it = iter(pf)
    assert next(it) == 0
    it.close()  # the consumer abandons the epoch
    assert pf.closed


def test_prefetcher_stress_more_workers_than_cores():
    """Sixteen workers, a short switch interval: every item arrives once, in
    order, and the counters add up."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = OrderedPrefetcher(lambda i: (i, sum(range(i % 50))), 400,
                               depth=8, workers=16, stall_timeout_s=60.0)
        got = list(pf)
    finally:
        sys.setswitchinterval(old)
    assert [g[0] for g in got] == list(range(400))
    assert pf.stats.delivered == 400 and pf.closed
    assert pf.stats.occupancy_max <= 8


# --------------------------------------------------------------------- #
# plan sources
# --------------------------------------------------------------------- #
def test_make_plan_source_kinds_and_context_manager():
    with make_plan_source("pipelined", None, 0, [], {}) as src:
        assert isinstance(src, PlanSource) and src.stats() == {}
    src = make_plan_source("device_pipelined", None, 0, [], {}, depth=3,
                           workers=5, stall_timeout_s=2.0, start=4)
    assert isinstance(src, DevicePipelinedPlanSource)
    assert (src.depth, src.workers, src.stall_timeout_s, src.start) == (3, 5, 2.0, 4)
    with pytest.raises(ValueError, match=re.escape("serial | pipelined | device")):
        make_plan_source("threaded", None, 0, [], {})


@pytest.fixture(scope="module")
def tds():
    return t_make_dataset("tiny")


def _trajectory(tds, model, source, epochs=2, iters=3, **over):
    spec = TGNNSpec(model=model, in_dim=tds.spec.feat_dim, hidden_dim=16,
                    out_dim=tds.spec.num_classes, num_layers=2, num_heads=4)
    kw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
              presample_epochs=2, plan_source=source, pipeline_depth=3,
              plan_workers=2, seed=7, stall_timeout_s=30.0)
    cfg = t_trainer.TrainConfig(**{**kw, **over})
    tr = t_trainer.Trainer(tds, spec, cfg, device="cpu")
    traj, last = [], None
    for _ in range(epochs):
        last = tr.train_epoch(max_iters=iters)
        traj += [(i.loss, i.accuracy) for i in last.iters]
    return tr, traj, last


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_pipelined_matches_serial_bitwise(tds, model, serial, pipelined):
    _, a, _ = _trajectory(tds, model, serial)
    tr, b, last = _trajectory(tds, model, pipelined, plan_workers=3)
    assert len(a) == len(b) == 6
    assert a == b  # exact: same keys, same delivery-side repad
    assert last.pipeline["delivered"] == 3 and last.pipeline["hit_rate"] > 0
    assert last.pipeline["leaked_threads"] == 0


def test_start_offset_keys_the_tail_by_global_index(tds):
    """A source started at batch 1 delivers the plans an uninterrupted
    source delivers from batch 1 on."""
    tr, _, _ = _trajectory(tds, "sage", "serial", epochs=0)
    full = [b.plan for b in tr.plan_source_for(0, 3)]
    tr2, _, _ = _trajectory(tds, "sage", "pipelined", epochs=0)
    tr2._pad_hwm.update(tr._pad_hwm)
    tail = list(tr2.plan_source_for(0, 3, start=1))
    assert [b.index for b in tail] == [1, 2]
    for got, want in zip(tail, full[1:], strict=True):
        assert plan_signature(got.plan) == plan_signature(want)
        for x, y in zip(got.plan.front_ids, want.front_ids):
            assert np.array_equal(x, y)


def test_pipelined_trajectory_matches_jax():
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=64,
              out_dim=ds.spec.num_classes, num_layers=2)
    ckw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, plan_source="pipelined",
               pipeline_depth=3, plan_workers=2)
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **kw), TrainConfig(**ckw))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(stall_timeout_s=60.0, **ckw),
        device="cpu", model=params_from_jax(np_params, tspec, "cpu"),
    )
    jl, tl = [], []
    for _ in range(2):
        je, te = jtr.train_epoch(), ttr.train_epoch()
        jl += [s.loss for s in je.iters]
        tl += [s.loss for s in te.iters]
        for k in ("delivered", "signatures", "hits", "misses"):
            assert te.pipeline[k] == je.pipeline[k], k
    assert len(tl) == 8
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------- #
# signatures
# --------------------------------------------------------------------- #
def _plans(fanouts=(4, 4), batch=16, n=3):
    """The first ``n`` repadded plans of both packages, bitwise equal."""
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, list(fanouts), batch, num_epochs=1,
                  seed=1)
    tw = t_presample(tds.graph, tds.train_ids, list(fanouts), batch,
                     num_epochs=1, seed=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    tpart = t_partition_graph(tds.graph, 4, method="gsplit", weights=tw)
    s = NeighborSampler(ds.graph, ds.train_ids, list(fanouts), batch, seed=3)
    ts = TNeighborSampler(tds.graph, tds.train_ids, list(fanouts), batch, seed=3)
    hwm, thwm, out = {}, {}, []
    for i, targets in enumerate(s.epoch_targets(0)[:n]):
        plan = repad_plan(build_split_plan(
            s.sample_batch(targets, 0, i), part.assignment, 4, pad_multiple=-1
        ), hwm)
        tplan = t_repad_plan(t_build_split_plan(
            ts.sample_batch(targets, 0, i), tpart.assignment, 4,
            pad_multiple=-1,
        ), thwm)
        out.append((plan, tplan, ds))
    return out


def test_plan_signature_matches_reference():
    extra = ("float32", 1, False)
    ours, theirs = SignatureCache(), JSignatureCache()
    for plan, tplan, _ in _plans():
        sig = plan_signature(tplan, extra=extra)
        assert sig == j_plan_signature(plan, extra=extra)
        assert ours.record(sig) == theirs.record(j_plan_signature(plan, extra=extra))
    assert ours.as_dict() == theirs.as_dict()
    # a cached plan keys on its cache plan's widths, as in the reference
    ds = _plans(n=1)[0][2]
    cache = TFeatureCache(ds.graph.num_nodes, 4, 16,
                          ranking=np.arange(ds.graph.num_nodes, dtype=np.float64),
                          mode="distributed")
    cp = cache.build_plan(tplan)
    assert plan_signature(tplan, cp, extra) == j_plan_signature(plan, cp, extra)
    assert plan_signature(tplan, cp, extra) != plan_signature(tplan, extra=extra)


# --------------------------------------------------------------------- #
# staging
# --------------------------------------------------------------------- #
def test_packed_staging_is_byte_equal_to_per_array_staging():
    for plan, tplan, ds in _plans(n=2):
        labels = np.arange(np.prod(tplan.front_ids[0].shape), dtype=np.int32)
        labels = labels.reshape(tplan.front_ids[0].shape)
        buf, spans = plan_io.pack_host(tplan, labels, pin=False)
        assert all(off % plan_io.ALIGN == 0 for _, _, off, _, _ in spans)
        got, got_labels = plan_io.unpack(buf, spans, tplan.num_layers)
        want = plan_io.plan_to_device(tplan, "cpu")
        assert torch.equal(got_labels, torch.as_tensor(labels))
        assert got.keys() == want.keys()
        for a, b in zip([got] + got["layers"], [want] + want["layers"]):
            for k, t in b.items():
                if k == "layers":
                    continue
                assert a[k].dtype == t.dtype and a[k].shape == t.shape, k
                assert a[k].is_contiguous() and torch.equal(a[k], t), k


def test_gather_and_device_padding_match_reference():
    for plan, tplan, ds in _plans(n=2):
        feats = plan_io.gather_features(tplan, ds.features)
        np.testing.assert_array_equal(feats.numpy(), j_load_features(plan, ds.features))
        # a block gathered before the marks grew, padded at staging
        rows = tplan.front_ids[-1].shape[1]
        short = feats[:, : rows // 2]
        staged = plan_io.pad_rows(short, rows)
        want = pad_axis(short.numpy(), 1, rows)
        assert staged.numpy().tobytes() == want.tobytes()
        f_d, pa, l_d = plan_io.stage_batch(
            tplan, short, np.zeros(tplan.front_ids[0].shape, np.int32), "cpu"
        )
        assert f_d.shape == (4, rows, ds.features.shape[1])
        assert pa["layers"][0]["edge_src"].dtype == torch.int32
        assert l_d.dtype == torch.int32
