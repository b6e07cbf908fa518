"""The port's fault-tolerance layer (``repro_torch.faults`` and the
supervision of ``repro_torch.runtime.prefetch``): retry policy, deterministic
injection, the watchdog, crash respawn, leak accounting, and the trainer's
non-finite guard.

* ``RetryPolicy.delay_s`` equals the JAX package's.
* The guarded step skips the poisoned step as the JAX ``Trainer`` does, its
  surviving losses within rtol 1e-4 / atol 1e-6 of the JAX run's, and leaves
  params and optimizer state bitwise as they were before the poisoned step.
* A chaos run (a transient fault and a crash) recovers the clean trajectory
  bit for bit.

Every test that starts producer threads closes them or sets a
``stall_timeout_s``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.faults import FaultAction as JFaultAction
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import RetryPolicy as JRetryPolicy
from repro.graph.datasets import make_dataset
from repro.models.gnn import GNNSpec
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.faults import (
    FaultAction,
    FaultInjected,
    FaultInjector,
    PipelineStallError,
    RetryableError,
    RetryPolicy,
    WorkerCrash,
    retry_call,
)
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.runtime import prefetch
from repro_torch.runtime.prefetch import OrderedPrefetcher
from repro_torch.train import trainer as t_trainer


# --------------------------------------------------------------------- #
# RetryPolicy / retry_call
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    {},
    dict(retries=5, backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.35),
    dict(retries=3, backoff_s=0.003, backoff_mult=3.0, max_backoff_s=10.0),
])
def test_backoff_schedule_matches_reference(kw):
    ours, ref = RetryPolicy(**kw), JRetryPolicy(**kw)
    delays = [ours.delay_s(k) for k in range(1, 9)]
    assert delays == [ref.delay_s(k) for k in range(1, 9)]
    if kw.get("max_backoff_s") == 0.35:
        assert delays[:4] == [0.1, 0.2, 0.35, 0.35]


def test_retry_call_recovers_within_budget():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RetryableError("transient")
        return "ok"

    seen = []
    out = retry_call(
        flaky, RetryPolicy(retries=3, backoff_s=0.001),
        on_retry=lambda a, e: seen.append((a, str(e))),
    )
    assert out == "ok" and len(calls) == 3
    assert seen == [(1, "transient"), (2, "transient")]


def test_retry_call_exhausted_budget_reraises():
    def always():
        raise RetryableError("still down")

    with pytest.raises(RetryableError, match="still down"):
        retry_call(always, RetryPolicy(retries=2, backoff_s=0.001))


def test_retry_call_only_retries_declared_transients():
    calls = []

    def bug():
        calls.append(1)
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        retry_call(bug, RetryPolicy(retries=5, backoff_s=0.001))
    assert len(calls) == 1  # fail fast, no retry


def test_retry_call_cancel_interrupts_backoff():
    cancel = threading.Event()
    cancel.set()

    def always():
        raise RetryableError("down")

    t0 = time.perf_counter()
    with pytest.raises(RetryableError):
        retry_call(always, RetryPolicy(retries=3, backoff_s=30.0), cancel=cancel)
    assert time.perf_counter() - t0 < 1.0  # did not sleep the 30 s backoff


# --------------------------------------------------------------------- #
# FaultInjector
# --------------------------------------------------------------------- #
def test_injector_fires_exactly_times_and_records_order():
    inj = FaultInjector(
        schedule=[FaultAction("transient", epoch=0, batch=1, times=2)]
    )
    inj.fire("build", 0, 0)  # no match: no-op
    for _ in range(2):
        with pytest.raises(RetryableError):
            inj.fire("build", 0, 1)
    inj.fire("build", 0, 1)  # exhausted: quiet again
    assert inj.fired == [("transient", "build", 0, 1)] * 2


def test_injector_kind_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultAction("segfault")
    with pytest.raises(ValueError, match="times"):
        FaultAction("crash", times=0)


@pytest.mark.parametrize("kind,exc", [
    ("crash", WorkerCrash),
    ("kill", FaultInjected),
])
def test_injector_delay_then_raise_ordering(kind, exc):
    inj = FaultInjector(schedule=[
        FaultAction(kind, epoch=0, batch=0),
        FaultAction("delay", epoch=0, batch=0, delay_s=0.05),
    ])
    t0 = time.perf_counter()
    with pytest.raises(exc, match="0/0"):
        inj.fire("build", 0, 0)
    assert time.perf_counter() - t0 >= 0.05
    assert [k for k, *_ in inj.fired] == ["delay", kind]


def test_poison_copies_and_matches_reference():
    feats = np.ones((4, 5), dtype=np.float32)
    inj = FaultInjector(schedule=[FaultAction("poison", epoch=0, batch=3)])
    ref = JFaultInjector(schedule=[JFaultAction("poison", epoch=0, batch=3)])
    out = inj.maybe_poison("build", 0, 3, feats)
    want = ref.maybe_poison("build", 0, 3, feats)
    assert np.isnan(out[0, 0]) and np.isfinite(out).sum() == 19
    np.testing.assert_array_equal(out, want)
    assert np.isfinite(feats).all()  # the source array is never mutated
    assert inj.maybe_poison("build", 0, 3, feats) is feats  # exhausted


# --------------------------------------------------------------------- #
# the supervised OrderedPrefetcher
# --------------------------------------------------------------------- #
def test_prefetcher_retries_transient_builds_in_place():
    inj = FaultInjector(
        schedule=[FaultAction("transient", epoch=0, batch=2, times=2)]
    )

    def build(i):
        inj.fire("build", 0, i)
        return i * 10

    pf = OrderedPrefetcher(build, 5, depth=2, workers=2,
                           retry=RetryPolicy(retries=3, backoff_s=0.001),
                           stall_timeout_s=30.0)
    assert list(pf) == [0, 10, 20, 30, 40]  # order kept through the retry
    assert pf.stats.retries == 2 and pf.stats.worker_crashes == 0


def test_prefetcher_retry_budget_exhausted_delivers_error_in_order():
    def build(i):
        if i == 1:
            raise RetryableError("persistently down")
        return i

    pf = OrderedPrefetcher(build, 3, depth=2, workers=1,
                           retry=RetryPolicy(retries=1, backoff_s=0.001),
                           stall_timeout_s=30.0)
    it = iter(pf)
    assert next(it) == 0
    with pytest.raises(RetryableError, match="persistently down"):
        next(it)
    assert pf.stats.retries == 1
    assert pf.closed


def test_prefetcher_crash_respawns_and_recovers_the_batch():
    inj = FaultInjector(schedule=[FaultAction("crash", epoch=0, batch=1)])

    def build(i):
        inj.fire("build", 0, i)
        return i

    pf = OrderedPrefetcher(build, 4, depth=2, workers=2, stall_timeout_s=30.0)
    assert list(pf) == [0, 1, 2, 3]  # the crashed index was requeued
    assert pf.stats.worker_crashes == 1 and pf.stats.respawns == 1
    assert pf.stats.leaked_threads == 0


def test_prefetcher_watchdog_names_the_stuck_index():
    release = threading.Event()

    def build(i):
        if i == 1:
            # the stall raises inside the consumer's next(), whose close()
            # joins this worker: the wait ends on its own, long after the
            # consumer's 0.2 s
            release.wait(3.0)
        return i

    pf = OrderedPrefetcher(build, 3, depth=2, workers=1, stall_timeout_s=0.2)
    try:
        it = iter(pf)
        assert next(it) == 0
        with pytest.raises(PipelineStallError) as ei:
            next(it)
    finally:
        release.set()
        pf.close()
    e = ei.value
    assert e.index == 1 and e.waited_s >= 0.2
    assert "index 1" in str(e) and "live producer threads" in str(e)
    assert e.live_threads  # the stuck worker is visible by name
    assert pf.closed


def test_prefetcher_close_accounts_leaked_threads(monkeypatch):
    release = threading.Event()

    def build(i):
        release.wait(10.0)
        return i

    monkeypatch.setattr(prefetch, "_JOIN_TIMEOUT_S", 0.1)
    pf = OrderedPrefetcher(build, 2, depth=2, workers=2)
    try:
        time.sleep(0.05)  # let the workers park inside the slow build
        pf.close()
        assert pf.stats.leaked_threads >= 1
        assert pf.stats.as_dict()["leaked_threads"] == pf.stats.leaked_threads
    finally:
        release.set()
    for t in pf._threads:
        t.join(timeout=10.0)
        assert not t.is_alive()


def test_prefetcher_stats_surface_recovery_counters():
    pf = OrderedPrefetcher(lambda i: i, 2, depth=1, workers=1)
    assert list(pf) == [0, 1]
    d = pf.stats.as_dict()
    for key in ("retries", "worker_crashes", "respawns", "leaked_threads"):
        assert d[key] == 0


# --------------------------------------------------------------------- #
# the trainer: chaos recovery, the stall watchdog, the non-finite guard
# --------------------------------------------------------------------- #
def _port_trainer(source="serial", injector=None, **over):
    ds = t_make_dataset("tiny")
    spec = TGNNSpec(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=ds.spec.num_classes, num_layers=2)
    kw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
              presample_epochs=1, plan_source=source, plan_workers=2,
              pipeline_depth=2, stall_timeout_s=30.0)
    cfg = t_trainer.TrainConfig(**{**kw, **over})
    return t_trainer.Trainer(ds, spec, cfg, device="cpu", injector=injector)


@pytest.mark.parametrize("source", ["pipelined", "device_pipelined"])
def test_chaos_run_recovers_the_clean_trajectory(source):
    clean = [i.loss for i in _port_trainer(source).train_epoch().iters]
    inj = FaultInjector(schedule=[
        FaultAction("transient", epoch=0, batch=1, times=2),
        FaultAction("crash", epoch=0, batch=2),
    ])
    tr = _port_trainer(source, inj, plan_retries=2, plan_retry_backoff_s=0.001)
    st = tr.train_epoch()
    assert [i.loss for i in st.iters] == clean
    assert st.pipeline["retries"] == 2
    assert st.pipeline["worker_crashes"] == st.pipeline["respawns"] == 1
    assert sorted(k for k, *_ in inj.fired) == ["crash", "transient", "transient"]


def test_trainer_stall_watchdog_names_the_index():
    """Batch 1 is claimed when the epoch starts (two workers, two tickets),
    so its delay runs while step 0 trains: the consumer then waits far past
    the timeout, however slow step 0 is on a loaded host."""
    inj = FaultInjector(
        schedule=[FaultAction("delay", epoch=0, batch=1, delay_s=4.0)]
    )
    tr = _port_trainer("pipelined", inj, stall_timeout_s=0.5)
    with pytest.raises(PipelineStallError, match="index 1"):
        tr.train_epoch()
    assert tr.global_step == 1


def test_kill_is_delivered_at_its_index():
    inj = FaultInjector(schedule=[FaultAction("kill", epoch=0, batch=1)])
    tr = _port_trainer("pipelined", inj)
    with pytest.raises(FaultInjected, match="build/0/1"):
        tr.train_epoch()
    assert tr.global_step == 1


@pytest.mark.parametrize("source", ["serial", "pipelined"])
def test_skip_nonfinite_keeps_params_bitwise(source):
    """Two steps with a poisoned second batch leave params, Adam slots and
    the step count bitwise where one clean step left them."""
    inj = FaultInjector(schedule=[FaultAction("poison", epoch=0, batch=1)])
    poisoned = _port_trainer(source, inj, skip_nonfinite=True)
    st = poisoned.train_epoch(max_iters=2)
    once = _port_trainer(source, skip_nonfinite=True)
    once.train_epoch(max_iters=1)
    assert poisoned.nonfinite_skips == 1 and once.nonfinite_skips == 0
    assert not np.isfinite(st.iters[1].loss)  # the skip reports the NaN
    assert poisoned.opt_state.step == once.opt_state.step == 1
    for a, b in zip(poisoned._opt_tensors(), once._opt_tensors(), strict=True):
        assert torch.equal(a, b)
    assert poisoned.global_step == 2


def test_skip_nonfinite_is_exact_on_clean_steps():
    plain = _port_trainer().train_epoch()
    guarded = _port_trainer(skip_nonfinite=True).train_epoch()
    assert [i.loss for i in guarded.iters] == [i.loss for i in plain.iters]


def test_skip_nonfinite_matches_jax():
    """The same poisoned batch is skipped by both packages from the same
    weights; the surviving losses agree within rtol 1e-4 / atol 1e-6."""
    ds, tds = make_dataset("tiny"), t_make_dataset("tiny")
    kw = dict(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=32,
              out_dim=ds.spec.num_classes, num_layers=2)
    ckw = dict(num_devices=4, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, lr=5e-3, skip_nonfinite=True)
    jtr = Trainer(ds, GNNSpec(agg_backend="jnp", **kw), TrainConfig(**ckw),
                  injector=JFaultInjector([JFaultAction("poison", batch=1)]))
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    tspec = TGNNSpec(**kw)
    ttr = t_trainer.Trainer(
        tds, tspec, t_trainer.TrainConfig(**ckw), device="cpu",
        model=params_from_jax(np_params, tspec, "cpu"),
        injector=FaultInjector([FaultAction("poison", batch=1)]),
    )
    jl, tl = [], []
    for _ in range(2):
        jl += [i.loss for i in jtr.train_epoch().iters]
        tl += [i.loss for i in ttr.train_epoch().iters]
    assert len(tl) == 8 and jtr.nonfinite_skips == ttr.nonfinite_skips == 1
    assert [np.isfinite(x) for x in tl] == [np.isfinite(x) for x in jl]
    assert not np.isfinite(tl[1])
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
