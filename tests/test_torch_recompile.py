"""The port's recompile tracer (``repro_torch/runtime/recompile.py``) held
against the JAX package's, at the reference test's config
(``tests/test_runtime.py::test_no_steady_state_recompiles``: the tiny
dataset, 4 splits, fan-outs 4,4, batch 32, 4 epochs of at most 3
steps: the tiny dataset has 2 batches an epoch). The module runs in one
torch thread.

* For each of the four plan sources, every epoch's ``misses`` and
  ``miss_steps`` equal the JAX ``Trainer``'s (``repro.runtime.recompile.
  RecompileTracer`` over its jit caches; the device sampler's jit,
  ``repro.sampler.engine._sample_device``, is module-level, so its cache is
  emptied first: an earlier test in the process would have warmed it. The
  step's jits are the trainer's own).
* A warm epoch has no miss, the warm-up has some.
* ``trace_recompiles=True`` leaves every loss bit as it was.
* ``register`` raises on a callable that is not traced; the signature
  reads tensors, arrays, containers and dataclasses, and other values by
  value.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.graph.datasets import make_dataset
from repro.models.gnn import GNNSpec
from repro.sampler.engine import _sample_device
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.runtime import RecompileEvent, RecompileTracer
from repro_torch.runtime.recompile import Traced, call_signature
from repro_torch.train import trainer as t_trainer

SOURCES = ["serial", "pipelined", "device", "device_pipelined"]
EPOCHS, ITERS = 4, 3
CFG = dict(mode="split", num_devices=4, fanouts=(4, 4), batch_size=32,
           presample_epochs=2, pipeline_depth=3, plan_workers=2, seed=7)
KEYS = ("steps", "misses", "miss_steps")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    return make_dataset("tiny"), t_make_dataset("tiny")


def _spec_kw(ds):
    return dict(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=16,
                out_dim=ds.spec.num_classes, num_layers=2, num_heads=4)


def _port(tds, source, trace=True):
    cfg = t_trainer.TrainConfig(plan_source=source, trace_recompiles=trace,
                                **CFG)
    tr = t_trainer.Trainer(tds, TGNNSpec(**_spec_kw(tds)), cfg, device="cpu")
    epochs = [tr.train_epoch(max_iters=ITERS) for _ in range(EPOCHS)]
    return tr, epochs


@pytest.mark.parametrize("source", SOURCES)
def test_misses_match_the_jax_tracer(data, source):
    ds, tds = data
    _sample_device.clear_cache()
    jtr = Trainer(ds, GNNSpec(**_spec_kw(ds)), TrainConfig(
        plan_source=source, sampler_backend="jnp", trace_recompiles=True,
        **CFG))
    want = [jtr.train_epoch(max_iters=ITERS).recompiles
            for _ in range(EPOCHS)]
    tr, epochs = _port(tds, source)
    got = [e.recompiles for e in epochs]
    assert [{k: r[k] for k in KEYS} for r in got] == \
        [{k: r[k] for k in KEYS} for r in want], (got, want)
    # the warm-up pays, a warm epoch does not
    assert got[-1]["misses"] == 0
    assert got[-1]["steps"] == len(epochs[-1].iters) > 0
    assert tr.recompiles.total_misses > 0
    assert set(got[0]["by_fn"]) <= {"step", "sample_device"}
    if source.startswith("device"):
        assert got[0]["by_fn"].get("sample_device", 0) > 0


@pytest.mark.parametrize("source", ["serial", "device_pipelined"])
def test_tracing_changes_no_loss_bit(data, source):
    _, tds = data
    _, on = _port(tds, source)
    _, off = _port(tds, source, trace=False)
    assert [i.loss for e in on for i in e.iters] == \
        [i.loss for e in off for i in e.iters]
    assert all(e.recompiles == {} for e in off)


def test_register_refuses_an_untraced_callable():
    tracer = RecompileTracer()
    with pytest.raises(TypeError, match="_cache_size"):
        tracer.register("step", lambda x: x)
    fn = Traced(lambda x, n=1: x)
    tracer.register("step", fn)
    fn(torch.zeros(2, 3))
    fn(torch.ones(2, 3))  # the same signature
    assert tracer.step("a") == {"step": 1}
    fn(torch.zeros(2, 4))
    fn(torch.zeros(2, 4), n=2)
    assert tracer.step("b") == {"step": 2}
    assert tracer.step("c") == {}
    assert tracer.events == [RecompileEvent(0, "a", {"step": 1}),
                             RecompileEvent(1, "b", {"step": 2})]
    assert tracer.summary() == {"steps": 3, "misses": 3,
                                "by_fn": {"step": 3}, "miss_steps": [0, 1]}


def test_call_signature_reads_containers_dataclasses_and_values():
    @dataclasses.dataclass
    class Part:
        a: object
        k: int

    x = torch.zeros(3, 2)
    base = call_signature(([x], {"p": Part(np.zeros(4), 1)}), {"s": "a"})
    same = call_signature(([torch.ones(3, 2)], {"p": Part(np.ones(4), 1)}),
                          {"s": "a"})
    assert base == same
    for args, kw in [(([x.double()], {"p": Part(np.zeros(4), 1)}), {"s": "a"}),
                     (([x], {"p": Part(np.zeros(5), 1)}), {"s": "a"}),
                     (([x], {"p": Part(np.zeros(4), 2)}), {"s": "a"}),
                     (([x], {"p": Part(np.zeros(4), 1)}), {"s": "b"}),
                     (((x,), {"p": Part(np.zeros(4), 1)}), {"s": "a"})]:
        assert call_signature(args, kw) != base
