"""Crash-consistent checkpointing in the port (``repro_torch.train.checkpoint``
and ``Trainer.save_checkpoint``/``resume``), mirroring
``tests/test_checkpoint.py`` on the tiny graph (hidden 16, 2 layers, P = 2,
batch 16, fan-outs (4, 4), seed 3):

* the roundtrip matrix: 3 models x split/dp/pushpull, and the R = 2 mesh;
  the resume restores the whole trainer state, in place (the model's
  parameters and the optimizer's slots stay the tensors the step uses);
* a run killed mid-epoch and resumed in a fresh ``Trainer`` continues bit
  for bit as its uninterrupted twin on all four plan sources and the R = 2
  mesh;
* the integrity checks raise ``CheckpointError``, never ``assert``: a
  missing or garbled manifest, a checksum mismatch before any parse, a
  truncated payload, a structure mismatch, a missing optimizer state, and
  ``load_latest_checkpoint``'s ordering, fallback and empty/all-corrupt
  distinction;
* the telemetry counters and ``nonfinite_skips`` survive a resume;
* against the JAX package, from the same weights after the same 2 steps:
  the npz key set, shapes and dtypes and the cursor equal the JAX
  checkpoint's, the arrays within rtol 1e-4, and so the resumed
  trajectories; the threaded presample is bitwise the JAX package's.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.presample import presample as j_presample
from repro.graph.datasets import make_dataset as j_make_dataset
from repro.models.gnn import GNNSpec as JGNNSpec
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.core.presample import presample
from repro_torch.faults import (
    CheckpointError,
    FaultAction,
    FaultInjected,
    FaultInjector,
    corrupt_checkpoint,
    truncate_checkpoint,
)
from repro_torch.graph.datasets import make_dataset
from repro_torch.models.gnn import GNNSpec, params_from_jax
from repro_torch.train.checkpoint import (
    checkpoint_name,
    list_checkpoints,
    load_checkpoint,
    load_latest_checkpoint,
    save_checkpoint,
)
from repro_torch.train.optimizer import OptimizerState
from repro_torch.train.trainer import TrainConfig, Trainer


@pytest.fixture(scope="module")
def ds():
    return make_dataset("tiny")


def _kw(ds, model="sage"):
    return dict(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                out_dim=ds.spec.num_classes, num_layers=2,
                num_heads=1 if model == "gat" else 4)


def _spec(ds, model="sage"):
    return GNNSpec(**_kw(ds, model))


BASE = dict(mode="split", num_devices=2, fanouts=(4, 4), batch_size=16,
            presample_epochs=2, seed=3, stall_timeout_s=60.0)


def _cfg(**over):
    return TrainConfig(**{**BASE, **over})


def _trainer(ds, model="sage", injector=None, **over):
    return Trainer(ds, _spec(ds, model), _cfg(**over), device="cpu",
                   injector=injector)


def _assert_state_equal(tr, ck):
    """A loaded checkpoint holds ``tr``'s parameters and optimizer state."""
    for layer, saved in zip(tr._param_tree(), ck.params, strict=True):
        assert sorted(layer) == sorted(saved)
        for name, p in layer.items():
            assert np.array_equal(p.detach().numpy(), saved[name]), name
    live = tr._opt_tree()
    assert isinstance(ck.opt_state, OptimizerState)
    assert int(ck.opt_state.step) == tr.opt_state.step
    assert ck.opt_state.step.dtype == np.int32
    if isinstance(live.slots, dict):
        for kind in live.slots:
            for layer, saved in zip(live.slots[kind], ck.opt_state.slots[kind],
                                    strict=True):
                for name, t in layer.items():
                    assert np.array_equal(t.numpy(), saved[name]), (kind, name)
    else:
        assert ck.opt_state.slots == () == live.slots


def _opt_tensors(tr):
    return [t.detach().clone() for t in tr._opt_tensors()]


def _same_tensors(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------- #
# roundtrip matrix: models x parallelism modes x 2-D mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("mode", ["split", "dp", "pushpull"])
def test_roundtrip_models_by_modes(tmp_path, ds, model, mode):
    tr = _trainer(ds, model, mode=mode)
    tr.train_epoch(max_iters=2)
    path = tr.save_checkpoint(root=str(tmp_path))
    assert os.path.basename(path) == checkpoint_name(2)
    ck = load_checkpoint(path, tr._param_tree(), tr._opt_tree())
    assert ck.step == tr.global_step == 2
    _assert_state_equal(tr, ck)
    assert ck.cursor["seed"] == 3
    assert ck.cursor["global_step"] == tr.global_step
    assert ck.cursor["sampler"] is None


def test_roundtrip_mesh_r2(tmp_path, ds):
    tr = _trainer(ds, num_replicas=2)
    tr.train_epoch(max_iters=2)
    path = tr.save_checkpoint(root=str(tmp_path))
    ck = load_checkpoint(path, tr._param_tree(), tr._opt_tree())
    _assert_state_equal(tr, ck)
    assert ck.cursor["hwm"] == {k: int(v) for k, v in tr._pad_hwm.items()}


def test_roundtrip_sgd_has_only_the_step(tmp_path, ds):
    tr = _trainer(ds, optimizer="sgd")
    tr.train_epoch(max_iters=2)
    path = tr.save_checkpoint(root=str(tmp_path))
    with np.load(os.path.join(path, "params.npz")) as npz:
        assert [k for k in npz.files if k.startswith("opt/")] == ["opt/0"]
    _assert_state_equal(tr, load_checkpoint(path, tr._param_tree(),
                                            tr._opt_tree()))


def test_resume_restores_full_trainer_state(tmp_path, ds):
    tr = _trainer(ds, ckpt_dir=str(tmp_path))
    tr.train_epoch()
    tr.save_checkpoint()
    fresh = _trainer(ds, ckpt_dir=str(tmp_path))
    ck = fresh.resume()
    assert ck is not None and fresh.global_step == tr.global_step
    assert fresh._epoch == tr._epoch == 1 and fresh._start_iter == 0
    assert dict(fresh._pad_hwm) == dict(tr._pad_hwm)
    assert fresh.opt_state.step == tr.opt_state.step
    assert _same_tensors(_opt_tensors(fresh), _opt_tensors(tr))


def test_resume_copies_in_place_and_trains_on(tmp_path, ds):
    """``resume`` writes into the tensors the forward, the gradient and the
    in-place optimizer hold: after it ``tr.params[i]`` is still the model's
    i-th parameter and the slots are the optimizer's, and one more step
    moves them."""
    tr = _trainer(ds, ckpt_dir=str(tmp_path))
    tr.train_epoch(max_iters=2)
    tr.save_checkpoint()
    fresh = _trainer(ds, ckpt_dir=str(tmp_path))
    ids = [id(t) for t in fresh._opt_tensors()]
    fresh.resume()
    assert [id(t) for t in fresh._opt_tensors()] == ids
    for p, q in zip(fresh.params, fresh.model.parameters(), strict=True):
        assert p is q
    for layer, mlayer in zip(fresh._param_tree(), fresh.model.layers,
                             strict=True):
        for name, p in layer.items():
            assert p is mlayer[name]
    restored = _opt_tensors(fresh)
    assert _same_tensors(restored, _opt_tensors(tr))
    st = fresh.train_epoch(max_iters=1)
    assert np.isfinite(st.iters[0].loss) and fresh.global_step == 3
    moved = _opt_tensors(fresh)
    n = len(fresh.params)
    assert all(not torch.equal(a, b) for a, b in zip(restored[:n], moved[:n]))
    assert fresh.opt_state.step == 3


# --------------------------------------------------------------------- #
# bit-exact mid-epoch continuation: all four sources and the mesh
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("source,replicas", [
    ("serial", 0), ("pipelined", 0), ("device", 0), ("device_pipelined", 0),
    ("serial", 2),
], ids=["serial", "pipelined", "device", "device_pipelined", "mesh-r2"])
def test_bit_exact_midepoch_continuation(tmp_path, ds, source, replicas):
    """Kill at (epoch 1, batch 2), resume in a fresh ``Trainer``: every step
    after the resume point and the final params and optimizer state are
    bitwise the uninterrupted twin's; a device sampler's state right after
    the resume is the saved one."""
    over = dict(plan_source=source, pipeline_depth=2, plan_workers=2,
                num_replicas=replicas)
    clean = _trainer(ds, **over)
    clean_traj = []
    for _ in range(2):
        clean_traj += [(it.loss, it.accuracy)
                       for it in clean.train_epoch().iters]

    over.update(ckpt_dir=str(tmp_path), ckpt_every=1)
    inj = FaultInjector(schedule=[FaultAction("kill", epoch=1, batch=2)])
    tr = _trainer(ds, injector=inj, **over)
    tr.train_epoch()
    with pytest.raises(FaultInjected):
        tr.train_epoch()
    tr = _trainer(ds, **over)  # the restarted process
    ck = tr.resume()
    assert ck is not None and tr._start_iter == 2 and tr._epoch == 1
    if "device" in source:
        assert ck.cursor["sampler"] is not None
        assert tr.device_sampler.export_state() == ck.cursor["sampler"]
    tail = [(it.loss, it.accuracy) for it in tr.train_epoch().iters]
    n = len(clean_traj) // 2  # batches per epoch
    assert n > 3 and tail == clean_traj[n + 2:], (tail, clean_traj[n + 2:])
    assert _same_tensors(_opt_tensors(tr), _opt_tensors(clean))
    assert tr.opt_state.step == clean.opt_state.step
    assert tr.global_step == clean.global_step


# --------------------------------------------------------------------- #
# integrity: real errors under any interpreter flags, never ``assert``
# --------------------------------------------------------------------- #
def _save_small(tmp_path, name="ck"):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": np.zeros(3, dtype=np.float32)}
    path = str(tmp_path / name)
    save_checkpoint(path, params, step=5, cursor={"epoch": 1, "batch": 2},
                    extra={"note": "x"})
    return path, params


def test_missing_and_garbled_manifest_raise(tmp_path):
    with pytest.raises(CheckpointError, match="no manifest"):
        load_checkpoint(str(tmp_path / "nope"), {"w": np.zeros(2)})
    path, params = _save_small(tmp_path)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError, match="unreadable"):
        load_checkpoint(path, params)


def test_checksum_mismatch_detected_before_parse(tmp_path, monkeypatch):
    path, params = _save_small(tmp_path)
    corrupt_checkpoint(path)

    def no_parse(*a, **k):
        raise AssertionError("np.load ran before the checksum check")

    monkeypatch.setattr(np, "load", no_parse)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        load_checkpoint(path, params)


def test_truncated_payload_detected(tmp_path):
    path, params = _save_small(tmp_path)
    truncate_checkpoint(path)
    with pytest.raises(CheckpointError):
        load_checkpoint(path, params)
    # the same torn payload with no checksum to hold it against: the parse
    # itself must fail as a CheckpointError
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["checksum"] = ""
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointError, match="unreadable arrays"):
        load_checkpoint(path, params)


def test_treedef_mismatch_rejected(tmp_path):
    path, params = _save_small(tmp_path)
    wrong = {"w": params["w"], "extra_layer": np.zeros(3, np.float32)}
    with pytest.raises(CheckpointError):
        load_checkpoint(path, wrong)
    # same key *names* but different nesting is also a structure mismatch
    nested = {"w": {"inner": params["w"]}, "b": params["b"]}
    with pytest.raises(CheckpointError):
        load_checkpoint(path, nested)
    # same keys, another shape or dtype: the port's structure string
    with pytest.raises(CheckpointError, match="treedef"):
        load_checkpoint(path, {"w": np.zeros((3, 2), np.float32),
                               "b": params["b"]})
    with pytest.raises(CheckpointError, match="treedef"):
        load_checkpoint(path, {"w": params["w"].double(), "b": params["b"]})


def test_requested_opt_state_must_exist(tmp_path):
    path, params = _save_small(tmp_path)  # saved without optimizer state
    with pytest.raises(CheckpointError, match="optimizer"):
        load_checkpoint(path, params, opt_state_like=(np.zeros(2),))


def test_cursor_and_extra_roundtrip(tmp_path):
    path, params = _save_small(tmp_path)
    ck = load_checkpoint(path, params)
    assert ck.cursor == {"epoch": 1, "batch": 2}
    assert ck.extra == {"note": "x"}
    assert np.array_equal(ck.params["w"], params["w"].numpy())
    assert isinstance(ck.params["w"], np.ndarray)
    # the manifest is committed last and is valid JSON on disk
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 5 and manifest["checksum"].startswith("sha256:")
    assert manifest["version"] == 2
    assert sorted(os.listdir(path)) == ["manifest.json", "params.npz"]


def test_list_and_latest_ordering(tmp_path):
    params = {"w": np.zeros(2, np.float32)}
    for step in (3, 12, 7):
        save_checkpoint(
            str(tmp_path / checkpoint_name(step)), params, step=step
        )
    # names off the pattern are ignored
    (tmp_path / "ckpt-12").mkdir()
    (tmp_path / "ckpt-00000009.tmp").mkdir()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3, 7, 12]
    ck = load_latest_checkpoint(str(tmp_path), params)
    assert ck is not None and ck.step == 12


def test_latest_falls_back_past_corruption(tmp_path):
    params = {"w": np.ones(4, np.float32)}
    for step in (1, 2):
        save_checkpoint(
            str(tmp_path / checkpoint_name(step)), params, step=step
        )
    corrupt_checkpoint(str(tmp_path / checkpoint_name(2)))
    ck = load_latest_checkpoint(str(tmp_path), params)
    assert ck is not None and ck.step == 1


def test_latest_empty_none_but_all_corrupt_raises(tmp_path):
    params = {"w": np.ones(4, np.float32)}
    assert load_latest_checkpoint(str(tmp_path), params) is None
    save_checkpoint(str(tmp_path / checkpoint_name(1)), params, step=1)
    corrupt_checkpoint(str(tmp_path / checkpoint_name(1)))
    with pytest.raises(CheckpointError, match="failed validation"):
        load_latest_checkpoint(str(tmp_path), params)


def test_trainer_resume_falls_back_and_raises_when_all_corrupt(tmp_path, ds):
    """The trainer's side of the fallback: a corrupt newest checkpoint
    resumes from the one before, bitwise on the clean trajectory; every
    checkpoint truncated raises."""
    clean = _trainer(ds)
    traj = [it.loss for it in clean.train_epoch(max_iters=4).iters]
    tr = _trainer(ds, ckpt_dir=str(tmp_path), ckpt_every=1)
    tr.train_epoch(max_iters=3)
    corrupt_checkpoint(str(tmp_path / checkpoint_name(3)))
    fresh = _trainer(ds, ckpt_dir=str(tmp_path))
    ck = fresh.resume()
    assert ck.step == 2 and fresh._start_iter == 2
    assert [it.loss for it in fresh.train_epoch(max_iters=4).iters] == traj[2:]
    for _, path in list_checkpoints(str(tmp_path)):
        truncate_checkpoint(path)
    with pytest.raises(CheckpointError, match="failed validation"):
        _trainer(ds, ckpt_dir=str(tmp_path)).resume()
    assert _trainer(ds, ckpt_dir=str(tmp_path / "none")).resume() is None


# --------------------------------------------------------------------- #
# the rest of the cursor: telemetry, the non-finite guard
# --------------------------------------------------------------------- #
def test_telemetry_aux_roundtrip(tmp_path, ds):
    tr = _trainer(ds, record_telemetry=True, ckpt_dir=str(tmp_path))
    tr.train_epoch(max_iters=3)
    path = tr.save_checkpoint()
    with np.load(os.path.join(path, "params.npz")) as npz:
        assert {"aux/telemetry_k_v", "aux/telemetry_k_e",
                "aux/telemetry_num_batches"} <= set(npz.files)
    fresh = _trainer(ds, record_telemetry=True, ckpt_dir=str(tmp_path))
    fresh.resume()
    a, b = tr.telemetry.counters(), fresh.telemetry.counters()
    assert a["num_batches"] == b["num_batches"] == 3
    assert np.array_equal(a["k_v"], b["k_v"]) and a["k_v"].any()
    assert np.array_equal(a["k_e"], b["k_e"])


def test_nonfinite_skips_survive_resume(tmp_path, ds):
    inj = FaultInjector([FaultAction("poison", epoch=0, batch=1)])
    tr = _trainer(ds, injector=inj, skip_nonfinite=True,
                  ckpt_dir=str(tmp_path), ckpt_every=1)
    tr.train_epoch(max_iters=3)
    assert tr.nonfinite_skips == 1 and tr.opt_state.step == 2
    fresh = _trainer(ds, skip_nonfinite=True, ckpt_dir=str(tmp_path))
    ck = fresh.resume()
    assert ck.cursor["nonfinite_skips"] == fresh.nonfinite_skips == 1
    assert fresh.opt_state.step == 2 and fresh.global_step == 3


# --------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("source", ["serial", "device"])
def test_checkpoint_matches_jax(tmp_path, ds, source):
    """The JAX ``Trainer`` and the port take the same 2 steps from the same
    weights and both save: the npz key sets, shapes and dtypes and the
    cursors (padding marks and the device sampler's state included) are
    equal, the arrays within rtol 1e-4; each package resumes its own
    checkpoint in a fresh trainer and the two tails agree within rtol
    1e-4."""
    jds = j_make_dataset("tiny")
    over = dict(plan_source=source, pipeline_depth=2, plan_workers=2)
    jbase = {k: v for k, v in BASE.items() if k != "stall_timeout_s"}

    def jtrainer(**extra):
        return JTrainer(jds, JGNNSpec(agg_backend="jnp", **_kw(jds)),
                        JTrainConfig(**jbase, **over, sampler_backend="jnp",
                                     **extra))

    jtr = jtrainer()
    np_params = [{k: np.asarray(v) for k, v in d.items()} for d in jtr.params]
    spec = _spec(ds)
    ttr = Trainer(ds, spec, _cfg(**over), device="cpu",
                  model=params_from_jax(np_params, spec, "cpu"))
    jl = [it.loss for it in jtr.train_epoch(max_iters=2).iters]
    tl = [it.loss for it in ttr.train_epoch(max_iters=2).iters]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    jpath = jtr.save_checkpoint(root=str(tmp_path / "jax"), epoch=0,
                               next_batch=2)
    tpath = ttr.save_checkpoint(root=str(tmp_path / "port"), epoch=0,
                               next_batch=2)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    with np.load(os.path.join(jpath, "params.npz")) as j, \
            np.load(os.path.join(tpath, "params.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        assert any(k.startswith("opt/1/m/") for k in t.files)
        for k in j.files:
            assert (j[k].shape, j[k].dtype) == (t[k].shape, t[k].dtype), k
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tman = json.load(f)
    assert tman["cursor"] == jman["cursor"]
    assert (tman["cursor"]["sampler"] is not None) == (source == "device")
    assert tman["keys"] == jman["keys"] and tman["version"] == jman["version"]

    jfresh = jtrainer(ckpt_dir=str(tmp_path / "jax"))
    tfresh = _trainer(ds, ckpt_dir=str(tmp_path / "port"), **over)
    jfresh.resume()
    tfresh.resume()
    assert tfresh._start_iter == jfresh._start_iter == 2
    jtail = [it.loss for it in jfresh.train_epoch(max_iters=4).iters]
    ttail = [it.loss for it in tfresh.train_epoch(max_iters=4).iters]
    assert len(ttail) == 2
    np.testing.assert_allclose(ttail, jtail, rtol=1e-4, atol=1e-6)


def test_threaded_presample_matches_jax(ds):
    """``workers > 1`` draws the keyed per-epoch streams: bitwise the JAX
    package's, independent of the thread count, and another stream than
    the one-generator path's."""
    args = (ds.graph, ds.train_ids, [4, 4], 16)
    jds = j_make_dataset("tiny")
    want = j_presample(jds.graph, jds.train_ids, [4, 4], 16, num_epochs=3,
                       seed=1, workers=3)
    w3 = presample(*args, num_epochs=3, seed=1, workers=3)
    w2 = presample(*args, num_epochs=3, seed=1, workers=2)
    w1 = presample(*args, num_epochs=3, seed=1)
    for w in (w3, w2):
        assert np.array_equal(w.vertex_weight, want.vertex_weight)
        assert np.array_equal(w.edge_weight, want.edge_weight)
    assert not np.array_equal(w1.edge_weight, w3.edge_weight)
    tr = _trainer(ds, presample_workers=3, presample_epochs=3)
    assert np.array_equal(tr.weights.edge_weight,
                          presample(ds.graph, ds.train_ids, [4, 4], 16,
                                    num_epochs=3, seed=4,
                                    workers=3).edge_weight)
