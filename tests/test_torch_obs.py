"""The port's tracing and metrics (``repro_torch.obs``): recorder semantics,
the Chrome-trace export schema, the stall-attribution report, high-water-mark
growth, and the trainer contract that observation never changes a loss bit.

* A trace written by either package gives the same ``summarize`` and
  ``validate_trace`` results with either package's report.
* Tracing is observation only: serial and pipelined runs are bitwise equal
  with tracing on and off.
* The trainer step's phases: ``step/pack``, ``step/forward``,
  ``step/backward`` and ``step/optimizer`` inside ``step/stage``,
  ``step/stats`` after the step, their ``IterStats`` fields with tracing
  off, the spans as ``torch.profiler`` ranges only with a tracer, the staged
  bytes, and the benchmark's readers of them.
"""
import importlib.util
import json
import logging
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.graph.datasets import make_dataset
from repro.models.gnn import GNNSpec
from repro.obs import report as j_report
from repro.train.trainer import TrainConfig, Trainer
from repro_torch.graph.datasets import make_dataset as t_make_dataset
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.obs import NULL_OBS, Obs, Tracer, note_hwm_growth
from repro_torch.obs import report as t_report
from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.obs.report import classify_step, load_trace, summarize, validate_trace
from repro_torch.train import trainer as t_trainer


# --------------------------------------------------------------------- #
# metrics registry
# --------------------------------------------------------------------- #
def test_percentile_nearest_rank():
    vals = sorted(float(v) for v in range(1, 11))
    assert percentile(vals, 0) == 1.0
    assert percentile(vals, 50) == 5.0  # nearest rank on 10 items
    assert percentile(vals, 100) == 10.0
    assert percentile([], 50) == 0.0


def test_registry_kinds_and_summaries():
    reg = MetricsRegistry()
    reg.count("hits")
    reg.count("hits", 4)
    reg.gauge("occupancy", 3.5)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.observe("lat", v)
    snap = reg.snapshot()
    assert snap["hits"] == 5
    assert snap["occupancy"] == 3.5
    assert snap["lat"]["count"] == 4
    assert snap["lat"]["mean"] == 2.5
    assert snap["lat"]["max"] == 4.0


def test_registry_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.count("x")
    with pytest.raises(TypeError, match="Counter"):
        reg.observe("x", 1.0)


def test_absorb_takes_numeric_leaves_only():
    reg = MetricsRegistry()
    reg.absorb(
        {"delivered": 7, "rate": 0.5, "name": "q", "flag": True, "sub": {}},
        prefix="src/",
    )
    assert reg.snapshot() == {"src/delivered": 7.0, "src/rate": 0.5}


def test_registry_counts_from_threads_lose_no_update():
    """More threads than cores, a short switch interval: every count lands."""
    import sys

    reg = MetricsRegistry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [reg.count("n") for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert reg.snapshot()["n"] == 16 * 2000


# --------------------------------------------------------------------- #
# tracer + span semantics
# --------------------------------------------------------------------- #
def test_span_times_without_tracer():
    with NULL_OBS.span("x") as sp:
        pass
    assert sp.duration >= 0.0
    assert NULL_OBS.tracer is None and NULL_OBS.metrics is None


def test_null_obs_calls_are_noops():
    NULL_OBS.count("c")
    NULL_OBS.observe("h", 1.0)
    NULL_OBS.instant("i")
    NULL_OBS.flow_start(("p", 0, 0))
    NULL_OBS.flow_end(("p", 0, 0))
    with pytest.raises(ValueError, match="disabled"):
        NULL_OBS.write("/dev/null")


def test_tracer_records_nested_spans_and_flows():
    tr = Tracer()
    with tr.span("outer", {"epoch": 0}):
        tr.flow_start(("plan", 0, 0))
        with tr.span("inner"):
            pass
    with tr.span("step"):
        tr.flow_end(("plan", 0, 0))
    tr.flow_start(("plan", 0, 99))  # never finished -> unresolved
    chrome = tr.to_chrome({"m": 1})

    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    # rings append at span *exit*: inner closes before outer
    assert [e["name"] for e in xs] == ["inner", "outer", "step"]
    assert next(e for e in xs if e["name"] == "outer")["args"] == {"epoch": 0}
    flows = [e for e in chrome["traceEvents"] if e["ph"] in ("s", "f")]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert chrome["otherData"]["unresolved_flows"] == 1
    assert chrome["otherData"]["unclosed_spans"] == 0
    assert chrome["otherData"]["metrics"] == {"m": 1}
    # the dangling flow is the one violation the validator sees
    assert validate_trace(chrome) == ["1 flow id(s) with a missing endpoint"]


def test_ring_overflow_drops_oldest_and_counts():
    tr = Tracer(ring_capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert tr.dropped_events() == 6
    chrome = tr.to_chrome()
    names = [e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert names == ["s6", "s7", "s8", "s9"]  # oldest evicted
    assert chrome["otherData"]["dropped_events"] == 6
    assert any("dropped" in err for err in validate_trace(chrome))


def test_threads_get_their_own_lanes():
    tr = Tracer()

    def worker():
        with tr.span("produced"):
            pass

    t = threading.Thread(target=worker, name="producer-0")
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    with tr.span("consumed"):
        pass
    chrome = tr.to_chrome()
    tids = {e["name"]: e["tid"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    assert tids["produced"] != tids["consumed"]
    lanes = {
        e["args"]["name"] for e in chrome["traceEvents"]
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    assert "producer-0" in lanes


def test_unclosed_span_flagged_at_export():
    tr = Tracer()
    tr.span("open").__enter__()
    chrome = tr.to_chrome()
    assert chrome["otherData"]["unclosed_spans"] == 1
    assert any("unclosed" in err for err in validate_trace(chrome))


def test_obs_write_and_load_roundtrip(tmp_path):
    obs = Obs(enabled=True)
    with obs.span("a"):
        pass
    obs.count("n", 3)
    path = tmp_path / "trace.json"
    obs.write(path)
    trace = load_trace(path)
    assert validate_trace(trace) == []
    assert trace["otherData"]["metrics"]["n"] == 3


# --------------------------------------------------------------------- #
# validation + report
# --------------------------------------------------------------------- #
def _ev(name, ts, dur=None, ph="X", **kw):
    ev = {"ph": ph, "name": name, "ts": ts, "pid": 0, "tid": 1, **kw}
    if dur is not None:
        ev["dur"] = dur
    return ev


def test_validate_catches_structural_breakage():
    bad = {
        "traceEvents": [
            {"ph": "Z", "name": "?", "ts": 0, "pid": 0, "tid": 1},
            _ev("no-dur", 10.0),
            _ev("negative", -5.0, 1.0),
            _ev("later", 100.0, 10.0),
            _ev("regressed", 50.0, 10.0),  # record time goes backwards
            _ev("flow", 1.0, ph="s", id=7),  # never finished
        ],
        "otherData": {},
    }
    errors = validate_trace(bad)
    assert errors == j_report.validate_trace(bad)
    assert any("unknown ph" in e for e in errors)
    assert any("missing/negative dur" in e for e in errors)
    assert any("negative ts" in e for e in errors)
    assert any("regresses" in e for e in errors)
    assert any("flow 7" in e and "unresolved" in e for e in errors)


def test_classify_step_picks_largest_component():
    assert classify_step({"wait_s": 0.5, "stage_s": 0.1}) == "producer-bound"
    assert classify_step({"stage_s": 0.9, "device_s": 0.2}) == "staging-bound"
    assert classify_step({"device_s": 1.0}) == "device-bound"


def test_summarize_stages_and_stalls():
    trace = {
        "traceEvents": [
            _ev("plan/build", 0.0, 1000.0),
            _ev("plan/build", 0.0, 3000.0),
            _ev("step", 0.0, 500.0,
                args={"wait_s": 0.9, "stage_s": 0.1, "device_s": 0.0}),
            _ev("step", 600.0, 500.0,
                args={"wait_s": 0.0, "stage_s": 0.1, "device_s": 0.8}),
        ],
        "otherData": {"metrics": {"sig/hit": 5}},
    }
    s = summarize(trace)
    assert s == j_report.summarize(trace)
    assert s["steps"] == 2
    assert s["stages"]["plan/build"]["count"] == 2
    assert s["stages"]["plan/build"]["mean_ms"] == 2.0
    assert s["stall_classes"] == {
        "producer-bound": 1, "staging-bound": 0, "device-bound": 1,
    }
    assert s["metrics"] == {"sig/hit": 5}


def test_cli_validate_and_report(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    obs = Obs(enabled=True)
    with obs.span("step", {"wait_s": 1.0, "stage_s": 0.0, "device_s": 0.0}):
        pass
    path = tmp_path / "t.json"
    obs.write(path)
    assert main(["validate", str(path)]) == 0
    assert "schema valid" in capsys.readouterr().out
    assert main(["report", str(path)]) == 0
    out = capsys.readouterr().out
    assert "producer-bound" in out and "stall attribution" in out

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    assert main(["validate", str(bad)]) == 1


def test_load_trace_accepts_jsonl(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(
        "\n".join(json.dumps(_ev(f"s{i}", i * 10.0, 1.0)) for i in range(3))
    )
    trace = load_trace(path)
    assert len(trace["traceEvents"]) == 3
    assert validate_trace(trace) == []


# --------------------------------------------------------------------- #
# high-water-mark growth
# --------------------------------------------------------------------- #
def test_note_hwm_growth_classifies_and_warns(caplog):
    obs = Obs(enabled=True)
    before = {"N0": 32, "E1": 16}
    after = {"N0": 64, "E1": 16, "CM": 8}  # one grown, one flat, one new
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs"):
        grown = note_hwm_growth(obs, before, after, "epoch0/batch3")
    assert grown == 1
    warnings = [r for r in caplog.records if "high-water mark" in r.message]
    assert len(warnings) == 1
    assert "N0" in warnings[0].message and "epoch0/batch3" in warnings[0].message
    assert obs.metrics.snapshot()["hwm/growth"] == 1
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]
             if e["ph"] == "i"]
    assert names.count("hwm/grow") == 1
    assert names.count("hwm/init") == 1  # first-seen marks are silent events


def test_note_hwm_growth_steady_state_is_silent(caplog):
    hwm = {"N0": 64}
    with caplog.at_level(logging.WARNING, logger="repro_torch.obs"):
        assert note_hwm_growth(NULL_OBS, dict(hwm), hwm, "steady") == 0
    assert not caplog.records


def test_device_sampler_fallback_is_counted():
    """A batch that overflows a cap falls back to the host sampler's keyed
    draw, and says so: a ``fault/sampler_fallback`` count and instant."""
    from repro_torch.graph.sampling import NeighborSampler as TNeighborSampler
    from repro_torch.sampler import DeviceSampler as TDeviceSampler

    ds = t_make_dataset("tiny")
    host = TNeighborSampler(ds.graph, ds.train_ids, [4, 4], 16, seed=0)
    eng = TDeviceSampler(ds.graph, np.arange(ds.graph.num_nodes) % 4, 4, [4, 4],
                         0, host_sampler=host, device="cpu")
    eng.obs = Obs(enabled=True)
    targets = host.epoch_targets(0)[0]
    eng.sample_batch(targets, 0, 0)
    assert eng.obs.metrics.snapshot() == {}
    eng._caps = dict(eng._caps, C0=1)  # undersized: the batch overflows
    got = eng.sample_batch(targets, 0, 1)
    want = host.sample_batch(targets, 0, 1)
    for a, b in zip(got.layers, want.layers, strict=True):
        assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert eng.stats()["sampler_fallbacks"] == 1
    assert eng.obs.metrics.snapshot() == {"fault/sampler_fallback": 1}
    instants = [e for e in eng.obs.tracer.to_chrome()["traceEvents"]
                if e["ph"] == "i"]
    assert [e["name"] for e in instants] == ["fault/sampler_fallback"]
    assert instants[0]["args"] == {"epoch": 0, "batch": 1, "caps": ["C0"]}


# --------------------------------------------------------------------- #
# the trainer: observation never perturbs; traces read across packages
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tds():
    return t_make_dataset("tiny")


def _trainer(tds, source, obs_path=None, **over):
    spec = TGNNSpec(model="sage", in_dim=tds.spec.feat_dim, hidden_dim=16,
                    out_dim=tds.spec.num_classes, num_layers=2)
    cfg = t_trainer.TrainConfig(**{
        **dict(num_devices=4, fanouts=(4, 4), batch_size=16,
               presample_epochs=2, plan_source=source, pipeline_depth=2,
               plan_workers=2, seed=7, stall_timeout_s=30.0,
               obs_trace=obs_path is not None,
               obs_path=str(obs_path) if obs_path else None),
        **over,
    })
    return t_trainer.Trainer(tds, spec, cfg, device="cpu")


def _run(tds, source, obs_path=None, epochs=2, iters=3):
    tr = _trainer(tds, source, obs_path)
    traj = []
    for _ in range(epochs):
        st = tr.train_epoch(max_iters=iters)
        traj += [(i.loss, i.accuracy) for i in st.iters]
    return tr, traj


@pytest.mark.parametrize("source", ["serial", "pipelined", "device_pipelined"])
def test_tracing_is_observation_only(tds, tmp_path, source):
    path = tmp_path / f"{source}.json"
    _, plain = _run(tds, source)
    tr, traced = _run(tds, source, obs_path=path)
    assert traced == plain  # bitwise: spans never touch the math

    trace = load_trace(path)
    assert validate_trace(trace) == []
    s = summarize(trace)
    assert s["steps"] == len(traced)
    assert sum(s["stall_classes"].values()) == s["steps"]
    for stage in ("plan/build", "plan/sample", "plan/split", "plan/load",
                  "plan/repad", "plan/queue_dwell", "step/wait",
                  "step/stage", "step/device", *PHASES):
        assert stage in s["stages"], f"missing {stage} spans"
    # producer build spans flow-link to consumer steps: all resolved
    flows = [e for e in trace["traceEvents"] if e["ph"] in ("s", "f")]
    assert len(flows) == 2 * len(traced)
    instants = [e["name"] for e in trace["traceEvents"] if e["ph"] == "i"]
    assert "hwm/init" in instants
    snap = trace["otherData"]["metrics"]
    assert snap["sig/hit"] + snap["sig/miss"] == len(traced)
    assert snap["source/delivered" if source != "serial" else "source/hits"] > 0


def test_epoch_stats_fields_survive_with_obs_off(tds):
    tr, _ = _run(tds, "pipelined", epochs=1)
    st = tr.train_epoch(max_iters=2)
    for it in st.iters:
        assert it.t_sample > 0.0 and it.t_split > 0.0 and it.t_load > 0.0
        assert it.t_compute == it.t_stage + it.t_device > 0.0
        assert it.t_wait >= 0.0


@pytest.fixture(scope="module")
def traces(tds, tmp_path_factory):
    """One pipelined trace written by each package's trainer."""
    root = tmp_path_factory.mktemp("traces")
    ds = make_dataset("tiny")
    cfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                      presample_epochs=2, plan_source="pipelined", seed=7,
                      obs_trace=True, obs_path=str(root / "jax.json"))
    spec = GNNSpec(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=16,
                   out_dim=ds.spec.num_classes, num_layers=2,
                   agg_backend="jnp")
    Trainer(ds, spec, cfg).train_epoch(max_iters=3)
    _run(tds, "pipelined", obs_path=root / "port.json", epochs=1)
    return {"jax": root / "jax.json", "port": root / "port.json"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reports_agree_across_packages(traces, writer):
    ours = t_report.load_trace(traces[writer])
    theirs = j_report.load_trace(traces[writer])
    assert ours == theirs
    assert t_report.validate_trace(ours) == j_report.validate_trace(theirs) == []
    s = t_report.summarize(ours)
    assert s == j_report.summarize(theirs)
    assert s["steps"] == 3 and sum(s["stall_classes"].values()) == 3
    assert t_report.format_report(s) == j_report.format_report(s)
    # both packages name the same spans
    for stage in ("plan/build", "plan/queue_dwell", "step/wait",
                  "step/stage", "step/device", "step"):
        assert stage in s["stages"], f"{writer}: missing {stage}"
    assert np.isfinite([row["mean_ms"] for row in s["stages"].values()]).all()


# --------------------------------------------------------------------- #
# the step's phases: spans, IterStats fields, profiler ranges, bytes
# --------------------------------------------------------------------- #
#: the children of ``step/stage``, then the accounting's span
CHILDREN = ("step/pack", "step/forward", "step/backward", "step/optimizer")
PHASES = (*CHILDREN, "step/stats")
#: the IterStats fields the phases fill
PHASE_FIELDS = ("t_pack", "t_forward", "t_backward", "t_optimizer", "t_stats",
                "h2d_bytes")


def _within(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


@pytest.mark.parametrize("replicas", [0, 2])
def test_phase_spans_nest_inside_stage(tds, replicas):
    """Each part opens pack, forward and backward; the step one optimizer
    span (two on the mesh: its average, then the update), all inside
    ``step/stage`` and summing to no more than it; ``step/stats`` follows
    each step outside its ``step`` span."""
    tr = _trainer(tds, "serial", obs_path=None, obs_trace=True,
                  num_replicas=replicas)
    iters = tr.train_epoch(max_iters=3).iters
    events = [e for e in tr.obs.tracer.to_chrome()["traceEvents"]
              if e["ph"] == "X"]
    by = {n: [e for e in events if e["name"] == n]
          for n in ("step", "step/stage", *PHASES)}
    parts = max(replicas, 1)
    assert len(by["step/stage"]) == len(by["step/stats"]) == len(iters) == 3
    for stage in by["step/stage"]:
        inside = [e for e in events if e["name"] in CHILDREN
                  and _within(e, stage)]
        got = sorted(e["name"] for e in inside)
        assert got == sorted([*CHILDREN[:3]] * parts + ["step/optimizer"]
                             * (2 if parts > 1 else 1))
        assert sum(e["dur"] for e in inside) <= stage["dur"]
    for name in CHILDREN:
        assert all(any(_within(e, st) for st in by["step/stage"])
                   for e in by[name])
    for stats in by["step/stats"]:
        assert not any(_within(stats, st) for st in by["step"])
    snap = tr.obs.metrics.snapshot()
    assert snap["plan/h2d_bytes"] == sum(it.h2d_bytes for it in iters) > 0
    assert "step/compute_s" not in snap


@pytest.mark.parametrize("path", ["train_epoch", "train_iter"])
def test_phase_fields_are_timed_with_obs_off(tds, path):
    tr = _trainer(tds, "serial")
    assert not tr.obs.enabled
    if path == "train_epoch":
        iters = tr.train_epoch(max_iters=2).iters
    else:
        iters = [tr.train_iter(t) for t in tr.sampler.epoch_targets(0)[:2]]
    for it in iters:
        for name in PHASE_FIELDS:
            assert getattr(it, name) > 0, name
        assert (it.t_pack + it.t_forward + it.t_backward + it.t_optimizer
                <= it.t_stage)


@pytest.mark.parametrize("traced", [True, False])
def test_spans_are_profiler_ranges_only_with_a_tracer(tds, tmp_path, traced):
    from torch.profiler import ProfilerActivity, profile

    tr = _trainer(tds, "serial", obs_path=tmp_path / "t.json" if traced else None)
    tr.train_epoch(max_iters=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        iters = tr.train_epoch(max_iters=2).iters
    events = prof.events()
    names = {e.name for e in events}
    if not traced:
        assert not {n for n in names if n.startswith(("step", "plan/"))}
        return
    assert set(PHASES) | {"step/stage", "step/device", "step/wait"} <= names
    for e in events:
        if e.name in CHILDREN:
            parent = e.cpu_parent
            while parent is not None and parent.name != "step/stage":
                parent = parent.cpu_parent
            assert parent is not None, e.name
    assert sum(e.name == "step/pack" for e in events) == len(iters)


class _OneBatch:
    """A plan source delivering one prepared batch."""

    def __init__(self, batch):
        self.batches = [batch]

    def __iter__(self):
        yield from self.batches

    def stats(self) -> dict:
        return {}

    def close(self) -> None:
        pass


@pytest.mark.parametrize("mode", ["split", "dp"])
def test_h2d_bytes_are_the_packed_buffer_and_the_feature_block(tds, mode):
    from repro_torch.train import plan_io

    tr = _trainer(tds, "serial", mode=mode)
    source = tr.plan_source_for(0, max_iters=1)
    batch = next(iter(source))
    source.close()
    packed, _ = plan_io.pack_host(batch.plan, batch.labels, pin=False)
    want = packed.nbytes + batch.feats.nbytes
    counts = {"h2d_bytes": 0}
    plan_io.stage_batch(batch.plan, batch.feats, batch.labels, "cpu",
                        counts=counts)
    assert counts["h2d_bytes"] == want
    tr.plan_source_for = lambda *a, **k: _OneBatch(batch)
    assert tr.train_epoch().iters[0].h2d_bytes == want


def test_profile_step_idle_reads_the_union_of_device_intervals(tmp_path):
    """A copy beside a kernel counts once; host ranges and the device-side
    copies of user annotations are no device work."""
    from repro_torch.profile_step import device_busy_us

    class Prof:
        def export_chrome_trace(self, path):
            ev = [("kernel", 0.0, 10.0), ("gpu_memcpy", 5.0, 10.0),
                  ("gpu_memset", 20.0, 5.0), ("kernel", 21.0, 2.0),
                  ("user_annotation", 0.0, 100.0),
                  ("gpu_user_annotation", 0.0, 40.0)]
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    {"ph": "X", "cat": c, "name": c, "ts": t, "dur": d}
                    for c, t, d in ev]}, f)

    assert device_busy_us(Prof()) == pytest.approx(20.0)


# --------------------------------------------------------------------- #
# the benchmark's readers of the phases (gsbench/metrics/<name>.py)
# --------------------------------------------------------------------- #
METRICS_DIR = Path(__file__).resolve().parents[1] / "gsbench" / "metrics"
#: two steps: (wait, stage, device, pack, forward, backward, optimizer,
#: stats) in ms and the staged bytes; 0.5 ms a step no span covers
STEPS = [(1.0, 10.0, 2.0, 4.0, 3.0, 2.0, 0.5, 1.0, 1000),
         (3.0, 12.0, 4.0, 6.0, 4.0, 1.0, 1.5, 2.0, 3000)]
WANT = {"pack_ms": 5.0, "forward_ms": 3.5, "backward_ms": 1.5,
        "optimizer_ms": 1.0, "stats_ms": 1.5, "h2d_bytes": 2000.0,
        "unspanned_ms": 0.5}


def _read(name, rec):
    spec = importlib.util.spec_from_file_location(
        f"gsbench_metric_{name}", METRICS_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(rec)


def _synthetic_rec():
    steps = []
    for w, st, d, pk, fw, bw, op, sa, nb in STEPS:
        steps.append(t_trainer.IterStats(
            loss=1.0, accuracy=0.5, t_sample=0.0, t_split=0.0, t_load=0.0,
            t_compute=(st + d) / 1e3, loaded_rows=1, computed_edges=1,
            shuffle_rows=1, t_wait=w / 1e3, t_stage=st / 1e3,
            t_device=d / 1e3, t_pack=pk / 1e3, t_forward=fw / 1e3,
            t_backward=bw / 1e3, t_optimizer=op / 1e3, t_stats=sa / 1e3,
            h2d_bytes=nb))
    spanned = sum(w + st + d + sa for w, st, d, *_, sa, _ in STEPS)
    return {"steps": steps, "window_s": (spanned + 0.5 * len(STEPS)) / 1e3}


@pytest.mark.parametrize("name", sorted(WANT))
def test_phase_metric_reads_a_synthetic_window(name):
    assert _read(name, _synthetic_rec()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_phase_metric_reads_nothing_without_its_field(name):
    """A program whose ``IterStats`` lacks the phases reads as no metric."""
    old = SimpleNamespace(t_wait=1e-3, t_stage=1e-2, t_device=1e-3,
                          t_compute=1.1e-2, loaded_rows=1)
    assert _read(name, {"steps": [old], "window_s": 1.3e-2}) is None
