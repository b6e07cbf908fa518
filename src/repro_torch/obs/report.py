"""Trace post-processing: schema validation and the stall-attribution
report — the counterpart of ``repro/obs/report.py`` (same checks, same
classes, so either package's report reads either package's trace).

  * :func:`validate_trace` — every event well formed, per-thread record
    order monotonic, flow ``s``/``f`` pairs resolved, no unclosed spans,
    nothing dropped. Returns the violations (empty = clean).
  * :func:`summarize` / :func:`format_report` — per-stage duration
    percentiles over every span name, and a stall class per step. Each
    consumer ``step`` span carries ``wait_s`` (blocked on the plan source),
    ``stage_s`` (staging to the card and enqueueing the step) and
    ``device_s`` (the step's one sync: device work still in flight); the
    largest names the step **producer-bound**, **staging-bound** or
    **device-bound**.

``python -m repro_torch.obs report|validate trace.json`` is the CLI face.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import percentile

__all__ = [
    "classify_step",
    "format_report",
    "load_trace",
    "summarize",
    "validate_trace",
]

#: step-span attr -> stall class (largest measured component wins)
STALL_CLASSES = {
    "wait_s": "producer-bound",
    "stage_s": "staging-bound",
    "device_s": "device-bound",
}


def load_trace(path) -> dict:
    """Load a trace file: Chrome JSON object, bare event array, or JSONL."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("["):
        return {"traceEvents": json.loads(stripped), "otherData": {}}
    if stripped.startswith("{"):
        try:
            return json.loads(stripped)
        except json.JSONDecodeError:
            pass  # JSONL whose first event is itself an object
    events = [json.loads(line) for line in stripped.splitlines() if line.strip()]
    return {"traceEvents": events, "otherData": {}}


def _record_time(ev: dict) -> float:
    """When an event was *recorded*: exit time for X, ts otherwise."""
    return ev.get("ts", 0.0) + (ev.get("dur", 0.0) if ev.get("ph") == "X" else 0.0)


def validate_trace(trace: dict) -> list[str]:
    """Structural violations of the trace schema (empty list = valid)."""
    errors: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    other = trace.get("otherData", {})
    if other.get("unclosed_spans", 0):
        errors.append(f"{other['unclosed_spans']} unclosed span(s) at export")
    if other.get("unresolved_flows", 0):
        errors.append(
            f"{other['unresolved_flows']} flow id(s) with a missing endpoint"
        )
    if other.get("dropped_events", 0):
        errors.append(
            f"{other['dropped_events']} event(s) dropped by ring overflow "
            "(raise ring_capacity for full traces)"
        )

    last_rec: dict = {}  # tid -> record time of the previous non-flow event
    flows: dict = {}  # id -> {"s": ts, "f": ts}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "s", "f"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for key in ("name", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i} ({ph}): missing {key!r}")
        if ev.get("ts", 0.0) < 0:
            errors.append(f"event {i} ({ev.get('name')}): negative ts")
        if ph == "X" and ev.get("dur", -1.0) < 0:
            errors.append(f"event {i} ({ev.get('name')}): missing/negative dur")
        if ph in ("s", "f"):
            slot = flows.setdefault(ev.get("id"), {})
            if ph in slot:
                errors.append(f"flow {ev.get('id')}: duplicate {ph} endpoint")
            slot[ph] = ev.get("ts", 0.0)
            continue
        # per-thread record order is monotonic: rings append at span exit
        tid = ev.get("tid")
        rec = _record_time(ev)
        if tid in last_rec and rec < last_rec[tid] - 1e-6:
            errors.append(
                f"event {i} ({ev.get('name')}): record time regresses on "
                f"tid {tid} ({rec:.3f} < {last_rec[tid]:.3f}us)"
            )
        last_rec[tid] = max(last_rec.get(tid, rec), rec)
    for fid, slot in flows.items():
        if "s" not in slot or "f" not in slot:
            errors.append(f"flow {fid}: unresolved ({sorted(slot)} only)")
        elif slot["f"] < slot["s"] - 1e-6:
            errors.append(f"flow {fid}: finish precedes start")
    return errors


def classify_step(args: dict) -> str:
    """The stall class of one step from its measured components."""
    parts = {k: float(args.get(k, 0.0)) for k in STALL_CLASSES}
    return STALL_CLASSES[max(parts, key=parts.get)]


def summarize(trace: dict) -> dict:
    """Per-stage percentiles and per-step stall attribution for one trace."""
    stages: dict[str, list[float]] = {}
    steps: list[dict] = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        stages.setdefault(ev["name"], []).append(ev.get("dur", 0.0) / 1e3)
        if ev["name"] == "step" and "args" in ev:
            steps.append(ev["args"])

    stage_rows = {}
    for name, durs in sorted(stages.items()):
        durs.sort()
        stage_rows[name] = {
            "count": len(durs),
            "mean_ms": sum(durs) / len(durs),
            "p50_ms": percentile(durs, 50),
            "p90_ms": percentile(durs, 90),
            "p99_ms": percentile(durs, 99),
            "max_ms": durs[-1],
        }

    counts = {cls: 0 for cls in STALL_CLASSES.values()}
    for args in steps:
        counts[classify_step(args)] += 1
    return {
        "stages": stage_rows,
        "steps": len(steps),
        "stall_classes": counts,
        "metrics": trace.get("otherData", {}).get("metrics", {}),
    }


def format_report(summary: dict) -> str:
    """Render the summary as the CLI's text report."""
    lines = [
        f"{'stage':<24}{'count':>7}{'mean':>9}{'p50':>9}{'p90':>9}"
        f"{'p99':>9}{'max':>9}  (ms)"
    ]
    for name, row in summary["stages"].items():
        lines.append(
            f"{name:<24}{row['count']:>7}{row['mean_ms']:>9.3f}"
            f"{row['p50_ms']:>9.3f}{row['p90_ms']:>9.3f}"
            f"{row['p99_ms']:>9.3f}{row['max_ms']:>9.3f}"
        )
    n = summary["steps"]
    lines += ["", f"stall attribution over {n} step(s):"]
    for cls, cnt in summary["stall_classes"].items():
        frac = cnt / n if n else 0.0
        lines.append(f"  {cls:<16}{cnt:>6}  ({frac:>5.1%})")
    metrics = summary.get("metrics")
    if metrics:
        lines += ["", "metrics:"]
        for name, val in metrics.items():
            if isinstance(val, dict):
                body = " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in val.items()
                )
                lines.append(f"  {name:<32}{body}")
            else:
                lines.append(f"  {name:<32}{val}")
    return "\n".join(lines)
