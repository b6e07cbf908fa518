"""Run one cell of the benchmark once.

    python3 -m gsbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is data found by name: the cell in
``BENCHMARK.json``, its configuration in ``gsbench/configs/<config>.json``,
its traffic in ``gsbench/traffic/<traffic>.json`` (whose ``driver`` names
``gsbench/drivers/<driver>.py``), the limits of its check in
``gsbench/limits/<cell>.json`` (with, under ``reference``, the precision
the reference is computed in, float32 unless it says otherwise), and each
metric's reader in
``gsbench/metrics/<metric>.py``. With ``--trace 0`` the run reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The run needs the card: without one, or with fewer cards than the cell asks
for, it exits non-zero and prints no result. So it does if a module of JAX
or of the JAX package was imported. The last line of standard output is
the result; the check's numbers, each beside its limit, are the last lines
of standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names the run may not hold (JAX and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str) -> tuple:
    """(manifest, cell entry, configuration, traffic, limits) of a cell."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in manifest["workloads"]}.get(workload)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return manifest, entry, cfg, traffic, limits


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's metrics of one kind: those listing it under ``workloads``
    and those with no such key."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gsbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number the limits name at
    or under its limit and finite."""
    rows = [(k, float(checks[k]), float(lim)) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """The result line's object for one run, and what its numbers were
    taken over (each step's and each leaf's gap, the padding marks, the
    window step's mean wait, staging and sync).
    The card's look is left to the caller, so a test can drive a run on
    the CPU."""
    manifest, entry, cfg, traffic, limits = cell(workload)
    precision = limits.pop("reference", "float32")
    driver = importlib.import_module(f"gsbench.drivers.{traffic['driver']}")
    rec = driver.run(cfg, traffic, seed, seconds, trace, device, t_start,
                     reference_precision=precision)
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gaps = rec["checks"].pop("detail")
    correct, rows = judge(rec["checks"], limits)
    correct = correct and rec["losses_finite"]
    steps = len(rec["steps"])
    result = {
        "correct": correct,
        "attempted": steps,
        "failed": sum(1 for s in rec["steps"] if not math.isfinite(s.loss)),
        "metrics": metrics,
        "device": device_info(device, entry["chips"], rec["peak_bytes"]),
    }
    if trace and "trace" in rec:
        tr = rec["trace"]
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_by_host_span()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    n = len(rec["steps"])
    parts = {k: 1e3 * sum(getattr(st, k) for st in rec["steps"]) / n
             for k in ("t_wait", "t_stage", "t_device")}
    others = {k: v for k, v in rec["checks"].items() if k not in limits}
    totals = [1e3 * (st.t_wait + st.t_stage + st.t_device) for st in rec["steps"]]
    tenths = [sum(totals[i * n // 10:(i + 1) * n // 10])
              / max(1, (i + 1) * n // 10 - i * n // 10) for i in range(10)]
    return result, {"gaps": gaps, "not_compared": others, "pad_marks": rec["hwm"],
                    "step_parts_ms": parts, "step_ms_by_tenth": tenths,
                    "reference": precision, "host": rec["host"],
                    "setup_s": rec["setup_s"], "kernel_build_s": rec["kernel_build_s"]}


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
            "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    if info["platform"] == "gpu":
        info["kind"] = torch.cuda.get_device_name(0)
        info["power_limit_w"] = power_limit()
    return info


def power_limit():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m gsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel and compile cache of the run stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    _, entry, _, _, _ = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"gsbench: needs {entry['chips']} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    result, detail = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"gsbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"detail {json.dumps(detail)}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
