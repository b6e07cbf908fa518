"""CLI: ``python -m repro_torch.obs {report|validate} trace.json``.

``report`` prints per-stage duration percentiles, the per-step
producer-bound / staging-bound / device-bound attribution and the embedded
metrics. ``validate`` checks the trace schema (unclosed spans, unresolved
flows, per-thread record order, ring drops) and exits 1 on any violation.
Either reads a trace written by this package or by the JAX package.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.report import (
    format_report,
    load_trace,
    summarize,
    validate_trace,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="per-stage percentiles + stall attribution")
    rep.add_argument("trace", help="trace file (Chrome JSON or JSONL events)")
    val = sub.add_parser("validate", help="schema check; exit 1 on violations")
    val.add_argument("trace")
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)
    errors = validate_trace(trace)
    if args.cmd == "validate":
        for err in errors:
            print(f"INVALID: {err}", file=sys.stderr)
        if not errors:
            n = len([e for e in trace["traceEvents"] if e.get("ph") == "X"])
            print(f"ok: {n} span(s), schema valid")
        return 1 if errors else 0
    print(format_report(summarize(trace)))
    if errors:
        print(
            f"\nwarning: trace failed validation ({len(errors)} issue(s)); "
            "numbers above may be partial",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
