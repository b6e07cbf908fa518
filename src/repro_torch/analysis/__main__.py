"""CLI for the port's splint static-analysis pass.

    python -m repro_torch.analysis [--root DIR] [--select PL,HP,KC,FT]
                                   [--format text|json]
                                   [--baseline FILE] [--no-baseline]
                                   [--write-baseline [--reason TEXT]]

Exit codes: 0 clean (or fully baselined), 1 new findings, 2 usage error.
A finding not in the baseline (none is checked in: the port's tree is
clean) fails with its file:line, rule id, and fix hint.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import FAMILIES, run_all
from repro_torch.analysis.findings import Baseline, to_json

#: the port's own baseline file (the reference's is splint_baseline.json)
DEFAULT_BASELINE = "splint_torch_baseline.json"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-native static analysis (plan lifecycle, hot-path "
        "purity, kernel contracts, fault handling)",
    )
    parser.add_argument(
        "--root", type=Path, default=Path.cwd(), help="project root"
    )
    parser.add_argument(
        "--select",
        default=",".join(FAMILIES),
        help="comma-separated rule families to run (default: all)",
    )
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument(
        "--baseline",
        type=Path,
        default=None,
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE} if present)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline; report every finding",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--reason",
        default="pre-existing; parked for burn-down",
        help="reason recorded on entries written by --write-baseline",
    )
    args = parser.parse_args(argv)

    select = tuple(s.strip().upper() for s in args.select.split(",") if s.strip())
    unknown = [s for s in select if s not in FAMILIES]
    if unknown:
        print(f"unknown rule families: {', '.join(unknown)}", file=sys.stderr)
        return 2

    root = args.root.resolve()
    findings = run_all(root, select=select)

    baseline_path = args.baseline or (root / DEFAULT_BASELINE)
    baseline = None
    if args.write_baseline:
        Baseline.from_findings(findings, args.reason).save(baseline_path)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0
    if not args.no_baseline and baseline_path.exists():
        baseline = Baseline.load(baseline_path)

    suppressed: list = []
    stale: list = []
    if baseline is not None:
        findings, suppressed, stale = baseline.split(findings)

    if args.format == "json":
        sys.stdout.write(to_json(findings))
    else:
        for f in findings:
            print(f.render())
        if suppressed:
            print(f"[splint] {len(suppressed)} finding(s) suppressed by "
                  f"{baseline_path.name}")
        for entry in stale:
            print(
                "[splint] stale baseline entry (fixed? remove it): "
                f"{entry.get('rule')} {entry.get('path')}: "
                f"{entry.get('message')}"
            )
        if not findings:
            print(f"[splint] clean: {','.join(select)} over {root}")
        else:
            print(f"[splint] {len(findings)} new finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
