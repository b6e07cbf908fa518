"""splint over the port: the counterpart of ``repro/analysis``, the
repo-native static-analysis pass, retargeted to ``src/repro_torch/``.

Four checker families over the source tree, all stdlib-AST based — the
target code is never imported, so the pass runs in well under a second
with no torch (or card) in sight:

  PL*  plan-lifecycle contracts  (analysis/plan_lifecycle.py)
  HP*  hot-path purity           (analysis/purity.py)
  KC*  kernel contracts          (analysis/kernel_contract.py)
  FT*  fault handling            (analysis/faults.py)

Run it as ``python -m repro_torch.analysis``; it exits 0 on a clean tree.
The runtime complement (new step-call signatures, the port's counterpart
of jit cache misses) lives in ``runtime/recompile.py``, not here — splint
itself never runs anything. Its deliberate exceptions, each with a reason,
are in ``analysis/exemptions.py``.
"""
from __future__ import annotations

from pathlib import Path

from repro_torch.analysis.faults import FaultSpec, check_faults
from repro_torch.analysis.findings import Baseline, Finding, dedupe, to_json
from repro_torch.analysis.kernel_contract import KernelSpec, check_kernel_contract
from repro_torch.analysis.plan_lifecycle import (
    ContractSpec,
    Leg,
    check_plan_lifecycle,
)
from repro_torch.analysis.purity import PuritySpec, check_purity

FAMILIES = ("PL", "HP", "KC", "FT")


def run_all(root: Path, select: tuple[str, ...] = FAMILIES) -> list[Finding]:
    """Run every selected checker family over one tree."""
    root = Path(root)
    findings: list[Finding] = []
    if "PL" in select:
        findings.extend(check_plan_lifecycle(root))
    if "HP" in select:
        findings.extend(check_purity(root))
    if "KC" in select:
        findings.extend(check_kernel_contract(root))
    if "FT" in select:
        findings.extend(check_faults(root))
    return dedupe(findings)


__all__ = [
    "Baseline",
    "ContractSpec",
    "FAMILIES",
    "FaultSpec",
    "Finding",
    "KernelSpec",
    "Leg",
    "PuritySpec",
    "check_faults",
    "check_kernel_contract",
    "check_plan_lifecycle",
    "check_purity",
    "dedupe",
    "run_all",
    "to_json",
]
