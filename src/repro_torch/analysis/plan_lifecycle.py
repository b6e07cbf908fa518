"""PL: the plan-lifecycle contract checker — the port's own copy of
``repro/analysis/plan_lifecycle.py``, over ``src/repro_torch/``.

Every ``LayerPlan``/``CachePlan`` field must survive three legs of the plan
lifecycle, or be explicitly exempted with a reason:

  repad      -- grown to the running high-water marks on the delivery side
                (``core.splitting.repad_plan`` / ``CachePlan.pad_to``);
  signature  -- its padded dims keyed into the plan signature
                (``runtime.signature.plan_signature``);
  staging    -- shipped to the device in the plan dict
                (``train.plan_io.plan_to_device`` / ``cache_plan_to_device``).

A field that skips a leg is the bug class of stale cross-split offsets
silently aggregating zeroed padding — a new field fails here with a
pointer to the missing site. "Handled" is determined by AST token
extraction (``astutil.handled_tokens``): attribute accesses,
string-literal key tuples, and resolvable f-string expansions all count;
comments and docstrings never do. Unlike the reference, a leg's tokens are
its function's and those of every function of its own file that it calls
(the port's staging names its keys in ``_plan_fields``/``_cache_fields``,
which ``plan_to_device`` and ``stage_batch`` share), with the string
constants of the module-level tuples those name (``HALF_KEYS``,
``CACHE_KEYS``).

Rules:
  PL001  field not handled in a leg and not exempted
  PL002  exemption names a field/contract that no longer exists
  PL003  exemption is stale — the field *is* handled in that leg now
  PL004  checker configuration rot (dataclass or leg function not found)
  PL005  exemption has no reason string
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import ast

from repro_torch.analysis.astutil import (
    FunctionInfo,
    ProjectIndex,
    dataclass_fields,
    handled_tokens,
    module_strings,
    reachable_functions,
)
from repro_torch.analysis.findings import Finding


@dataclass(frozen=True)
class Leg:
    """One registration site a plan field must pass through."""

    name: str  # "repad" | "signature" | "staging" (free-form for fixtures)
    path: str  # project-root-relative file
    func: str  # qualname within that file ("repad_plan", "CachePlan.pad_to")


@dataclass(frozen=True)
class ContractSpec:
    """One dataclass whose fields are bound to a set of lifecycle legs."""

    name: str
    dataclass_path: str
    dataclass_name: str
    legs: tuple[Leg, ...]


PKG = "src/repro_torch"

#: the port's two plan contracts — the subject of the whole checker
DEFAULT_CONTRACTS: tuple[ContractSpec, ...] = (
    ContractSpec(
        name="LayerPlan",
        dataclass_path=f"{PKG}/core/splitting.py",
        dataclass_name="LayerPlan",
        legs=(
            Leg("repad", f"{PKG}/core/splitting.py", "repad_plan"),
            Leg("signature", f"{PKG}/runtime/signature.py", "plan_signature"),
            Leg("staging", f"{PKG}/train/plan_io.py", "plan_to_device"),
        ),
    ),
    ContractSpec(
        name="CachePlan",
        dataclass_path=f"{PKG}/graph/cache.py",
        dataclass_name="CachePlan",
        legs=(
            Leg("repad", f"{PKG}/graph/cache.py", "CachePlan.pad_to"),
            Leg("signature", f"{PKG}/runtime/signature.py", "plan_signature"),
            Leg("staging", f"{PKG}/train/plan_io.py", "cache_plan_to_device"),
        ),
    ),
)


def leg_tokens_of(index: ProjectIndex, fn: FunctionInfo) -> set[str]:
    """The tokens a leg handles: ``handled_tokens`` of ``fn`` and of every
    function of ``fn``'s own file that it reaches, and the string constants
    of the module-level tuples they name."""
    consts = module_strings(fn.module)
    tokens: set[str] = set()
    for f in reachable_functions(index, [fn]):
        if f.path != fn.path:
            continue
        tokens |= handled_tokens(f.node)
        for node in ast.walk(f.node):
            if isinstance(node, ast.Name) and node.id in consts:
                tokens |= consts[node.id]
    return tokens


def check_plan_lifecycle(
    root: Path,
    contracts: tuple[ContractSpec, ...] = DEFAULT_CONTRACTS,
    exemptions: dict[tuple[str, str, str], str] | None = None,
) -> list[Finding]:
    """Run the lifecycle contract over one tree; returns findings."""
    if exemptions is None:
        from repro_torch.analysis.exemptions import PLAN_LIFECYCLE_EXEMPTIONS

        exemptions = PLAN_LIFECYCLE_EXEMPTIONS

    paths = {c.dataclass_path for c in contracts}
    paths |= {leg.path for c in contracts for leg in c.legs}
    index = ProjectIndex(root, subdirs=tuple(sorted(paths)))

    findings: list[Finding] = []
    known_fields: dict[str, set[str]] = {}
    leg_names: dict[str, set[str]] = {}

    for contract in contracts:
        mod = index.modules.get(contract.dataclass_path)
        fields = (
            dataclass_fields(mod, contract.dataclass_name) if mod else None
        )
        if fields is None:
            findings.append(
                Finding(
                    path=contract.dataclass_path,
                    line=1,
                    rule="PL004",
                    message=(
                        f"contract {contract.name}: dataclass "
                        f"{contract.dataclass_name!r} not found in "
                        f"{contract.dataclass_path}"
                    ),
                    hint="update DEFAULT_CONTRACTS in analysis/plan_lifecycle.py",
                )
            )
            continue
        known_fields[contract.name] = {f for f, _ in fields}
        leg_names[contract.name] = {leg.name for leg in contract.legs}

        leg_tokens: dict[str, set[str] | None] = {}
        for leg in contract.legs:
            fn = index.function(leg.path, leg.func)
            if fn is None:
                findings.append(
                    Finding(
                        path=leg.path,
                        line=1,
                        rule="PL004",
                        message=(
                            f"contract {contract.name}: leg "
                            f"{leg.name!r} function {leg.func!r} not found "
                            f"in {leg.path}"
                        ),
                        hint=(
                            "the registration site moved or was renamed — "
                            "point the Leg at its new home"
                        ),
                    )
                )
                leg_tokens[leg.name] = None
            else:
                leg_tokens[leg.name] = leg_tokens_of(index, fn)

        for field_name, line in fields:
            for leg in contract.legs:
                tokens = leg_tokens[leg.name]
                if tokens is None:
                    continue  # PL004 already reported for the leg
                handled = field_name in tokens
                reason = exemptions.get((contract.name, field_name, leg.name))
                if not handled and reason is None:
                    findings.append(
                        Finding(
                            path=contract.dataclass_path,
                            line=line,
                            rule="PL001",
                            message=(
                                f"{contract.name}.{field_name} is not handled "
                                f"in the {leg.name} leg — {leg.func} "
                                f"({leg.path}) never names it"
                            ),
                            hint=(
                                f"register the field in {leg.func}, or add a "
                                "reasoned exemption to "
                                "analysis/exemptions.py"
                            ),
                        )
                    )
                elif handled and reason is not None:
                    findings.append(
                        Finding(
                            path=contract.dataclass_path,
                            line=line,
                            rule="PL003",
                            message=(
                                f"{contract.name}.{field_name} is exempted "
                                f"from the {leg.name} leg but {leg.func} now "
                                "handles it"
                            ),
                            hint="remove the stale exemption",
                        )
                    )
                elif reason is not None and not str(reason).strip():
                    findings.append(
                        Finding(
                            path=contract.dataclass_path,
                            line=line,
                            rule="PL005",
                            message=(
                                f"exemption for {contract.name}.{field_name} "
                                f"/ {leg.name} has an empty reason"
                            ),
                            hint="every exemption must say *why* it is safe",
                        )
                    )

    # stale exemption entries: unknown contract, field, or leg
    for (cname, fname, lname), _reason in sorted(exemptions.items()):
        if cname not in known_fields:
            continue  # contract not part of this run (fixture trees)
        if fname not in known_fields[cname] or lname not in leg_names[cname]:
            findings.append(
                Finding(
                    path=f"{PKG}/analysis/exemptions.py",
                    line=1,
                    rule="PL002",
                    message=(
                        f"exemption ({cname}, {fname}, {lname}) matches no "
                        "known field/leg"
                    ),
                    hint="the field was removed or renamed — drop the entry",
                )
            )
    return findings
