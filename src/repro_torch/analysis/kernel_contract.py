"""KC: the kernel contract checker — the port's own copy of
``repro/analysis/kernel_contract.py``, over ``src/repro_torch/``.

Every kernel package under ``src/repro_torch/kernels/`` (and the device
sampler, a kernel package in spirit) must ship the contract the port's
kernels follow:

  KC001  a ``ref.py`` — the plain torch version the kernel is held against
  KC002  an ``ops.py`` — the public entry point (the plain version on a CPU
         tensor, shape plumbing)
  KC003  a tolerance-pinned equivalence test: some ``tests/test_torch_*.py``
         must import the package *and* pin ``rtol=``/``atol=`` in its
         asserts — "looks about right" is not a contract
  KC004  no low-precision accumulators among the Python allocations: an
         ``acc`` buffer made in bf16/fp16 loses the summation-order
         robustness the plain versions assume. The ``.cu`` sources lie
         outside the AST's reach; their accumulators are the card tests'.
  KC005  a ``kernel.py`` — the CUDA kernel's wrapper
  KC006  every CUDA source the package names (``typed_library("name")`` /
         ``load_library("name")``) exists as ``csrc/<name>.cu``, and it
         names at least one
  KC007  a card test: ``tests/test_torch_cuda.py`` imports the package

A directory is a kernel package when it contains a ``kernel.py`` or an
``ops.py``; the sampler directory is included explicitly. Where the port's
layout differs from the contract on purpose (a wrapper and its plain
version in one ``ops.py``), ``exemptions.KERNEL_CONTRACT_EXEMPTIONS``
holds the (package, rule) with its reason; an entry that matches no
finding is reported (KC008), and so is one without a reason (KC009).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.astutil import _dotted_name
from repro_torch.analysis.findings import Finding

LOW_PRECISION = {"bfloat16", "float16", "bf16", "fp16", "half"}
_ALLOC_CALLS = {"zeros", "empty", "full", "ones", "zeros_like", "empty_like",
                "new_zeros", "new_empty", "new_full", "new_ones"}
_LIBRARY_CALLS = {"typed_library", "load_library"}


@dataclass(frozen=True)
class KernelSpec:
    """Where to look for kernel packages, their CUDA sources and tests."""

    kernel_roots: tuple[str, ...] = ("src/repro_torch/kernels",)
    extra_packages: tuple[str, ...] = ("src/repro_torch/sampler",)
    tests_dir: str = "tests"
    test_glob: str = "test_torch_*.py"
    csrc: str = "src/repro_torch/csrc"
    card_tests: str = "tests/test_torch_cuda.py"
    exemptions: dict | None = None  # None: KERNEL_CONTRACT_EXEMPTIONS


def _kernel_packages(root: Path, spec: KernelSpec) -> list[Path]:
    pkgs: list[Path] = []
    for kroot in spec.kernel_roots:
        base = root / kroot
        if not base.is_dir():
            continue
        for child in sorted(base.iterdir()):
            if child.is_dir() and (
                (child / "kernel.py").exists() or (child / "ops.py").exists()
            ):
                pkgs.append(child)
    for extra in spec.extra_packages:
        path = root / extra
        if path.is_dir():
            pkgs.append(path)
    return pkgs


def _import_target(pkg: Path, root: Path) -> str:
    """The dotted module path tests would import, e.g.
    repro_torch.kernels.segsum."""
    rel = pkg.relative_to(root)
    parts = rel.parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    return ".".join(parts)


def _test_modules(root: Path, spec: KernelSpec) -> list[tuple[Path, str, ast.AST]]:
    out = []
    tests = root / spec.tests_dir
    if not tests.is_dir():
        return out
    for path in sorted(tests.glob(spec.test_glob)):
        try:
            text = path.read_text(encoding="utf-8")
            out.append((path, text, ast.parse(text)))
        except (OSError, SyntaxError):
            continue
    return out


def _imports_package(tree: ast.AST, dotted: str) -> bool:
    prefix = dotted + "."
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == dotted or alias.name.startswith(prefix):
                    return True
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == dotted or node.module.startswith(prefix):
                return True
    return False


def _has_tolerance_pin(text: str, tree: ast.AST) -> bool:
    """Whether any call in the module pins rtol=/atol= to a numeric value."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in ("rtol", "atol"):
                    return True
        # TOL = dict(rtol=..., atol=...) indirection also counts — the
        # dict() call above catches it; a literal {"rtol": ...} does too:
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and k.value in ("rtol", "atol"):
                    return True
    # subprocess-style tests build their asserts inside a code string the
    # AST cannot see into (e.g. the spmd multi-process harness); a literal
    # rtol=/atol= anywhere in the source still counts as a pin
    return re.search(r"\b[ra]tol\s*=", text) is not None


def _low_precision_dtype(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in LOW_PRECISION
    dotted = _dotted_name(node) or ""
    return dotted.rsplit(".", 1)[-1] in LOW_PRECISION


def _accumulator_findings(path: Path, relpath: str) -> list[Finding]:
    """KC004 within one kernel source file."""
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return []
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any("acc" in t.lower() for t in targets):
            continue
        call = node.value
        if not isinstance(call, ast.Call):
            continue
        dotted = _dotted_name(call.func) or ""
        if dotted.rsplit(".", 1)[-1] not in _ALLOC_CALLS:
            continue
        dtype_args = [kw.value for kw in call.keywords if kw.arg == "dtype"]
        if len(call.args) >= 2:
            dtype_args.append(call.args[1])
        for arg in dtype_args:
            if _low_precision_dtype(arg):
                out.append(
                    Finding(
                        path=relpath,
                        line=node.lineno,
                        col=node.col_offset,
                        rule="KC004",
                        message=(
                            f"accumulator {targets[0]!r} allocated in a "
                            "low-precision dtype"
                        ),
                        hint=(
                            "accumulate in float32 and cast on the way out; "
                            "bf16 partial sums drift past the pinned "
                            "tolerances"
                        ),
                    )
                )
    return out


def _named_sources(pkg: Path) -> list[tuple[str, str, int]]:
    """(library name, file, line) of every ``typed_library``/``load_library``
    call with a literal name in the package's Python files."""
    out = []
    for src in sorted(pkg.glob("*.py")):
        try:
            tree = ast.parse(src.read_text(encoding="utf-8"))
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and node.args
                    and (_dotted_name(node.func) or "").rsplit(".", 1)[-1]
                    in _LIBRARY_CALLS
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((node.args[0].value, src.name, node.lineno))
    return out


def check_kernel_contract(
    root: Path, spec: KernelSpec | None = None
) -> list[Finding]:
    """Run the kernel contract over one tree; returns findings."""
    spec = spec or KernelSpec()
    exemptions = spec.exemptions
    if exemptions is None:
        from repro_torch.analysis.exemptions import KERNEL_CONTRACT_EXEMPTIONS

        exemptions = KERNEL_CONTRACT_EXEMPTIONS
    findings: list[Finding] = []
    tests = _test_modules(root, spec)
    card = root / spec.card_tests
    card_tree = None
    if card.is_file():
        try:
            card_tree = ast.parse(card.read_text(encoding="utf-8"))
        except SyntaxError:
            card_tree = None

    for pkg in _kernel_packages(root, spec):
        rel = pkg.relative_to(root).as_posix()
        if not (pkg / "ref.py").exists():
            findings.append(
                Finding(
                    path=rel,
                    line=1,
                    rule="KC001",
                    message=f"kernel package {rel} has no ref.py",
                    hint=(
                        "every kernel ships a plain torch version; the "
                        "equivalence tests diff against it"
                    ),
                )
            )
        if not (pkg / "ops.py").exists():
            findings.append(
                Finding(
                    path=rel,
                    line=1,
                    rule="KC002",
                    message=f"kernel package {rel} has no ops.py",
                    hint=(
                        "the public entry point (the plain version on a CPU "
                        "tensor, shape plumbing) lives in ops.py"
                    ),
                )
            )
        dotted = _import_target(pkg, root)
        covered = any(
            _imports_package(tree, dotted) and _has_tolerance_pin(text, tree)
            for _path, text, tree in tests
        )
        if not covered:
            findings.append(
                Finding(
                    path=rel,
                    line=1,
                    rule="KC003",
                    message=(
                        f"no tolerance-pinned equivalence test imports "
                        f"{dotted}"
                    ),
                    hint=(
                        f"add a {spec.tests_dir}/ module importing {dotted} "
                        "that asserts against ref.py with explicit "
                        "rtol=/atol="
                    ),
                )
            )
        if not (pkg / "kernel.py").exists():
            findings.append(Finding(
                path=rel, line=1, rule="KC005",
                message=f"kernel package {rel} has no kernel.py",
                hint="the CUDA kernel's wrapper (launch or raise on a card "
                     "tensor, the plain version on a CPU one) lives in "
                     "kernel.py"))
        named = _named_sources(pkg)
        if not named:
            findings.append(Finding(
                path=rel, line=1, rule="KC006",
                message=f"kernel package {rel} names no CUDA source",
                hint="its wrapper loads csrc/<name>.cu through "
                     "kernels.build.typed_library"))
        for name, fname, line in named:
            if not (root / spec.csrc / f"{name}.cu").is_file():
                findings.append(Finding(
                    path=f"{rel}/{fname}", line=line, rule="KC006",
                    message=f"{rel}/{fname} names {name!r}, but "
                            f"{spec.csrc}/{name}.cu does not exist",
                    hint="add the source, or name the one that exists"))
        if card_tree is None or not _imports_package(card_tree, dotted):
            findings.append(Finding(
                path=rel, line=1, rule="KC007",
                message=f"no card test in {spec.card_tests} imports {dotted}",
                hint="hold the kernel against its plain version on the card "
                     "in a test marked cuda"))
        for src in sorted(pkg.glob("*.py")):
            findings.extend(
                _accumulator_findings(src, src.relative_to(root).as_posix())
            )
    kept, used = [], set()
    for f in findings:
        key = (f.path, f.rule)
        if key not in exemptions:
            kept.append(f)
            continue
        used.add(key)
        if not str(exemptions[key]).strip():
            kept.append(Finding(
                path=f.path, line=f.line, rule="KC009",
                message=f"exemption {key} has an empty reason",
                hint="every exemption must say *why* the layout differs"))
    roots = spec.kernel_roots + spec.extra_packages
    for key in sorted(set(exemptions) - used):
        if not any(key[0].startswith(r) for r in roots):
            continue  # not part of this run (fixture trees)
        kept.append(Finding(
            path="src/repro_torch/analysis/exemptions.py", line=1,
            rule="KC008", message=f"kernel exemption {key} matches no finding",
            hint="the package now holds the piece: drop the entry"))
    return kept
