"""HP: the hot-path purity lint — the port's own copy of
``repro/analysis/purity.py``, over ``src/repro_torch/``.

Walks every function reachable from the port's step paths — the trainer's
step (``Trainer._step``, ``_step_grads``), the GNN forwards and the
shuffle, the device sampling loop (``sampler/engine.py::_sample_device``)
and the transformer's step factories (``make_train_step``,
``make_prefill_step``, ``make_decode_step``) — and flags what stalls the
card's stream or breaks determinism in eager PyTorch:

  HP001  a host sync: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``
         on a value that is not a numpy name's, or ``torch.cuda.synchronize``
         (the host waits for the stream and the next launch waits for the
         host)
  HP002  ``float()`` / ``int()`` / ``bool()`` applied to a non-static
         expression (a tensor's value read on the host: a sync)
  HP003  ``np.random`` use (host RNG: thread-unsafe, and invisible to the
         keyed-RNG determinism contract)
  HP004  ``np.asarray`` / ``np.array`` (a tensor's values materialized on
         the host)
  HP005  Python ``if``/``while`` on a tensor's ``.any()`` / ``.all()`` (or
         ``torch.any``/``torch.all``/``torch.isnan``/``torch.isinf``): the
         branch reads a device value on the host
  HP007  a literal bf16/fp16 cast (``.to(torch.bfloat16)``, ``.half()``,
         ``dtype=torch.float16``...) outside the ``wire_cast`` choke point
         (the wire format must have exactly one owner)

Two of the reference's rules keep no code here, because the hazard they
guard does not exist without jit:

  HP006  ``jax.jit`` static-arg declarations that do not match the wrapped
         function's signature (jax would trace the argument instead): eager
         PyTorch declares no static arguments.
  HP008  obs calls inside a jit-reachable function (a span in traced code
         records once at trace time, then never again): an eager step runs
         its spans every time, and the trainer's step spans are the obs
         layer's design (``NULL_OBS`` records nothing when tracing is off).

A real host sync on the step path is exempted with its reason in
``exemptions.HOT_PATH_EXEMPTIONS`` (by file, function and rule), never by
a blanket baseline: an exemption that matches no finding is reported
(HP009), and so is one without a reason (HP010). The walk stops at the
``HOST_BOUNDARIES`` (functions that are host-side by design, each with its
reason), so their host arrays do not read as device values.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.astutil import (
    FunctionInfo,
    ProjectIndex,
    _dotted_name,
    reachable_functions,
)
from repro_torch.analysis.findings import Finding, dedupe

PKG = "src/repro_torch"

#: the port's step paths (module docstring)
DEFAULT_ENTRIES: tuple[tuple[str, str], ...] = (
    (f"{PKG}/train/trainer.py", "Trainer._step"),
    (f"{PKG}/train/trainer.py", "Trainer._step_grads"),
    (f"{PKG}/models/gnn/layers.py", "gnn_forward"),
    (f"{PKG}/models/gnn/layers.py", "gnn_forward_cached"),
    (f"{PKG}/models/gnn/layers.py", "gnn_forward_spmd"),
    (f"{PKG}/core/shuffle.py", "sim_shuffle"),
    (f"{PKG}/core/shuffle.py", "sim_serve_features"),
    (f"{PKG}/sampler/engine.py", "_sample_device"),
    (f"{PKG}/models/transformer/model.py", "make_train_step"),
    (f"{PKG}/models/transformer/model.py", "make_prefill_step"),
    (f"{PKG}/models/transformer/model.py", "make_decode_step"),
)

#: (path, qualname) -> why the walk stops there: host-side by design
HOST_BOUNDARIES: dict[tuple[str, str], str] = {
    (f"{PKG}/train/plan_io.py", "stage_batch"): (
        "the staging stage: it packs the host plan's numpy arrays into one "
        "pinned buffer and issues the step's two non_blocking copies; its "
        "numpy reads are of host buffers, never of a device value"
    ),
}

#: (path, qualname) sites allowed to own a literal wire-dtype cast (HP007)
WIRE_CAST_OWNERS: tuple[tuple[str, str], ...] = (
    (f"{PKG}/core/shuffle.py", "wire_cast"),
)

LOW_PRECISION = {"bfloat16", "float16", "bf16", "fp16", "half"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_MATERIALIZE = {"asarray", "array", "ascontiguousarray"}
_TORCH_BOOL = {"any", "all", "isnan", "isinf", "equal"}


def _is_static_expr(node: ast.expr) -> bool:
    """Whether an expression is host-static (safe under float()/int()).

    Constants, ``.shape``/``.ndim``/``.size``/``.dtype`` reads, ``len()``,
    names, and arithmetic over those are shape math — Python numbers.
    Calls (other than ``len``/``min``/``max``) and subscripted tensor reads
    are not.
    """
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return True  # a bare name: assume a scalar config, not a tensor
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim", "dtype") or _is_static_expr(
            node.value)
    if isinstance(node, ast.Subscript):
        # shape[0] is static; anything_else[i] is a tensor read
        return (isinstance(node.value, ast.Attribute)
                and node.value.attr == "shape"
                and _is_static_expr(node.value))
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand)
    if isinstance(node, ast.Call):
        fn = _dotted_name(node.func) or ""
        if fn in ("len", "min", "max") or fn.endswith(".ceil"):
            return all(_is_static_expr(a) for a in node.args)
        if fn.endswith(".size") or fn.endswith(".numel") or fn.endswith(".dim"):
            return True  # t.size(i), t.numel(), t.dim(): shape reads
        return False
    return False


def _host_owner(node: ast.expr) -> bool:
    """A method's receiver that is numpy's: a numpy name, or the result of
    a numpy call (``np.asarray(caps).any()``)."""
    if isinstance(node, ast.Call):
        node = node.func
    owner = _dotted_name(node) or ""
    return owner.split(".")[0] in ("np", "numpy")


def _device_bool_test(test: ast.expr) -> ast.AST | None:
    """The offending subexpression if a branch test reads a tensor's
    truth value."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
                "any", "all") and not _host_owner(node.func.value):
            return node
        dotted = _dotted_name(node.func) or ""
        head, _, tail = dotted.partition(".")
        if head == "torch" and tail in _TORCH_BOOL:
            return node
    return None


def _low_precision_const(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in LOW_PRECISION
    dotted = _dotted_name(node) or ""
    return dotted.rsplit(".", 1)[-1] in LOW_PRECISION


@dataclass
class PuritySpec:
    """Tunable inputs so fixture trees can exercise every rule."""

    entries: tuple[tuple[str, str], ...] = DEFAULT_ENTRIES
    wire_cast_owners: tuple[tuple[str, str], ...] = WIRE_CAST_OWNERS
    subdirs: tuple[str, ...] = (PKG,)
    boundaries: dict = field(default_factory=lambda: dict(HOST_BOUNDARIES))
    exemptions: dict | None = None  # None: exemptions.HOT_PATH_EXEMPTIONS


def _finding(fn: FunctionInfo, node: ast.AST, rule: str, message: str,
             hint: str) -> Finding:
    return Finding(path=fn.path, line=node.lineno, col=node.col_offset,
                   rule=rule, message=message, hint=hint)


def _rules_for_function(fn: FunctionInfo, spec: PuritySpec) -> list[Finding]:
    out: list[Finding] = []
    is_wire_owner = (fn.path, fn.qualname) in spec.wire_cast_owners
    where = f"hot-path {fn.qualname}"

    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            dotted = _dotted_name(node.func) or ""
            # a method of any receiver, a call's result included
            tail = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else dotted)
            head = dotted.split(".")[0]

            # HP001: explicit host syncs
            if (isinstance(node.func, ast.Attribute) and tail in _SYNC_METHODS
                    and not _host_owner(node.func.value)):
                out.append(_finding(
                    fn, node, "HP001",
                    f".{tail}() inside {where} forces a host sync",
                    "keep the value on the device, or move this call off "
                    "the step path"))
            if dotted.endswith("cuda.synchronize"):
                out.append(_finding(
                    fn, node, "HP001",
                    f"torch.cuda.synchronize() inside {where} forces a host "
                    "sync",
                    "sync once, where the step's results are read"))

            # HP002: python scalar coercion of a tensor
            if dotted in ("float", "int", "bool") and node.args:
                if not _is_static_expr(node.args[0]):
                    out.append(_finding(
                        fn, node, "HP002",
                        f"{dotted}() on a non-static expression in {where} "
                        "reads a tensor on the host",
                        "keep the value a tensor; hoist scalar coercions to "
                        "setup code"))

            # HP004: host materialization of tensors
            if head in ("np", "numpy") and tail in _NP_MATERIALIZE:
                out.append(_finding(
                    fn, node, "HP004",
                    f"{dotted}() in {where} materializes on the host",
                    "keep the tensor on the device"))

            # HP007: literal low-precision cast outside wire_cast
            if not is_wire_owner:
                cast_args: list[ast.expr] = []
                if isinstance(node.func, ast.Attribute) and tail in (
                        "to", "type", "astype"):
                    cast_args = list(node.args)
                cast_args += [kw.value for kw in node.keywords
                              if kw.arg == "dtype"]
                low = any(_low_precision_const(a) for a in cast_args) or (
                    isinstance(node.func, ast.Attribute)
                    and tail in ("bfloat16", "half") and not node.args)
                if low:
                    out.append(_finding(
                        fn, node, "HP007",
                        f"literal low-precision cast in {where} bypasses "
                        "the wire_cast choke point",
                        "route wire-format casts through core.shuffle."
                        "wire_cast"))

        # HP003: host RNG
        if isinstance(node, ast.Attribute):
            dotted = _dotted_name(node) or ""
            if dotted.startswith(("np.random", "numpy.random")):
                out.append(_finding(
                    fn, node, "HP003",
                    f"np.random use in {where} (unkeyed host RNG)",
                    "use the keyed counter-based streams (sampler/rng.py) "
                    "or an explicit torch.Generator"))

        # HP005: branching on a tensor's truth value
        if isinstance(node, (ast.If, ast.While)):
            if _device_bool_test(node.test) is not None:
                out.append(_finding(
                    fn, node, "HP005",
                    f"Python branch on a tensor's truth value in {where}",
                    "use torch.where / a select on the device instead"))
    return out


def check_purity(root: Path, spec: PuritySpec | None = None) -> list[Finding]:
    """Run the hot-path purity lint over one tree; returns findings."""
    spec = spec or PuritySpec()
    exemptions = spec.exemptions
    if exemptions is None:
        from repro_torch.analysis.exemptions import HOT_PATH_EXEMPTIONS

        exemptions = HOT_PATH_EXEMPTIONS
    index = ProjectIndex(root, subdirs=spec.subdirs)
    entries = [fn for path, qualname in spec.entries
               if (fn := index.function(path, qualname)) is not None]
    stops = set(spec.boundaries)

    findings: list[Finding] = []
    used: set = set()
    for fn in reachable_functions(index, entries, stop=stops):
        for f in _rules_for_function(fn, spec):
            key = (fn.path, fn.qualname, f.rule)
            if key not in exemptions:
                findings.append(f)
                continue
            used.add(key)
            if not str(exemptions[key]).strip():
                findings.append(Finding(
                    path=f.path, line=f.line, rule="HP010",
                    message=f"exemption {key} has an empty reason",
                    hint="every exemption must say *why* the sync is needed"))
    for key in sorted(set(exemptions) - used):
        if not any(key[0].startswith(sub) for sub in spec.subdirs):
            continue  # not part of this run (fixture trees)
        findings.append(Finding(
            path=f"{PKG}/analysis/exemptions.py", line=1, rule="HP009",
            message=f"hot-path exemption {key} matches no finding",
            hint="the sync moved or went: drop or re-point the entry"))
    return dedupe(findings)
