"""Shared AST machinery for the splint checkers — the port's own copy of
``repro/analysis/astutil.py``, run over ``src/repro_torch/``.

Everything here is stdlib-only and works on *source text*, never imports:
the checkers run without torch (or a card) in sight, and must be able to
analyse fixture trees with deliberate violations that would not import
cleanly.

Four capabilities:

  * ``ProjectIndex``     -- parse every ``*.py`` under a root into
    ``ModuleInfo`` records: functions by qualname, import aliases, source.
  * ``handled_tokens``   -- the name-occurrence extraction behind the
    plan-lifecycle checker: attribute names, string constants (docstrings
    excluded — prose must never count as "handled"), and statically
    resolvable f-string expansions (``f"{side}pack_perm"`` under
    ``for side in ("l", "r")`` yields ``lpack_perm``/``rpack_perm``).
  * ``module_strings``   -- the string constants of a module's top-level
    tuples, lists and sets (the port's staging names its keys in
    ``HALF_KEYS`` and ``CACHE_KEYS``).
  * ``reachable_functions`` -- conservative call-graph walk from a set of
    entry functions, resolving direct calls, ``self``/``cls`` methods,
    module-attribute calls, and the function arguments of known
    higher-order wrappers (``torch.utils.checkpoint.checkpoint``,
    ``functools.partial``, ...).

The reference also finds every ``jax.jit``-decorated function as an entry;
eager PyTorch has no jit, so the port's hot path is its configured entry
list alone.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

#: higher-order wrappers whose function-valued arguments run inside the
#: caller: ``wrapper(f, ...)`` means ``f`` is reachable.
HIGHER_ORDER = {
    "checkpoint",  # torch.utils.checkpoint: the block runs twice
    "partial",
    "vmap",
    "grad",
    "functional_call",
}

#: cap on f-string cross-product expansion — a resolver safety valve, far
#: above anything a real repad/staging loop produces.
MAX_EXPANSIONS = 256


@dataclass
class FunctionInfo:
    """One function (or method) definition found in a module."""

    module: "ModuleInfo"
    qualname: str  # "fn" or "Class.method"
    node: ast.AST  # FunctionDef | AsyncFunctionDef

    @property
    def path(self) -> str:
        return self.module.relpath

    @property
    def lineno(self) -> int:
        return self.node.lineno


@dataclass
class ModuleInfo:
    """Parse results for one source file."""

    relpath: str  # posix path relative to the project root
    tree: ast.Module
    # qualname -> FunctionInfo (methods are "Class.method"; nested defs are
    # scanned as part of their parent's body, not indexed separately)
    functions: dict[str, FunctionInfo] = field(default_factory=dict)
    # local alias -> dotted module name ("np" -> "numpy")
    import_aliases: dict[str, str] = field(default_factory=dict)
    # local name -> (module, original name) for ``from m import x [as y]``
    from_imports: dict[str, tuple[str, str]] = field(default_factory=dict)


def parse_module(path: Path, relpath: str) -> ModuleInfo | None:
    """Parse one file; returns None on syntax errors (reported separately)."""
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (SyntaxError, UnicodeDecodeError):
        return None
    mod = ModuleInfo(relpath=relpath, tree=tree)
    for node in tree.body:
        _index_stmt(mod, node, prefix="")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.import_aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mod.from_imports[a.asname or a.name] = (node.module, a.name)
    return mod


def _index_stmt(mod: ModuleInfo, node: ast.stmt, prefix: str) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        qn = f"{prefix}{node.name}"
        mod.functions[qn] = FunctionInfo(module=mod, qualname=qn, node=node)
    elif isinstance(node, ast.ClassDef):
        for sub in node.body:
            _index_stmt(mod, sub, prefix=f"{node.name}.")


class ProjectIndex:
    """All parsed modules under a root, addressable by relative path."""

    def __init__(self, root: Path, subdirs: tuple[str, ...] = ("",)):
        self.root = Path(root)
        self.modules: dict[str, ModuleInfo] = {}
        self.parse_errors: list[str] = []
        seen: set[str] = set()
        for sub in subdirs:
            base = self.root / sub if sub else self.root
            if not base.exists():
                continue
            paths = [base] if base.is_file() else sorted(base.rglob("*.py"))
            for path in paths:
                rel = path.relative_to(self.root).as_posix()
                if rel in seen:
                    continue
                seen.add(rel)
                mod = parse_module(path, rel)
                if mod is None:
                    self.parse_errors.append(rel)
                else:
                    self.modules[rel] = mod

    def function(self, relpath: str, qualname: str) -> FunctionInfo | None:
        mod = self.modules.get(relpath)
        return mod.functions.get(qualname) if mod else None

    def resolve_import(
        self, mod: ModuleInfo, dotted: str, name: str
    ) -> FunctionInfo | None:
        """Find function ``name`` in module ``dotted`` if it is in-tree."""
        rel = self._module_relpath(dotted)
        if rel is None:
            return None
        target = self.modules.get(rel)
        if target is None:
            return None
        fn = target.functions.get(name)
        if fn is not None:
            return fn
        # ``from pkg import name`` may re-export through __init__.py
        chain = target.from_imports.get(name)
        if chain is not None:
            return self.resolve_import(target, chain[0], chain[1])
        return None

    def _module_relpath(self, dotted: str) -> str | None:
        """Map a dotted module name onto a file in this index (or None)."""
        parts = dotted.split(".")
        for candidate in (
            "/".join(parts) + ".py",
            "/".join(parts) + "/__init__.py",
            "src/" + "/".join(parts) + ".py",
            "src/" + "/".join(parts) + "/__init__.py",
        ):
            if candidate in self.modules:
                return candidate
        return None


# --------------------------------------------------------------------- #
# token extraction (plan-lifecycle checker)
# --------------------------------------------------------------------- #
def _docstring_nodes(tree: ast.AST) -> set[int]:
    """ids of Constant nodes that are docstrings (excluded from tokens)."""
    out: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            body = getattr(node, "body", [])
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                out.add(id(body[0].value))
    return out


def _str_values(node: ast.expr) -> set[str] | None:
    """Set of string constants an expression can evaluate to, or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: set[str] = set()
        for elt in node.elts:
            vals = _str_values(elt)
            if vals is None:
                return None
            out |= vals
        return out
    return None


def _loop_bindings(func: ast.AST) -> dict[str, set[str]]:
    """Names bound by ``for x in (<str constants>)`` or ``x = "lit"``.

    Scope-flattened over-approximation: a name bound in two loops carries
    the union of both value sets. Used only to *expand* f-strings, so the
    over-approximation can at worst mark a field as handled by a sibling
    loop in the same function — acceptable for functions the size of
    ``repad_plan``.
    """
    bindings: dict[str, set[str]] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            vals = _str_values(node.iter)
            if vals:
                bindings.setdefault(node.target.id, set()).update(vals)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                vals = _str_values(node.value)
                if vals:
                    bindings.setdefault(tgt.id, set()).update(vals)
    return bindings


def _expand_joined(
    node: ast.JoinedStr, bindings: dict[str, set[str]]
) -> set[str]:
    """Possible values of an f-string whose holes are all resolvable."""
    options: list[list[str]] = []
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            options.append([part.value])
        elif isinstance(part, ast.FormattedValue) and isinstance(
            part.value, ast.Name
        ):
            vals = bindings.get(part.value.id)
            if not vals:
                return set()
            options.append(sorted(vals))
        else:
            return set()
        total = 1
        for opt in options:
            total *= len(opt)
        if total > MAX_EXPANSIONS:
            return set()
    out = [""]
    for opt in options:
        out = [prefix + piece for prefix in out for piece in opt]
    return set(out)


def handled_tokens(func: ast.AST) -> set[str]:
    """Every identifier a function's body "touches" by name.

    The union of: attribute names (``lp.edge_src`` -> ``edge_src``),
    non-docstring string constants (the staging loop's literal key tuples),
    and resolvable f-string expansions (repad's ``f"{side}pack_perm"``).
    A field name in this set means the function handles — or at least
    names — that field; absence is what the lifecycle checker reports.
    """
    docstrings = _docstring_nodes(func)
    bindings = _loop_bindings(func)
    tokens: set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Attribute):
            tokens.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) not in docstrings:
                tokens.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            tokens |= _expand_joined(node, bindings)
    return tokens


def module_strings(mod: ModuleInfo) -> dict[str, set[str]]:
    """Top-level name -> the string constants of the tuple, list or set it
    is assigned (``CACHE_KEYS = ("local_slot", ...)``)."""
    out: dict[str, set[str]] = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            vals = _str_values(node.value) if node.value is not None else None
            for tgt in targets:
                if isinstance(tgt, ast.Name) and vals:
                    out[tgt.id] = vals
    return out


def dataclass_fields(
    mod: ModuleInfo, class_name: str
) -> list[tuple[str, int]] | None:
    """(field, lineno) for each annotated class-level field, or None."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            fields = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    fields.append((stmt.target.id, stmt.lineno))
            return fields
    return None


# --------------------------------------------------------------------- #
# call-graph reachability (hot-path purity checker)
# --------------------------------------------------------------------- #
def _dotted_name(node: ast.expr) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _callee_names(func: ast.AST) -> list[tuple[str, ast.Call]]:
    """(dotted callee, call node) pairs, plus function-valued arguments of
    known higher-order wrappers (their args run inside the caller)."""
    out: list[tuple[str, ast.Call]] = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted_name(node.func)
        if dotted:
            out.append((dotted, node))
            tail = dotted.rsplit(".", 1)[-1]
            if tail in HIGHER_ORDER:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    arg_name = _dotted_name(arg)
                    if arg_name:
                        out.append((arg_name, node))
    return out


def _resolve_call(
    index: ProjectIndex, caller: FunctionInfo, dotted: str
) -> FunctionInfo | None:
    mod = caller.module
    head, _, rest = dotted.partition(".")
    if head in ("self", "cls") and rest and "." not in rest:
        if "." in caller.qualname:
            cls = caller.qualname.split(".")[0]
            return mod.functions.get(f"{cls}.{rest}")
        return None
    if not rest:
        # bare name: local def, or from-import
        fn = mod.functions.get(dotted)
        if fn is not None:
            return fn
        chain = mod.from_imports.get(dotted)
        if chain is not None:
            return index.resolve_import(mod, chain[0], chain[1])
        return None
    # module-attribute call: alias.fn (one attribute deep)
    if "." not in rest:
        target_mod = mod.import_aliases.get(head)
        if target_mod is not None:
            rel = index._module_relpath(target_mod)
            if rel is not None:
                return index.modules[rel].functions.get(rest)
        # class-attribute call on an in-tree class: Class.method
        fn = mod.functions.get(f"{head}.{rest}")
        if fn is not None:
            return fn
    return None


def reachable_functions(
    index: ProjectIndex, entries: list[FunctionInfo], stop=frozenset()
) -> list[FunctionInfo]:
    """Worklist closure of the conservative call graph from ``entries``;
    a function whose (path, qualname) is in ``stop`` is neither walked nor
    returned."""
    seen: dict[tuple[str, str], FunctionInfo] = {}
    work = list(entries)
    while work:
        fn = work.pop()
        key = (fn.path, fn.qualname)
        if key in seen or key in stop:
            continue
        seen[key] = fn
        for dotted, _ in _callee_names(fn.node):
            callee = _resolve_call(index, fn, dotted)
            if callee is not None and (callee.path, callee.qualname) not in seen:
                work.append(callee)
    return sorted(seen.values(), key=lambda f: (f.path, f.lineno))
