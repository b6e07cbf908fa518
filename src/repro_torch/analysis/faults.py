"""FT: the fault-handling lint — the port's own copy of
``repro/analysis/faults.py``, over the port's ``runtime/``, ``faults/``
and ``launch/spmd.py`` (the rank launcher, whose failures must reach the
caller).

The fault-tolerance layer only works if failures stay *visible*: a
``try/except`` that silently swallows an exception in the runtime or faults
packages defeats the retry accounting, the watchdog diagnostics, and the
``fault/*`` metrics all at once. This checker walks every handler under the
configured subtrees and flags the ones that make an error disappear.

Rules:
  FT001  an ``except`` handler that swallows the exception: it neither
         re-raises, nor references the bound exception (delivering or
         wrapping it), nor routes it into the accounting surface (a
         counter increment, an obs ``count``/``instant``, a logging call,
         or ``retry_call``), and carries no ``# FT001:`` exemption comment
         with a reason.

A handler is compliant when any of these holds:

  * its body contains a ``raise`` (bare re-raise or wrap-and-raise);
  * it binds the exception (``except E as e``) and the body *reads* ``e``
    — captured-for-delivery, the prefetcher's reorder-buffer pattern;
  * the body calls one of the routing/recording functions
    (``count``, ``instant``, ``warning``, ``error``, ``exception``,
    ``critical``, ``retry_call``) or increments a counter (``x += 1``);
  * the ``except`` line (or the line above it) carries ``# FT001: <reason>``
    — the explicit, reviewed escape hatch for probes whose failure *is*
    the documented result (e.g. an optional-API feature check).

Everything else — most damningly ``except: pass`` and
``except Exception: return None`` — is a finding.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.findings import Finding, dedupe

#: subtrees whose exception handling must never swallow (the runtime's
#: producer pipeline, the fault layer itself and the rank launcher)
DEFAULT_SUBDIRS: tuple[str, ...] = (
    "src/repro_torch/runtime",
    "src/repro_torch/faults",
    "src/repro_torch/launch/spmd.py",
)

#: calls that route an exception into the accounting/diagnostic surface
_ROUTING_CALLS = {
    "count",       # obs counter
    "instant",     # obs instant event
    "warning",     # logging
    "error",
    "exception",
    "critical",
    "retry_call",  # the faults.retry helper
}

_EXEMPT_TAG = "FT001:"


@dataclass(frozen=True)
class FaultSpec:
    """Which subtrees the fault-handling lint covers."""

    subdirs: tuple[str, ...] = DEFAULT_SUBDIRS


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """True when nothing in the handler body surfaces the exception."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.AugAssign):
            return False  # counter increment — accounted
        if isinstance(node, ast.Call) and _call_name(node) in _ROUTING_CALLS:
            return False
        if (
            handler.name
            and isinstance(node, ast.Name)
            and isinstance(node.ctx, ast.Load)
            and node.id == handler.name
        ):
            return False  # the bound exception is read: captured somewhere
    return True


def _exempted(handler: ast.ExceptHandler, lines: list[str]) -> bool:
    """An ``# FT001: reason`` comment on the except line or the line above."""
    for lineno in (handler.lineno, handler.lineno - 1):
        if 1 <= lineno <= len(lines) and _EXEMPT_TAG in lines[lineno - 1]:
            return True
    return False


def _exc_label(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "bare except"
    try:
        return f"except {ast.unparse(handler.type)}"
    except Exception:  # FT001: unparse of an exotic node — label only
        return "except <?>"


class _Walker(ast.NodeVisitor):
    """Collects swallowing handlers with their enclosing qualname."""

    def __init__(self, relpath: str, lines: list[str]):
        self.relpath = relpath
        self.lines = lines
        self.stack: list[str] = []
        self.findings: list[Finding] = []

    def _qualname(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def visit_FunctionDef(self, node):  # noqa: N802 (ast API)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Try(self, node: ast.Try):  # noqa: N802 (ast API)
        for handler in node.handlers:
            if _handler_swallows(handler) and not _exempted(
                handler, self.lines
            ):
                self.findings.append(
                    Finding(
                        path=self.relpath,
                        line=handler.lineno,
                        rule="FT001",
                        message=(
                            f"{_exc_label(handler)} in {self._qualname()} "
                            "swallows the exception"
                        ),
                        hint=(
                            "re-raise, count it (obs.count/'+= 1'), log it, "
                            "route it through faults.retry_call, or exempt "
                            "with '# FT001: <reason>'"
                        ),
                        col=handler.col_offset,
                    )
                )
        self.generic_visit(node)


def check_faults(
    root: Path, spec: FaultSpec = FaultSpec()
) -> list[Finding]:
    """Run the fault-handling lint over one tree; returns findings."""
    root = Path(root)
    findings: list[Finding] = []
    for subdir in spec.subdirs:
        base = root / subdir
        if base.is_file():
            paths = [base]
        elif base.is_dir():
            paths = sorted(base.rglob("*.py"))
        else:
            continue
        for path in paths:
            try:
                text = path.read_text(encoding="utf-8")
                tree = ast.parse(text)
            except (OSError, SyntaxError, UnicodeDecodeError):
                continue  # FT001: unparseable file — other checkers report it
            relpath = path.relative_to(root).as_posix()
            walker = _Walker(relpath, text.splitlines())
            walker.visit(tree)
            findings.extend(walker.findings)
    return dedupe(findings)
