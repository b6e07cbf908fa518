"""Finding records and the checked-in baseline (docs/ANALYSIS.md).

A ``Finding`` is one rule violation at one site. Baseline matching keys on
``(rule, path, message)`` — deliberately *not* on line numbers, which drift
with every unrelated edit; the message embeds the stable identity (field
name, missing leg, offending call) instead.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

BASELINE_VERSION = 1


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation: file:line, rule id, message, and a fix hint."""

    path: str  # project-root-relative posix path
    line: int
    rule: str
    message: str
    hint: str = ""
    col: int = 0

    @property
    def key(self) -> tuple[str, str, str]:
        """Line-drift-stable identity used for baseline suppression."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        if self.col:
            loc += f":{self.col}"
        out = f"{loc}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class Baseline:
    """Checked-in suppression list for pre-existing findings.

    Each entry carries a ``reason`` explaining why it is parked rather than
    fixed — the burn-down policy (docs/ANALYSIS.md) requires one. Entries
    that no longer match any finding are reported as *stale* so the file
    shrinks as violations are fixed; stale entries warn, they never gate.
    """

    entries: list[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(Path(path).read_text(encoding="utf-8"))
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"baseline {path} has version {data.get('version')!r}, "
                f"expected {BASELINE_VERSION}"
            )
        return cls(entries=list(data.get("findings", [])))

    @classmethod
    def from_findings(cls, findings: list[Finding], reason: str) -> "Baseline":
        return cls(
            entries=[
                {
                    "rule": f.rule,
                    "path": f.path,
                    "message": f.message,
                    "reason": reason,
                }
                for f in sorted(findings)
            ]
        )

    def save(self, path: Path) -> None:
        payload = {"version": BASELINE_VERSION, "findings": self.entries}
        Path(path).write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n",
            encoding="utf-8",
        )

    def split(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """(new, suppressed, stale_entries) for one run's findings."""
        keys = {
            (e.get("rule", ""), e.get("path", ""), e.get("message", "")): e
            for e in self.entries
        }
        new: list[Finding] = []
        suppressed: list[Finding] = []
        matched: set[tuple] = set()
        for f in findings:
            if f.key in keys:
                suppressed.append(f)
                matched.add(f.key)
            else:
                new.append(f)
        stale = [e for k, e in keys.items() if k not in matched]
        return new, suppressed, stale


def dedupe(findings: list[Finding]) -> list[Finding]:
    """Drop duplicate (rule, path, line, message) findings, keep order stable.

    Nested defs are walked as part of their parent function *and* may be
    independently reachable — the same site must not be reported twice.
    """
    seen: set[tuple] = set()
    out: list[Finding] = []
    for f in sorted(findings):
        k = (f.rule, f.path, f.line, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def to_json(findings: list[Finding]) -> str:
    return json.dumps([asdict(f) for f in findings], indent=2) + "\n"
