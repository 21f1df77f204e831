"""Finding / Report data model for the port's static-analysis suite (a
copy of ``repro.analysis.report``).

Every analyzer returns a list of ``Finding``s; the CLI aggregates them
into a ``Report`` with a stable machine-readable JSON shape, which
``--report`` writes.

Suppression: a finding anchored to a source line is dropped when that
line (or the line above it) carries ``# analysis: allow(<analyzer>)``.
Non-source findings (the wire payload checks) can be waived with the
CLI's ``--suppress CODE`` flag; both mechanisms are deliberate, visible
markers rather than config-file state.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([\w\-,\s]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``analyzer`` names the check group (``host-sync``, ``concurrency``,
    ``wire``); ``code`` is a stable short id for suppression;
    ``location`` is either ``path:line`` or a logical site like
    ``_engine_config_wire()['dtype']``.
    """
    analyzer: str
    code: str
    location: str
    message: str
    severity: str = "error"          # "error" fails the build; "warning"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.analyzer}] {self.code} {self.severity}: "
                f"{self.location}: {self.message}")


@dataclasses.dataclass
class Report:
    findings: list[Finding] = dataclasses.field(default_factory=list)
    analyzers_run: list[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps({
            "schema": 1,
            "analyzers_run": self.analyzers_run,
            "counts": {
                "errors": len(self.errors),
                "warnings": len(self.findings) - len(self.errors),
            },
            "findings": [f.to_dict() for f in self.findings],
        }, indent=indent)


def line_suppressed(source_lines: list[str], lineno: int,
                    analyzer: str) -> bool:
    """True when line ``lineno`` (1-based) — or the line directly above
    it — carries ``# analysis: allow(<analyzer>)`` (or ``allow()`` for
    any analyzer)."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            m = _ALLOW_RE.search(source_lines[ln - 1])
            if m:
                names = {s.strip() for s in m.group(1).split(",") if s.strip()}
                if not names or analyzer in names:
                    return True
    return False


def apply_suppressions(findings: list[Finding],
                       codes: Iterable[str]) -> list[Finding]:
    """Drop findings whose ``code`` is in ``codes`` (CLI --suppress)."""
    codes = set(codes)
    return [f for f in findings if f.code not in codes]
