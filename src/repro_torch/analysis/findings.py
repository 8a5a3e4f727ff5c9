"""Finding model shared by the static passes and the analyze CLI.

A finding's ``key`` deliberately excludes the line number: baselines pin
*what* was accepted (rule, file, symbol, discriminating detail), not where
it happened to sit in the file, so unrelated edits above a baselined
finding never churn the baseline.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # "LOCK-ORDER" | "LOCK-BLOCKING" | "REP001".."REP005"
    path: str        # repo-relative posix path
    line: int        # 1-based; informational only (not part of the key)
    symbol: str      # qualified symbol ("Class.method", "func", "<module>")
    message: str     # human-readable description
    detail: str = ""  # stable discriminator (no line numbers)

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail or '-'}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: {self.message}"


def dedup(findings: list[Finding]) -> list[Finding]:
    """Drop key-duplicates, keeping the first (lowest-line) occurrence."""
    seen: set[str] = set()
    out: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.key not in seen:
            seen.add(f.key)
            out.append(f)
    return out
