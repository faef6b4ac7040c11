"""Committed baseline of grandfathered findings.

The baseline keys findings by (rule, path, symbol, message) with an
occurrence count — never by line number, so unrelated edits that shift code
do not churn it.  The workflow (docs/ANALYSIS.md):

- ``--write-baseline`` records the current findings;
- a normal run fails only on findings NOT in the baseline;
- baseline entries that no longer match anything are reported as *stale*
  (the debt was paid — remove the entry) but do not fail the gate.

Policy note: the baseline exists for migrations, not as a dumping ground —
deliberate, permanent exceptions belong in the source as
``# graftlint: disable=GLxxx reason=...`` pragmas where reviewers see them.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from .core import Finding

_KEY_FIELDS = ("rule", "path", "symbol", "message")


@dataclass
class Baseline:
    """Multiset of grandfathered finding keys."""

    counts: Counter = field(default_factory=Counter)

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        return cls(Counter(f.key() for f in findings))

    def filter(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[tuple[str, str, str, str]]]:
        """Split ``findings`` into (new, stale-baseline-keys).  Each baseline
        entry absorbs at most its recorded count of matching findings."""
        budget = Counter(self.counts)
        new: list[Finding] = []
        for finding in findings:
            key = finding.key()
            if budget[key] > 0:
                budget[key] -= 1
            else:
                new.append(finding)
        stale = sorted(key for key, left in budget.items() if left > 0)
        return new, stale


def load_baseline(path: Path) -> Baseline:
    data = json.loads(path.read_text(encoding="utf-8"))
    counts: Counter = Counter()
    for entry in data.get("findings", []):
        key = tuple(str(entry.get(k, "")) for k in _KEY_FIELDS)
        counts[key] += int(entry.get("count", 1))
    return Baseline(counts)


def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    baseline = Baseline.from_findings(findings)
    entries = [
        {
            "rule": rule,
            "path": rel,
            "symbol": symbol,
            "message": message,
            "count": count,
        }
        for (rule, rel, symbol, message), count in sorted(baseline.counts.items())
    ]
    payload = {
        "comment": (
            "graftlint baseline — grandfathered findings only; new code must "
            "be clean and deliberate exceptions use inline pragmas "
            "(docs/ANALYSIS.md)"
        ),
        "findings": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
