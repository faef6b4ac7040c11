"""Analysis-pipeline data models.

Copy of ``operator_tpu/schema/analysis.py`` as far as the analysis path
needs it; the provider contract (``AIProviderConfig``, ``PriorIncident``,
``AnalysisRequest``, ``AIResponse``) comes with the operator.  The JAX
package's models replace the external ``common-lib`` classes whose shape
is only visible through usage in the reference (SURVEY.md §2.2):

- ``PodFailureData``  — what the operator collects and POSTs to the parser
  (reference LogParserClient.java:36, PodFailureWatcher.java:319-332).
- ``AnalysisResult``  — what the parser returns; the operator reads
  ``summary.highestSeverity``, ``summary.significantEvents``,
  ``events[].score`` and ``events[].matchedPattern.{name,severity}``
  (reference EventService.java:75-78, AnalysisStorageService.java:147-156,308-325).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from .kube import Event, Pod
from .serde import from_dict, to_dict


class Severity(str, enum.Enum):
    """Pattern severity ladder; ordering is by ``rank``."""

    CRITICAL = "CRITICAL"
    HIGH = "HIGH"
    MEDIUM = "MEDIUM"
    LOW = "LOW"
    INFO = "INFO"

    @property
    def rank(self) -> int:
        return _SEVERITY_RANK[self]

    @classmethod
    def parse(cls, value) -> "Severity":
        if isinstance(value, cls):
            return value
        if value is None:
            return cls.INFO
        try:
            return cls(str(value).upper())
        except ValueError:
            return cls.INFO

    @classmethod
    def highest(cls, values: list["Severity"]) -> "Severity":
        return max(values, key=lambda s: s.rank) if values else cls.INFO


_SEVERITY_RANK = {
    Severity.INFO: 0,
    Severity.LOW: 1,
    Severity.MEDIUM: 2,
    Severity.HIGH: 3,
    Severity.CRITICAL: 4,
}


@dataclass
class PodFailureData:
    """The failure evidence bundle (reference collectPodFailureData,
    PodFailureWatcher.java:310-345): the pod object, its raw log tail, and
    recent namespace events."""

    pod: Optional[Pod] = None
    logs: str = ""
    events: list[Event] = field(default_factory=list)
    collection_time: Optional[str] = None

    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]) -> "PodFailureData":
        return from_dict(cls, data)


@dataclass
class MatchedPattern:
    """events[].matchedPattern (reference AnalysisStorageService.java:314-323)."""

    id: Optional[str] = None
    name: Optional[str] = None
    severity: Optional[str] = None
    category: Optional[str] = None
    remediation: Optional[str] = None


@dataclass
class MatchContext:
    """The log window that produced a match; feeds prompt construction."""

    line_number: Optional[int] = None
    matched_line: Optional[str] = None
    lines_before: list[str] = field(default_factory=list)
    lines_after: list[str] = field(default_factory=list)

    def render(self) -> str:
        return "\n".join([*self.lines_before, self.matched_line or "", *self.lines_after])


@dataclass
class AnalysisEvent:
    """One scored match (reference reads .score and .matchedPattern:
    AnalysisStorageService.java:308-325)."""

    score: float = 0.0
    matched_pattern: Optional[MatchedPattern] = None
    context: Optional[MatchContext] = None
    source: str = "regex"  # regex | keyword | semantic

    @property
    def severity(self) -> Severity:
        return Severity.parse(self.matched_pattern.severity if self.matched_pattern else None)


@dataclass
class AnalysisSummary:
    """summary block (reference EventService.java:75-78 reads
    highestSeverity + significantEvents)."""

    highest_severity: Optional[str] = None
    significant_events: int = 0
    total_events: int = 0
    score: float = 0.0


@dataclass
class StageTimings:
    """Per-stage latency accounting (milliseconds) — the observability the
    reference lacks entirely (SURVEY.md §5 tracing: none)."""

    collect_ms: Optional[float] = None
    parse_ms: Optional[float] = None
    embed_ms: Optional[float] = None
    prefill_ms: Optional[float] = None
    decode_ms: Optional[float] = None
    store_ms: Optional[float] = None
    total_ms: Optional[float] = None


@dataclass
class AnalysisResult:
    analysis_id: Optional[str] = None
    pod_name: Optional[str] = None
    pod_namespace: Optional[str] = None
    summary: AnalysisSummary = field(default_factory=AnalysisSummary)
    events: list[AnalysisEvent] = field(default_factory=list)
    timings: Optional[StageTimings] = None

    def top_events(self, k: int = 5) -> list[AnalysisEvent]:
        return sorted(self.events, key=lambda e: e.score, reverse=True)[:k]

    def pattern_summary_line(self) -> str:
        """The compact one-line summary stored when AI analysis is off
        (behavioural spec: reference AnalysisStorageService.java:142-156)."""
        if not self.events:
            return "No known failure patterns matched."
        top = self.top_events(1)[0]
        name = top.matched_pattern.name if top.matched_pattern else "unknown"
        sev = self.summary.highest_severity or "INFO"
        return (
            f"Pattern analysis: {name} (severity: {sev}, score: {top.score:.2f}); "
            f"{self.summary.significant_events} significant event(s)."
        )

    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]) -> "AnalysisResult":
        return from_dict(cls, data)
