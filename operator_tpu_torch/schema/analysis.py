"""Analysis-pipeline data models.

Copy of ``operator_tpu/schema/analysis.py``.  The JAX package's models
replace the external ``common-lib`` classes whose shape is only visible
through usage in the reference (SURVEY.md §2.2):

- ``PodFailureData``  — what the operator collects and POSTs to the parser
  (reference LogParserClient.java:36, PodFailureWatcher.java:319-332).
- ``AnalysisResult``  — what the parser returns; the operator reads
  ``summary.highestSeverity``, ``summary.significantEvents``,
  ``events[].score`` and ``events[].matchedPattern.{name,severity}``
  (reference EventService.java:75-78, AnalysisStorageService.java:147-156,308-325).
- ``AnalysisRequest`` / ``AIResponse`` — the ai-interface contract
  (reference AIInterfaceClient.java:45-59).
- ``AIProviderConfig`` — resolved provider config incl. auth token
  (reference AIInterfaceClient.java:71-105).
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


@dataclass
class AIProviderConfig:
    """Resolved provider configuration handed to the inference backend
    (reference AIInterfaceClient.convertToProviderConfig :71-105, defaults
    :78-84, auth token resolved from a Secret :118-149)."""

    provider_id: Optional[str] = None
    api_url: Optional[str] = None
    model_id: Optional[str] = None
    auth_token: Optional[str] = None
    timeout_seconds: int = 30
    max_retries: int = 3
    caching_enabled: bool = True
    prompt_template: Optional[str] = None
    max_tokens: int = 500
    temperature: float = 0.3
    additional_config: dict[str, str] = field(default_factory=dict)


@dataclass
class PriorIncident:
    """One remembered incident injected into the prompt as
    retrieval-augmented context on a near-miss recall
    (memory/recall.py; rendered by serving/prompts.py)."""

    fingerprint: Optional[str] = None
    score: float = 0.0
    seen_count: int = 0
    severity: Optional[str] = None
    last_seen: Optional[str] = None
    explanation: Optional[str] = None


@dataclass
class AnalysisRequest:
    """POST body for explanation generation (reference
    AIInterfaceClient.java:45-59: wraps AnalysisResult + provider config)."""

    analysis_result: Optional[AnalysisResult] = None
    provider_config: Optional[AIProviderConfig] = None
    failure_data: Optional[PodFailureData] = None
    #: residual deadline budget (seconds) at dispatch time
    #: (utils/deadline.py): backends must finish inside it — the tpu-native
    #: engine clamps max_tokens to the roofline fit, the HTTP provider
    #: clamps its read timeout.  None = no budget (legacy callers).
    deadline_s: Optional[float] = None
    #: near-miss recalls from incident memory, best first — prompt
    #: construction appends them under a bounded char budget
    prior_incidents: list[PriorIncident] = field(default_factory=list)
    #: the failure-class fingerprint digest (memory/fingerprint.py) when
    #: incident memory computed one — the router's first-choice affinity
    #: key, so recurrences land on the replica whose recall cache is hot
    fingerprint: Optional[str] = None
    #: SLO class this analysis is accounted under (obs/sloledger.py) —
    #: the overload value model (router/value.py) weights shed decisions
    #: by it.  None = the ledger's default class.
    slo_class: Optional[str] = None
    #: recall-hit probability (memory/recall.py hit_probability): how
    #: likely this request resolves from incident memory instead of a
    #: cold analysis — a recalled request costs ~4% of a cold one, so
    #: this rides into its overload value score
    recall_p: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]) -> "AnalysisRequest":
        return from_dict(cls, data)


@dataclass
class AIResponse:
    """Explanation response (reference AIInterfaceClient.java:45-59 reads
    ``.getExplanation()``); we add serving metadata."""

    explanation: Optional[str] = None
    provider_id: Optional[str] = None
    model_id: Optional[str] = None
    prompt_tokens: Optional[int] = None
    completion_tokens: Optional[int] = None
    cached: bool = False
    error: Optional[str] = None
    #: deadline-budget outcome: "completed" | "truncated" (output clamped
    #: to fit the residual budget) | "degraded" (overload ladder reduced
    #: analysis depth — distinct from deadline truncation) | "shed" (the
    #: ladder dropped the request; no AI text) | "deadline-exceeded" (no
    #: AI text; pipeline degrades to pattern-only).  None = budget not
    #: involved.
    deadline_outcome: Optional[str] = None
    #: which serving replica produced this response (operator_tpu/router/)
    #: — flight-recorder spans and routing forensics read it.  None =
    #: unrouted backend (template, in-process tpu-native).
    replica_id: Optional[str] = None
    #: cross-replica requeues the request survived before completing
    requeues: int = 0

    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]) -> "AIResponse":
        return from_dict(cls, data)
