"""CPU pattern matcher: regex/keyword scoring of log lines.

Copy of ``operator_tpu/patterns/matcher.py``.

This is the in-tree replacement for the reference's external log-parser
service (``POST /parse``: PodFailureData -> AnalysisResult, reference
LogParserRestClient.java:37-39).  Scoring model:

- a line matching a pattern's primary regex (or containing all its keywords)
  scores ``confidence``;
- each secondary pattern found within ``proximity_window`` lines of the hit
  adds its ``weight`` (corroboration);
- an event is *significant* when its score clears ``significance_threshold``
  (drives ``summary.significantEvents``, which the reference surfaces in
  K8s events — EventService.java:75-78).

Repeated hits of one pattern (crash loops replay the same error) are capped
at ``max_events_per_pattern``, keeping the newest hits because failure
evidence concentrates at the log tail.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .prefilter import LiteralPrefilter

from ..schema.analysis import (
    AnalysisEvent,
    AnalysisResult,
    AnalysisSummary,
    MatchContext,
    MatchedPattern,
    Severity,
)
from ..schema.patterns import Pattern
from .loader import LoadedLibrary
from .windows import context_window

DEFAULT_SIGNIFICANCE_THRESHOLD = 0.7
DEFAULT_MAX_EVENTS_PER_PATTERN = 3


@dataclass
class MatcherConfig:
    significance_threshold: float = DEFAULT_SIGNIFICANCE_THRESHOLD
    max_events_per_pattern: int = DEFAULT_MAX_EVENTS_PER_PATTERN
    max_total_events: int = 50


def _primary_hits(
    pattern: Pattern,
    lines: list[str],
    candidate_lines: Optional[list[int]] = None,
) -> list[int]:
    """Line numbers where the primary pattern fires.

    ``candidate_lines`` (ascending) restricts the scan to lines the literal
    prefilter already flagged (prefilter.py) — pure work-skipping; the
    prefilter guarantees no match exists outside the candidates."""
    primary = pattern.primary_pattern
    if primary is None:
        return []
    line_numbers = candidate_lines if candidate_lines is not None else range(len(lines))
    hits: list[int] = []
    regex = primary.compiled()
    if regex is not None:
        for i in line_numbers:
            if regex.search(lines[i]):
                hits.append(i)
    elif primary.keywords:
        lowered = [kw.lower() for kw in primary.keywords]
        for i in line_numbers:
            hay = lines[i].lower()
            if all(kw in hay for kw in lowered):
                hits.append(i)
    return hits


def _secondary_bonus(pattern: Pattern, lines: list[str], hit_line: int) -> float:
    bonus = 0.0
    for secondary in pattern.secondary_patterns:
        regex = secondary.compiled()
        if regex is None:
            continue
        lo = max(0, hit_line - secondary.proximity_window)
        hi = min(len(lines), hit_line + secondary.proximity_window + 1)
        for i in range(lo, hi):
            if i != hit_line and regex.search(lines[i]):
                bonus += secondary.weight
                break  # each secondary corroborates at most once
    return bonus


def match_pattern(
    pattern: Pattern,
    lines: list[str],
    config: Optional[MatcherConfig] = None,
    source: str = "regex",
    candidate_lines: Optional[list[int]] = None,
) -> list[AnalysisEvent]:
    config = config or MatcherConfig()
    if config.max_events_per_pattern <= 0:
        return []
    hits = _primary_hits(pattern, lines, candidate_lines)
    if not hits:
        return []
    # newest hits carry the evidence; cap per pattern
    hits = hits[-config.max_events_per_pattern :]
    confidence = pattern.primary_pattern.confidence if pattern.primary_pattern else 1.0
    extraction = pattern.context_extraction
    events = []
    for line_number in hits:
        score = confidence + _secondary_bonus(pattern, lines, line_number)
        before, after = context_window(
            lines,
            line_number,
            before=extraction.lines_before,
            after=extraction.lines_after,
        )
        remediation = pattern.remediation.description if pattern.remediation else None
        events.append(
            AnalysisEvent(
                score=round(score, 4),
                source=source,
                matched_pattern=MatchedPattern(
                    id=pattern.id,
                    name=pattern.name or pattern.id,
                    severity=pattern.severity_enum.value,
                    category=pattern.category,
                    remediation=remediation,
                ),
                context=MatchContext(
                    line_number=line_number,
                    matched_line=lines[line_number],
                    lines_before=before,
                    lines_after=after,
                ),
            )
        )
    return events


def summarize(events: list[AnalysisEvent], config: Optional[MatcherConfig] = None) -> AnalysisSummary:
    config = config or MatcherConfig()
    if not events:
        return AnalysisSummary(highest_severity=None, significant_events=0, total_events=0, score=0.0)
    significant = [e for e in events if e.score >= config.significance_threshold]
    highest = Severity.highest([e.severity for e in (significant or events)])
    return AnalysisSummary(
        highest_severity=highest.value,
        significant_events=len(significant),
        total_events=len(events),
        score=round(max(e.score for e in events), 4),
    )


def fold_events(
    events: list[AnalysisEvent], config: Optional[MatcherConfig] = None
) -> tuple[AnalysisSummary, list[AnalysisEvent]]:
    """The one ranking policy: sort by (score, severity), summarise over the
    FULL set, then truncate.  Shared by the regex fold and the semantic
    merge so both paths rank identically."""
    config = config or MatcherConfig()
    events = sorted(events, key=lambda e: (e.score, e.severity.rank), reverse=True)
    summary = summarize(events, config)
    return summary, events[: config.max_total_events]


def collect_events(
    libraries: list[LoadedLibrary],
    lines: list[str],
    config: Optional[MatcherConfig] = None,
    prefilter: Optional["LiteralPrefilter"] = None,
) -> list[AnalysisEvent]:
    """Score every pattern of every library against the log lines; returns
    the UNtruncated event list so callers can merge other sources (e.g. the
    semantic matcher) before the single fold_events ranking pass.

    With a prefilter, anchored patterns only regex-scan the lines the
    native literal scan flagged; unanchored ones scan everything."""
    config = config or MatcherConfig()
    candidates = prefilter.candidate_lines(lines) if prefilter is not None else None
    events: list[AnalysisEvent] = []
    for library in libraries:
        for pattern in library.patterns:
            candidate_lines = None
            if candidates is not None and pattern.id not in prefilter.full_scan_ids:
                flagged = candidates.get(pattern.id)
                if not flagged:
                    continue  # literal absent -> pattern cannot match
                candidate_lines = sorted(flagged)
            events.extend(
                match_pattern(pattern, lines, config, candidate_lines=candidate_lines)
            )
    return events


def match_libraries(
    libraries: list[LoadedLibrary],
    lines: list[str],
    config: Optional[MatcherConfig] = None,
    *,
    pod_name: Optional[str] = None,
    pod_namespace: Optional[str] = None,
) -> AnalysisResult:
    """Score every pattern of every library against the log lines and fold
    the hits into one AnalysisResult (highest-scoring events first)."""
    config = config or MatcherConfig()
    summary, events = fold_events(collect_events(libraries, lines, config), config)
    return AnalysisResult(
        analysis_id=str(uuid.uuid4()),
        pod_name=pod_name,
        pod_namespace=pod_namespace,
        summary=summary,
        events=events,
    )
