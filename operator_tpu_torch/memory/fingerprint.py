"""Stable failure fingerprints — the identity key of incident memory.

Copy of ``operator_tpu/memory/fingerprint.py``.

A fleet replays the same failure classes endlessly: the 500th
CrashLoopBackOff of one bad deploy differs from the 1st only in pod-name
suffix, timestamps, and request ids.  The fingerprint collapses those
instances onto one key so the pipeline can recognise "seen this before"
(memory/recall.py) instead of paying the full pattern-match + TPU decode
cost again.

Identity basis (everything else is deliberately excluded):

- the set of matched pattern ids (sorted — match order is scheduling noise);
- the container exit code and termination/waiting reason from the pod's
  status (the reference detects these, PodFailureWatcher.java:147-159);
- a NORMALIZED template of the strongest evidence lines: timestamps, hex
  ids, UUIDs, IPs, digit runs, and pod-name hash suffixes are replaced by
  placeholder tokens, so two pods of one ReplicaSet crashing a minute
  apart produce byte-identical templates.

Pod name/namespace are NOT part of the identity: the whole point is that
`web-1` and `web-2` failing the same way share one incident.
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass
from typing import Optional

from ..schema.analysis import AnalysisResult
from ..schema.kube import Pod

#: evidence lines folded into the template (matches the prompt's top-3
#: evidence selection, serving/prompts.py — the lines a human would read)
TEMPLATE_EVENTS = 3

# Normalisation rules, applied IN ORDER (earlier rules must not produce
# text a later rule would mangle differently across runs).  Each replaces
# run-specific noise with a stable placeholder.
_RULES: list[tuple[re.Pattern, str]] = [
    # RFC3339 / ISO-8601 timestamps, with or without T/offset/fraction
    (re.compile(r"\b\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?\b"), "<ts>"),
    # bare dates and clock times (log prefixes like "2026-01-01" / "09:14:03,123")
    (re.compile(r"\b\d{4}-\d{2}-\d{2}\b"), "<date>"),
    (re.compile(r"\b\d{2}:\d{2}:\d{2}(?:[.,]\d+)?\b"), "<time>"),
    # UUIDs before the generic hex rule eats their segments
    (re.compile(r"\b[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}\b"), "<uuid>"),
    # IPv4 (optionally with :port)
    (re.compile(r"\b\d{1,3}(?:\.\d{1,3}){3}(?::\d+)?\b"), "<ip>"),
    # 0x-prefixed and long bare hex (addresses, request ids, image digests)
    (re.compile(r"\b0x[0-9a-fA-F]+\b"), "<hex>"),
    (re.compile(r"\b[0-9a-f]{8,}\b"), "<hex>"),
    # kubernetes name hash suffixes: "-7f9c" / "-x2b9z" style trailing
    # segments that contain a digit (ReplicaSet/pod suffixes) — a plain
    # word like "half-open" has no digit and survives
    (re.compile(r"-(?=[a-z0-9]{4,10}\b)(?=[a-z]*\d)[a-z0-9]{4,10}\b"), "-<id>"),
    # any remaining digit run (ports, counts, durations, pids)
    (re.compile(r"\d+"), "<n>"),
]

_WS = re.compile(r"[ \t]+")


def normalize_line(line: str) -> str:
    """One evidence line with its run-specific noise replaced by
    placeholders; idempotent (normalize(normalize(x)) == normalize(x))."""
    out = line.strip()
    for pattern, token in _RULES:
        out = pattern.sub(token, out)
    return _WS.sub(" ", out)


def evidence_template(result: Optional[AnalysisResult]) -> str:
    """The normalized template of the strongest evidence lines (matched
    line per top event — the context around it is presentation, not
    identity), deduplicated preserving order."""
    if result is None:
        return ""
    lines: list[str] = []
    for event in result.top_events(TEMPLATE_EVENTS):
        if event.context is None or not event.context.matched_line:
            continue
        normalized = normalize_line(event.context.matched_line)
        if normalized and normalized not in lines:
            lines.append(normalized)
    return "\n".join(lines)


def _termination_identity(pod: Optional[Pod]) -> tuple[Optional[int], Optional[str]]:
    """(exit code, reason) of the failing container: the terminated state's
    exit code/reason when present, else the waiting reason
    (CrashLoopBackOff, ImagePullBackOff...)."""
    if pod is None or pod.status is None:
        return None, None
    exit_code: Optional[int] = None
    reason: Optional[str] = None
    for cs in [*pod.status.container_statuses, *pod.status.init_container_statuses]:
        for state in (cs.state, cs.last_state):
            if state is None:
                continue
            if state.terminated is not None:
                if exit_code is None:
                    exit_code = state.terminated.exit_code
                if reason is None and state.terminated.reason:
                    reason = state.terminated.reason
            if state.waiting is not None and reason is None and state.waiting.reason:
                reason = state.waiting.reason
    return exit_code, reason


def incident_embedding_text(
    template: str,
    pattern_ids: "tuple[str, ...] | list[str]",
    reason: Optional[str],
    exit_code: Optional[int],
) -> str:
    """THE canonical embedding basis for near-miss scoring — used both at
    insert time (FailureFingerprint.embedding_text) and when the index is
    rebuilt from stored incidents (memory/index.py), so a restart can
    never shift near-miss scores."""
    parts = [template, *pattern_ids]
    if reason:
        parts.append(reason)
    if exit_code is not None:
        parts.append(f"exit {exit_code}")
    return " ".join(p for p in parts if p)


@dataclass(frozen=True)
class FailureFingerprint:
    """The stable identity of one failure class.  ``digest`` is the store
    key; the components ride along for display and for the embedding text
    the near-miss index scores."""

    digest: str
    pattern_ids: tuple[str, ...] = ()
    exit_code: Optional[int] = None
    reason: Optional[str] = None
    template: str = ""

    @property
    def is_weak(self) -> bool:
        """True when the identity basis is only (exit code, reason) — no
        matched patterns, no evidence template.  Two UNRELATED apps both
        dying with exit 1 would collide on such a digest, so weak
        fingerprints are never stored or reused (memory/recall.py): a
        wrong-but-confident recycled root cause is worse than a cold
        analysis."""
        return not self.pattern_ids and not self.template

    def embedding_text(self) -> str:
        """What the incident index embeds for near-miss scoring: the
        template plus the identity fields, so lexically different phrasings
        of one failure class still land close."""
        return incident_embedding_text(
            self.template, self.pattern_ids, self.reason, self.exit_code
        )

    def short(self) -> str:
        return self.digest[:12]


def failure_fingerprint(
    result: Optional[AnalysisResult], pod: Optional[Pod] = None
) -> FailureFingerprint:
    """Fingerprint one analyzed failure.  Deterministic: equal inputs (up
    to the normalized noise) yield byte-equal digests across processes."""
    pattern_ids = tuple(sorted({
        event.matched_pattern.id
        for event in (result.events if result else [])
        if event.matched_pattern is not None and event.matched_pattern.id
    }))
    exit_code, reason = _termination_identity(pod)
    template = evidence_template(result)
    basis = json.dumps(
        {
            "patterns": list(pattern_ids),
            "exit": exit_code,
            "reason": reason,
            "template": template,
        },
        sort_keys=True,
    )
    return FailureFingerprint(
        digest=hashlib.sha256(basis.encode()).hexdigest(),
        pattern_ids=pattern_ids,
        exit_code=exit_code,
        reason=reason,
        template=template,
    )
