"""Incident records of incident memory.

The dataclasses of ``operator_tpu/memory/store.py`` that the incident
index reads (``Incident``, ``CachedAnalysis``), copied as they are.  The
bounded store itself (``IncidentStore``, its journal and ConfigMap
snapshot) comes with the operator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..schema.serde import from_dict, to_dict


@dataclass
class CachedAnalysis:
    """One provider's clean analysis of a failure class — the unit an
    exact hit reuses verbatim."""

    explanation: Optional[str] = None
    provider_id: Optional[str] = None
    model_id: Optional[str] = None


@dataclass
class Incident:
    """One remembered failure class: identity, recurrence accounting, and
    the cached analyses future exact hits reuse verbatim.

    Recurrence (``seen_count`` etc.) is per failure CLASS; the reusable
    analyses are per AIProvider ref (``analyses`` keyed by
    "namespace/name", "" for none) — two CRs watching one workload with
    different providers each reuse THEIR OWN text, never each other's."""

    fingerprint: Optional[str] = None
    pattern_ids: list[str] = field(default_factory=list)
    severity: Optional[str] = None
    template: str = ""
    exit_code: Optional[int] = None
    reason: Optional[str] = None
    #: the LATEST clean analysis text (display + near-hit prompt context;
    #: None while only pattern-only/degraded results exist for this class)
    explanation: Optional[str] = None
    provider_id: Optional[str] = None
    model_id: Optional[str] = None
    #: per-provider-ref reusable analyses (exact-hit reuse looks up the
    #: recalling CR's own ref here)
    analyses: dict[str, CachedAnalysis] = field(default_factory=dict)
    #: where this class was FIRST seen (display only — identity excludes it)
    pod_name: Optional[str] = None
    pod_namespace: Optional[str] = None
    first_seen: Optional[str] = None
    last_seen: Optional[str] = None
    #: wall-clock epoch of the last sighting (TTL arithmetic; the ISO
    #: strings above are for humans and the CR status)
    last_seen_ts: float = 0.0
    seen_count: int = 1
    #: how many of those sightings reused the cached analysis
    reused_count: int = 0
    #: fingerprints of near-miss incidents this analysis was linked to
    #: (retrieval-augmented context at generation time)
    related: list[str] = field(default_factory=list)
    #: flight-recorder trace id of the most recent sighting's analysis —
    #: a recurrence links straight to the prior timeline
    last_trace_id: Optional[str] = None

    def to_dict(self) -> dict:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict) -> "Incident":
        return from_dict(cls, data)
