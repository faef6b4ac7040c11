"""Incident memory of the port: failure fingerprinting, a durable incident
store, an embedding index scored by the best-window similarity kernel,
and the recall policy that lets the analysis pipeline reuse whole
analyses for recurring failures.  Own copies of ``operator_tpu/memory``.
"""

from .fingerprint import FailureFingerprint, evidence_template, failure_fingerprint, normalize_line
from .index import IncidentIndex
from .recall import (
    RECALL_HIT,
    RECALL_MISS,
    RECALL_NEAR,
    IncidentMemory,
    RecallDecision,
    build_incident_memory,
)
from .store import CachedAnalysis, Incident, IncidentStore

__all__ = [
    "CachedAnalysis",
    "FailureFingerprint",
    "Incident",
    "IncidentIndex",
    "IncidentMemory",
    "IncidentStore",
    "RECALL_HIT",
    "RECALL_MISS",
    "RECALL_NEAR",
    "RecallDecision",
    "build_incident_memory",
    "evidence_template",
    "failure_fingerprint",
    "normalize_line",
]
