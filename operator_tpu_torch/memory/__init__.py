"""Incident memory of the port: failure fingerprinting and the embedding
index scored by the best-window similarity kernel.  The durable store
and the recall policy come with the operator."""

from .fingerprint import FailureFingerprint, evidence_template, failure_fingerprint, normalize_line
from .index import IncidentIndex
from .store import CachedAnalysis, Incident

__all__ = [
    "CachedAnalysis",
    "FailureFingerprint",
    "Incident",
    "IncidentIndex",
    "evidence_template",
    "failure_fingerprint",
    "normalize_line",
]
