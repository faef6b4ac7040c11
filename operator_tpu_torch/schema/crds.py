"""The three custom resources of the system — Podmortem, AIProvider,
PatternLibrary — as typed dataclasses.

The port's own copy of ``operator_tpu/schema/crds.py``.

Field-for-field parity with the reference CRDs:
- Podmortem       reference podmortem-crd.yaml:19-82
- AIProvider      reference aiprovider-crd.yaml:19-69
- PatternLibrary  reference patternlibrary-crd.yaml:19-87

plus the pieces the reference declared but never implemented, which we do
implement: per-repo sync status (reference PatternLibraryReconciler.java:171-176
is a stub) and AIProvider status reconciliation (no AIProvider reconciler
exists in the reference at all — SURVEY.md §2.1).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from .meta import K8sObject, LabelSelector

GROUP = "podmortem.tpu.dev"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"


# --------------------------------------------------------------------------
# Podmortem
# --------------------------------------------------------------------------


@dataclass
class AIProviderRef:
    """spec.aiProviderRef (reference podmortem-crd.yaml:40-49)."""

    name: Optional[str] = None
    namespace: Optional[str] = None


@dataclass
class PodmortemSpec:
    pod_selector: LabelSelector = field(default_factory=LabelSelector)
    ai_provider_ref: Optional[AIProviderRef] = None
    ai_analysis_enabled: bool = True  # default true (podmortem-crd.yaml:50-53)
    #: end-to-end budget for one failure's analysis ("90s"/"2m"/"1h30m",
    #: parse_refresh_interval grammar); None = the operator default, which
    #: mirrors the reference's 180 s external-LLM envelope
    #: (application.properties:8-9).  Enforced at every hop: collection
    #: slice, parse cap, AI remainder, engine admission clamp.
    analysis_deadline: Optional[str] = None


@dataclass
class FailureRecurrence:
    """status.recentFailures[].recurrence — how incident memory classified
    this failure (operator_tpu/memory/): the stable fingerprint, how often
    the class has been seen fleet-wide, and whether the stored analysis
    was reused instead of re-generated."""

    fingerprint: Optional[str] = None
    seen_count: int = 0
    first_seen: Optional[str] = None
    reused_analysis: bool = False


@dataclass
class PodFailureStatus:
    """One entry of status.recentFailures (reference podmortem-crd.yaml:68-82,
    written by AnalysisStorageService.java:286-333)."""

    pod_name: Optional[str] = None
    pod_namespace: Optional[str] = None
    failure_time: Optional[str] = None
    analysis_status: Optional[str] = None  # Analyzed|PatternOnly|Failed|degraded|deadline-exceeded
    explanation: Optional[str] = None
    severity: Optional[str] = None
    #: deadline-budget outcome for the AI leg (utils/deadline.py):
    #: completed | truncated (max_tokens clamped to fit the residual
    #: budget) | degraded (overload ladder reduced analysis depth,
    #: router/value.py) | shed (ladder dropped the request) |
    #: deadline-exceeded (degraded to pattern-only)
    deadline_outcome: Optional[str] = None
    #: incident-memory classification (None when memory is disabled)
    recurrence: Optional[FailureRecurrence] = None
    #: flight-recorder trace id for this analysis (operator_tpu/obs/):
    #: ``GET /traces/{id}`` on the health port replays the span tree —
    #: where the deadline budget went, stage by stage
    trace_id: Optional[str] = None


@dataclass
class PodmortemStatus:
    phase: Optional[str] = None  # Pending|Ready|Processing|Error (crd:57-59)
    message: Optional[str] = None
    last_update_time: Optional[str] = None
    recent_failures: list[PodFailureStatus] = field(default_factory=list)
    observed_generation: Optional[int] = None


@dataclass
class Podmortem(K8sObject):
    spec: PodmortemSpec = field(default_factory=PodmortemSpec)
    status: Optional[PodmortemStatus] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or API_VERSION
        self.kind = self.kind or "Podmortem"
        if self.spec is None:
            self.spec = PodmortemSpec()


# --------------------------------------------------------------------------
# AIProvider
# --------------------------------------------------------------------------


@dataclass
class AuthenticationRef:
    """spec.authenticationRef (reference aiprovider-crd.yaml:28-35)."""

    secret_name: Optional[str] = None
    secret_key: Optional[str] = None


@dataclass
class AIProviderSpec:
    """Provider config.  ``provider_id`` values: ``tpu-native`` (in-tree TPU
    serving — the whole point of this rebuild), plus ``openai``-compatible
    HTTP fallback preserved for parity (reference aiprovider-crd.yaml:19-21).

    Defaults mirror reference AIInterfaceClient.java:78-84.
    """

    provider_id: Optional[str] = None
    api_url: Optional[str] = None
    model_id: Optional[str] = None
    authentication_ref: Optional[AuthenticationRef] = None
    timeout_seconds: int = 30
    max_retries: int = 3
    caching_enabled: bool = True
    prompt_template: Optional[str] = None
    max_tokens: int = 500
    temperature: float = 0.3
    additional_config: dict[str, str] = field(default_factory=dict)


@dataclass
class AIProviderStatus:
    phase: Optional[str] = None  # Pending|Ready|Failed (aiprovider-crd.yaml:67-69)
    message: Optional[str] = None
    last_validated: Optional[str] = None
    observed_generation: Optional[int] = None  # aiprovider-crd.yaml:73-75


@dataclass
class AIProvider(K8sObject):
    spec: AIProviderSpec = field(default_factory=AIProviderSpec)
    status: Optional[AIProviderStatus] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or API_VERSION
        self.kind = self.kind or "AIProvider"
        if self.spec is None:
            self.spec = AIProviderSpec()


# --------------------------------------------------------------------------
# PatternLibrary
# --------------------------------------------------------------------------


@dataclass
class SecretRef:
    name: Optional[str] = None
    namespace: Optional[str] = None
    key: Optional[str] = None


@dataclass
class RepositoryCredentials:
    secret_ref: Optional[SecretRef] = None


@dataclass
class PatternRepository:
    """spec.repositories[] (reference patternlibrary-crd.yaml:19-41)."""

    name: Optional[str] = None
    url: Optional[str] = None
    branch: str = "main"  # default matches reference PatternSyncService.java:132
    credentials: Optional[RepositoryCredentials] = None


@dataclass
class PatternLibrarySpec:
    repositories: list[PatternRepository] = field(default_factory=list)
    refresh_interval: str = "1h"  # default (patternlibrary-crd.yaml:42-45)
    enabled_libraries: list[str] = field(default_factory=list)


@dataclass
class SyncedRepository:
    """status.syncedRepositories[] (patternlibrary-crd.yaml:65-82) — declared
    by the reference CRD but never populated (PatternLibraryReconciler.java:171-176
    stub); we populate it."""

    name: Optional[str] = None
    last_sync_time: Optional[str] = None
    last_sync_commit: Optional[str] = None
    status: Optional[str] = None  # Synced|Failed
    message: Optional[str] = None
    pattern_count: Optional[int] = None


@dataclass
class PatternLibraryStatus:
    phase: Optional[str] = None  # Pending|Syncing|Ready|Failed (crd:54-58)
    message: Optional[str] = None
    last_sync_time: Optional[str] = None
    synced_repositories: list[SyncedRepository] = field(default_factory=list)
    available_libraries: list[str] = field(default_factory=list)


@dataclass
class PatternLibrary(K8sObject):
    spec: PatternLibrarySpec = field(default_factory=PatternLibrarySpec)
    status: Optional[PatternLibraryStatus] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or API_VERSION
        self.kind = self.kind or "PatternLibrary"
        if self.spec is None:
            self.spec = PatternLibrarySpec()


# --------------------------------------------------------------------------
# refresh-interval parsing
# --------------------------------------------------------------------------

_INTERVAL_RE = re.compile(r"(\d+)\s*([smhd])", re.IGNORECASE)
_UNIT_SECONDS = {"s": 1, "m": 60, "h": 3600, "d": 86400}


def parse_refresh_interval(text: Optional[str], default_seconds: int = 3600) -> int:
    """Parse ``30s`` / ``5m`` / ``1h`` / ``2d`` / compound ``1h30m`` into
    seconds (reference PatternLibraryReconciler.java:282-305 format set).

    Unparseable or empty input falls back to the 1h default, matching the
    CRD default (patternlibrary-crd.yaml:42-45).
    """
    if not text:
        return default_seconds
    text = text.strip()
    if text.isdigit():  # bare number == seconds
        return int(text)
    matches = _INTERVAL_RE.findall(text)
    consumed = "".join(f"{n}{u}" for n, u in matches).lower()
    if not matches or consumed != re.sub(r"\s+", "", text).lower():
        return default_seconds
    return sum(int(n) * _UNIT_SECONDS[u.lower()] for n, u in matches)
