"""The asyncio control plane of the port: watch loop, reconcilers, event
emission, durable storage and claims, git pattern sync, leader election,
the fleet autoscaler, health — own copies of
``operator_tpu/operator``, rebuilt around one shared analysis pipeline
that drives the port's provider and semantic matcher on the card."""

from .app import Operator
from .events import EventService, truncate_message
from .health import LivenessCheck, ReadinessCheck
from .kubeapi import (
    ApiError,
    ConflictError,
    FakeKubeApi,
    ForbiddenError,
    KubeApi,
    NotFoundError,
    WatchClosed,
    WatchEvent,
)
from .patternsync import GitSyncService, PatternLibraryReconciler, SyncOutcome
from .pipeline import AnalysisPipeline
from .providers import (
    BreakerBoard,
    CircuitBreaker,
    OpenAICompatProvider,
    ProviderError,
    ProviderRegistry,
    ResponseCache,
    TemplateProvider,
    default_registry,
    resolve_provider_config,
)
from .reconciler import AIProviderReconciler, PodmortemReconciler
from .storage import AnalysisStorageService
from .watcher import PodFailureWatcher, PodmortemCache, get_failure_time, has_pod_failed

__all__ = [name for name in dir() if not name.startswith("_")]
