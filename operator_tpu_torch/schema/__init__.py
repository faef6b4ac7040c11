"""Typed schema layer of the port: own copies of the JAX package's
``operator_tpu/schema`` modules that the analysis path and the provider
read (the CRDs and their generator come with the operator)."""

from .analysis import (
    AIProviderConfig,
    AIResponse,
    AnalysisEvent,
    AnalysisRequest,
    AnalysisResult,
    AnalysisSummary,
    MatchContext,
    MatchedPattern,
    PodFailureData,
    PriorIncident,
    Severity,
    StageTimings,
)
from .kube import (
    Container,
    ContainerState,
    ContainerStateTerminated,
    ContainerStateWaiting,
    ContainerStatus,
    Event,
    ObjectReference,
    Pod,
    PodSpec,
    PodStatus,
)
from .meta import K8sObject, ObjectMeta, OwnerReference, now_iso
from .patterns import (
    ContextExtraction,
    LibraryMetadata,
    Pattern,
    PatternLibraryFile,
    PrimaryPattern,
    Remediation,
    SecondaryPattern,
)
from .serde import from_dict, to_dict

__all__ = [name for name in dir() if not name.startswith("_")]
