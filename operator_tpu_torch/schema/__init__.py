"""Typed schema layer of the port: own copies of the JAX package's
``operator_tpu/schema`` modules, the CRD manifest generator (``crdgen``)
included."""

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
from .crds import (
    API_VERSION,
    GROUP,
    VERSION,
    AIProvider,
    AIProviderRef,
    AIProviderSpec,
    AIProviderStatus,
    AuthenticationRef,
    FailureRecurrence,
    PatternLibrary,
    PatternLibrarySpec,
    PatternLibraryStatus,
    PatternRepository,
    PodFailureStatus,
    Podmortem,
    PodmortemSpec,
    PodmortemStatus,
    RepositoryCredentials,
    SecretRef,
    SyncedRepository,
    parse_refresh_interval,
)
from .kube import (
    Container,
    ContainerState,
    ContainerStateTerminated,
    ContainerStateWaiting,
    ContainerStatus,
    Deployment,
    DeploymentSpec,
    EndpointAddress,
    EndpointPort,
    Endpoints,
    EndpointSubset,
    Event,
    Lease,
    LeaseSpec,
    ObjectReference,
    Pod,
    PodSpec,
    PodStatus,
    ReplicaSet,
    Scale,
    ScaleSpec,
    ScaleStatus,
    Secret,
)
from .meta import (
    K8sObject,
    LabelSelector,
    LabelSelectorRequirement,
    ObjectMeta,
    OwnerReference,
    now_iso,
)
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
