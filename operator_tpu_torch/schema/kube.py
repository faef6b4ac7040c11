"""Typed models of the core-Kubernetes objects the system touches:
Pods (failure detection), Events (evidence and result channel), Secrets
(credentials), ReplicaSets/Deployments (owner chase for event targeting),
Leases (leader election), Endpoints (fleet discovery) and the Deployment's
Scale (the autoscaler).

The port's own copy of ``operator_tpu/schema/kube.py``.

Field coverage mirrors what the reference actually reads:
- container terminated state w/ exit code   (reference PodFailureWatcher.java:147-159)
- restart counts / lastState                (reference PodmortemReconciler.java:121-128)
- events.k8s.io/v1 Event shape              (reference EventService.java:158-203)
- owner references Pod->ReplicaSet->Deployment (reference EventService.java:224-256)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .meta import K8sObject, ObjectMeta
from .serde import wire


@dataclass
class ContainerStateTerminated:
    exit_code: Optional[int] = None
    signal: Optional[int] = None
    reason: Optional[str] = None
    message: Optional[str] = None
    started_at: Optional[str] = None
    finished_at: Optional[str] = None


@dataclass
class ContainerStateWaiting:
    reason: Optional[str] = None  # e.g. CrashLoopBackOff, ImagePullBackOff
    message: Optional[str] = None


@dataclass
class ContainerState:
    terminated: Optional[ContainerStateTerminated] = None
    waiting: Optional[ContainerStateWaiting] = None
    running: Optional[dict] = None


@dataclass
class ContainerStatus:
    name: Optional[str] = None
    ready: Optional[bool] = None
    restart_count: int = 0
    state: Optional[ContainerState] = None
    last_state: Optional[ContainerState] = None
    image: Optional[str] = None


@dataclass
class PodStatus:
    phase: Optional[str] = None  # Pending|Running|Succeeded|Failed|Unknown
    reason: Optional[str] = None
    message: Optional[str] = None
    container_statuses: list[ContainerStatus] = field(default_factory=list)
    init_container_statuses: list[ContainerStatus] = field(default_factory=list)
    start_time: Optional[str] = None


@dataclass
class Container:
    name: Optional[str] = None
    image: Optional[str] = None


@dataclass
class PodSpec:
    containers: list[Container] = field(default_factory=list)
    node_name: Optional[str] = None


@dataclass
class Pod(K8sObject):
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "v1"
        self.kind = self.kind or "Pod"


@dataclass
class ObjectReference:
    api_version: Optional[str] = None
    kind: Optional[str] = None
    name: Optional[str] = None
    namespace: Optional[str] = None
    uid: Optional[str] = None


@dataclass
class Event(K8sObject):
    """events.k8s.io/v1 Event (reference EventService.java:158-203)."""

    reason: Optional[str] = None
    note: Optional[str] = None  # the message body (1024-byte budget)
    type_: Optional[str] = wire("type", default=None)  # Normal | Warning
    regarding: Optional[ObjectReference] = None
    reporting_controller: Optional[str] = None
    reporting_instance: Optional[str] = None
    action: Optional[str] = None
    event_time: Optional[str] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "events.k8s.io/v1"
        self.kind = self.kind or "Event"


@dataclass
class Secret(K8sObject):
    """Opaque secret; ``data`` values are base64-encoded on the wire, exactly
    as the reference consumes them (reference AIInterfaceClient.java:138-139)."""

    data: dict[str, str] = field(default_factory=dict)
    string_data: dict[str, str] = field(default_factory=dict)
    type_: Optional[str] = wire("type", default=None)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "v1"
        self.kind = self.kind or "Secret"

    def decoded(self, key: str) -> Optional[str]:
        import base64

        if key in self.string_data:
            return self.string_data[key]
        raw = self.data.get(key)
        if raw is None:
            return None
        try:
            return base64.b64decode(raw).decode("utf-8").strip()
        except Exception:
            return raw


@dataclass
class LeaseSpec:
    """coordination.k8s.io/v1 LeaseSpec — the fields leader election
    reads and writes."""

    holder_identity: Optional[str] = None
    lease_duration_seconds: Optional[int] = None
    acquire_time: Optional[str] = None  # RFC3339 MicroTime
    renew_time: Optional[str] = None  # RFC3339 MicroTime
    lease_transitions: Optional[int] = None


@dataclass
class Lease(K8sObject):
    """The leader-election lock object: whoever is in
    ``spec.holderIdentity`` with a fresh ``renewTime`` runs the control
    plane; everyone else is a hot standby."""

    spec: LeaseSpec = field(default_factory=LeaseSpec)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "coordination.k8s.io/v1"
        self.kind = self.kind or "Lease"


@dataclass
class ReplicaSet(K8sObject):
    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "apps/v1"
        self.kind = self.kind or "ReplicaSet"


@dataclass
class DeploymentSpec:
    replicas: Optional[int] = None


@dataclass
class Deployment(K8sObject):
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "apps/v1"
        self.kind = self.kind or "Deployment"


@dataclass
class EndpointAddress:
    """One ready (or not-ready) pod IP behind a Service subset."""

    ip: Optional[str] = None
    hostname: Optional[str] = None
    node_name: Optional[str] = None


@dataclass
class EndpointPort:
    name: Optional[str] = None
    port: Optional[int] = None
    protocol: Optional[str] = None


@dataclass
class EndpointSubset:
    """core/v1 EndpointSubset: the (addresses x ports) cross product the
    headless serving Service publishes — what ``router/discovery.py``
    turns into consistent-hash ring members."""

    addresses: list[EndpointAddress] = field(default_factory=list)
    not_ready_addresses: list[EndpointAddress] = field(default_factory=list)
    ports: list[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints(K8sObject):
    """core/v1 Endpoints for the headless serving Service: the
    membership source of truth the endpoint-watch discovery loop
    lists + watches."""

    subsets: list[EndpointSubset] = field(default_factory=list)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "v1"
        self.kind = self.kind or "Endpoints"


@dataclass
class ScaleSpec:
    replicas: int = 0


@dataclass
class ScaleStatus:
    replicas: int = 0


@dataclass
class Scale(K8sObject):
    """autoscaling/v1 Scale — the Deployment ``scale`` subresource shape
    the autoscale controller (operator/autoscale.py) reads and patches."""

    spec: ScaleSpec = field(default_factory=ScaleSpec)
    status: ScaleStatus = field(default_factory=ScaleStatus)

    def __post_init__(self) -> None:
        super().__post_init__()
        self.api_version = self.api_version or "autoscaling/v1"
        self.kind = self.kind or "Scale"
