"""Typed models of the core-Kubernetes objects the analysis path reads:
Pods (failure detection) and Events (evidence).

Copy of ``operator_tpu/schema/kube.py`` as far as that path needs it; the
other objects (Secrets, Leases, ReplicaSets, Deployments, Endpoints,
Scale) come with the operator.

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
