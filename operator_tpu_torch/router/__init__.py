"""Resilient multi-engine data plane: the port's copy of
``operator_tpu/router``.

A health-gated, affinity-aware failover router in front of N serving
replicas: consistent-hash placement on prompt prefix / incident
fingerprint (``ring.py``), per-replica breakers + passive scoring + load
reports (``health.py``), requeue-once failover with residual deadlines
(``core.py``), token-level streaming resume checkpoints (``resume.py``),
the value model of the overload ladder (``value.py``) and endpoint-watch
fleet membership (``discovery.py``).
"""

from .core import (
    EngineRouter,
    Replica,
    RouteDecision,
    RouteOutcome,
    RouterError,
    request_key,
)
from .discovery import EndpointDiscovery, endpoint_urls
from .health import (
    BreakerBoard,
    CircuitBreaker,
    HealthBoard,
    ReplicaHealth,
    ReplicaLoad,
)
from .resume import ResumeLog
from .ring import HashRing
from .value import (
    OverloadPolicy,
    OverloadVerdict,
    RequestValue,
    ShedDecisionLog,
    ValueModel,
)

__all__ = [
    "BreakerBoard",
    "CircuitBreaker",
    "EndpointDiscovery",
    "EngineRouter",
    "HashRing",
    "HealthBoard",
    "OverloadPolicy",
    "OverloadVerdict",
    "Replica",
    "ReplicaHealth",
    "ReplicaLoad",
    "RequestValue",
    "ResumeLog",
    "RouteDecision",
    "RouteOutcome",
    "RouterError",
    "ShedDecisionLog",
    "ValueModel",
    "endpoint_urls",
    "request_key",
]
