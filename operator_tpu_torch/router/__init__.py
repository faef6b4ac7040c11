"""Resilient multi-engine data plane: the port's copy of
``operator_tpu/router``.

A health-gated, affinity-aware failover router in front of N serving
replicas: consistent-hash placement on prompt prefix / incident
fingerprint (``ring.py``), per-replica breakers + passive scoring + load
reports (``health.py``), requeue-once failover with residual deadlines
(``core.py``), token-level streaming resume checkpoints (``resume.py``)
and the value model of the overload ladder (``value.py``).  Endpoint
discovery (``discovery.py``) is not ported yet (ROADMAP.md Queue 1 item
5a).
"""

from .core import (
    EngineRouter,
    Replica,
    RouteDecision,
    RouteOutcome,
    RouterError,
    request_key,
)
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
    "request_key",
]
