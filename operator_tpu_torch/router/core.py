"""The failover router — health-gated, affinity-aware dispatch over N
serving replicas.

The port's own copy of ``operator_tpu/router/core.py``.

One :class:`EngineRouter` fronts a replica set (N ``ServingEngine``
deployments behind the headless Service, or any OpenAI-compatible
endpoints) and keeps analyses flowing through replica crashes, wedges,
and overload:

- **health gating** (``router/health.py``) — per-replica circuit
  breakers fed by passive error observations, plus probe/load verdicts:
  traffic drains off a sick replica before it hard-fails, and a breaker
  trip excludes it until a half-open probe succeeds;
- **placement** (``router/ring.py``) — consistent-hash affinity on the
  shared prompt prefix / incident fingerprint, so each replica's prefix
  cache, ``ResponseCache`` and incident-recall cache actually hit across
  the fleet; per-replica load reports (queue depth + the admission
  roofline's own per-token estimate) let the router SHED to a
  less-loaded healthy replica instead of rejecting — a request is
  refused only when no healthy replica exists at all;
- **failover** — a request in flight on a replica that dies or stalls is
  requeued at most ``max_failover`` times on a DIFFERENT replica with
  its residual absolute deadline (the budget keeps draining across the
  requeue, mirroring the supervisor's requeue discipline), the dead
  replica excluded; the idempotency key (a deterministic digest of the
  request) rides every attempt so at-least-once dispatch composes with
  the storage layer's idempotent status patches into exactly-once
  effects.

Counters: ``podmortem_router_routed_total``,
``podmortem_router_shed_total``, ``podmortem_router_failover_total``,
``podmortem_router_excluded_total``, ``podmortem_router_no_replica_total``.
Every attempt opens a ``router.dispatch`` span on the ambient analysis
trace (``obs/``), so the flight recorder shows exactly which
replica served — or killed — each leg.

Chaos seam: ``fault_plan`` stays ``None`` in the port, because
``utils/faultinject.py`` is not ported yet (ROADMAP.md Queue 1 item 5a);
the seam is a no-op then, as in the reference.  A plan with the
reference's ``apply_async`` is consulted at site ``router.dispatch``.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Iterable, Optional

from ..obs import span as obs_span
from ..utils.timing import METRICS, MetricsRegistry
from .health import HealthBoard, ReplicaLoad
from .ring import HashRing

log = logging.getLogger(__name__)

__all__ = ["EngineRouter", "Replica", "RouteDecision", "RouteOutcome", "RouterError"]


@dataclass(frozen=True)
class Replica:
    """One routable serving replica: a stable identity plus (for HTTP
    replicas) its base URL."""

    id: str
    url: str = ""


@dataclass
class RouteDecision:
    """One placement: the chosen replica, whether load feedback shed it
    off the affinity owner, and who that owner was."""

    replica: Replica
    affinity_owner: str
    shed: bool = False


@dataclass
class RouteOutcome:
    """A completed dispatch: the backend's response plus the routing
    forensics the caller surfaces (AIResponse metadata, span attrs)."""

    response: Any
    replica_id: str
    attempts: int = 1
    requeues: int = 0
    shed: bool = False
    request_id: str = ""


class RouterError(Exception):
    """Dispatch exhausted: no healthy replica, or the failover budget is
    spent.  ``last_error`` carries the final replica failure (None when
    no attempt could even be placed)."""

    def __init__(self, message: str, *, last_error: Optional[BaseException] = None,
                 tried: Optional[list[str]] = None) -> None:
        super().__init__(message)
        self.last_error = last_error
        self.tried = list(tried or [])


def request_key(basis: str) -> str:
    """Deterministic idempotency key for one logical request — a digest,
    not a uuid, so a seeded chaos replay produces the identical key and
    the dispatch log replays byte-identically."""
    return hashlib.sha256(basis.encode()).hexdigest()[:16]


class EngineRouter:
    """Health-gated affinity router over a replica set (module doc)."""

    def __init__(
        self,
        replicas: Iterable["Replica | str"],
        *,
        vnodes: int = 64,
        shed_pressure: int = 8,
        failure_threshold: int = 3,
        reset_s: float = 10.0,
        max_failover: int = 1,
        clock: Optional[Callable[[], float]] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self._clock = clock or time.monotonic
        self.metrics = metrics or METRICS
        #: queue pressure (queued + inflight) past which the affinity
        #: owner is considered overloaded and load feedback may shed
        self.shed_pressure = max(1, shed_pressure)
        #: cross-replica requeues allowed per request (the supervisor's
        #: requeue-ONCE discipline, generalized)
        self.max_failover = max(0, max_failover)
        self.health = HealthBoard(
            failure_threshold=failure_threshold, reset_s=reset_s, clock=clock
        )
        self._replicas: dict[str, Replica] = {}
        self._ring = HashRing(vnodes=vnodes)
        for replica in replicas:
            self.add(replica)
        #: opt-in chaos seam (utils/faultinject.py), site "router.dispatch"
        self.fault_plan = None
        #: value-aware overload ladder (router/value.py OverloadPolicy):
        #: callers consult overload_verdict() BEFORE dispatching so the
        #: router can degrade or shed by value, not arrival order.
        #: None = pre-overload-control semantics (route() still sheds to
        #: a less-loaded replica, it just never drops work itself).
        self.policy = None

    # -- membership ----------------------------------------------------
    def add(self, replica: "Replica | str") -> None:
        if isinstance(replica, str):
            replica = Replica(id=replica)
        joined = replica.id not in self._replicas
        self._replicas[replica.id] = replica
        self._ring.add(replica.id)
        if joined:
            # counted only on a REAL membership change (idempotent re-adds
            # from a relist are silent) so ring_resize tracks actual remaps
            self.metrics.incr("ring_member_added")
            self.metrics.incr("ring_resize")

    def remove(self, replica_id: str) -> None:
        left = self._replicas.pop(replica_id, None) is not None
        self._ring.remove(replica_id)
        if left:
            # age the health/breaker/fabric-index state with the ring: a
            # departed replica's KV inventory must never match again (a
            # rejoin re-reports and starts clean)
            self.health.remove(replica_id)
            self.metrics.incr("ring_member_removed")
            self.metrics.incr("ring_resize")

    def replicas(self) -> list[Replica]:
        return [self._replicas[rid] for rid in sorted(self._replicas)]

    def __len__(self) -> int:
        return len(self._replicas)

    # -- feedback ------------------------------------------------------
    def report_load(self, replica_id: str, load: ReplicaLoad) -> None:
        """Ingest one replica's load report (a ``/healthz`` poll body or
        an in-process ``ServingEngine.load_report()``) — and refresh the
        fabric block index with the replica's URL so the fetch client
        can hit its /kv/blocks endpoint without a second lookup."""
        replica = self._replicas.get(replica_id)
        self.health.report_load(
            replica_id, load, url=replica.url if replica is not None else ""
        )

    def mark_probe(self, replica_id: str, ready: bool) -> None:
        self.health.for_replica(replica_id).mark_probe(ready)

    # -- placement -----------------------------------------------------
    @staticmethod
    def affinity_key(*, prefix: Optional[str] = None,
                     fingerprint: Optional[str] = None) -> str:
        """The placement key: the incident fingerprint when one exists
        (recurrences land where the recall cache is hot), else the
        prompt's shared prefix (the prefix cache's reuse unit), else ""
        (no affinity — pure load balancing)."""
        if fingerprint:
            return f"fp:{fingerprint}"
        if prefix:
            return f"px:{hashlib.sha256(prefix[:512].encode()).hexdigest()}"
        return ""

    def route(
        self,
        key: str = "",
        *,
        exclude: "frozenset[str] | set[str]" = frozenset(),
        deadline_s: Optional[float] = None,
        tokens: int = 256,
        kv_hint: Optional["list[str]"] = None,
        role: Optional[str] = None,
    ) -> Optional[RouteDecision]:
        """Pick one replica for a request.

        Health gate first (breaker + probe/gave-up state), then affinity
        (the ring walk from ``key``; keyless requests skip straight to
        least-loaded), then load feedback: an affinity owner whose queue
        pressure crosses ``shed_pressure`` — or whose roofline-queue
        estimate cannot fit the request inside ``deadline_s`` — sheds to
        the least-loaded healthy replica that CAN fit it (or the least
        loaded outright when nobody fits: degrade, never reject while
        any replica is healthy).  ``exclude`` removes replicas that
        already failed this request; the exclusion is waived when it
        would empty the healthy set (a single-replica set must still be
        retryable).  ``kv_hint`` (block-hash hexes from the prefix
        cache's hasher) re-ranks the candidates by how many of those
        blocks each replica's last KV inventory advertises — a failover
        lands on the survivor that can re-prefill from cache instead of
        recomputing; the inventory is advisory, so a zero-holder fleet
        falls back to plain affinity order.  ``role`` (fabric/disagg.py)
        partitions candidates by advertised replica role — exact match
        first, then mixed/unknown, then the opposite role — a stable
        PREFERENCE, never a filter: a fleet with no replica of the
        wanted role degrades to mixed rather than rejecting.  Returns
        None only when NO replica is healthy."""
        order = self._ring.preference(key) if key else sorted(self._replicas)
        # PURE filter: can_route never mutates breaker state — consuming
        # a recovering replica's half-open probe token here would let
        # traffic whose affinity lies elsewhere starve it of readmission;
        # dispatch() consumes admission (health.admit) for the one
        # replica it actually sends to
        healthy = [rid for rid in order if self.health.can_route(rid)]
        if not healthy:
            return None
        candidates = [rid for rid in healthy if rid not in exclude] or healthy
        if kv_hint:
            wanted = set(kv_hint)

            def held(rid: str) -> int:
                blocks = self.health.for_replica(rid).load.kv_blocks
                return len(wanted.intersection(blocks)) if blocks else 0

            # stable sort: block holders first (most blocks wins), the
            # affinity walk order breaks ties — no inventory anywhere
            # leaves the order untouched
            candidates = sorted(
                candidates,
                key=lambda rid: (-held(rid), candidates.index(rid)),
            )
        if role:
            from ..fabric.disagg import role_preference

            # stable partition AFTER the kv_hint re-rank so the role
            # tier dominates and inventory breaks ties within it: exact
            # role, then mixed/unknown, then the opposite role
            candidates = sorted(
                candidates,
                key=lambda rid: (
                    role_preference(
                        self.health.for_replica(rid).load.role, role
                    ),
                    candidates.index(rid),
                ),
            )
        owner = candidates[0]
        chosen = owner
        load = self.health.for_replica(owner).load
        overloaded = load.pressure() >= self.shed_pressure or (
            deadline_s is not None and load.est_wait_s(tokens) > deadline_s
        )
        if overloaded and len(candidates) > 1:
            def fits(rid: str) -> bool:
                candidate_load = self.health.for_replica(rid).load
                if candidate_load.pressure() >= self.shed_pressure:
                    return False
                return deadline_s is None or (
                    candidate_load.est_wait_s(tokens) <= deadline_s
                )

            # stable ordering: pressure first, affinity walk order as the
            # tie-break, so equal-load fleets keep their cache locality
            by_load = sorted(
                candidates,
                key=lambda rid: (self.health.for_replica(rid).load.pressure(),
                                 candidates.index(rid)),
            )
            chosen = next((rid for rid in by_load if fits(rid)), by_load[0])
        return RouteDecision(
            replica=self._replicas[chosen],
            affinity_owner=owner,
            shed=chosen != owner,
        )

    def fleet_pressure(self) -> Optional[float]:
        """The LEAST-loaded healthy replica's queue pressure — the best
        offer the fleet can make a new request.  None when no replica is
        healthy (route() would return None anyway)."""
        pressures = [
            self.health.for_replica(rid).load.pressure()
            for rid in self._replicas
            if self.health.can_route(rid)
        ]
        return min(pressures) if pressures else None

    def overload_verdict(
        self,
        *,
        value=None,
        request_id: str = "",
        site: str = "router",
    ):
        """Consult the value ladder (``self.policy``) for one request
        BEFORE dispatch: returns an ``OverloadVerdict`` (serve / degrade
        / shed) or None when no policy is wired, no value was scored, or
        no replica is healthy (the route itself will fail then — a shed
        verdict on top would misattribute the outcome)."""
        if self.policy is None or value is None:
            return None
        pressure = self.fleet_pressure()
        if pressure is None:
            return None
        verdict = self.policy.decide(
            value, pressure, site=site, request_id=request_id
        )
        if verdict.action == "shed":
            self.metrics.incr("router_value_shed")
        elif verdict.action == "degrade":
            self.metrics.incr("router_value_degraded")
        return verdict

    # -- dispatch ------------------------------------------------------
    async def dispatch(
        self,
        send: Callable[[Replica, int, Optional[float]], Awaitable[Any]],
        *,
        key: str = "",
        request_id: str = "",
        deadline: Optional[Any] = None,  # utils.deadline.Deadline
        attempts: int = 1,
        tokens: int = 256,
        backoff_s: float = 0.2,
        resume_log: Optional[Any] = None,  # router.resume.ResumeLog
        kv_hint: Optional["list[str]"] = None,
        role: Optional[str] = None,
    ) -> RouteOutcome:
        """Run ``send(replica, attempt, budget_s)`` against the routed
        replica, failing over across the set.

        ``deadline`` is the request's ABSOLUTE envelope: each attempt —
        including a cross-replica requeue — receives the RESIDUAL budget
        (``deadline.remaining()``), so queue time and dead-replica time
        already spent stay spent.  A replica failure feeds its breaker
        and excludes it; the request requeues on a different replica at
        most ``max_failover`` times (the supervisor's requeue-ONCE
        discipline), then the dispatch fails loudly.  Same-replica
        retries (single-replica sets) are bounded by ``attempts`` with
        exponential backoff and do not count as failovers.

        With ``resume_log`` (router/resume.py) the contract widens:
        ``send`` is called as ``send(replica, attempt, budget_s,
        resume_tokens)`` where ``resume_tokens`` is the generated-so-far
        checkpoint for ``request_id`` (None on the first attempt) — the
        replica re-prefills ``prompt + resume_tokens`` and decodes only
        the continuation, so a mid-stream replica death costs one
        re-prefill (mostly cached) instead of a full re-decode.  ``send``
        is responsible for checkpointing tokens as they stream; the
        router completes the log entry once the dispatch settles.
        ``kv_hint`` is forwarded to :meth:`route` on every attempt so a
        failover prefers survivors already holding the prompt's blocks.
        ``role`` (fabric/disagg.py) is forwarded the same way — a
        disaggregated leg keeps preferring its role across failovers,
        degrading to mixed replicas rather than failing.
        """
        tried: list[str] = []  # distinct replicas that failed, in order
        requeues = 0
        shed_any = False
        last_error: Optional[BaseException] = None
        for attempt in range(max(1, attempts)):
            budget = deadline.remaining() if deadline is not None else None
            if budget is not None and budget <= 0.0:
                raise RouterError(
                    f"deadline exhausted after {attempt} attempt(s)",
                    last_error=last_error, tried=tried,
                )
            decision = self.route(
                key, exclude=set(tried), deadline_s=budget, tokens=tokens,
                kv_hint=kv_hint, role=role,
            )
            if decision is None:
                self.metrics.incr("router_no_replica")
                raise RouterError(
                    "no healthy replica (all breakers open or probes failing)",
                    last_error=last_error, tried=tried,
                )
            replica = decision.replica
            if not self.health.admit(replica.id):
                # the consuming admission check lost a race for the
                # half-open probe token (another dispatch between this
                # task's route and now) — re-route on the next attempt
                continue
            if tried and replica.id not in tried:
                # moving to a replica that has not failed this request =
                # the cross-replica requeue; enforce the failover budget
                if requeues >= self.max_failover:
                    raise RouterError(
                        f"request failed after {requeues} cross-replica "
                        f"requeue(s) (tried {tried})",
                        last_error=last_error, tried=tried,
                    )
                requeues += 1
                self.metrics.incr("router_failover")
            shed_any = shed_any or decision.shed
            started = self._clock()
            try:
                with obs_span(
                    "router.dispatch",
                    replica=replica.id,
                    attempt=attempt,
                    shed=decision.shed,
                    requeue=requeues,
                    request=request_id,
                ):
                    if self.fault_plan is not None:
                        # apply_async: delay/jitter actions shape dispatch
                        # latency without blocking the loop
                        await self.fault_plan.apply_async(
                            "router.dispatch", replica=replica.id, attempt=attempt
                        )
                    if resume_log is not None:
                        call = send(
                            replica, attempt, budget,
                            resume_log.tokens(request_id),
                        )
                    else:
                        call = send(replica, attempt, budget)
                    result = await asyncio.wait_for(call, timeout=budget)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 - failures feed health; only
                # Exception — SystemExit/KeyboardInterrupt/MemoryError must
                # propagate, never read as replica weather
                last_error = exc
                if self.health.observe_failure(replica.id):
                    # this failure OPENED the breaker: the replica is now
                    # excluded from routing until its half-open probe
                    self.metrics.incr("router_excluded")
                if replica.id not in tried:
                    tried.append(replica.id)
                log.warning("router: replica %s attempt %d failed: %s",
                            replica.id, attempt + 1, exc)
                if len(tried) >= len(self._replicas):
                    # no FRESH replica left: the next attempt re-hammers
                    # an already-failed endpoint — back off (crash-looping
                    # replicas need the breathing room; the caller's
                    # deadline wait_for bounds the tail).  A failover to
                    # an untried sibling stays immediate instead.
                    await asyncio.sleep(min(2 ** attempt * backoff_s, 2.0))
                continue
            self.health.observe_success(replica.id, self._clock() - started)
            if resume_log is not None:
                # settled: drop the checkpoint (tombstones it in the
                # journal) — a replayed router must not resume a request
                # the client already received in full
                resume_log.complete(request_id)
            self.metrics.incr("router_routed")
            if decision.shed:
                self.metrics.incr("router_shed")
            return RouteOutcome(
                response=result,
                replica_id=replica.id,
                attempts=attempt + 1,
                requeues=requeues,
                shed=shed_any,
                request_id=request_id,
            )
        raise RouterError(
            f"dispatch failed after {max(1, attempts)} attempt(s) "
            f"(tried {tried})",
            last_error=last_error, tried=tried,
        )
