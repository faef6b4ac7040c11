"""SLO-judged serving-fleet autoscaler — scale-to-zero included
(docs/SCALING.md).

The port's own copy of ``operator_tpu/operator/autoscale.py``: host code, the same names and
behaviour.

A leader-only control loop (same ``_leader_cycle`` discipline as the
other reconcilers) that sizes the serving Deployment through the
``scale`` subresource from TWO live signals:

- the router's fleet rollup (``GET /fleet``): queue depth, inflight, and
  ``fleet_pressure`` — the least-loaded healthy replica's queue pressure,
  the same signal the overload ladder keys on.  Scale-up is the rung
  ABOVE degrade: when even the best offer the fleet can make crosses
  ``target_pressure``, add a replica instead of degrading deeper;
- the SLO ledger's per-class attainment (obs/sloledger.py): a class
  below its attainment target with work pending bursts the fleet out
  even when raw pressure looks tolerable — the autoscaler is judged on
  attainment, not utilisation.

Scale-DOWN is deliberately slower than scale-up: only after the fleet
has been completely idle (no queue, no inflight, no pending admissions)
for ``idle_s`` does the desired count drop to ``min_replicas`` — and
when that floor is zero, to ZERO.  The first pending arrival against an
empty fleet wakes it back up (the ``cold_start`` bench lane measures
token-one latency from exactly this state).

Every decision is observable: ``podmortem_autoscale_{up,down,to_zero,
blocked}_total`` counters, ``desired_replicas`` / ``last_scale_reason``
on ``GET /fleet``, and a log line per actuation.  Apiserver calls are
bounded by ``kube_timeout_s`` (graftlint GL003); a failed patch is a
blocked decision retried next tick, never a crash.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils.config import OperatorConfig
from ..utils.timing import METRICS, MetricsRegistry
from .kubeapi import KubeApi

log = logging.getLogger(__name__)

__all__ = ["AutoscaleController", "ScaleDecision"]


@dataclass(frozen=True)
class ScaleDecision:
    """One autoscale verdict: the target replica count, what kind of move
    it is (``up`` / ``down`` / ``to_zero`` / ``hold`` / ``blocked``), and
    the human-readable why that ``/fleet`` surfaces."""

    desired: int
    action: str
    reason: str


class AutoscaleController:
    """Size one serving Deployment from fleet pressure + SLO attainment."""

    def __init__(
        self,
        api: KubeApi,
        *,
        deployment: str,
        namespace: str = "default",
        min_replicas: int = 0,
        max_replicas: int = 8,
        target_pressure: float = 4.0,
        idle_s: float = 600.0,
        interval_s: float = 15.0,
        kube_timeout_s: float = 15.0,
        attainment_target: float = 0.9,
        fleet: Optional[Callable[[], dict]] = None,
        attainment: Optional[Callable[[], "dict[str, Optional[float]]"]] = None,
        pending: Optional[Callable[[], int]] = None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.api = api
        self.deployment = deployment
        self.namespace = namespace
        self.min_replicas = max(0, min_replicas)
        self.max_replicas = max(self.min_replicas, 1, max_replicas)
        self.target_pressure = target_pressure
        self.idle_s = idle_s
        self.interval_s = interval_s
        #: per-call apiserver budget (graftlint GL003)
        self.kube_timeout_s = kube_timeout_s
        self.attainment_target = attainment_target
        #: fleet rollup feed — the ``fleet`` half of
        #: ``OpenAICompatProvider.fleet_view()`` (queueDepth / inflight /
        #: pressure); None or an empty dict reads as "no signal"
        self.fleet = fleet
        #: per-class SLO attainment feed (SLOLedger.attainment_by_class)
        self.attainment = attainment
        #: admitted-but-unsettled work feed (SLOLedger.pending) — what
        #: wakes a scaled-to-zero fleet
        self.pending = pending
        self.metrics = metrics or METRICS
        self._clock = clock or time.monotonic
        #: when the fleet last went COMPLETELY idle (None = busy now)
        self._idle_since: Optional[float] = None
        #: last decision, surfaced on GET /fleet
        self.desired_replicas: Optional[int] = None
        self.last_scale_reason: str = ""

    @classmethod
    def from_config(
        cls,
        api: KubeApi,
        config: OperatorConfig,
        *,
        fleet: Optional[Callable[[], dict]] = None,
        attainment: Optional[Callable[[], "dict[str, Optional[float]]"]] = None,
        pending: Optional[Callable[[], int]] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> "AutoscaleController":
        namespace = (
            config.autoscale_namespace
            or getattr(api, "namespace", None)
            or "default"
        )
        return cls(
            api,
            deployment=config.autoscale_deployment,
            namespace=namespace,
            min_replicas=config.autoscale_min_replicas,
            max_replicas=config.autoscale_max_replicas,
            target_pressure=config.autoscale_target_pressure,
            idle_s=config.scale_to_zero_idle_s,
            interval_s=config.autoscale_interval_s,
            kube_timeout_s=config.kube_call_timeout_s,
            attainment_target=config.slo_attainment_target,
            fleet=fleet,
            attainment=attainment,
            pending=pending,
            metrics=metrics,
        )

    # -- policy (pure: no I/O, injectable clock) -----------------------
    def decide(self, current: int, *, now: Optional[float] = None) -> ScaleDecision:
        """The sizing policy for one tick.  Pure so tests drive it
        directly: reads the signal feeds, tracks the idle window, returns
        what the fleet SHOULD be — ``tick()`` does the actuation."""
        now = self._clock() if now is None else now
        rollup = (self.fleet() if self.fleet is not None else {}) or {}
        queue = int(rollup.get("queueDepth") or 0)
        inflight = int(rollup.get("inflight") or 0)
        pressure = rollup.get("pressure")
        pending = int(self.pending()) if self.pending is not None else 0
        busy = (queue + inflight + pending) > 0
        if busy:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        # wake-from-zero: ANY admitted work against an empty fleet brings
        # at least one replica back — this transition is the cold-start
        # path the bench lane times
        if current <= 0:
            if busy:
                desired = max(1, self.min_replicas)
                return ScaleDecision(
                    desired, "up",
                    f"wake-from-zero: {pending} pending / {queue} queued "
                    f"arrivals against an empty fleet",
                )
            return ScaleDecision(
                max(current, self.min_replicas),
                "up" if current < self.min_replicas else "hold",
                "idle at zero" if self.min_replicas <= 0
                else f"floor min_replicas={self.min_replicas}",
            )

        # burst out: storm pressure (the overload ladder's fleet_pressure
        # signal) or an SLO class already missing its target with work
        # still pending
        burst_reason = None
        if pressure is not None and float(pressure) >= self.target_pressure:
            burst_reason = (
                f"fleet_pressure {float(pressure):.1f} >= "
                f"target {self.target_pressure:.1f}"
            )
        if burst_reason is None:
            # role-aware signal (fabric/disagg.py): a disaggregated
            # fleet can starve ONE role behind a calm aggregate — all
            # prefill replicas saturated while decode sits idle keeps
            # fleet_pressure (the best offer anywhere) low.  Judge each
            # role tier by its own mean pressure per ready replica.
            for role, tier in sorted((rollup.get("roles") or {}).items()):
                if role == "mixed":
                    continue  # the aggregate signal already covers mixed
                ready = max(1, int(tier.get("ready") or 0))
                tier_pressure = float(tier.get("pressure") or 0) / ready
                if tier_pressure >= self.target_pressure:
                    burst_reason = (
                        f"role {role!r} pressure {tier_pressure:.1f}/replica"
                        f" >= target {self.target_pressure:.1f} "
                        f"({tier.get('ready')}/{tier.get('replicas')} ready)"
                    )
                    break
        if burst_reason is None and pending > 0 and self.attainment is not None:
            lagging = [
                (cls, att)
                for cls, att in sorted((self.attainment() or {}).items())
                if att is not None and att < self.attainment_target
            ]
            if lagging:
                cls, att = lagging[0]
                burst_reason = (
                    f"slo class {cls!r} attainment {att:.2f} < "
                    f"{self.attainment_target:.2f} with {pending} pending"
                )
        if burst_reason is not None:
            if current >= self.max_replicas:
                return ScaleDecision(
                    current, "blocked",
                    f"{burst_reason}, but at max_replicas={self.max_replicas}",
                )
            return ScaleDecision(current + 1, "up", burst_reason)

        # settle down: only after a FULL idle window, and all the way to
        # the floor — replicas are interchangeable behind the ring, so
        # there is nothing to drain gradually once nothing is in flight
        idle_for = (now - self._idle_since) if self._idle_since is not None else 0.0
        if not busy and idle_for >= self.idle_s and current > self.min_replicas:
            action = "to_zero" if self.min_replicas <= 0 else "down"
            return ScaleDecision(
                self.min_replicas, action,
                f"idle {idle_for:.0f}s >= {self.idle_s:.0f}s",
            )
        return ScaleDecision(current, "hold",
                             "busy" if busy else f"idle {idle_for:.0f}s")

    # -- actuation -----------------------------------------------------
    async def tick(self) -> ScaleDecision:
        """One control cycle: read the scale subresource, decide, patch.
        A patch failure (partition, conflict) demotes the decision to
        ``blocked`` — the signal feeds are live, so next tick re-derives
        a fresh target instead of retrying a stale one."""
        scale = await asyncio.wait_for(
            self.api.get_scale("Deployment", self.deployment, self.namespace),
            timeout=self.kube_timeout_s,
        )
        current = int((scale.get("spec") or {}).get("replicas") or 0)
        decision = self.decide(current)
        self.desired_replicas = decision.desired
        self.last_scale_reason = decision.reason
        if decision.action == "blocked":
            self.metrics.incr("autoscale_blocked")
            log.warning("autoscale blocked at %d: %s", current, decision.reason)
            return decision
        if decision.action == "hold" or decision.desired == current:
            return decision
        try:
            await asyncio.wait_for(
                self.api.patch_scale(
                    "Deployment", self.deployment, self.namespace,
                    decision.desired,
                    resource_version=(scale.get("metadata") or {}).get(
                        "resourceVersion"
                    ),
                ),
                timeout=self.kube_timeout_s,
            )
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - a failed patch is a blocked
            # decision retried next tick, never a controller crash
            self.metrics.incr("autoscale_blocked")
            log.warning("autoscale patch %s/%s -> %d failed (%s); retrying "
                        "next tick", self.namespace, self.deployment,
                        decision.desired, exc)
            return ScaleDecision(decision.desired, "blocked",
                                 f"{decision.reason}; patch failed: {exc}")
        self.metrics.incr(f"autoscale_{decision.action}")
        log.info("autoscale %s: %s/%s %d -> %d (%s)", decision.action,
                 self.namespace, self.deployment, current, decision.desired,
                 decision.reason)
        return decision

    async def run(self, stop: asyncio.Event) -> None:
        """Tick every ``interval_s`` until ``stop`` — leader-only (spawned
        by ``_spawn_control_tasks``): two replicas scaling one Deployment
        would fight through the rv guard forever."""
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=self.interval_s)
                return  # stopping
            except asyncio.TimeoutError:
                pass
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - NotFound before first deploy,
                # apiserver blips: the loop must outlive one bad tick
                log.warning("autoscale tick failed", exc_info=True)

    # -- introspection -------------------------------------------------
    def view(self) -> dict:
        """The ``GET /fleet`` fields this controller owns."""
        return {
            "desiredReplicas": self.desired_replicas,
            "lastScaleReason": self.last_scale_reason or None,
        }
