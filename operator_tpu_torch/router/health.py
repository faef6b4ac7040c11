"""Health gating for the multi-replica data plane.

The port's own copy of ``operator_tpu/router/health.py``.  Two layers,
composed by :class:`HealthBoard`:

- **circuit breakers** — :class:`CircuitBreaker` / :class:`BreakerBoard`:
  the consecutive-failure state machine that turns a dying backend from
  "every call burns a deadline budget" into "calls skip it until a
  half-open probe succeeds".  The board is keyed generically
  (:meth:`BreakerBoard.for_key`): the pipeline keys it by provider id,
  the router by replica.
- **passive scoring + load reports** — :class:`ReplicaHealth` keeps an
  EWMA of observed latency, a consecutive-error count, an optional
  probe verdict (``/healthz`` polls or an injected check), and the
  replica's last :class:`ReplicaLoad` report (queue depth, roofline
  decode estimate, step clock, SLO board and KV economy from
  ``ServingEngine.load_report``).  The router's shed decision reads
  these; nothing here blocks.

The clock is injectable end to end so tests drive every state machine
deterministically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..fabric.index import FabricIndex

__all__ = [
    "CircuitBreaker",
    "BreakerBoard",
    "ReplicaHealth",
    "ReplicaLoad",
    "HealthBoard",
    "fleet_rollup",
]


def fleet_rollup(replicas: dict) -> dict:
    """Aggregate per-replica fleet rows (``HealthBoard.fleet_view``
    shape) into one fleet summary.  MFU / occupancy / host-gap means are
    STEP-WEIGHTED over the replicas that reported them — a replica with
    an empty step ring contributes nothing, not a zero; queue depth and
    inflight are plain sums.  Module-level so the operator can merge
    rows across several routed replica sets before rolling up."""
    mfu_w = gap_w = occ_w = 0.0
    mfu_steps = gap_steps = occ_steps = 0
    queue_depth = inflight = 0
    # SLO attainment is weighted by each replica's settled-request count
    # (a replica that served 10x the traffic moves the fleet number 10x
    # as much); goodput is a plain sum — tokens/s add across replicas
    slo_w = 0.0
    slo_requests = 0
    goodput = 0.0
    goodput_seen = False
    # KV economy: pages sum across replicas; the fleet hit rate is
    # weighted by each replica's lookup count (a replica that answered
    # 10x the block lookups moves the fleet number 10x as much)
    kv_free = kv_total = 0
    hit_w = 0.0
    hit_lookups = 0
    # overload-ladder totals (router/value.py): plain sums — shed and
    # degraded counts add across replicas
    shed = degraded = 0
    # disaggregation (fabric/disagg.py): per-role replica counts and
    # queue pressure so the autoscaler can see ONE starved role behind a
    # calm aggregate (all prefill replicas saturated, decode idle)
    roles: dict = {}
    for row in replicas.values():
        queue_depth += int(row.get("queueDepth") or 0)
        inflight += int(row.get("inflight") or 0)
        role = str(row.get("role") or "mixed")
        tier = roles.setdefault(
            role, {"replicas": 0, "ready": 0, "pressure": 0}
        )
        tier["replicas"] += 1
        tier["ready"] += 1 if row.get("ready") else 0
        tier["pressure"] += int(row.get("queueDepth") or 0) + int(
            row.get("inflight") or 0
        )
        shed += int(row.get("shedTotal") or 0)
        degraded += int(row.get("degradedTotal") or 0)
        weight = max(1, int(row.get("steps") or 0))
        if row.get("decodeMfu") is not None:
            mfu_w += float(row["decodeMfu"]) * weight
            mfu_steps += weight
        if row.get("hostGapFrac") is not None:
            gap_w += float(row["hostGapFrac"]) * weight
            gap_steps += weight
        if row.get("occupancy") is not None:
            occ_w += float(row["occupancy"]) * weight
            occ_steps += weight
        if row.get("sloAttainment") is not None:
            slo_weight = max(1, int(row.get("sloCompleted") or 0))
            slo_w += float(row["sloAttainment"]) * slo_weight
            slo_requests += slo_weight
        if row.get("goodput") is not None:
            goodput += float(row["goodput"])
            goodput_seen = True
        kv_free += int(row.get("kvPagesFree") or 0)
        kv_total += int(row.get("kvPagesTotal") or 0)
        if row.get("prefixHitRate") is not None:
            weight = max(1, int(row.get("kvLookups") or 0))
            hit_w += float(row["prefixHitRate"]) * weight
            hit_lookups += weight
    return {
        "replicaCount": len(replicas),
        "readyCount": sum(1 for r in replicas.values() if r.get("ready")),
        "queueDepth": queue_depth,
        "inflight": inflight,
        "decodeMfu": round(mfu_w / mfu_steps, 6) if mfu_steps else None,
        "hostGapFrac": round(gap_w / gap_steps, 6) if gap_steps else None,
        "occupancy": round(occ_w / occ_steps, 6) if occ_steps else None,
        "sloAttainment": round(slo_w / slo_requests, 6) if slo_requests else None,
        "goodput": round(goodput, 6) if goodput_seen else None,
        "kvPagesFree": kv_free,
        "kvPagesTotal": kv_total,
        "prefixHitRate": (
            round(hit_w / hit_lookups, 6) if hit_lookups else None
        ),
        "shedTotal": shed,
        "degradedTotal": degraded,
        "roles": {role: roles[role] for role in sorted(roles)},
    }


class CircuitBreaker:
    """Consecutive-failure breaker for one backend (provider or replica).

    States: ``closed`` (calls flow) → after ``failure_threshold``
    consecutive failures ``open`` (calls skipped: a dead backend must stop
    burning the deadline budget — the pipeline falls through the existing
    degradation ladder and stores pattern-only results) → after
    ``reset_s`` ``half-open`` (exactly ONE probe flows) → probe success
    closes, probe failure re-opens for another window.

    The clock is injectable so tests drive the state machine
    deterministically.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.reset_s = reset_s
        self._clock = clock or time.monotonic
        self.state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0

    def allow(self) -> bool:
        """May a call be attempted now?  Transitions open → half-open when
        the reset window elapsed (that caller IS the probe; concurrent
        callers in half-open are refused until the probe resolves).  A
        probe whose caller died without ever reporting (cancelled task,
        operator shutdown mid-call) must not wedge the breaker: after
        another full window in half-open a fresh probe is admitted."""
        now = self._clock()
        if self.state == self.OPEN:
            if now - self._opened_at >= self.reset_s:
                self.state = self.HALF_OPEN
                self._probe_at = now
                return True
            return False
        if self.state == self.HALF_OPEN:
            if now - self._probe_at >= self.reset_s:
                self._probe_at = now
                return True
            return False
        return True

    def can_attempt(self) -> bool:
        """PURE read: would :meth:`allow` admit a call now?  No state
        transition and no probe-token consumption — the router's health
        FILTER asks this about every replica on every route; only the
        caller actually about to dispatch consumes via ``allow()``
        (otherwise routing traffic whose affinity lies elsewhere would
        burn a recovering replica's single half-open probe and starve it
        of readmission)."""
        now = self._clock()
        if self.state == self.OPEN:
            return now - self._opened_at >= self.reset_s
        if self.state == self.HALF_OPEN:
            return now - self._probe_at >= self.reset_s
        return True

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self.state = self.CLOSED

    def record_failure(self) -> bool:
        """Returns True when THIS failure opened (or re-opened) the
        breaker — the caller's cue to count/emit the trip once."""
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self._opened_at = self._clock()
            return True
        self._consecutive_failures += 1
        if (
            self.state == self.CLOSED
            and self._consecutive_failures >= self.failure_threshold
        ):
            self.state = self.OPEN
            self._opened_at = self._clock()
            return True
        return False


class BreakerBoard:
    """One CircuitBreaker per key, created on first use.  Keys are
    provider ids on the pipeline's board and replica ids on the
    router's — same machinery, different granularity."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}

    def remove(self, key: str) -> None:
        """Drop a key's breaker outright (replica left the ring); a
        rejoin under the same id starts closed, like any new replica."""
        self._breakers.pop(key, None)

    def for_key(self, key: str) -> CircuitBreaker:
        breaker = self._breakers.get(key)
        if breaker is None:
            breaker = CircuitBreaker(
                self.failure_threshold, self.reset_s, clock=self._clock
            )
            self._breakers[key] = breaker
        return breaker

    def for_provider(self, provider_id: Optional[str]) -> CircuitBreaker:
        """The pipeline's historical entry point (None → "template")."""
        return self.for_key(provider_id or "template")

    def states(self) -> dict[str, str]:
        return {key: b.state for key, b in self._breakers.items()}


@dataclass
class ReplicaLoad:
    """One replica's self-reported load — the feedback the shed decision
    reads.  Produced by ``ServingEngine.load_report()`` and carried on
    ``GET /healthz`` (serving/httpserver.py); all fields degrade to
    "unknown = no pressure" so a replica that never reported is routable.
    """

    #: requests queued ahead of admission (ServingEngine._queue)
    queue_depth: int = 0
    #: admitted + popped-but-unadmitted requests riding the engine now
    inflight: int = 0
    #: measured/roofline seconds per decoded token (0.0 = unknown) — the
    #: admission roofline's own estimate, so the router's residual-fit
    #: check agrees with what the replica itself would clamp to
    decode_token_s: float = 0.0
    #: the engine's supervisor exhausted its reset budget (serving cold
    #: until the window drains) — treated as not-ready
    gave_up: bool = False
    #: step-clock perf summary (serving/perf.py): measured attributed
    #: decode MFU over the replica's step ring, the host-gap stall
    #: fraction, mean slot occupancy, and how many step records back
    #: them.  None/0 = replica predates the step clock or has not
    #: decoded yet — the fleet view skips it, routing is unaffected.
    decode_mfu: Optional[float] = None
    host_gap_frac: Optional[float] = None
    occupancy: Optional[float] = None
    steps: int = 0
    #: per-class SLO aggregates (obs/sloledger.py SLOBoard via
    #: ``ServingEngine.load_report()``): fraction of settled requests
    #: that attained their SLO, goodput-under-SLO tokens/s, how many
    #: settled requests back the fraction, and the per-class breakdown.
    #: None = replica predates the board or has settled nothing.
    slo_attainment: Optional[float] = None
    goodput_tokens_s: Optional[float] = None
    slo_completed: int = 0
    slo_classes: Optional[dict] = None
    #: KV economy (serving/kvstore.py via ``ServingEngine.load_report``):
    #: free/total device KV pages, the prefix cache's lifetime hit rate
    #: over ``prefix_lookups`` block lookups (None = caching off or the
    #: replica predates it), and a bounded MRU inventory of block hashes
    #: (hex) the replica holds — the peer index a failover consults to
    #: prefer a survivor that already has the prompt's blocks resident.
    kv_pages_free: int = 0
    kv_pages_total: int = 0
    prefix_hit_rate: Optional[float] = None
    prefix_lookups: int = 0
    kv_blocks: Optional[list] = None
    #: prefill/decode disaggregation role (fabric/disagg.py): "prefill",
    #: "decode", or "mixed".  A routing PREFERENCE, never a filter —
    #: unknown/legacy replicas read as mixed and serve everything.
    role: str = "mixed"
    #: value-aware overload ladder totals (router/value.py): requests
    #: this replica shed (dropped by value) and served degraded
    #: (depth-truncated) — rolled up fleet-wide by ``fleet_rollup``
    shed: int = 0
    degraded: int = 0

    def pressure(self) -> int:
        """Scalar queue pressure used for least-loaded comparison."""
        return self.queue_depth + self.inflight

    def est_wait_s(self, tokens: int) -> float:
        """Crude roofline-queue estimate of seconds until a NEW request
        of ``tokens`` decode tokens completes here: everything already
        riding the engine plus this request, at the replica's own
        per-token estimate.  0.0 when the rate is unknown."""
        if self.decode_token_s <= 0.0:
            return 0.0
        return self.decode_token_s * tokens * (1 + self.pressure())

    def to_dict(self) -> dict:
        return {
            "queueDepth": self.queue_depth,
            "inflight": self.inflight,
            "decodeTokenS": round(self.decode_token_s, 6),
            "gaveUp": self.gave_up,
            "decodeMfu": (
                round(self.decode_mfu, 6) if self.decode_mfu is not None
                else None
            ),
            "hostGapFrac": (
                round(self.host_gap_frac, 6)
                if self.host_gap_frac is not None else None
            ),
            "occupancy": (
                round(self.occupancy, 6) if self.occupancy is not None
                else None
            ),
            "steps": self.steps,
            "sloAttainment": (
                round(self.slo_attainment, 6)
                if self.slo_attainment is not None else None
            ),
            "goodput": (
                round(self.goodput_tokens_s, 6)
                if self.goodput_tokens_s is not None else None
            ),
            "sloCompleted": self.slo_completed,
            "sloClasses": self.slo_classes,
            "kvPagesFree": self.kv_pages_free,
            "kvPagesTotal": self.kv_pages_total,
            "prefixHitRate": (
                round(self.prefix_hit_rate, 6)
                if self.prefix_hit_rate is not None else None
            ),
            "kvLookups": self.prefix_lookups,
            "kvBlocks": self.kv_blocks,
            "role": self.role,
            "shedTotal": self.shed,
            "degradedTotal": self.degraded,
        }

    @classmethod
    def parse(cls, data: dict) -> "ReplicaLoad":
        def _opt(key: str) -> Optional[float]:
            value = data.get(key)
            if value is None:
                return None
            try:
                return float(value)
            except (TypeError, ValueError):
                return None

        return cls(
            queue_depth=int(data.get("queueDepth") or 0),
            inflight=int(data.get("inflight") or 0),
            decode_token_s=float(data.get("decodeTokenS") or 0.0),
            gave_up=bool(data.get("gaveUp")),
            decode_mfu=_opt("decodeMfu"),
            host_gap_frac=_opt("hostGapFrac"),
            occupancy=_opt("occupancy"),
            steps=int(data.get("steps") or 0),
            slo_attainment=_opt("sloAttainment"),
            goodput_tokens_s=_opt("goodput"),
            slo_completed=int(data.get("sloCompleted") or 0),
            slo_classes=(
                data.get("sloClasses")
                if isinstance(data.get("sloClasses"), dict) else None
            ),
            kv_pages_free=int(data.get("kvPagesFree") or 0),
            kv_pages_total=int(data.get("kvPagesTotal") or 0),
            prefix_hit_rate=_opt("prefixHitRate"),
            prefix_lookups=int(data.get("kvLookups") or 0),
            kv_blocks=(
                [str(h) for h in data["kvBlocks"]]
                if isinstance(data.get("kvBlocks"), list) else None
            ),
            role=str(data.get("role") or "mixed"),
            shed=int(data.get("shedTotal") or 0),
            degraded=int(data.get("degradedTotal") or 0),
        )


class ReplicaHealth:
    """Passive health of one replica: EWMA latency, consecutive errors,
    last probe verdict, last load report."""

    #: EWMA smoothing for observed latency (~last 10 calls dominate)
    ALPHA = 0.2

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.monotonic
        self.latency_ms: float = 0.0
        self.consecutive_errors: int = 0
        self.total_errors: int = 0
        self.total_calls: int = 0
        #: active-probe verdict; None = never probed (treated as ready —
        #: passive scoring and the breaker carry the gate until the first
        #: probe lands)
        self.probe_ready: Optional[bool] = None
        self.probed_at: float = 0.0
        self.load: ReplicaLoad = ReplicaLoad()
        self.load_at: float = 0.0

    def observe(self, *, ok: bool, latency_s: float = 0.0) -> None:
        self.total_calls += 1
        if ok:
            self.consecutive_errors = 0
            sample = latency_s * 1e3
            self.latency_ms = (
                sample if self.latency_ms == 0.0
                else (1 - self.ALPHA) * self.latency_ms + self.ALPHA * sample
            )
        else:
            self.consecutive_errors += 1
            self.total_errors += 1

    def report_load(self, load: ReplicaLoad) -> None:
        self.load = load
        self.load_at = self._clock()

    def mark_probe(self, ready: bool) -> None:
        self.probe_ready = ready
        self.probed_at = self._clock()

    @property
    def ready(self) -> bool:
        """Probe-level readiness: an explicit failing probe or a gave-up
        load report excludes the replica from routing until it recovers."""
        if self.load.gave_up:
            return False
        return self.probe_ready is not False

    def to_dict(self) -> dict:
        return {
            "latencyMs": round(self.latency_ms, 3),
            "consecutiveErrors": self.consecutive_errors,
            "totalErrors": self.total_errors,
            "totalCalls": self.total_calls,
            "probeReady": self.probe_ready,
            "load": self.load.to_dict(),
        }


class HealthBoard:
    """Per-replica health + breaker state behind one gate.

    Two admission questions, deliberately split: ``can_route`` is the
    PURE filter (no breaker transition, no probe consumption) the router
    asks about every replica while ranking candidates; ``admit`` is the
    consuming form the dispatcher calls for the ONE replica it is about
    to send to — in half-open, that dispatch IS the probe.  Passive
    observations feed the breaker, so a replica that dies without ever
    failing a probe still drains within ``failure_threshold`` calls."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        reset_s: float = 10.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self._clock = clock or time.monotonic
        self.breakers = BreakerBoard(failure_threshold, reset_s, clock=clock)
        self._health: dict[str, ReplicaHealth] = {}
        # fabric block index (fabric/index.py): the active form of the
        # kvBlocks inventory — replace-on-report staleness tombstones,
        # fed by report_load() below, aged by remove() and breaker opens
        self.kv_index = FabricIndex()

    def for_replica(self, replica_id: str) -> ReplicaHealth:
        health = self._health.get(replica_id)
        if health is None:
            health = ReplicaHealth(clock=self._clock)
            self._health[replica_id] = health
        return health

    def can_route(self, replica_id: str) -> bool:
        """Pure filter: would an attempt be admitted now?  Never mutates
        breaker state (see class doc)."""
        return (
            self.for_replica(replica_id).ready
            and self.breakers.for_key(replica_id).can_attempt()
        )

    def admit(self, replica_id: str) -> bool:
        """CONSUME admission for a call about to dispatch: transitions
        open→half-open when the reset window elapsed (this caller is the
        probe) and claims the probe token."""
        return (
            self.for_replica(replica_id).ready
            and self.breakers.for_key(replica_id).allow()
        )

    def observe_success(self, replica_id: str, latency_s: float) -> None:
        self.for_replica(replica_id).observe(ok=True, latency_s=latency_s)
        self.breakers.for_key(replica_id).record_success()

    def observe_failure(self, replica_id: str) -> bool:
        """Returns True when this failure OPENED the replica's breaker
        (the caller's cue to count the exclusion once)."""
        health = self.for_replica(replica_id)
        health.observe(ok=False)
        opened = self.breakers.for_key(replica_id).record_failure()
        if opened:
            # age the KV inventory with the breaker: an unreachable
            # replica's blocks must stop matching immediately, not
            # linger until its (never-arriving) next load report
            health.load.kv_blocks = None
            self.kv_index.remove(replica_id)
        return opened

    def report_load(
        self, replica_id: str, load: ReplicaLoad, *, url: str = ""
    ) -> None:
        """Land a load report AND refresh the fabric index in one step —
        the replace semantics ARE the staleness tombstone (anything the
        replica stopped advertising is unmatchable as of this report)."""
        self.for_replica(replica_id).report_load(load)
        self.kv_index.update(replica_id, load.kv_blocks, url=url)

    def remove(self, replica_id: str) -> None:
        """Forget a replica that left the ring (discovery leave, scale
        down): health entry, breaker, and its whole fabric inventory —
        a removed replica's blocks must never match again."""
        self._health.pop(replica_id, None)
        self.breakers.remove(replica_id)
        self.kv_index.remove(replica_id)

    def states(self) -> dict[str, dict]:
        return {
            replica_id: {
                "breaker": self.breakers.for_key(replica_id).state,
                **health.to_dict(),
            }
            for replica_id, health in sorted(self._health.items())
        }

    def fleet_view(self) -> dict:
        """Fleet perf roll-up for the operator's ``GET /fleet``: every
        replica's step-clock summary (as last reported on ``/healthz``)
        plus fleet aggregates (see :func:`fleet_rollup`)."""
        replicas = {}
        for replica_id, health in sorted(self._health.items()):
            load = health.load
            replicas[replica_id] = {
                "ready": health.ready,
                "breaker": self.breakers.for_key(replica_id).state,
                "latencyMs": round(health.latency_ms, 3),
                "queueDepth": load.queue_depth,
                "inflight": load.inflight,
                "decodeMfu": load.decode_mfu,
                "hostGapFrac": load.host_gap_frac,
                "occupancy": load.occupancy,
                "steps": load.steps,
                "sloAttainment": load.slo_attainment,
                "goodput": load.goodput_tokens_s,
                "sloCompleted": load.slo_completed,
                "sloClasses": load.slo_classes,
                "kvPagesFree": load.kv_pages_free,
                "kvPagesTotal": load.kv_pages_total,
                "prefixHitRate": load.prefix_hit_rate,
                "kvLookups": load.prefix_lookups,
                "role": load.role,
                "shedTotal": load.shed,
                "degradedTotal": load.degraded,
            }
        return {"replicas": replicas, "fleet": fleet_rollup(replicas)}

    def holders(self, block_hash: str) -> list[str]:
        """Replica ids whose last load report advertised ``block_hash``
        (hex) in their KV inventory — the peer index a failover consults
        to resume onto a survivor that can re-prefill from cache instead
        of recomputing.  Reports are advisory (bounded MRU snapshot, may
        be stale): an empty answer means "no known holder", never "no
        holder".  The union of the fabric index (fed via
        :meth:`report_load`, aged by :meth:`remove`/breaker opens) and
        the legacy per-health scan, so direct ``ReplicaHealth``
        report_load callers stay visible."""
        found = set(self.kv_index.holders(block_hash))
        for replica_id, health in self._health.items():
            blocks = health.load.kv_blocks
            if blocks and block_hash in blocks:
                found.add(replica_id)
        return sorted(found)
