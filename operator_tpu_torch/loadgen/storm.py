"""The storm stack (the port's copy of ``operator_tpu/loadgen/storm.py``):
a full in-process operator→router→serving loop the open-loop driver can
pound.

``build_storm_stack`` assembles the SAME components production wires —
FakeKubeApi, PatternEngine, AnalysisPipeline (with its SLO ledger), a
ProviderRegistry whose ``storm`` backend dispatches through a real
:class:`~..router.core.EngineRouter` over in-process replicas — so a
storm exercises admission, affinity routing, load-feedback shedding,
failover, deadline clamping, and the ledger's journaling together, not a
mocked subset.  Replicas come in two flavours:

- :class:`SyntheticReplica` — deterministic engine-less service times
  with a bounded concurrency gate, so the CPU-only CI smoke shows REAL
  queueing collapse under overload without a device;
- :class:`EngineReplica` — wraps a live ``ServingEngine`` (the
  ``deployed`` phase of ``chip_smoke.py``), mapping SLO class to admission priority and the
  residual budget to a ``SamplingParams.deadline``.

Every storm submit is one ``pipeline.process_pod_failure`` call on a pod
carrying a ``podmortem.io/slo-class`` annotation; the ledger admits at
trace birth and settles in the pipeline's finally, so shed / deadline /
failure outcomes are accounted exactly once per arrival.
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
from dataclasses import dataclass
from typing import Any, Mapping, Optional

from ..memory.recall import build_incident_memory
from ..obs import SLOLedger, Tracer, annotate_root, parse_slo_classes
from ..obs.sloledger import SLO_OUTCOME_ATTR
from ..operator.kubeapi import FakeKubeApi
from ..operator.pipeline import AnalysisPipeline
from ..operator.providers import default_registry
from ..patterns.engine import PatternEngine
from ..router import EngineRouter, Replica, RouterError, request_key
from ..router.health import ReplicaLoad
from ..schema.analysis import AIResponse, AnalysisRequest
from ..schema.crds import (
    AIProvider,
    AIProviderRef,
    AIProviderSpec,
    Podmortem,
    PodmortemSpec,
)
from ..schema.kube import (
    ContainerState,
    ContainerStateTerminated,
    ContainerStatus,
    Pod,
    PodStatus,
)
from ..schema.meta import ObjectMeta
from ..utils.config import OperatorConfig
from ..utils.deadline import Deadline
from ..utils.timing import MetricsRegistry

from ..router.value import (
    RECALL_COST_FRACTION,
    OverloadPolicy,
    ShedDecisionLog,
    ValueModel,
)
from .arrivals import ArrivalEvent, ArrivalProcess, ArrivalSpec
from .driver import run_open_loop

__all__ = [
    "EngineReplica",
    "InProcessServingBackend",
    "StormStack",
    "SyntheticReplica",
    "build_storm_stack",
    "run_storm",
]

#: pod annotation the pipeline reads the SLO class from
SLO_CLASS_ANNOTATION = "podmortem.io/slo-class"

#: SLO class -> scheduler admission priority (EDF orders within a class)
CLASS_PRIORITY = {"interactive": 10, "standard": 5, "batch": 0}

#: recall-hot arrivals repeat these EXACT log bodies, so incident-memory
#: fingerprints collide (recall hits) and router affinity keeps them on
#: the replica whose cache is warm
HOT_LOGS = {
    "short": "java.lang.OutOfMemoryError: Java heap space\n"
             "    at com.example.Worker.run(Worker.java:42)\n",
    "long": "java.lang.OutOfMemoryError: Java heap space\n"
            "    at com.example.Batch.process(Batch.java:7)\n"
            + "INFO retrying shard merge\n" * 40,
}


def storm_log(event: ArrivalEvent) -> str:
    """Deterministic log body for one arrival.  Hot events repeat a fixed
    body (fingerprint hit); cold events embed a per-index token so every
    cold failure is a fresh incident class."""
    if event.recall_hot:
        return HOT_LOGS[event.kind]
    # the tag must SURVIVE fingerprint normalization (memory/fingerprint.py
    # folds hex runs to <hex>), so cold events stay distinct incident
    # classes: map the digest onto letters outside [0-9a-f]
    digest = hashlib.sha256(f"cold-{event.index}".encode()).hexdigest()
    tag = "".join(chr(ord("g") + int(c, 16) % 18) for c in digest[:10])
    body = (
        f"java.lang.OutOfMemoryError: Java heap space in stage-{tag}\n"
        f"    at com.example.Cold{tag}.run(Cold.java:{13 + event.index % 80})\n"
    )
    if event.kind == "long":
        body += f"INFO shard {tag} spilling to disk\n" * 40
    return body


def storm_pod(event: ArrivalEvent, *, namespace: str = "storm") -> Pod:
    """A failed pod shaped like the watcher tests' ``failed_pod``, with
    the SLO class riding the annotation the pipeline admits under."""
    return Pod(
        metadata=ObjectMeta(
            name=f"storm-{event.index}",
            namespace=namespace,
            labels={"app": "storm"},
            annotations={SLO_CLASS_ANNOTATION: event.slo_class},
        ),
        status=PodStatus(
            phase="Running",
            container_statuses=[ContainerStatus(
                name="app",
                restart_count=1,
                state=ContainerState(terminated=ContainerStateTerminated(
                    exit_code=137, reason="OOMKilled",
                    finished_at="2026-08-05T00:00:00Z",
                )),
            )],
        ),
    )


# --------------------------------------------------------------------------
# replicas
# --------------------------------------------------------------------------


class SyntheticReplica:
    """An engine-less replica with a REAL concurrency bottleneck.

    Service time is a deterministic function of the request (log volume),
    but at most ``concurrency`` requests are in service at once — excess
    arrivals wait on the gate, so an open-loop storm past capacity shows
    genuine queueing growth (and SLO misses) on a CPU-only box in
    milliseconds, not minutes.  ``time_scale`` compresses service times
    by the same factor the driver compresses arrivals."""

    #: disaggregated service-time split (fabric/disagg.py): the prefill
    #: leg is the prompt-heavy share of one analysis, the decode leg the
    #: rest — a prefill replica serving only prefill legs models the
    #: prompt-bound tier, symmetric for decode
    PHASE_COST = {"full": 1.0, "prefill": 0.6, "decode": 0.4}

    def __init__(
        self,
        replica_id: str,
        *,
        concurrency: int = 4,
        base_ms: float = 5.0,
        per_kb_ms: float = 4.0,
        time_scale: float = 1.0,
        role: str = "mixed",
    ) -> None:
        self.id = replica_id
        self.concurrency = max(1, concurrency)
        self.base_ms = base_ms
        self.per_kb_ms = per_kb_ms
        self.time_scale = time_scale
        self.role = role
        self._gate = asyncio.Semaphore(self.concurrency)
        self.inflight = 0
        self.waiting = 0
        self.served = 0
        #: per-phase serve counts — the disagg smoke's role-honesty gate
        self.served_by_phase: "dict[str, int]" = {}

    def load(self) -> ReplicaLoad:
        return ReplicaLoad(
            queue_depth=self.waiting,
            inflight=self.inflight,
            occupancy=min(1.0, self.inflight / self.concurrency),
            role=self.role,
        )

    def service_ms(self, request: AnalysisRequest) -> float:
        logs = ""
        if request.failure_data is not None:
            logs = request.failure_data.logs or ""
        return self.base_ms + self.per_kb_ms * (len(logs) / 1024.0)

    async def serve(
        self,
        request: AnalysisRequest,
        budget_s: Optional[float],
        degrade_frac: float = 1.0,
        phase: str = "full",
    ) -> AIResponse:
        cost_s = self.service_ms(request) * self.time_scale / 1000.0
        cost_s *= self.PHASE_COST.get(phase, 1.0)
        if degrade_frac < 1.0:
            # overload ladder truncated the analysis depth: a shallower
            # answer costs proportionally less service time
            cost_s *= max(0.05, degrade_frac)
        self.waiting += 1
        try:
            async with self._gate:
                self.waiting -= 1
                self.inflight += 1
                try:
                    await asyncio.sleep(cost_s)
                finally:
                    self.inflight -= 1
        except BaseException:
            # gate wait cancelled (drain) — waiting was already counted
            if self.waiting > 0:
                self.waiting -= 1
            raise
        self.served += 1
        self.served_by_phase[phase] = self.served_by_phase.get(phase, 0) + 1
        fingerprint = request.fingerprint or "cold"
        return AIResponse(
            explanation=(
                f"Root Cause: synthetic analysis of class {fingerprint[:12]}.\n"
                "Fix: inspect the storm harness."
            ),
            provider_id="storm",
            model_id="synthetic",
            completion_tokens=24,
            deadline_outcome="completed" if budget_s is not None else None,
        )


class EngineReplica:
    """A live ``ServingEngine`` behind the storm router, served through
    its ``generate`` coroutine.  Imports serving lazily so the loadgen
    package stays importable without torch's device stack loaded."""

    def __init__(self, replica_id: str, engine: Any, *, max_tokens: int = 48) -> None:
        self.id = replica_id
        self.engine = engine
        self.max_tokens = max_tokens

    def load(self) -> ReplicaLoad:
        return self.engine.load_report()

    async def serve(
        self,
        request: AnalysisRequest,
        budget_s: Optional[float],
        degrade_frac: float = 1.0,
        phase: str = "full",
    ) -> AIResponse:
        from ..serving.types import SamplingParams

        logs = ""
        slo_class = getattr(request, "slo_class", None)
        if request.failure_data is not None:
            logs = request.failure_data.logs or ""
            slo_class = slo_class or getattr(
                request.failure_data, "slo_class", None
            )
        prompt = f"Explain this pod failure:\n{logs[:2048]}\nRoot cause:"
        deadline = (
            self.engine.generator._clock() + budget_s
            if budget_s is not None
            else None
        )
        max_tokens = self.max_tokens
        if phase == "prefill":
            # disaggregated prefill leg: run the full prompt for exactly
            # one token — the decode leg picks up over the fabric
            max_tokens = 1
        if degrade_frac < 1.0:
            max_tokens = max(1, int(max_tokens * degrade_frac))
        params = SamplingParams(
            max_tokens=max_tokens,
            temperature=0.0,
            deadline=deadline,
            slo_class=slo_class,
            degraded=degrade_frac < 1.0,
            recall_p=getattr(request, "recall_p", 0.0),
        )
        priority = CLASS_PRIORITY.get(slo_class or "", 5)
        result = await self.engine.generate(prompt, params, priority=priority)
        return AIResponse(
            explanation=result.text,
            provider_id="storm",
            model_id="tpu-native",
            completion_tokens=result.completion_tokens,
            deadline_outcome=(
                "deadline-exceeded" if result.finish_reason == "deadline"
                and not result.completion_tokens else
                "truncated" if result.finish_reason == "deadline"
                else "degraded" if result.finish_reason == "degraded"
                else "completed" if budget_s is not None else None
            ),
        )


# --------------------------------------------------------------------------
# the routed backend
# --------------------------------------------------------------------------


class InProcessServingBackend:
    """AIProviderBackend dispatching through a real EngineRouter over
    in-process replicas — the storm's serving plane.

    The dispatch mirrors ``OpenAICompatProvider.generate`` (affinity from
    fingerprint/prefix, absolute deadline envelope, failover across the
    set) but ``send`` is a direct coroutine call instead of HTTP, and
    load feedback comes straight from the replicas' own reports before
    every route, so shedding reacts to THIS storm's queue depths."""

    def __init__(
        self,
        replicas: "list[SyntheticReplica | EngineReplica]",
        *,
        metrics: Optional[MetricsRegistry] = None,
        shed_pressure: int = 8,
        max_failover: int = 1,
        allow_empty: bool = False,
        disaggregate: bool = False,
    ) -> None:
        if not replicas and not allow_empty:
            raise ValueError("storm backend needs at least one replica")
        self.replicas = {r.id: r for r in replicas}
        self.metrics = metrics
        self.router = EngineRouter(
            [Replica(id=r.id, url=f"inproc://{r.id}") for r in replicas],
            shed_pressure=shed_pressure,
            max_failover=max_failover,
            metrics=metrics,
        )
        #: fabric disaggregation (fabric/disagg.py): every analysis runs
        #: as a prefill leg + a decode leg, role-preferred routing each
        self.disaggregate = disaggregate
        #: pulsed on every membership change; arrivals against an empty
        #: fleet wait here for the autoscaler to wake a replica
        self._members_changed = asyncio.Event()

    # -- elastic membership (docs/SCALING.md): the discovery loop mutates
    # the serving plane mid-storm through these, without restart --------
    def add_replica(
        self, replica: "SyntheticReplica | EngineReplica"
    ) -> None:
        self.replicas[replica.id] = replica
        self.router.add(Replica(id=replica.id, url=f"inproc://{replica.id}"))
        self._members_changed.set()

    def remove_replica(self, replica_id: str) -> None:
        self.replicas.pop(replica_id, None)
        self.router.remove(replica_id)
        self._members_changed.set()

    def _feed_load(self) -> None:
        for rid, replica in self.replicas.items():
            try:
                self.router.report_load(rid, replica.load())
            except Exception:  # a torn load report must not kill dispatch
                continue

    async def generate(self, request: AnalysisRequest) -> AIResponse:
        logs = ""
        if request.failure_data is not None:
            logs = request.failure_data.logs or ""
        prompt_basis = logs[:512] or "empty"
        budget = (
            Deadline.start(request.deadline_s)
            if request.deadline_s is not None
            else None
        )
        # scale-from-zero: an arrival against an EMPTY fleet is the wake
        # signal (the autoscaler sees it as ledger pending) — wait for a
        # member to join instead of failing, bounded by the arrival's own
        # deadline envelope so a fleet that never wakes settles as a
        # deadline miss, not a hang
        while len(self.router) == 0:
            self._members_changed.clear()
            if len(self.router):
                break  # joined between the check and the clear
            wait_s = budget.remaining() if budget is not None else 5.0
            if wait_s <= 0.0:
                return AIResponse(
                    error="deadline exhausted waiting for the fleet to "
                          "wake from zero",
                    provider_id="storm",
                    deadline_outcome="deadline-exceeded",
                )
            try:
                await asyncio.wait_for(
                    self._members_changed.wait(), timeout=min(wait_s, 5.0)
                )
            except asyncio.TimeoutError:
                continue
        self._feed_load()

        # value-aware overload ladder (router/value.py): consult BEFORE
        # dispatch so a storm past the collapse point degrades low-value
        # work (shallower analysis) and sheds only the lowest-value tail,
        # never the protected class — the router's raw pressure shed stays
        # as the backstop underneath
        degrade_frac = 1.0
        if getattr(self.router, "policy", None) is not None:
            verdict = self.router.overload_verdict(
                value=self.router.policy.model.value(
                    slo_class=getattr(request, "slo_class", None),
                    residual_s=budget.remaining() if budget is not None else None,
                    recall_p=getattr(request, "recall_p", 0.0),
                ),
                request_id=request_key(prompt_basis),
                site="storm",
            )
            if verdict is not None and verdict.action == "shed":
                annotate_root(SLO_OUTCOME_ATTR, "shed", overwrite=False)
                return AIResponse(
                    error="shed by overload ladder (lowest value at storm "
                          "admission)",
                    provider_id="storm",
                    deadline_outcome="shed",
                )
            if verdict is not None and verdict.action == "degrade":
                degrade_frac = verdict.degrade_tokens_frac

        async def send(
            replica: Replica, attempt: int, budget_s: Optional[float]
        ) -> AIResponse:
            target = self.replicas[replica.id]
            return await target.serve(request, budget_s, degrade_frac)

        key = EngineRouter.affinity_key(
            prefix=prompt_basis, fingerprint=request.fingerprint
        )
        rid = request_key(prompt_basis)
        try:
            if self.disaggregate:
                from ..fabric.disagg import disaggregated_dispatch

                async def prefill_send(replica, attempt, budget_s):
                    target = self.replicas[replica.id]
                    return await target.serve(
                        request, budget_s, degrade_frac, phase="prefill"
                    )

                async def decode_send(replica, attempt, budget_s, prefix):
                    target = self.replicas[replica.id]
                    return await target.serve(
                        request, budget_s, degrade_frac, phase="decode"
                    )

                _prefill, outcome = await disaggregated_dispatch(
                    self.router, prefill_send, decode_send,
                    key=key, request_id=rid, deadline=budget,
                    metrics=self.metrics,
                )
            else:
                outcome = await self.router.dispatch(
                    send,
                    key=key,
                    request_id=rid,
                    deadline=budget,
                    attempts=1,
                )
        except RouterError as exc:
            deadline_spent = budget is not None and budget.remaining() <= 0.0
            if not deadline_spent:
                # load-refused: the ledger settles this arrival as shed,
                # not failed (the root-span override sloledger reads)
                annotate_root(SLO_OUTCOME_ATTR, "shed", overwrite=False)
            return AIResponse(
                error=f"storm dispatch failed: {exc}",
                provider_id="storm",
                deadline_outcome="deadline-exceeded" if deadline_spent else None,
                replica_id=exc.tried[-1] if exc.tried else None,
            )
        response: AIResponse = outcome.response
        response.replica_id = outcome.replica_id
        response.requeues = outcome.requeues
        if (
            degrade_frac < 1.0
            and response.explanation
            and not response.error
            and response.deadline_outcome in (None, "completed")
        ):
            # the ladder shortened this analysis and it still landed —
            # a DISTINCT terminal outcome, not a deadline miss
            response.deadline_outcome = "degraded"
        return response

    def fleet_view(self) -> dict:
        self._feed_load()
        view = self.router.health.fleet_view()
        # the autoscaler's burst signal (least-loaded healthy pressure)
        view["fleet"]["pressure"] = self.router.fleet_pressure()
        return view


# --------------------------------------------------------------------------
# stack assembly + the storm loop
# --------------------------------------------------------------------------


@dataclass
class StormStack:
    """Everything one storm drives, pre-wired.  ``submit`` is the
    open-loop driver's callable: one arrival -> one full analysis."""

    api: FakeKubeApi
    config: OperatorConfig
    metrics: MetricsRegistry
    pipeline: AnalysisPipeline
    ledger: SLOLedger
    backend: InProcessServingBackend
    podmortem: Podmortem
    namespace: str = "storm"
    deadline_factor: float = 4.0
    time_scale: float = 1.0

    async def submit(self, event: ArrivalEvent) -> None:
        pod = storm_pod(event, namespace=self.namespace)
        self.api.set_pod_log(self.namespace, pod.metadata.name,
                             storm_log(event))
        target_s = self.ledger.classes.get(
            event.slo_class,
            self.ledger.classes[self.ledger.default_class],
        )
        envelope_s = max(0.25, target_s * self.deadline_factor * self.time_scale)
        await self.pipeline.process_pod_failure(
            pod, self.podmortem,
            failure_time=f"storm-t{event.index}",
            deadline=Deadline.start(envelope_s),
        )

    def close(self) -> None:
        self.ledger.close()


async def build_storm_stack(
    *,
    replicas: "Optional[list[SyntheticReplica | EngineReplica]]" = None,
    config: Optional[OperatorConfig] = None,
    metrics: Optional[MetricsRegistry] = None,
    ledger_path: Optional[str] = None,
    time_scale: float = 1.0,
    deadline_factor: float = 4.0,
    namespace: str = "storm",
    fault_plan: Any = None,
    disaggregate: bool = False,
    device: Any = None,
) -> StormStack:
    """Wire the full storm stack.  Defaults give the CI smoke shape: two
    synthetic replicas, in-memory pattern cache, ledger journaled to
    ``ledger_path`` when set.  The pattern engine and the incident
    memory's index run on ``device`` (``cuda`` unless the caller asks
    for another)."""
    api = FakeKubeApi()
    if fault_plan is not None:
        api.fault_plan = fault_plan
    config = config or OperatorConfig(
        pattern_cache_directory="/nonexistent",
        conflict_backoff_base_s=0.001,
        memory_enabled=True,
    )
    metrics = metrics or MetricsRegistry()
    ledger = SLOLedger(
        parse_slo_classes(config.slo_classes),
        path=ledger_path,
        metrics=metrics,
    )
    # an EXPLICIT empty list is the elastic (scale-from-zero) shape: the
    # fleet starts at zero and membership arrives through add_replica;
    # None keeps the classic two-synthetic-replica CI smoke
    allow_empty = replicas is not None and not replicas
    if replicas is None:
        replicas = [
            SyntheticReplica(f"storm-replica-{i}", time_scale=time_scale)
            for i in range(2)
        ]
    backend = InProcessServingBackend(
        replicas, metrics=metrics, allow_empty=allow_empty,
        disaggregate=disaggregate,
    )
    if fault_plan is not None:
        # the router's dispatch seam joins the same plan as the apiserver
        # (router.dispatch — replica kills/partitions in the data plane)
        backend.router.fault_plan = fault_plan
    registry = default_registry()
    registry.register("storm", backend)
    pipeline = AnalysisPipeline(
        api, PatternEngine(device=device), config=config, metrics=metrics,
        providers=registry, tracer=Tracer(recorder=None),
        slo_ledger=ledger, memory=build_incident_memory(config, device=device),
    )
    # one value model for the whole chain: the storm backend's router
    # consults the SAME policy (same attainment feed, same decision log)
    # the pipeline built, so shed/degrade ordering is provable end-to-end
    backend.router.policy = pipeline.overload_policy
    provider = AIProvider(
        metadata=ObjectMeta(name="storm", namespace=namespace),
        spec=AIProviderSpec(provider_id="storm", model_id="storm"),
    )
    await api.create("AIProvider", provider.to_dict())
    podmortem = Podmortem(
        metadata=ObjectMeta(name="storm", namespace=namespace),
        spec=PodmortemSpec(
            ai_provider_ref=AIProviderRef(name="storm", namespace=namespace),
        ),
    )
    await api.create("Podmortem", podmortem.to_dict())
    return StormStack(
        api=api, config=config, metrics=metrics, pipeline=pipeline,
        ledger=ledger, backend=backend, podmortem=podmortem,
        namespace=namespace, deadline_factor=deadline_factor,
        time_scale=time_scale,
    )


async def run_storm(
    stack: StormStack,
    process: ArrivalProcess,
    *,
    drain_s: float = 30.0,
) -> dict:
    """Drive one storm open-loop and fold the ledger's verdict into the
    driver's offered/achieved accounting — the record bench.py publishes
    as ``open_loop`` and the CI smoke asserts on."""
    report = await run_open_loop(
        stack.submit, process,
        time_scale=stack.time_scale, drain_s=drain_s,
    )
    snapshot = stack.ledger.snapshot()
    return {
        "arrival_spec": process.spec.to_dict(),
        "seed": process.seed,
        "fingerprint": process.fingerprint(),
        **report,
        "slo": snapshot,
        "fleet": stack.backend.fleet_view(),
        "overload": _overload_evidence(stack),
    }


def _overload_evidence(stack: StormStack) -> Optional[dict]:
    """The overload ladder's verdict for one storm: labeled shed/degrade
    totals, per-class splits, and a digest of the decision log (two runs
    of the same seeded storm against a deterministic pressure trace must
    produce byte-identical logs — tests/test_value.py proves the policy
    layer; the digest makes a live storm's log comparable at a glance)."""
    policy = getattr(stack.pipeline, "overload_policy", None)
    if policy is None:
        return None

    def by_class(name: str) -> "dict[str, int]":
        out: dict[str, int] = {}
        for key, count in stack.metrics.labeled(name).items():
            cls = dict(key).get("slo_class", "unknown")
            out[cls] = out.get(cls, 0) + count
        return out

    log_text = policy.log.text()
    return {
        "shed_total": stack.metrics.labeled_total("shed"),
        "degraded_total": stack.metrics.labeled_total("degraded"),
        "shed_by_class": by_class("shed"),
        "degraded_by_class": by_class("degraded"),
        "attainment_by_class": stack.ledger.attainment_by_class(),
        "decisions": len(policy.log.lines()),
        "decisions_dropped": policy.log.dropped,
        "decision_log_sha256":
            hashlib.sha256(log_text.encode("utf-8")).hexdigest(),
    }


def simulate_overload(
    rate_per_min: float,
    *,
    seed: int = 0,
    duration_s: float = 60.0,
    servers: int = 4,
    service_s: float = 0.35,
    long_service_s: float = 0.9,
    classes: Optional[Mapping[str, float]] = None,
    shed_pressure: float = 8.0,
    degrade_pressure: Optional[float] = None,
    degrade_tokens_frac: float = 0.25,
    shed_value_floor: float = 1.0,
    attainment_target: float = 0.9,
) -> dict:
    """One overload storm replayed through the production value ladder in
    VIRTUAL time — the deterministic proof surface for the 2×-collapse CI
    pass.

    The live ladder keys off measured queue pressure, which is a
    contention signal BY DESIGN: wall-clock attainment of a 2-second
    interactive target on a loaded CI runner says more about the runner
    than the ladder, so a live-stack gate flakes in both directions (an
    idle host never overloads; a contended one cliffs).  Here the same
    seeded :class:`ArrivalProcess` schedule is replayed against an M/D/c
    queue with a virtual clock — ``servers`` slots, deterministic
    per-kind service times, recall hits at ~:data:`RECALL_COST_FRACTION
    <..router.value.RECALL_COST_FRACTION>` of cold cost, degraded work
    shortened to ``degrade_tokens_frac`` — and every arrival is decided
    by the SAME :class:`~..router.value.OverloadPolicy` /
    :class:`~..router.value.ValueModel` the pipeline wires, with
    pressure = unfinished jobs at the arrival instant.  The per-class
    attainment feeding class protection updates CAUSALLY (only jobs
    finished strictly before the deciding arrival count), so the
    protect-below-target loop closes exactly as it does live.

    No wall clock, no ambient randomness (GL007): the same ``(seed,
    rate, knobs)`` returns a byte-identical decision log and result row.
    """
    class_targets = dict(
        classes if classes is not None
        else {"interactive": 2.0, "standard": 30.0, "batch": 120.0}
    )
    events = ArrivalProcess(
        ArrivalSpec(
            name="poisson", rate_per_min=rate_per_min,
            duration_s=duration_s,
        ),
        seed=seed,
    ).materialize()
    counts = {
        c: {"admitted": 0, "attained": 0, "missed": 0,
            "shed": 0, "degraded": 0}
        for c in class_targets
    }

    def attainment() -> "dict[str, Optional[float]]":
        out: "dict[str, Optional[float]]" = {}
        for cls, k in counts.items():
            settled = k["attained"] + k["missed"]
            out[cls] = (k["attained"] / settled) if settled else None
        return out

    model = ValueModel(
        class_targets, attainment=attainment,
        attainment_target=attainment_target,
    )
    policy = OverloadPolicy(
        model,
        shed_pressure=shed_pressure,
        degrade_pressure=degrade_pressure,
        degrade_tokens_frac=degrade_tokens_frac,
        shed_value_floor=shed_value_floor,
        log=ShedDecisionLog(cap=65536),
    )
    free = [0.0] * max(1, int(servers))  # per-slot next-free virtual time
    heapq.heapify(free)
    # (finish_time, slo_class, attained) for every unfinished admitted job;
    # its length at an arrival IS the pressure signal (queued + inflight)
    settle: "list[tuple[float, str, bool]]" = []
    protected_shed = 0
    for event in events:
        # settle jobs that finished before this arrival FIRST so the
        # attainment feed (and therefore protection) stays causal
        while settle and settle[0][0] <= event.at_s:
            _, cls, ok = heapq.heappop(settle)
            counts[cls]["attained" if ok else "missed"] += 1
        cls = event.slo_class
        counts.setdefault(
            cls, {"admitted": 0, "attained": 0, "missed": 0,
                  "shed": 0, "degraded": 0},
        )
        counts[cls]["admitted"] += 1
        pressure = float(len(settle))
        value = model.value(
            slo_class=cls,
            recall_p=1.0 if event.recall_hot else 0.0,
        )
        verdict = policy.decide(
            value, pressure, site="sim", request_id=f"req-{event.index}",
        )
        if verdict.action == "shed":
            counts[cls]["missed"] += 1
            counts[cls]["shed"] += 1
            if value.protected:
                protected_shed += 1
            continue
        cost = long_service_s if event.kind == "long" else service_s
        if event.recall_hot:
            cost *= RECALL_COST_FRACTION
        if verdict.action == "degrade":
            counts[cls]["degraded"] += 1
            cost *= max(0.05, verdict.degrade_tokens_frac)
        start = max(event.at_s, heapq.heappop(free))
        finish = start + cost
        heapq.heappush(free, finish)
        # a degraded completion inside its target still ATTAINS — that is
        # the degrade-before-reject mechanism paying out (the live
        # sloledger applies the same rule to "degraded" outcomes)
        target = class_targets.get(cls, 0.0)
        heapq.heappush(settle, (finish, cls, finish - event.at_s <= target))
    while settle:
        _, cls, ok = heapq.heappop(settle)
        counts[cls]["attained" if ok else "missed"] += 1

    att = attainment()
    settled_total = sum(k["attained"] + k["missed"] for k in counts.values())
    attained_total = sum(k["attained"] for k in counts.values())
    log_text = policy.log.text()
    return {
        "rate_per_min": float(rate_per_min),
        "arrivals": len(events),
        "attainment": (
            attained_total / settled_total if settled_total else None
        ),
        "attainment_by_class": att,
        "shed_total": sum(k["shed"] for k in counts.values()),
        "degraded_total": sum(k["degraded"] for k in counts.values()),
        "shed_by_class": {
            c: k["shed"] for c, k in counts.items() if k["shed"]
        },
        "degraded_by_class": {
            c: k["degraded"] for c, k in counts.items() if k["degraded"]
        },
        "protected_shed": protected_shed,
        "protected": sorted(model.protected_classes()),
        "decisions": len(policy.log.lines()),
        "decisions_dropped": policy.log.dropped,
        "decision_log": log_text,
        "decision_log_sha256":
            hashlib.sha256(log_text.encode("utf-8")).hexdigest(),
    }
