"""The failure-analysis pipeline: collect -> parse -> explain -> store -> emit.

One implementation shared by the real-time watcher and the poll-path
reconciler — the consolidation SURVEY.md §3.3 calls out (the reference
duplicates ~200 LoC between PodFailureWatcher and PodmortemReconciler, and
the reconcile path never stores results; here both paths store).

Graceful degradation mirrors the reference (SURVEY.md §5 failure-detection
entry): parse failure => error event + status; AI failure => pattern-only
result still stored; provider missing => stored without AI.

The port's own copy of ``operator_tpu/operator/pipeline.py``.  A pipeline
that builds its own incident memory scores recall on cuda; the operator
passes one built on its device.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Optional

from ..memory import (
    RECALL_HIT,
    RECALL_NEAR,
    IncidentMemory,
    RecallDecision,
    build_incident_memory,
)
from ..obs import SLOLedger, Span, Tracer, annotate_root, parse_slo_classes, stage_durations
from ..obs.sloledger import SLO_OUTCOME_ATTR
from ..patterns.engine import PatternEngine
from ..schema.analysis import (
    AIResponse,
    AnalysisRequest,
    AnalysisResult,
    PodFailureData,
    PriorIncident,
)
from ..schema.crds import AIProvider, FailureRecurrence, Podmortem, parse_refresh_interval
from ..schema.kube import Event as KubeEvent
from ..schema.kube import Pod
from ..schema.meta import now_iso
from ..utils.config import OperatorConfig
from ..utils.deadline import Deadline
from ..utils.timing import METRICS, MetricsRegistry
from .claims import ClaimLedger, ClaimRecord
from .events import EventService
from .kubeapi import ApiError, KubeApi, NotFoundError
from .providers import (
    BreakerBoard,
    ProviderError,
    ProviderRegistry,
    ResponseCache,
    default_registry,
    resolve_provider_config,
)
from .storage import AnalysisStorageService

log = logging.getLogger(__name__)




class AnalysisPipeline:
    def __init__(
        self,
        api: KubeApi,
        engine: PatternEngine,
        *,
        config: Optional[OperatorConfig] = None,
        events: Optional[EventService] = None,
        storage: Optional[AnalysisStorageService] = None,
        providers: Optional[ProviderRegistry] = None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Optional[Callable[[], float]] = None,
        memory: Optional[IncidentMemory] = None,
        tracer: Optional[Tracer] = None,
        claims: Optional[ClaimLedger] = None,
        slo_ledger: Optional[SLOLedger] = None,
        overload_policy: Optional[Any] = None,
    ) -> None:
        self.api = api
        self.engine = engine
        self.config = config or OperatorConfig()
        self.events = events or EventService(api, self.config)
        self.storage = storage or AnalysisStorageService(api, self.config)
        self.providers = providers or default_registry()
        self.metrics = metrics or METRICS
        self.cache = ResponseCache()
        # the claim map shared by the watcher and the poll-path reconciler —
        # one analysis per distinct (pod, failureTime), like the reference's
        # ``processedFailures`` map (PodFailureWatcher.java:50,180-193) but
        # (a) shared by both detection paths, (b) bounded, (c) retry-aware,
        # and (d) DURABLE when config.claims_path is set: claims journal to
        # a crash-safe ledger, and a restarted (or newly elected,
        # operator/lease.py) operator resumes non-terminal analyses with
        # their remaining deadline budget (resume_pending).  Injectable so
        # tests drive the wall clock.
        self.claims = claims if claims is not None else ClaimLedger(
            self.config.claims_path,
            max_entries=self.config.claims_max_entries,
        )
        # incident memory (docs/MEMORY.md): recall across failures so a
        # recurring class pays the decode once, not once per pod.
        # Injectable; the default honours config.memory_enabled.
        self.memory = memory if memory is not None else build_incident_memory(self.config)
        # per-analysis tracing + flight recorder (obs/,
        # docs/OBSERVABILITY.md): every analysis produces a span tree;
        # deadline-exceeded / breaker-open / engine-error analyses dump a
        # black box.  Injectable; the default is the process-wide tracer.
        if tracer is not None:
            self.tracer = tracer
        else:
            from ..obs import TRACER

            self.tracer = TRACER
        # deadline budgets + per-provider circuit breakers share one
        # injectable clock so chaos tests replay deterministically
        self._clock = clock or time.monotonic
        # SLO ledger (obs/sloledger.py, docs/OBSERVABILITY.md "SLO
        # ledger"): every analysis is admitted under a class + latency
        # target at trace birth and settled in process_pod_failure's
        # finally — completed / deadline-exceeded / shed / failed, exactly
        # once per analysis.  Shares the pipeline clock so chaos replays
        # produce identical ledgers.
        self.slo_ledger = slo_ledger if slo_ledger is not None else SLOLedger(
            parse_slo_classes(self.config.slo_classes),
            path=self.config.slo_ledger_path or None,
            metrics=self.metrics,
            clock=self._clock,
        )
        self.breakers = BreakerBoard(
            self.config.breaker_failure_threshold,
            self.config.breaker_reset_s,
            clock=self._clock,
        )
        # value-aware overload ladder (router/value.py, docs/ROBUSTNESS.md
        # "Degradation ladder"): ONE model shared by every shed site —
        # the router's pre-dispatch verdict, the scheduler's queue
        # eviction, and admission's degrade clamp — fed live per-class
        # attainment from the SLO ledger so the class already below its
        # target is never shed.  Injectable for tests; the default builds
        # from config knobs.
        if overload_policy is not None:
            self.overload_policy = overload_policy
        else:
            from ..router.value import OverloadPolicy, ValueModel

            self.overload_policy = OverloadPolicy(
                ValueModel(
                    parse_slo_classes(self.config.slo_classes),
                    attainment=self.slo_ledger.attainment_by_class,
                    attainment_target=self.config.slo_attainment_target,
                ),
                shed_pressure=self.config.shed_pressure,
                degrade_pressure=(
                    self.config.degrade_pressure
                    if self.config.degrade_pressure > 0 else None
                ),
                degrade_tokens_frac=self.config.degrade_max_tokens_frac,
                shed_value_floor=self.config.shed_value_floor,
                metrics=self.metrics,
            )
        # hand the ladder to every provider that routes dispatches
        # (OpenAICompatProvider.router_for stamps it onto its router)
        for provider in getattr(self.providers, "_providers", {}).values():
            if hasattr(provider, "overload_policy"):
                provider.overload_policy = self.overload_policy

    def _deadline_total_for(self, podmortem: Podmortem) -> float:
        """One CR's full envelope in seconds: spec.analysisDeadline when
        set, else the operator default (the reference's 180 s LLM budget)."""
        total_s = self.config.analysis_deadline_s
        if podmortem.spec.analysis_deadline:
            total_s = float(parse_refresh_interval(
                podmortem.spec.analysis_deadline,
                default_seconds=int(self.config.analysis_deadline_s),
            ))
        return total_s

    def _deadline_for(self, podmortem: Podmortem) -> Deadline:
        """One CR's analysis envelope, born NOW.  PER CR — a fan-out
        group's first analysis legitimately spending its whole envelope
        must not starve the remaining CRs down to zero-budget no-result
        runs."""
        return Deadline.start(self._deadline_total_for(podmortem), clock=self._clock)

    # ------------------------------------------------------------------
    async def process_failure_group(
        self,
        pod: Pod,
        podmortems: list[Podmortem],
        *,
        failure_time: str,
    ) -> list[Optional[AnalysisResult]]:
        """Claim one (pod, failureTime) and fan out one pipeline per matching
        CR (reference fans out per CR, PodFailureWatcher.java:196-199).
        Returns [] if the failure was already claimed.  A fully failed group
        releases the claim so the other detection path can retry it."""
        key = ClaimLedger.key(pod, failure_time)
        # the claim record carries everything a SUCCESSOR process needs to
        # resume this analysis if we die mid-flight: pod coordinates, the
        # matched CR refs, and the largest per-CR envelope (resume clamps
        # each CR to what is left of it)
        if not self.claims.try_claim(
            key,
            pod_name=pod.metadata.name or "",
            pod_namespace=pod.metadata.namespace or "",
            failure_time=failure_time,
            podmortems=[pm.qualified_name() for pm in podmortems],
            deadline_total_s=max(
                (self._deadline_total_for(pm) for pm in podmortems), default=0.0
            ),
        ):
            return []
        # durable dedupe: the claim ledger may be fresh (or in-memory), but
        # the analyzed-failure annotation is in etcd — a restarted operator
        # (or the pre-watch sweep) must not re-analyze an annotated failure
        from .storage import ANNOTATION_ANALYZED_FAILURE

        if pod.metadata.annotations.get(ANNOTATION_ANALYZED_FAILURE) == failure_time:
            self.claims.mark_done(key)
            self.metrics.incr("dedupe_durable_hits")
            return []
        # each CR's deadline budget is BORN when its analysis starts under
        # this claim: collection, parse, AI — one envelope per CR (the
        # fan-out is sequential, so a shared group envelope would hand
        # later CRs whatever the first one left, possibly nothing)
        try:
            results = []
            for podmortem in podmortems:
                self.claims.note_stage(key, f"analyze:{podmortem.qualified_name()}")
                results.append(
                    await self.process_pod_failure(
                        pod, podmortem, failure_time=failure_time,
                        deadline=self._deadline_for(podmortem),
                    )
                )
        except BaseException:
            self.claims.release(key)
            raise
        if any(result is not None for result in results):
            self.claims.mark_done(key)
        else:
            self.claims.release(key)
        return results

    # ------------------------------------------------------------------
    async def resume_pending(self) -> int:
        """Crash-resume: re-run every non-terminal claim a previous process
        — or the previous LEADER, on lease takeover — left in the ledger.
        Each analysis restarts with the claim's REMAINING wall-clock budget
        (a claim 50 s into a 180 s envelope resumes with ~130 s).  Status
        patches are idempotent (operator/storage.py), so a claim that died
        after storing still converges to exactly one recentFailures entry.
        Returns the number of claims actually resumed."""
        # a warm standby's ledger was read at ITS boot: re-read the shared
        # journal NOW so takeover sees the dead leader's claims (and a
        # fresh append handle, in case the leader compacted the file)
        self.claims.reload()

        async def _one(claim: ClaimRecord) -> int:
            try:
                return await self._resume_claim(claim)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - one bad claim must not block the rest
                log.exception("claim resume failed for %s; releasing", claim.key)
                self.claims.release(claim.key)
                return 0

        # concurrent: the watcher does not start until resume returns, so
        # several pending claims resumed serially would leave the cluster
        # unwatched for the SUM of their budgets; gather bounds the blind
        # window to the slowest single claim
        return sum(
            await asyncio.gather(*(_one(c) for c in self.claims.take_pending()))
        )

    async def _resume_claim(self, claim: ClaimRecord) -> int:
        from .storage import ANNOTATION_ANALYZED_FAILURE

        try:
            raw = await asyncio.wait_for(
                self.api.get("Pod", claim.pod_name, claim.pod_namespace),
                timeout=self.config.kube_call_timeout_s,
            )
        except NotFoundError:
            self.claims.mark_done(claim.key)  # the pod is gone; nothing to analyze
            return 0
        except (ApiError, asyncio.TimeoutError):
            # transient: release so the sweep/reconciler can re-claim later
            self.claims.release(claim.key)
            return 0
        pod = Pod.parse(raw)
        if pod.metadata.annotations.get(ANNOTATION_ANALYZED_FAILURE) == claim.failure_time:
            # the previous process finished storing before it died
            self.claims.mark_done(claim.key)
            self.metrics.incr("dedupe_durable_hits")
            return 0
        podmortems: list[Podmortem] = []
        for ref in claim.podmortems:
            namespace, _, name = ref.partition("/")
            try:
                pm_raw = await asyncio.wait_for(
                    self.api.get("Podmortem", name, namespace),
                    timeout=self.config.kube_call_timeout_s,
                )
            except NotFoundError:
                continue  # CR deleted since the claim: skip it
            except (ApiError, asyncio.TimeoutError):
                # transient apiserver trouble (likely: the takeover window
                # IS an apiserver-degraded window) must not read as "CR
                # deleted" — that path marks the claim done and drops the
                # analysis forever.  Release so a later resume/sweep retries.
                self.claims.release(claim.key)
                return 0
            podmortems.append(Podmortem.parse(pm_raw))
        if not podmortems:
            self.claims.mark_done(claim.key)
            return 0
        self.metrics.incr("claims_resumed")
        log.info(
            "resuming claim %s (stage %r, %.1fs of %.1fs budget left)",
            claim.key, claim.stage,
            self.claims.remaining_budget_s(claim), claim.deadline_total_s,
        )
        # which CR was mid-flight when the process died (the stage marker):
        # refs at or before it consumed the claim's envelope and resume with
        # the wall-clock REMAINDER; refs after it never started, so they get
        # their own fresh envelope — exactly what the live path would have
        # handed them (its own design note: a shared group envelope would
        # hand later CRs whatever the first one left, possibly nothing)
        staged_ref = claim.stage.partition(":")[2]
        refs = claim.podmortems
        staged_idx = refs.index(staged_ref) if staged_ref in refs else len(refs)
        try:
            results = []
            for podmortem in podmortems:
                ref = podmortem.qualified_name()
                self.claims.note_stage(claim.key, f"resume:{ref}")
                if ref in refs and refs.index(ref) > staged_idx:
                    budget_s = self._deadline_total_for(podmortem)
                else:
                    # the resumed envelope is the smaller of the CR's own
                    # budget and what wall-clock says is left of the claim
                    budget_s = min(
                        self._deadline_total_for(podmortem),
                        self.claims.remaining_budget_s(claim),
                    )
                results.append(
                    await self.process_pod_failure(
                        pod, podmortem, failure_time=claim.failure_time,
                        deadline=Deadline.start(budget_s, clock=self._clock),
                    )
                )
        except BaseException:
            self.claims.release(claim.key)
            raise
        if any(result is not None for result in results):
            self.claims.mark_done(claim.key)
        else:
            self.claims.release(claim.key)
        return 1

    # ------------------------------------------------------------------
    async def process_pod_failure(
        self,
        pod: Pod,
        podmortem: Podmortem,
        *,
        failure_time: Optional[str] = None,
        deadline: Optional[Deadline] = None,
    ) -> Optional[AnalysisResult]:
        """The hot path (reference call stack §3.2).  Returns the analysis
        result, or None when collection failed outright.  Every stage spends
        the one ``deadline`` envelope (born at claim; a fresh default is
        created for direct callers).

        The whole run is one trace (obs/): a span per stage,
        the trace id stamped into ``status.recentFailures[]``, and — when
        the analysis ends ``deadline-exceeded``, a breaker opens, or the
        engine reports a device error — a black-box dump of the full span
        tree plus the deadline ledger and any active fault-plan seed."""
        if deadline is None:
            deadline = self._deadline_for(podmortem)
        root: Optional[Span] = None
        result: Optional[AnalysisResult] = None
        try:
            with self.tracer.trace(
                "analysis",
                attributes={
                    "pod": pod.qualified_name(),
                    "podmortem": podmortem.qualified_name(),
                    "failure_time": failure_time or "",
                    "deadline_total_s": round(deadline.total_s, 3),
                },
            ) as root:
                # SLO admission at trace birth, keyed by the trace id so
                # ledger records join span trees on one id; the class
                # rides the pod's podmortem.io/slo-class annotation
                self.slo_ledger.admit(
                    root.trace_id,
                    cls=(pod.metadata.annotations or {}).get(
                        "podmortem.io/slo-class"
                    ),
                )
                result = await self._analyze(
                    pod, podmortem, failure_time=failure_time, deadline=deadline,
                    trace_root=root,
                )
            return result
        finally:
            # in a FINALLY so a flagged trace dumps even when the analysis
            # raises or is cancelled mid-flight (operator shutdown after a
            # breaker opened) — hard failures are exactly when the
            # forensic record matters.  The trace is fully assembled
            # (recorded by the tracer on context exit) before this reads it.
            if root is not None:
                reason = root.attributes.get("blackbox")
                if reason:
                    self._dump_black_box(root, reason, deadline)
                # settle the SLO record exactly once per analysis, in the
                # finally so cancelled/raised runs are accounted too.
                # Outcome precedence: an explicit backend override (the
                # storm harness stamps "shed" when the router refused the
                # dispatch) > the black-box deadline verdict > whether a
                # result was stored at all.
                outcome = root.attributes.get(SLO_OUTCOME_ATTR)
                if outcome is None:
                    if reason == "deadline-exceeded":
                        outcome = "deadline-exceeded"
                    elif result is not None:
                        outcome = "completed"
                    else:
                        outcome = "failed"
                self.slo_ledger.finish(
                    root.trace_id,
                    outcome=outcome,
                    tokens=int(root.attributes.get("ai_tokens") or 0),
                    replica=root.attributes.get("replica") or None,
                    stages=stage_durations(root),
                )

    def _dump_black_box(self, root: Span, reason: str, deadline: Deadline) -> None:
        """Dump the completed trace with its failure context: the deadline
        ledger and, when a chaos fault plan is active on the api seam, its
        seed + fired-fault fingerprint so the dump names the exact replay."""
        recorder = getattr(self.tracer, "recorder", None)
        if recorder is None:
            return
        extra: dict = {
            "deadline": {
                "total_s": round(deadline.total_s, 3),
                "elapsed_s": round(deadline.elapsed(), 3),
                "remaining_s": round(deadline.remaining(), 3),
            },
        }
        plan = getattr(self.api, "fault_plan", None)
        if plan is not None:
            extra["fault_plan"] = {
                "seed": plan.seed,
                "fired": len(plan.trace()),
                "fingerprint": plan.fingerprint(),
            }
        recorder.black_box(root.trace_id, reason, extra)

    async def _analyze(
        self,
        pod: Pod,
        podmortem: Podmortem,
        *,
        failure_time: Optional[str],
        deadline: Deadline,
        trace_root: Span,
    ) -> Optional[AnalysisResult]:
        started = time.perf_counter()
        self.metrics.incr("failures_detected")
        with self.tracer.span("emit.detected"):
            await self.events.emit_failure_detected(pod, podmortem)

        # -- collect (gets a SLICE of the budget) --------------------------
        collect_s = deadline.slice(
            self.config.collect_budget_fraction, floor_s=1.0
        )
        try:
            with self.tracer.span("collect", budget_s=round(collect_s, 3)):
                with self.metrics.timed("collect"):
                    failure = await asyncio.wait_for(
                        self.collect_failure_data(
                            pod,
                            deadline=Deadline.start(collect_s, clock=self._clock),
                        ),
                        timeout=collect_s,
                    )
        except asyncio.TimeoutError:
            log.error("log collection for %s exceeded its %.1fs budget slice",
                      pod.qualified_name(), collect_s)
            if deadline.expired:  # the ENVELOPE died during collection
                annotate_root("blackbox", "deadline-exceeded", overwrite=False)
            await self.events.emit_analysis_error(
                pod, podmortem,
                f"log collection exceeded its {collect_s:.1f}s budget slice",
            )
            self.metrics.incr("collect_timeouts")
            return None
        except ApiError as exc:
            log.error("failed collecting failure data for %s: %s", pod.qualified_name(), exc)
            await self.events.emit_analysis_error(pod, podmortem, f"log collection failed: {exc}")
            self.metrics.incr("collect_errors")
            return None

        # -- parse (pattern match on the host and the card; capped by the remainder) --------
        parse_s = min(self.config.parse_timeout_s, max(0.1, deadline.remaining()))
        try:
            with self.tracer.span("parse", budget_s=round(parse_s, 3)):
                with self.metrics.timed("parse"):
                    result = await asyncio.wait_for(
                        asyncio.to_thread(self.engine.analyze, failure),
                        timeout=parse_s,
                    )
        except asyncio.TimeoutError:
            # attribute the timeout honestly: a deadline-bound cap means
            # the BUDGET killed the parse, not the pattern engine
            budget_bound = parse_s < self.config.parse_timeout_s
            message = (
                f"pattern analysis exceeded the remaining deadline budget "
                f"({parse_s:.1f}s)"
                if budget_bound
                else f"pattern analysis timed out after {parse_s:.0f}s"
            )
            log.error("%s (%s)", message, pod.qualified_name())
            if budget_bound:
                annotate_root("blackbox", "deadline-exceeded", overwrite=False)
            await self.events.emit_analysis_error(pod, podmortem, message)
            self.metrics.incr("deadline_exceeded" if budget_bound else "parse_errors")
            return None
        except Exception as exc:  # noqa: BLE001 - degrade, never crash the watch
            log.exception("pattern analysis failed for %s", pod.qualified_name())
            await self.events.emit_analysis_error(pod, podmortem, f"pattern analysis failed: {exc}")
            self.metrics.incr("parse_errors")
            return None

        # -- recall (incident memory, docs/MEMORY.md) ----------------------
        # exact fingerprint hit: reuse the stored analysis and SKIP the AI
        # leg — the dominant cost for a fleet-wide recurring failure; near
        # hit: carry the top-k prior incidents into the prompt; miss: full
        # analysis, remembered below
        ai_configured = (
            podmortem.spec.ai_analysis_enabled
            and podmortem.spec.ai_provider_ref is not None
        )
        # reuse identity is the provider ref PLUS a hash of the spec
        # fields that shape its output: a hit must hand this CR an
        # analysis its own CURRENT provider would have generated — never
        # another CR's text, and never a stale one from before the
        # AIProvider was edited (new model/template regenerates).  The CR's
        # cachingEnabled opt-out is honoured exactly like ResponseCache.
        provider_ref_key: Optional[str] = None
        provider: Optional[AIProvider] = None
        caching_ok = False
        recall: Optional[RecallDecision] = None
        recurrence: Optional[FailureRecurrence] = None
        ai_response: Optional[AIResponse] = None
        reused = False
        with self.tracer.span("recall") as recall_span:
            if ai_configured:
                # its own child span: the identity fetch is an apiserver
                # GET, and its latency must never read as incident-memory
                # time in the trace
                with self.tracer.span("provider.identity"):
                    provider, provider_ref_key = await self._resolve_provider_identity(
                        podmortem, deadline=deadline
                    )
                caching_ok = provider is not None and provider.spec.caching_enabled
            if self.memory is not None:
                with self.metrics.timed("recall"):
                    # embedding may be a neural encoder; keep the loop free
                    recall = await asyncio.to_thread(
                        self.memory.recall, result, pod,
                        allow_reuse=ai_configured and caching_ok,
                        provider_ref=provider_ref_key,
                        trace_id=trace_root.trace_id,
                    )
                recall_span.set(kind=recall.kind)
                if recall.prior_trace_id:
                    # a recurrence links back to its prior analysis's trace
                    recall_span.set(prior_trace_id=recall.prior_trace_id)
                if recall.kind == RECALL_HIT:
                    incident = recall.incident
                    reused = True
                    self.metrics.incr("recall_hit")
                    # the hit RETURNS the unused deadline budget: everything
                    # the AI leg would have spent is handed back (recorded so
                    # the decode-seconds saved are visible on /metrics)
                    self.metrics.record(
                        "recall_budget_returned", deadline.remaining() * 1e3
                    )
                    ai_response = AIResponse(
                        explanation=recall.analysis.explanation,
                        provider_id=recall.analysis.provider_id,
                        model_id=recall.analysis.model_id,
                        cached=True,
                    )
                    recurrence = FailureRecurrence(
                        fingerprint=incident.fingerprint,
                        seen_count=incident.seen_count,
                        first_seen=incident.first_seen,
                        reused_analysis=True,
                    )
                elif recall.kind == RECALL_NEAR:
                    self.metrics.incr("recall_near")
                else:
                    self.metrics.incr("recall_miss")

        # -- explain (the AI leg gets whatever budget is left) -------------
        with self.tracer.span(
            "explain", reused=reused, configured=ai_configured
        ) as explain_span:
            if reused:
                pass  # cached analysis; no generation
            elif ai_configured:
                if deadline.expired:
                    # the budget died before the AI leg even started: degrade
                    # to pattern-only NOW instead of dispatching a doomed call
                    message = (
                        f"analysis deadline ({deadline.total_s:.0f}s) exhausted "
                        "before AI generation; storing pattern-only result"
                    )
                    log.warning("%s (%s)", message, pod.qualified_name())
                    await self.events.emit_analysis_error(pod, podmortem, message)
                    ai_response = AIResponse(
                        error=message, deadline_outcome="deadline-exceeded"
                    )
                else:
                    priors = [
                        PriorIncident(
                            fingerprint=inc.fingerprint,
                            score=round(score, 4),
                            seen_count=inc.seen_count,
                            severity=inc.severity,
                            last_seen=inc.last_seen,
                            explanation=inc.explanation,
                        )
                        for inc, score in (recall.neighbors if recall else [])
                    ]
                    ai_response = await self._generate_explanation(
                        pod, podmortem, result, failure, deadline=deadline,
                        prior_incidents=priors, provider=provider,
                        # the failure-class fingerprint is the router's
                        # affinity key: recurrences of one incident land
                        # on the replica whose recall cache is hot
                        fingerprint=(
                            recall.fingerprint.digest if recall is not None
                            else None
                        ),
                        # overload-value signals (router/value.py): the
                        # SLO class weights the shed decision and the
                        # recall-hit probability discounts the expected
                        # cost — recalled work is shed last
                        slo_class=(pod.metadata.annotations or {}).get(
                            "podmortem.io/slo-class"
                        ),
                        recall_p=(
                            IncidentMemory.hit_probability(recall)
                            if recall is not None else 0.0
                        ),
                    )
                self._record_deadline_outcome(ai_response)
                if ai_response is not None:
                    if ai_response.deadline_outcome:
                        explain_span.set(outcome=ai_response.deadline_outcome)
                    if ai_response.deadline_outcome == "deadline-exceeded":
                        # the terminal deadline outcome — the black-box trigger
                        annotate_root(
                            "blackbox", "deadline-exceeded", overwrite=False
                        )
                    if ai_response.deadline_outcome in ("degraded", "shed"):
                        # the overload ladder's verdict settles the SLO
                        # record under its own outcome (the ledger's
                        # finally reads this override)
                        annotate_root(
                            SLO_OUTCOME_ATTR, ai_response.deadline_outcome,
                            overwrite=False,
                        )
                    if ai_response.error:
                        explain_span.status = "error"
                        explain_span.error = ai_response.error[:300]
                    # the SLO ledger's goodput + per-replica attribution
                    # read these off the root at settlement
                    if ai_response.completion_tokens:
                        trace_root.set(ai_tokens=ai_response.completion_tokens)
                    if ai_response.replica_id:
                        trace_root.set(replica=ai_response.replica_id)
            elif podmortem.spec.ai_analysis_enabled:
                log.info("podmortem %s has no aiProviderRef; storing pattern-only result",
                         podmortem.qualified_name())

        # -- remember (a hit already bumped its recurrence counters) -------
        if self.memory is not None and recall is not None:
            with self.tracer.span("remember"):
                if not reused:
                    incident = await asyncio.to_thread(
                        self.memory.insert, recall.fingerprint, result, pod, ai_response,
                        related=[inc.fingerprint for inc, _ in recall.neighbors],
                        # recall() already counted this sighting iff it found
                        # the digest; otherwise a racing concurrent first
                        # sighting is counted by the upsert itself
                        seen_recorded=recall.incident is not None,
                        # cachingEnabled=false also means "don't remember my
                        # generations": recurrence is tracked, text is not
                        provider_ref=provider_ref_key if caching_ok else None,
                        cacheable=caching_ok,
                        trace_id=trace_root.trace_id,
                    )
                    if incident is not None:  # weak fingerprints are never stored
                        recurrence = FailureRecurrence(
                            fingerprint=incident.fingerprint,
                            seen_count=incident.seen_count,
                            first_seen=incident.first_seen,
                            reused_analysis=False,
                        )
                # snapshot into the OPERATOR's namespace (where restore reads
                # it, app.py) — never the CR's, or multi-namespace fleets
                # scatter partial snapshots that restore can't find.  Hits
                # flush too: recurrence counters must survive a restart.
                await self.memory.maybe_flush_to_configmap(
                    self.api, getattr(self.api, "namespace", None) or "default"
                )

        # -- store + emit --------------------------------------------------
        with self.tracer.span("store"):
            with self.metrics.timed("store"):
                await self.storage.store_analysis_results(
                    result, ai_response, pod, podmortem,
                    failure_time=failure_time, recurrence=recurrence,
                    trace_id=trace_root.trace_id,
                )
        explanation = (
            ai_response.explanation
            if ai_response is not None and ai_response.explanation
            else result.pattern_summary_line()
        )
        with self.tracer.span("emit.complete"):
            await self.events.emit_analysis_complete(pod, podmortem, result, explanation)
        total_ms = (time.perf_counter() - started) * 1e3
        self.metrics.record("pipeline_total", total_ms)
        self.metrics.incr("analyses_completed")
        if result.timings is not None:
            result.timings.total_ms = round(total_ms, 3)
        return result

    # ------------------------------------------------------------------
    async def collect_failure_data(
        self, pod: Pod, *, deadline: Optional[Deadline] = None
    ) -> PodFailureData:
        """Pod log + namespace events for the pod
        (reference collectPodFailureData, PodFailureWatcher.java:310-345).
        Prefers the previous container's log when the pod restarted (the
        crash evidence lives there, not in the fresh container).  Each
        apiserver call spends from ``deadline`` (the collect slice of the
        analysis envelope); without one the calls are unbounded — callers
        on the analysis path always pass the budget."""
        restarted = any(
            cs.restart_count > 0 for cs in (pod.status.container_statuses if pod.status else [])
        )

        def residue() -> Optional[float]:
            return deadline.remaining() if deadline is not None else None

        logs = ""
        try:
            logs = await asyncio.wait_for(
                self.api.get_log(
                    pod.metadata.name,
                    pod.metadata.namespace,
                    previous=restarted,
                    tail_bytes=self.config.log_tail_bytes,
                ),
                timeout=residue(),
            )
        except NotFoundError:
            raise
        except ApiError as exc:
            log.warning("log fetch failed for %s (%s); continuing with events only",
                        pod.qualified_name(), exc)
        events: list[KubeEvent] = []
        try:
            raw_events = await asyncio.wait_for(
                self.api.list("Event", namespace=pod.metadata.namespace),
                timeout=residue(),
            )
            for raw in raw_events:
                event = KubeEvent.parse(raw)
                if event.regarding is None or event.regarding.name != pod.metadata.name:
                    continue
                # never feed our own analysis events back into analysis — the
                # explanation quotes log evidence, which would re-match the
                # patterns and echo-amplify on every restart
                if event.reporting_controller == self.config.reporting_controller:
                    continue
                events.append(event)
        except (ApiError, asyncio.TimeoutError) as exc:
            # events are best-effort evidence: a timeout here degrades to
            # logs-only instead of burning the rest of the collect slice
            log.debug("event list failed for %s: %s", pod.qualified_name(), exc)
        return PodFailureData(pod=pod, logs=logs, events=events, collection_time=now_iso())

    # ------------------------------------------------------------------
    async def _resolve_provider_identity(
        self, podmortem: Podmortem, *, deadline: Optional[Deadline] = None
    ) -> "tuple[Optional[AIProvider], Optional[str]]":
        """Fetch the CR's AIProvider and derive the reuse-identity key:
        ``namespace/name@spec-hash`` over the spec fields that shape the
        generated text (the same identity basis as ResponseCache.key).
        Fetch failures — including the ``deadline`` residue expiring —
        return (None, bare ref key): recall proceeds reuse-disabled and the
        AI leg's own fetch reports the error."""
        import hashlib
        import json

        ref = podmortem.spec.ai_provider_ref
        namespace = ref.namespace or podmortem.metadata.namespace or "default"
        ref_key = f"{namespace}/{ref.name}"
        try:
            provider_dict = await asyncio.wait_for(
                self.api.get("AIProvider", ref.name, namespace),
                timeout=deadline.remaining() if deadline is not None else None,
            )
        except (ApiError, asyncio.TimeoutError):
            return None, ref_key
        provider = AIProvider.parse(provider_dict)
        spec = provider.spec
        basis = json.dumps(
            {
                "provider": spec.provider_id,
                "url": spec.api_url,
                "model": spec.model_id,
                "template": spec.prompt_template,
                "max_tokens": spec.max_tokens,
                "temperature": spec.temperature,
                # additionalConfig selects LoRA adapters and guided-decoding
                # constraints — output-shaping, so part of the identity
                "extra": dict(sorted(spec.additional_config.items())),
            },
            sort_keys=True,
        )
        digest = hashlib.sha256(basis.encode()).hexdigest()[:12]
        return provider, f"{ref_key}@{digest}"

    # ------------------------------------------------------------------
    def _note_breaker_trip(self, breaker_key: str) -> None:
        """One place counts a breaker trip AND flags the ambient trace for
        a black-box dump — an open breaker is exactly the moment the
        per-request timeline matters (docs/OBSERVABILITY.md)."""
        self.metrics.incr("circuit_opened")
        annotate_root("blackbox", "breaker-open", overwrite=False)
        annotate_root("breaker", breaker_key)

    # ------------------------------------------------------------------
    def _record_deadline_outcome(self, ai_response: Optional[AIResponse]) -> None:
        """One place turns the AI leg's budget outcome into counters (the
        Prometheus surface: podmortem_deadline_*_total).  Backends that
        produced text without reporting an outcome count as completed."""
        if ai_response is None:
            return
        if ai_response.deadline_outcome is None and ai_response.explanation:
            ai_response.deadline_outcome = "completed"
        outcome = ai_response.deadline_outcome
        if outcome == "completed":
            self.metrics.incr("deadline_completed")
        elif outcome == "truncated":
            self.metrics.incr("deadline_truncated")
        elif outcome == "degraded":
            self.metrics.incr("deadline_degraded")
        elif outcome == "deadline-exceeded":
            self.metrics.incr("deadline_exceeded")

    # ------------------------------------------------------------------
    async def _generate_explanation(
        self,
        pod: Pod,
        podmortem: Podmortem,
        result: AnalysisResult,
        failure: PodFailureData,
        *,
        deadline: Optional[Deadline] = None,
        prior_incidents: Optional[list[PriorIncident]] = None,
        provider: Optional[AIProvider] = None,
        fingerprint: Optional[str] = None,
        slo_class: Optional[str] = None,
        recall_p: float = 0.0,
    ) -> AIResponse:
        ref = podmortem.spec.ai_provider_ref
        namespace = ref.namespace or podmortem.metadata.namespace or "default"
        with self.tracer.span("provider.resolve", ref=f"{namespace}/{ref.name}"):
            if provider is None:  # not pre-fetched by the recall identity step
                try:
                    provider_dict = await asyncio.wait_for(
                        self.api.get("AIProvider", ref.name, namespace),
                        timeout=(
                            deadline.remaining() if deadline is not None else None
                        ),
                    )
                except NotFoundError:
                    message = f"AIProvider {namespace}/{ref.name} not found"
                    log.warning("%s (podmortem %s)", message, podmortem.qualified_name())
                    await self.events.emit_analysis_error(pod, podmortem, message)
                    self.metrics.incr("provider_missing")
                    return AIResponse(error=message)
                except (ApiError, asyncio.TimeoutError) as exc:
                    message = (
                        f"AIProvider fetch failed: "
                        f"{str(exc) or 'deadline budget exhausted'}"
                    )
                    await self.events.emit_analysis_error(pod, podmortem, message)
                    return AIResponse(error=message)
                provider = AIProvider.parse(provider_dict)
            provider_config = await resolve_provider_config(
                self.api, provider, deadline=deadline
            )
        remaining = deadline.remaining() if deadline is not None else None
        request = AnalysisRequest(
            analysis_result=result, provider_config=provider_config,
            failure_data=failure, deadline_s=remaining,
            prior_incidents=list(prior_incidents or []),
            fingerprint=fingerprint,
            slo_class=slo_class, recall_p=recall_p,
        )

        cache_key = None
        if provider_config.caching_enabled:
            cache_key = ResponseCache.key(request)
            cached = self.cache.get(cache_key)
            if cached is not None:
                self.metrics.incr("ai_cache_hits")
                cached_copy = AIResponse(**{**cached.__dict__, "cached": True})
                return cached_copy

        # circuit breaker: a dead backend must stop burning the deadline
        # budget — skip the call outright while its breaker is open and
        # fall through the existing degradation ladder (pattern-only store).
        # Keyed by providerId AND apiUrl: two CRs sharing a providerId but
        # pointing at different HTTP endpoints are different backends, and
        # one dead endpoint must not blackhole the healthy one.
        breaker_key = provider_config.provider_id or "template"
        if provider_config.api_url:
            breaker_key = f"{breaker_key}@{provider_config.api_url}"
        breaker = self.breakers.for_provider(breaker_key)
        if not breaker.allow():
            message = f"circuit open for provider {breaker_key}: AI call skipped"
            log.warning("%s (%s)", message, pod.qualified_name())
            await self.events.emit_analysis_error(pod, podmortem, message)
            self.metrics.incr("circuit_open_skips")
            return AIResponse(error=message, provider_id=provider_config.provider_id)

        try:
            backend = self.providers.resolve(provider_config.provider_id)
        except ProviderError as exc:
            await self.events.emit_analysis_error(pod, podmortem, str(exc))
            self.metrics.incr("provider_errors")
            if breaker.record_failure():
                self._note_breaker_trip(breaker_key)
            return AIResponse(error=str(exc))

        # the AI leg gets the REMAINDER of the envelope, never more than
        # the flat reference budget (ai_timeout_s, application.properties)
        timeout_s = self.config.ai_timeout_s
        if remaining is not None:
            timeout_s = min(timeout_s, remaining)
        try:
            with self.tracer.span(
                "ai_generate",
                provider=provider_config.provider_id or "template",
                budget_s=round(timeout_s, 3),
            ) as gen_span:
                with self.metrics.timed("ai_generate"):
                    response = await asyncio.wait_for(
                        backend.generate(request), timeout=timeout_s
                    )
                # routing forensics (the JAX package's router): which replica
                # served this leg, and whether a cross-replica requeue
                # saved it — mirrored into the stage metrics so the
                # counter surface shows failovers without span digging
                if response.replica_id:
                    gen_span.set(replica=response.replica_id)
                if response.requeues:
                    gen_span.set(requeues=response.requeues)
                    self.metrics.incr("analysis_requeued")
        except asyncio.TimeoutError:
            budget_bound = remaining is not None and remaining < self.config.ai_timeout_s
            message = (
                f"AI generation exceeded the remaining deadline budget "
                f"({timeout_s:.1f}s)"
                if budget_bound
                else f"AI generation timed out after {timeout_s:.0f}s"
            )
            await self.events.emit_analysis_error(pod, podmortem, message)
            self.metrics.incr("ai_timeouts")
            # budget-bound timeouts are OUR deadline pressure, not backend
            # health: counting them would trip the breaker on a healthy
            # backend whenever upstream stages run long
            if not budget_bound and breaker.record_failure():
                self._note_breaker_trip(breaker_key)
            return AIResponse(
                error=message, provider_id=provider_config.provider_id,
                deadline_outcome="deadline-exceeded" if budget_bound else None,
            )
        except Exception as exc:  # noqa: BLE001 - degrade to pattern-only
            log.exception("AI generation failed for %s", pod.qualified_name())
            await self.events.emit_analysis_error(pod, podmortem, f"AI generation failed: {exc}")
            self.metrics.incr("ai_errors")
            if breaker.record_failure():
                self._note_breaker_trip(breaker_key)
            return AIResponse(error=str(exc), provider_id=provider_config.provider_id)

        if response.error:
            await self.events.emit_analysis_error(pod, podmortem, response.error)
            self.metrics.incr("ai_errors")
            # backend-attributed failures only: a deadline-exceeded outcome
            # means the BUDGET killed the leg, not the provider
            if response.deadline_outcome != "deadline-exceeded" and \
                    breaker.record_failure():
                self._note_breaker_trip(breaker_key)
        else:
            breaker.record_success()
            if cache_key is not None:
                self.cache.put(cache_key, response)
        return response
