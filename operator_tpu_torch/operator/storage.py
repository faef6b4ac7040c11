"""Durable result storage — pod annotations + Podmortem CR status history.

Behavioural parity with the reference's AnalysisStorageService:

- annotation keys ``podmortem.io/{analysis,severity,analyzed-at,monitor}``
  (reference AnalysisStorageService.java:42-46);
- full AI text stored when present, else the pattern summary line
  (:142-156);
- Podmortem ``status.recentFailures`` is a newest-first ring capped at 10
  (:48,286-333);
- optimistic-concurrency discipline: re-fetch latest, patch with its
  resourceVersion, on 409 retry up to 5 times with 100ms*2^n backoff
  (:74-76,179-187); 403 logs an RBAC warning and gives up (:188-193).

Unlike the reference — where the reconciler injects this service but never
calls it (PodmortemReconciler.java:50, SURVEY.md §3.3) — both detection
paths here share one pipeline, so poll-path results are stored too.

The port's own copy of ``operator_tpu/operator/storage.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..schema.analysis import AIResponse, AnalysisResult
from ..schema.crds import FailureRecurrence, PodFailureStatus, Podmortem
from ..schema.kube import Pod
from ..schema.meta import now_iso
from ..schema.serde import to_dict
from ..utils.config import OperatorConfig
from .kubeapi import ApiError, ConflictError, ForbiddenError, KubeApi, NotFoundError

log = logging.getLogger(__name__)

ANNOTATION_ANALYSIS = "podmortem.io/analysis"
ANNOTATION_SEVERITY = "podmortem.io/severity"
ANNOTATION_ANALYZED_AT = "podmortem.io/analyzed-at"
#: which failure (finishedAt) the stored analysis covers — the DURABLE
#: dedupe marker: even when the claim ledger (operator/claims.py) is
#: in-memory or freshly rotated, this annotation in etcd stops a restarted
#: watcher/reconciler from re-analyzing an already-annotated failure (the
#: reference accepts re-analysis after restart by design,
#: AnalysisStorageService.java:42-46; we do one better)
ANNOTATION_ANALYZED_FAILURE = "podmortem.io/analyzed-failure"
ANNOTATION_MONITOR = "podmortem.io/monitor"

#: the apiserver rejects objects whose TOTAL annotation BYTES exceed
#: 256 KiB (TotalAnnotationSizeLimitB); whatever the configured char cap
#: says, never let one analysis text get near it — a rejected patch loses
#: the whole store, a truncated text loses only its tail.  Enforced in
#: bytes because that is what the apiserver counts (CJK / box-drawing
#: evidence encodes at 3-4 bytes per char).
HARD_ANNOTATION_CEILING_BYTES = 240 * 1024

#: explicit truncation marker — a reader (or a tool diffing two stored
#: analyses) must be able to tell "short analysis" from "cap applied"
TRUNCATION_MARKER = "…[truncated]"


def truncate_marked(text: str, cap: int, *, max_bytes: Optional[int] = None) -> str:
    """Truncate ``text`` to at most ``cap`` chars — and, when ``max_bytes``
    is given, at most that many UTF-8 bytes — replacing the tail with an
    explicit marker when anything was cut.  Deterministic (equal inputs
    give byte-equal outputs — incident-memory reuse depends on it)."""
    out = text
    if 0 < cap < len(out):
        if cap <= len(TRUNCATION_MARKER):
            return TRUNCATION_MARKER[:cap]
        out = out[: cap - len(TRUNCATION_MARKER)] + TRUNCATION_MARKER
    if max_bytes is not None and len(out.encode("utf-8")) > max_bytes:
        budget = max(0, max_bytes - len(TRUNCATION_MARKER.encode("utf-8")))
        head = out.encode("utf-8")[:budget].decode("utf-8", errors="ignore")
        out = head + TRUNCATION_MARKER
    return out


class AnalysisStorageService:
    def __init__(self, api: KubeApi, config: Optional[OperatorConfig] = None) -> None:
        self.api = api
        self.config = config or OperatorConfig()

    # ------------------------------------------------------------------
    async def store_analysis_results(
        self,
        result: AnalysisResult,
        ai_response: Optional[AIResponse],
        pod: Pod,
        podmortem: Podmortem,
        *,
        failure_time: Optional[str] = None,
        recurrence: Optional[FailureRecurrence] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        """Store to both places; failures in one must not block the other
        (reference stores annotations first, then status :60-68).
        ``trace_id`` links the status entry to its flight-recorder trace
        (GET /traces/{id}, docs/OBSERVABILITY.md)."""
        explanation = self._explanation_text(result, ai_response)
        # the durable marker is only earned by a FINAL result: AI succeeded,
        # or AI was never requested (pattern-only is the intended outcome).
        # A degraded store (AI errored / provider refused) must stay
        # re-analyzable — e.g. the checkpoint gets mounted and the operator
        # restarts; stamping the marker then would suppress the retry forever
        final = ai_response is None or bool(ai_response.explanation)
        await self.store_to_pod_annotations(
            pod, result, explanation, failure_time=failure_time if final else None
        )
        await self.store_to_podmortem_status(
            podmortem, pod, result, ai_response, explanation,
            failure_time=failure_time, recurrence=recurrence,
            trace_id=trace_id,
        )

    @staticmethod
    def _explanation_text(result: AnalysisResult, ai_response: Optional[AIResponse]) -> str:
        if ai_response is not None and ai_response.explanation:
            return ai_response.explanation
        return result.pattern_summary_line()

    # ------------------------------------------------------------------
    async def store_to_pod_annotations(
        self,
        pod: Pod,
        result: AnalysisResult,
        explanation: str,
        *,
        failure_time: Optional[str] = None,
    ) -> bool:
        annotations = {
            ANNOTATION_ANALYSIS: truncate_marked(
                explanation, self.config.max_annotation_chars,
                max_bytes=HARD_ANNOTATION_CEILING_BYTES,
            ),
            ANNOTATION_SEVERITY: (result.summary.highest_severity or "NONE"),
            ANNOTATION_ANALYZED_AT: now_iso(),
        }
        if failure_time:
            annotations[ANNOTATION_ANALYZED_FAILURE] = failure_time

        async def attempt() -> bool:
            # each apiserver call bounded by the control-loop budget
            # (kube_call_timeout_s, graftlint GL003): a wedged connection
            # costs one bounded attempt, not the pipeline forever
            latest = await asyncio.wait_for(
                self.api.get("Pod", pod.metadata.name, pod.metadata.namespace),
                timeout=self.config.kube_call_timeout_s,
            )
            rv = latest.get("metadata", {}).get("resourceVersion")
            await asyncio.wait_for(
                self.api.patch(
                    "Pod",
                    pod.metadata.name,
                    pod.metadata.namespace,
                    {"metadata": {"annotations": annotations}},
                    resource_version=rv,
                ),
                timeout=self.config.kube_call_timeout_s,
            )
            return True

        return await self._with_conflict_retry(
            attempt, what=f"pod annotations {pod.qualified_name()}"
        )

    # ------------------------------------------------------------------
    async def store_to_podmortem_status(
        self,
        podmortem: Podmortem,
        pod: Pod,
        result: AnalysisResult,
        ai_response: Optional[AIResponse],
        explanation: str,
        *,
        failure_time: Optional[str] = None,
        recurrence: Optional[FailureRecurrence] = None,
        trace_id: Optional[str] = None,
    ) -> bool:
        if ai_response is not None and ai_response.explanation:
            analysis_status = "Analyzed"
        elif ai_response is not None and ai_response.error:
            analysis_status = "Failed"
        else:
            analysis_status = "PatternOnly"
        deadline_outcome = ai_response.deadline_outcome if ai_response else None
        if deadline_outcome == "deadline-exceeded":
            # the budget — not the backend — killed the AI leg; operators
            # alert on this string (and podmortem_deadline_exceeded_total)
            analysis_status = "deadline-exceeded"
        elif deadline_outcome == "degraded":
            # the overload ladder truncated analysis depth but the leg
            # still produced text — a DISTINCT terminal status, not a
            # deadline miss (podmortem_deadline_degraded_total)
            analysis_status = "degraded"
        entry = PodFailureStatus(
            pod_name=pod.metadata.name,
            pod_namespace=pod.metadata.namespace,
            failure_time=failure_time or now_iso(),
            analysis_status=analysis_status,
            explanation=truncate_marked(
                explanation, self.config.max_status_explanation_chars
            ),
            severity=result.summary.highest_severity,
            deadline_outcome=deadline_outcome,
            recurrence=recurrence,
            trace_id=trace_id,
        )

        async def attempt() -> bool:
            latest = await asyncio.wait_for(
                self.api.get(
                    "Podmortem", podmortem.metadata.name, podmortem.metadata.namespace
                ),
                timeout=self.config.kube_call_timeout_s,
            )
            rv = latest.get("metadata", {}).get("resourceVersion")
            status = latest.get("status") or {}
            existing = list(status.get("recentFailures") or [])
            # IDEMPOTENT store: at-least-once execution (crash-resume,
            # operator/claims.py — a claim that died after storing replays)
            # must yield exactly-once status entries.  Identity is
            # (pod, failureTime) — the same triple that keys the claim.
            payload = to_dict(entry)
            duplicate_index: Optional[int] = None
            for i, prior in enumerate(existing):
                if (
                    prior.get("podName") == entry.pod_name
                    and prior.get("podNamespace") == entry.pod_namespace
                    and prior.get("failureTime") == entry.failure_time
                ):
                    duplicate_index = i
                    break
            if duplicate_index is not None:
                prior = existing[duplicate_index]
                if prior.get("traceId") and prior.get("traceId") == entry.trace_id:
                    # the SAME analysis already landed (a retried patch whose
                    # first attempt actually succeeded): nothing to write
                    return True
                # a resumed analysis supersedes the partial entry in place —
                # replace, never append, so the ring holds one entry per
                # failure no matter how many times the claim replays
                existing[duplicate_index] = payload
                failures = existing
            else:
                failures = [payload] + existing
            failures = failures[: self.config.max_recent_failures]  # ring of 10
            status.update(
                {
                    "recentFailures": failures,
                    "lastUpdateTime": now_iso(),
                }
            )
            await asyncio.wait_for(
                self.api.patch_status(
                    "Podmortem",
                    podmortem.metadata.name,
                    podmortem.metadata.namespace,
                    status,
                    resource_version=rv,
                ),
                timeout=self.config.kube_call_timeout_s,
            )
            return True

        return await self._with_conflict_retry(
            attempt, what=f"podmortem status {podmortem.qualified_name()}"
        )

    # ------------------------------------------------------------------
    async def _with_conflict_retry(self, attempt, what: str) -> bool:
        """Re-fetch + patch, retrying 409s with exponential backoff
        (reference :74-76,179-193)."""
        retries = self.config.conflict_max_retries
        for i in range(retries):
            try:
                return await attempt()
            except ConflictError:
                if i == retries - 1:
                    log.error("giving up storing %s after %d conflicts", what, retries)
                    return False
                delay = self.config.conflict_backoff_base_s * (2**i)
                log.debug("409 storing %s; retry %d in %.0fms", what, i + 1, delay * 1e3)
                await asyncio.sleep(delay)
            except ForbiddenError as exc:
                log.warning(
                    "RBAC forbids storing %s (%s); grant patch on the target resource", what, exc
                )
                return False
            except NotFoundError:
                log.info("target of %s is gone; skipping storage", what)
                return False
            except asyncio.TimeoutError:
                # the per-call kube budget (kube_call_timeout_s) expired:
                # storing is best-effort — give up on this attempt rather
                # than let a wedged apiserver stall the pipeline
                log.error("timed out storing %s (kube_call_timeout_s)", what)
                return False
            except ApiError as exc:
                log.error("failed storing %s: %s", what, exc)
                return False
        return False
