"""Kubernetes Events — the system's user-facing result channel.

Parity with the reference's EventService (SURVEY.md §5 observability):

- three lifecycle events: ``PodFailureDetected`` (Warning),
  ``PodmortemAnalysisComplete`` (Normal), ``PodmortemAnalysisError``
  (Warning) (reference EventService.java:45-128);
- each emitted to three targets: the failed pod, its owning Deployment
  (found by chasing Pod -> ReplicaSet -> Deployment owner references,
  :224-256), and the Podmortem CR;
- 1024-byte message budget that preserves the "Root Cause" / "Fix"
  sections of AI output when truncating (:81-91,278-305);
- ``reportingController: podmortem.operator`` (:32).

The port's own copy of ``operator_tpu/operator/events.py``.
"""

from __future__ import annotations

import asyncio
import logging
import re
import uuid
from typing import Optional

from ..schema.analysis import AnalysisResult
from ..schema.crds import Podmortem
from ..schema.kube import Event, ObjectReference, Pod
from ..schema.meta import K8sObject, now_iso
from ..utils.config import OperatorConfig
from .kubeapi import ApiError, KubeApi, NotFoundError

log = logging.getLogger(__name__)

REASON_FAILURE_DETECTED = "PodFailureDetected"
REASON_ANALYSIS_COMPLETE = "PodmortemAnalysisComplete"
REASON_ANALYSIS_ERROR = "PodmortemAnalysisError"


def _section(text: str, heading: str) -> Optional[str]:
    """Extract a ``heading: ...`` section from AI output (up to the next
    heading-looking line or blank line block)."""
    pattern = re.compile(
        rf"(?im)^[#*\s]*{heading}[^\n:]*:?\s*\n?(.*?)(?=\n[#*\s]*[A-Z][\w /]+:|\n\s*\n|\Z)",
        re.DOTALL,
    )
    match = pattern.search(text)
    if not match:
        return None
    body = match.group(1).strip()
    return body or None


def truncate_message(text: str, limit: int = 1024) -> str:
    """Budgeted truncation that keeps the parts users act on
    (reference EventService.java:278-305: preserves Root Cause / Fix)."""
    if len(text) <= limit:
        return text
    root_cause = _section(text, "Root Cause")
    fix = _section(text, "(?:Suggested )?Fix")
    if root_cause or fix:
        parts = []
        if root_cause:
            parts.append(f"Root Cause: {root_cause}")
        if fix:
            parts.append(f"Fix: {fix}")
        composed = "\n".join(parts)
        if len(composed) <= limit:
            return composed
        return composed[: limit - 3] + "..."
    return text[: limit - 3] + "..."


class EventService:
    def __init__(self, api: KubeApi, config: Optional[OperatorConfig] = None) -> None:
        self.api = api
        self.config = config or OperatorConfig()

    # -- public emitters ---------------------------------------------------
    async def emit_failure_detected(self, pod: Pod, podmortem: Podmortem) -> None:
        message = (
            f"Pod failure detected in {pod.qualified_name()}; analysis started "
            f"(podmortem: {podmortem.metadata.name})"
        )
        await self._emit_all(REASON_FAILURE_DETECTED, "Warning", message, pod, podmortem)

    async def emit_analysis_complete(
        self,
        pod: Pod,
        podmortem: Podmortem,
        result: AnalysisResult,
        explanation: Optional[str],
    ) -> None:
        severity = result.summary.highest_severity or "NONE"
        header = (
            f"Analysis complete for {pod.qualified_name()} "
            f"[severity: {severity}, significant events: {result.summary.significant_events}]"
        )
        message = f"{header}\n{explanation}" if explanation else header
        await self._emit_all(REASON_ANALYSIS_COMPLETE, "Normal", message, pod, podmortem)

    async def emit_analysis_error(self, pod: Pod, podmortem: Podmortem, error: str) -> None:
        message = f"Analysis failed for {pod.qualified_name()}: {error}"
        await self._emit_all(REASON_ANALYSIS_ERROR, "Warning", message, pod, podmortem)

    # -- mechanics ---------------------------------------------------------
    async def _emit_all(
        self, reason: str, type_: str, message: str, pod: Pod, podmortem: Podmortem
    ) -> None:
        """Emit to pod + owning Deployment + CR; an individual emission
        failing must not break the pipeline (reference emits async off the
        event loop and logs failures, EventService.java:158-203)."""
        targets: list[K8sObject] = [pod]
        deployment = await self.find_owning_deployment(pod)
        if deployment is not None:
            targets.append(deployment)
        targets.append(podmortem)
        for target in targets:
            try:
                await self._emit(reason, type_, message, target)
            except (ApiError, asyncio.TimeoutError) as exc:
                log.warning("failed to emit %s to %s: %s", reason,
                            target.qualified_name(), str(exc) or "timed out")

    async def _emit(self, reason: str, type_: str, message: str, target: K8sObject) -> None:
        event = Event()
        event.metadata.name = self._event_name(target.metadata.name or "obj")
        event.metadata.namespace = target.metadata.namespace
        event.reason = reason
        event.type_ = type_
        event.note = truncate_message(message, self.config.event_message_limit)
        event.action = "Analyze"
        event.reporting_controller = self.config.reporting_controller
        event.reporting_instance = f"{self.config.reporting_controller}-0"
        event.event_time = now_iso()
        event.regarding = ObjectReference(
            api_version=target.api_version,
            kind=target.kind,
            name=target.metadata.name,
            namespace=target.metadata.namespace,
            uid=target.metadata.uid,
        )
        # bounded by the control-loop kube budget (graftlint GL003):
        # events are a best-effort surface — a wedged apiserver costs one
        # bounded attempt, never the analysis pipeline behind it
        await asyncio.wait_for(
            self.api.create("Event", event.to_dict()),
            timeout=self.config.kube_call_timeout_s,
        )

    @staticmethod
    def _event_name(target_name: str) -> str:
        # unique per occurrence (reference generateEventName :264)
        return f"podmortem.{target_name[:40]}.{uuid.uuid4().hex[:10]}"

    async def find_owning_deployment(self, pod: Pod) -> Optional[K8sObject]:
        """Pod -> ReplicaSet -> Deployment owner chase
        (reference EventService.java:224-256)."""
        from ..schema.kube import Deployment  # local to avoid cycle noise

        rs_ref = next(
            (ref for ref in pod.metadata.owner_references if ref.kind == "ReplicaSet"), None
        )
        if rs_ref is None or not pod.metadata.namespace:
            return None
        try:
            rs_dict = await asyncio.wait_for(
                self.api.get("ReplicaSet", rs_ref.name, pod.metadata.namespace),
                timeout=self.config.kube_call_timeout_s,
            )
        except NotFoundError:
            return None
        except (ApiError, asyncio.TimeoutError) as exc:
            log.debug("owner chase failed at ReplicaSet: %s", exc)
            return None
        from ..schema.kube import ReplicaSet

        rs = ReplicaSet.parse(rs_dict)
        deploy_ref = next(
            (ref for ref in rs.metadata.owner_references if ref.kind == "Deployment"), None
        )
        if deploy_ref is None:
            return None
        try:
            deploy_dict = await asyncio.wait_for(
                self.api.get("Deployment", deploy_ref.name, pod.metadata.namespace),
                timeout=self.config.kube_call_timeout_s,
            )
        except NotFoundError:
            return None
        except (ApiError, asyncio.TimeoutError) as exc:
            log.debug("owner chase failed at Deployment: %s", exc)
            return None
        return Deployment.parse(deploy_dict)
