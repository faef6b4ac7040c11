"""Poll-path reconcilers for Podmortem and AIProvider CRs.

PodmortemReconciler is the deliberate redundancy the reference maintains
(SURVEY.md §3.3): the watcher gives real-time detection, the reconciler
catches failures that happened while the watcher was down.  Differences from
the reference, both fixes: it reuses the shared AnalysisPipeline (so results
are *stored*, not just logged — the reference's reconcile path never calls
its storage service), and failure dedupe is shared with the watcher via the
pipeline-level dedupe map passed in by the app.

AIProviderReconciler is net-new: the reference declares AIProvider status
(phase Pending/Ready/Failed, aiprovider-crd.yaml:67-69) but ships no
reconciler for it (SURVEY.md §2.1); here specs are validated and status is
kept truthful.

The port's own copy of ``operator_tpu/operator/reconciler.py``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..schema.crds import AIProvider, Podmortem
from ..schema.kube import Pod
from ..schema.meta import now_iso
from ..utils.config import OperatorConfig
from ..utils.timing import METRICS, MetricsRegistry
from .kubeapi import ApiError, ConflictError, KubeApi, NotFoundError
from .pipeline import AnalysisPipeline
from .providers import ProviderRegistry, default_registry
from .watcher import get_failure_time, has_pod_failed

log = logging.getLogger(__name__)


class PodmortemReconciler:
    def __init__(
        self,
        api: KubeApi,
        pipeline: AnalysisPipeline,
        *,
        config: Optional[OperatorConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.api = api
        self.pipeline = pipeline
        self.config = config or OperatorConfig()
        self.metrics = metrics or METRICS

    # ------------------------------------------------------------------
    async def reconcile(self, podmortem: Podmortem) -> None:
        """One reconcile pass (reference PodmortemReconciler.reconcile :72).
        Failure dedupe is the pipeline's shared map, so a failure the watcher
        already handled is not re-analysed here (and vice versa)."""
        name = podmortem.qualified_name()
        try:
            pods = await self._find_matching_pods(podmortem)
            failed = [pod for pod in pods if has_pod_failed(pod)]
            log.debug("reconcile %s: %d pods, %d failed", name, len(pods), len(failed))
            if failed:
                await self._patch_phase(
                    podmortem, "Processing", f"analysing {len(failed)} failed pod(s)"
                )
            for pod in failed:
                failure_time = get_failure_time(pod) or "unknown"
                await self.pipeline.process_failure_group(
                    pod, [podmortem], failure_time=failure_time
                )
            await self._patch_phase(podmortem, "Ready", f"monitoring; {len(pods)} pod(s) match")
            self.metrics.incr("reconciles")
        except ApiError as exc:
            log.error("reconcile %s failed: %s", name, exc)
            try:
                await self._patch_phase(podmortem, "Error", str(exc))
            except ApiError:
                pass
            self.metrics.incr("reconcile_errors")

    async def _find_matching_pods(self, podmortem: Podmortem) -> list[Pod]:
        """LIST pods by selector across namespaces (reference :105-111 lists
        any-namespace; the allowlist still applies)."""
        raw_pods = await self.api.list("Pod", label_selector=podmortem.spec.pod_selector)
        allow = self.config.watch_namespaces
        pods = [Pod.parse(raw) for raw in raw_pods]
        if allow:
            pods = [pod for pod in pods if pod.metadata.namespace in allow]
        return pods

    async def _patch_phase(self, podmortem: Podmortem, phase: str, message: str) -> None:
        """Patch status only on actual transition — an unconditional write per
        sweep would churn resourceVersion and wake every watcher for nothing."""
        try:
            current = await self.api.get(
                "Podmortem", podmortem.metadata.name, podmortem.metadata.namespace
            )
            status = current.get("status") or {}
            if status.get("phase") == phase and status.get("message") == message:
                return
            await self.api.patch_status(
                "Podmortem",
                podmortem.metadata.name,
                podmortem.metadata.namespace,
                {
                    "phase": phase,
                    "message": message,
                    "lastUpdateTime": now_iso(),
                    "observedGeneration": podmortem.metadata.generation,
                },
            )
        except (NotFoundError, ConflictError) as exc:
            log.debug("phase patch skipped for %s: %s", podmortem.qualified_name(), exc)

    # ------------------------------------------------------------------
    async def run(self, stop: asyncio.Event) -> None:
        """Periodic resync of all Podmortem CRs (the operator-sdk resync
        role).  Event-driven reconcile rides the watcher; this loop is the
        catch-up sweep."""
        while not stop.is_set():
            try:
                for raw in await self.api.list("Podmortem"):
                    if stop.is_set():
                        return
                    await self.reconcile(Podmortem.parse(raw))
            except ApiError as exc:
                log.warning("podmortem resync list failed: %s", exc)
            try:
                await asyncio.wait_for(stop.wait(), timeout=self.config.reconcile_interval_s)
            except asyncio.TimeoutError:
                pass


class AIProviderReconciler:
    """Validates AIProvider specs and maintains status (net-new vs the
    reference, which never writes AIProvider status)."""

    def __init__(
        self,
        api: KubeApi,
        *,
        providers: Optional[ProviderRegistry] = None,
        config: Optional[OperatorConfig] = None,
    ) -> None:
        self.api = api
        self.providers = providers or default_registry()
        self.config = config or OperatorConfig()

    async def reconcile(self, provider: AIProvider) -> str:
        """Returns the phase written."""
        spec = provider.spec
        problems: list[str] = []
        if not spec.provider_id:
            problems.append("spec.providerId is required")
        elif spec.provider_id not in self.providers.known_ids() and spec.provider_id != "tpu-native":
            problems.append(
                f"unknown providerId {spec.provider_id!r}; known: {self.providers.known_ids()}"
            )
        if spec.provider_id in ("openai", "ollama", "openai-compatible") and not spec.api_url:
            problems.append(f"providerId {spec.provider_id!r} requires spec.apiUrl")
        if not spec.model_id and spec.provider_id not in ("template", None):
            problems.append("spec.modelId is required")
        if spec.authentication_ref is not None and spec.authentication_ref.secret_name:
            try:
                secret = await self.api.get(
                    "Secret",
                    spec.authentication_ref.secret_name,
                    provider.metadata.namespace or "default",
                )
                key = spec.authentication_ref.secret_key or "token"
                data = {**(secret.get("data") or {}), **(secret.get("stringData") or {})}
                if key not in data:
                    problems.append(
                        f"secret {spec.authentication_ref.secret_name} lacks key {key!r}"
                    )
            except NotFoundError:
                problems.append(f"auth secret {spec.authentication_ref.secret_name} not found")
            except ApiError as exc:
                problems.append(f"auth secret check failed: {exc}")
        phase = "Failed" if problems else "Ready"
        message = "; ".join(problems) if problems else "provider validated"
        try:
            current = await self.api.get(
                "AIProvider", provider.metadata.name, provider.metadata.namespace
            )
            status = current.get("status") or {}
            if status.get("phase") == phase and status.get("message") == message:
                return phase  # no transition; don't churn resourceVersion
            await self.api.patch_status(
                "AIProvider",
                provider.metadata.name,
                provider.metadata.namespace,
                {
                    "phase": phase,
                    "message": message,
                    "lastValidated": now_iso(),
                    "observedGeneration": provider.metadata.generation,
                },
            )
        except ApiError as exc:
            log.warning("failed to patch AIProvider status %s: %s",
                        provider.qualified_name(), exc)
        return phase

    async def run(self, stop: asyncio.Event) -> None:
        while not stop.is_set():
            try:
                for raw in await self.api.list("AIProvider"):
                    if stop.is_set():
                        return
                    await self.reconcile(AIProvider.parse(raw))
            except ApiError as exc:
                log.warning("aiprovider resync failed: %s", exc)
            try:
                await asyncio.wait_for(stop.wait(), timeout=self.config.reconcile_interval_s)
            except asyncio.TimeoutError:
                pass
