"""Operator application wiring + demo harness.

The port's own copy of ``operator_tpu/operator/app.py``.  ``Operator``
composes the control plane: pattern engine, analysis pipeline, pod-failure
watcher, the Podmortem, AIProvider and PatternLibrary reconcilers, and
health checks, all over one ``KubeApi``.  The startup sequence is the
reference's: the claim ledger resumes, the reconcilers register, the pod
watcher starts, readiness gates on pattern availability.

``Operator(..., device=None)`` runs on ``cuda`` unless the caller asks for
another device (``utils/device.py``): the ``tpu-native`` provider's engine
and the semantic matcher and incident index live there.  Without a card it
raises; nothing falls back to the CPU.

The HTTP providerIds (``openai``, ``ollama``, ``openai-compatible``)
share one configured ``OpenAICompatProvider`` whose routers a background
``/healthz`` poll feeds (``router_health_poll_s``); ``GET /fleet`` on the
health port serves its fleet view.  ``completion_api_port >= 0`` serves
the OpenAI-compatible API and the reference's analyze route from this
process on an engine built on the operator's device (the ``tpu-native``
provider then answers on the same engine); like the reference, a build
or bind failure disables the API with a warning, and nothing runs on the
CPU in the card's place.

The fleet, as in the reference: with ``LEADER_ELECTION`` the control
loops run only while this replica holds the Lease (``lease.py``), and a
standby that takes over resumes the dead leader's non-terminal claims;
``DISCOVERY_ENABLED`` feeds the dynamic router from the serving
Service's Endpoints (``router/discovery.py``, on leaders and standbys);
``AUTOSCALE_ENABLED`` sizes the serving Deployment through its scale
subresource (``autoscale.py``, leader-only).  PatternLibrary CRs are
synced from git (``patternsync.py``) and the pattern engine reloads.

``python -m operator_tpu_torch.operator [--device cpu]`` is the deployed
entry point: in-cluster or through ``KUBECONFIG`` (``httpapi.py``), until
SIGTERM.  ``--demo [--provider tpu-native]`` runs the whole control plane
against the in-memory fake apiserver instead, injects a CrashLoopBackOff
failure, and prints the emitted events, annotations, and CR status.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional, Union

import torch

from ..obs import build_tracer
from ..patterns.engine import PatternEngine
from ..utils.config import OperatorConfig
from ..utils.device import resolve_device
from ..utils.timing import METRICS, MetricsRegistry
from .events import EventService
from .health import (
    ENGINE_DISABLED,
    ENGINE_FAILED,
    ENGINE_LOADING,
    ENGINE_READY,
    LivenessCheck,
    ReadinessCheck,
)
from .httpserver import HealthServer
from .kubeapi import FakeKubeApi, KubeApi
from .lease import LeaseElector
from .patternsync import GitSyncService, PatternLibraryReconciler
from .pipeline import AnalysisPipeline
from .providers import HTTP_PROVIDER_IDS, ProviderRegistry, default_registry
from .reconciler import AIProviderReconciler, PodmortemReconciler
from .storage import AnalysisStorageService
from .watcher import PodFailureWatcher, PodmortemCache

log = logging.getLogger(__name__)


class Operator:
    def __init__(
        self,
        api: KubeApi,
        *,
        config: Optional[OperatorConfig] = None,
        providers: Optional[ProviderRegistry] = None,
        metrics: Optional[MetricsRegistry] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.api = api
        self.config = config or OperatorConfig()
        self.device = resolve_device(device)
        self.metrics = metrics or METRICS
        self.providers = providers or default_registry()
        # per-analysis tracing + flight recorder: one recorder behind the
        # pipeline and GET /traces on the health port
        self.tracer, self.recorder = build_tracer(self.config, self.metrics)
        #: the shared HTTP backend whose routers the background /healthz
        #: poll loop feeds (None when an injected registry owns providers)
        self._http_backend = None
        self._register_tpu_provider()
        self._register_http_providers()
        self.engine = PatternEngine(
            cache_dir=self.config.pattern_cache_directory,
            semantic=self._build_semantic(),
        )
        self.events = EventService(api, self.config)
        self.storage = AnalysisStorageService(api, self.config)
        # incident memory shares the semantic matcher's embedder when one
        # is mounted (neural near-miss recall); lexical hashing otherwise
        from ..memory import build_incident_memory

        semantic = getattr(self.engine, "semantic", None)
        self.memory = build_incident_memory(
            self.config,
            embedder=semantic.embedder if semantic is not None else None,
            device=self.device,
        )
        self.pipeline = AnalysisPipeline(
            api,
            self.engine,
            config=self.config,
            events=self.events,
            storage=self.storage,
            providers=self.providers,
            metrics=self.metrics,
            memory=self.memory,
            tracer=self.tracer,
        )
        self.cr_cache = PodmortemCache(
            api, list_timeout_s=self.config.kube_call_timeout_s
        )
        self.watcher = PodFailureWatcher(
            api, self.pipeline, config=self.config, metrics=self.metrics, cache=self.cr_cache
        )
        self.podmortem_reconciler = PodmortemReconciler(
            api, self.pipeline, config=self.config, metrics=self.metrics
        )
        self.aiprovider_reconciler = AIProviderReconciler(
            api, providers=self.providers, config=self.config
        )
        self.pattern_reconciler = PatternLibraryReconciler(
            api, GitSyncService(self.config), engine=self.engine, config=self.config
        )
        # serverless fleet: the SLO-judged autoscaler (leader-only,
        # _spawn_control_tasks) and endpoint-watch membership (leaders AND
        # standbys, start(): a standby's router must track the live fleet
        # or its first routed request after takeover would hit pods that
        # no longer exist)
        self.autoscaler = None
        if self.config.autoscale_enabled:
            from .autoscale import AutoscaleController

            self.autoscaler = AutoscaleController.from_config(
                api,
                self.config,
                fleet=self._fleet_signals,
                attainment=(
                    lambda: self.pipeline.slo_ledger.attainment_by_class()
                ),
                pending=(lambda: self.pipeline.slo_ledger.pending),
                metrics=self.metrics,
            )
        self.discovery = None
        if self.config.discovery_enabled and self._http_backend is not None:
            from ..router.discovery import EndpointDiscovery

            backend = self._http_backend
            self.discovery = EndpointDiscovery(
                api,
                backend.dynamic_router(),
                service=self.config.discovery_service,
                namespace=(
                    self.config.discovery_namespace
                    or getattr(api, "namespace", None)
                    or "default"
                ),
                scheme=self.config.discovery_scheme,
                port_name=self.config.discovery_port,
                kube_timeout_s=self.config.kube_call_timeout_s,
                restart_delay_s=self.config.watch_restart_delay_s,
                prewarm=(
                    (
                        lambda replica: backend.prewarm_replica(
                            replica, timeout_s=self.config.kube_call_timeout_s
                        )
                    )
                    if self.config.discovery_prewarm
                    else None
                ),
            )
        # engine warmth: "disabled" unless the in-process completion API
        # warms an engine before readiness (LOADING -> READY)
        self.engine_warmth = ENGINE_DISABLED
        self.readiness = ReadinessCheck(
            api, self.config, engine_state=lambda: self.engine_warmth
        )
        self.liveness = LivenessCheck()
        self.health_server: Optional[HealthServer] = None
        if self.config.health_port >= 0:
            self.health_server = HealthServer(
                self.liveness,
                self.readiness,
                metrics=self.metrics,
                memory=self.memory,
                recorder=self.recorder,
                tracer=self.tracer,
                incidents_token=self.config.incidents_api_token or None,
                # GET /fleet: the HTTP backend's per-replica rows + rollup
                fleet=(
                    (lambda: self._fleet_view())
                    if self._http_backend is not None else None
                ),
                # per-class queue depth + attainment from the pipeline's
                # SLO ledger on GET /healthz/ready (obs/sloledger.py)
                slo=(lambda: self.pipeline.slo_ledger.snapshot()),
                host=self.config.health_host,
                port=self.config.health_port,
            )
        self.completion_server = None  # started on demand (completion_api_port)
        self.completion_task: Optional[asyncio.Task] = None
        # HA: with leader_election on, the control loops run only while
        # this replica holds the Lease; standbys keep probes and the
        # serving engine warm and take over on expiry, resuming the dead
        # leader's non-terminal claims from the ledger
        self.elector: Optional[LeaseElector] = None
        if self.config.leader_election:
            import socket

            identity = (
                self.config.pod_name
                or f"{socket.gethostname()}-{os.getpid()}"
            )
            namespace = (
                self.config.lease_namespace
                or getattr(api, "namespace", None)
                or "default"
            )
            self.elector = LeaseElector(
                api,
                lease_name=self.config.lease_name,
                namespace=namespace,
                identity=identity,
                duration_s=self.config.lease_duration_s,
                renew_period_s=self.config.lease_renew_period_s,
                retry_period_s=self.config.lease_retry_period_s,
                kube_timeout_s=self.config.kube_call_timeout_s,
                metrics=self.metrics,
            )
        self._stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._control_tasks: list[asyncio.Task] = []

    def _register_tpu_provider(self) -> None:
        """Lazily wire the tpu-native serving backend on the operator's
        device; a factory that raises (no checkpoint, no weights) degrades
        the analysis to its pattern result at first use, never at
        operator startup.  A kernel launch failure on the card raises in
        the engine and reaches the analysis as the provider's error, as
        any provider failure does; nothing reruns on the CPU."""
        device, config = self.device, self.config

        def factory():
            from ..serving.provider import build_tpu_native_provider

            return build_tpu_native_provider(device, os.environ, config=config)

        self.providers.register_factory("tpu-native", factory)

    def _register_http_providers(self) -> None:
        """One CONFIGURED OpenAI-compat backend behind every HTTP
        providerId: the config's router knobs (affinity, shed, breakers)
        reach dispatch, the operator's metrics registry receives the
        podmortem_router_* counters, and all three ids share ONE router
        per replica set — so per-replica breaker and health history
        survives across CRs naming the same replicas.  Injected
        registries keep their own backends (tests)."""
        from .providers import OpenAICompatProvider

        http_ids = [pid for pid in HTTP_PROVIDER_IDS if not self.providers.has(pid)]
        if not http_ids:
            return
        backend = OpenAICompatProvider(
            metrics=self.metrics,
            router_vnodes=self.config.router_vnodes,
            shed_pressure=self.config.router_shed_pressure,
            replica_failure_threshold=self.config.router_replica_failure_threshold,
            replica_reset_s=self.config.router_replica_reset_s,
        )
        # the background /healthz poll loop (start()) feeds this
        # backend's routers so shedding has load data between analyses
        self._http_backend = backend
        for pid in http_ids:
            self.providers.register(pid, backend)

    def _fleet_signals(self) -> dict:
        """The autoscaler's rollup feed: the ``fleet`` half of the
        backend's fleet view (queueDepth / inflight / pressure)."""
        if self._http_backend is None:
            return {}
        return self._http_backend.fleet_view().get("fleet") or {}

    def _fleet_view(self) -> dict:
        """``GET /fleet`` body: the backend's per-replica rows + rollup,
        plus the serverless-fleet fields — live member count and the
        autoscaler's last verdict."""
        view = (
            self._http_backend.fleet_view()
            if self._http_backend is not None
            else {"replicas": {}, "fleet": {}}
        )
        view["fleetSize"] = len(view.get("replicas") or {})
        view["desiredReplicas"] = None
        view["lastScaleReason"] = None
        if self.autoscaler is not None:
            view.update(self.autoscaler.view())
        return view

    def _build_semantic(self):
        """Neural semantic matcher on the operator's device when an encoder
        checkpoint is mounted; None otherwise (lexical regex/keyword
        matching still runs).  A bad checkpoint degrades with a warning —
        pattern matching must never be taken down by the optional neural
        scorer."""
        directory = self.config.encoder_checkpoint_dir
        if not directory:
            return None
        from ..patterns.semantic import SemanticMatcher, build_embedder

        embedder = build_embedder(directory, fallback=False, device=self.device)
        if embedder is None:
            return None
        return SemanticMatcher(embedder=embedder, device=self.device)

    async def _start_completion_api(self) -> None:
        """Serve the OpenAI-compatible API and the reference's analyze
        route from the operator process on one engine built on the
        operator's device; the ``tpu-native`` provider is re-registered
        on it, so in-cluster explanations and external callers share one
        batch.  Like the reference, an engine that cannot be built or a
        port that cannot be bound disables the API with a warning — it
        never takes down the control plane — and the engine never moves
        to the CPU in the card's place.  Runs as its own task so the
        watcher and reconcilers never wait for the weight load."""
        engine = None
        server = None
        self.engine_warmth = ENGINE_LOADING
        bringup_t0 = time.monotonic()
        try:
            from ..patterns.semantic import build_embedder
            from ..serving.httpserver import CompletionServer
            from ..serving.prompts import build_warmup_prompt
            from ..serving.provider import TPUNativeProvider, build_serving_engine
            from ..serving.types import OversizedRequest, SamplingParams

            loop = asyncio.get_running_loop()
            # the weight load and the kernel build block for seconds:
            # keep probes live
            engine, model_id = await loop.run_in_executor(
                None, lambda: build_serving_engine(self.device, os.environ, config=self.config)
            )
            # the warmup grid (WARMUP_GRID): every serving program captured
            # before readiness, as the JAX operator compiles its grid;
            # readiness stays cold until it returns.  With AOT_CACHE_PATH
            # the grid's ``aot`` entry carries hit/miss/live_compile counts
            # — a warm boot shows live_compiles=0 and builds no kernel
            grid = await engine.precompile(self.config.warmup_grid)
            log.info("engine warmup grid: %s", grid)
            # /v1/embeddings reuses the pattern engine's embedder (MiniLM
            # if an encoder checkpoint is mounted, lexical hashing
            # otherwise)
            semantic = getattr(self.engine, "semantic", None)
            embedder = semantic.embedder if semantic is not None else build_embedder(None)
            tpu_provider = TPUNativeProvider(
                engine, model_id=model_id,
                register_template_prefixes=self.config.prefix_cache,
            )
            server = CompletionServer(
                engine,
                model_id=model_id,
                host=self.config.completion_api_host,
                port=self.config.completion_api_port,
                api_token=self.config.completion_api_token or None,
                embedder=embedder,
                # the reference's ai-interface contract, served verbatim
                # (POST /api/v1/analysis/analyze)
                analysis_backend=tpu_provider,
                # inbound traceparent joins the caller's trace; the spans
                # land in the same flight recorder /traces serves
                tracer=self.tracer,
                drain_grace_s=self.config.serving_drain_grace_s,
                replica_id=(
                    self.config.serving_replica_id or self.config.pod_name or None
                ),
                profile_enabled=self.config.profile_enabled,
                profile_dir=self.config.profile_dir,
            )
            await server.start()
            # one throwaway generation shaped like a real explanation, so
            # the first real failure does not pay the first step's costs
            warm_tokens = 2 * max(1, self.config.decode_block)
            try:
                # graftlint: disable=GL003 reason=warmup generation is deliberately unbounded: readiness stays cold (visible to probes) until it completes
                await engine.generate(
                    build_warmup_prompt(), SamplingParams(max_tokens=warm_tokens)
                )
            except OversizedRequest:
                log.warning(
                    "full-size warmup exceeds the KV cache; warming with a "
                    "minimal prompt"
                )
                try:
                    # graftlint: disable=GL003 reason=same unbounded-warmup exception as the full-size probe above
                    await engine.generate("warmup", SamplingParams(max_tokens=1))
                except OversizedRequest:
                    log.warning("minimal warmup also exceeds the KV cache; "
                                "serving cold")
            log.info(
                "engine bring-up ready in %.1fs (aot=%s)",
                time.monotonic() - bringup_t0, (grid or {}).get("aot", "off"),
            )
        except asyncio.CancelledError:
            # operator stop() mid-load: not a failure, just no engine
            self.engine_warmth = ENGINE_DISABLED
            if server is not None:
                await server.stop()
            if engine is not None:
                await asyncio.to_thread(engine.close)
            raise
        except Exception:  # noqa: BLE001 - optional surface, degrade quietly
            self.engine_warmth = ENGINE_FAILED
            log.warning("completion api disabled", exc_info=True)
            if server is not None:  # a post-start warmup failure leaks the port
                await server.stop()
            if engine is not None:  # free the loaded weights, not just leak them
                await asyncio.to_thread(engine.close)
            return
        # register (not register_factory): overwrite any backend a pipeline
        # already resolved from the lazy factory, so explanations and HTTP
        # callers share this engine
        self.providers.register("tpu-native", tpu_provider)
        self.completion_server = server
        self.engine_warmth = ENGINE_READY

    async def _health_poll_loop(self) -> None:
        """Periodic ``/healthz`` sweep over every routed serving replica
        (``OpenAICompatProvider.poll_replica_health``): probe verdicts and
        load reports land in the routers' health boards so the shed
        decision has data BETWEEN analyses.  A failed poll marks the
        replica not-ready, never crashes; the loop exits on stop."""
        assert self._http_backend is not None
        interval = self.config.router_health_poll_s
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=interval)
                return  # stopping
            except asyncio.TimeoutError:
                pass
            try:
                await self._http_backend.poll_replica_health(
                    timeout_s=self.config.kube_call_timeout_s
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - polling must outlive one bad sweep
                log.warning("replica health poll sweep failed", exc_info=True)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        log.info("operator starting (namespaces: %s)",
                 self.config.watch_namespaces or "ALL")
        self._stop.clear()
        if self.memory is not None and self.config.memory_configmap:
            # PVC-less durability: merge the last ConfigMap snapshot before
            # any analysis runs (journal/live entries win over snapshot)
            namespace = getattr(self.api, "namespace", None) or "default"
            await self.memory.restore_from_configmap(self.api, namespace)
        if self.health_server is not None:
            await self.health_server.start()
        if self.config.completion_api_port >= 0:
            # flip warmth BEFORE the task is scheduled: a readiness probe
            # landing between create_task and the task's first step must
            # already see the engine as cold
            self.engine_warmth = ENGINE_LOADING
            self.completion_task = asyncio.create_task(
                self._start_completion_api(), name="completion-api"
            )
        if self.elector is None:
            # single-replica mode: resume any claims a crashed predecessor
            # left in the ledger, then run the control loops — resume must
            # COMPLETE first, or the watcher's pre-watch sweep could claim
            # a failure that ClaimLedger.reload() then re-lists as pending
            # and analyzes a second time, concurrently
            self._tasks = [
                asyncio.create_task(self._single_replica_cycle(), name="claims-resume"),
            ]
        else:
            # HA mode: contend for the Lease; the leader cycle starts and
            # stops the control loops as leadership comes and goes
            self._tasks = [
                asyncio.create_task(self.elector.run(self._stop), name="leader-elector"),
                asyncio.create_task(self._leader_cycle(), name="leader-cycle"),
            ]
        if self._http_backend is not None and self.config.router_health_poll_s > 0:
            # background /healthz polling: load-fed shedding needs load
            # reports even when no analysis traffic produces them.  Runs
            # on leaders AND standbys (breaker and health state are then
            # warm at takeover)
            self._tasks.append(asyncio.create_task(
                self._health_poll_loop(), name="replica-health-poll"
            ))
        if self.discovery is not None:
            # endpoint-watch membership on leaders AND standbys, like the
            # health poll: a standby whose ring already tracks the live
            # fleet takes over without a stale-member window
            self._tasks.append(asyncio.create_task(
                self.discovery.run(self._stop), name="endpoint-discovery"
            ))

    def _spawn_control_tasks(self) -> list[asyncio.Task]:
        tasks = [
            asyncio.create_task(self.watcher.run(self._stop), name="pod-watcher"),
            asyncio.create_task(self.podmortem_reconciler.run(self._stop), name="podmortem-reconciler"),
            asyncio.create_task(self.aiprovider_reconciler.run(self._stop), name="aiprovider-reconciler"),
            asyncio.create_task(self.pattern_reconciler.run(self._stop), name="patternlibrary-reconciler"),
        ]
        if self.autoscaler is not None:
            # leader-only like the reconcilers: two replicas scaling one
            # Deployment would fight through the rv guard forever
            tasks.append(asyncio.create_task(
                self.autoscaler.run(self._stop), name="autoscaler"
            ))
        return tasks

    async def _single_replica_cycle(self) -> None:
        await self._resume_claims()
        self._control_tasks = self._spawn_control_tasks()
        try:
            # propagate control-loop crashes (run_forever's gather watches
            # this task); stop() cancels the control tasks directly
            await asyncio.gather(*self._control_tasks)
        finally:
            # first crash cancels the SIBLINGS too — without this the
            # surviving reconcilers keep patching CRs through stop()'s
            # drain while the watcher is already dead
            for task in self._control_tasks:
                task.cancel()
            await asyncio.gather(*self._control_tasks, return_exceptions=True)

    async def _resume_claims(self) -> None:
        try:
            resumed = await self.pipeline.resume_pending()
            if resumed:
                log.info("resumed %d in-flight analyses from the claim ledger",
                         resumed)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - resume is best-effort recovery
            log.exception("claim-ledger resume failed; continuing")

    async def _leader_cycle(self) -> None:
        """Run the control loops only while holding the Lease.  On
        takeover, first resume the previous leader's non-terminal claims
        (idempotent status patches make a double-completed claim converge
        anyway), THEN start the watcher — whose startup re-lists pods and
        CRs, closing any blind window the dead leader left."""
        assert self.elector is not None
        while not self._stop.is_set():
            if not await self.elector.wait_leading(self._stop):
                return  # stopping
            if self._stop.is_set():
                return
            # watch for depose through BOTH phases — resume can run for
            # minutes of residual claim budget, and a deposed replica must
            # not keep analyzing claims the new leader is resuming
            lost = asyncio.create_task(
                self.elector.wait_not_leading(self._stop),
                name="leadership-lost",
            )
            crashed: list[asyncio.Task] = []
            resume: Optional[asyncio.Task] = None
            try:
                resume = asyncio.create_task(
                    self._resume_claims(), name="claims-resume"
                )
                await asyncio.wait(
                    {resume, lost}, return_when=asyncio.FIRST_COMPLETED
                )
                if not resume.done():
                    resume.cancel()  # deposed mid-resume
                    await asyncio.gather(resume, return_exceptions=True)
                    continue
                await resume  # raises nothing: _resume_claims guards itself
                if lost.done():
                    continue
                self._control_tasks = self._spawn_control_tasks()
                done, _ = await asyncio.wait(
                    {lost, *self._control_tasks},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                crashed = [task for task in done if task is not lost]
            finally:
                # resume too: if stop() cancels THIS task mid-wait, an
                # orphaned resume would keep analyzing past claims.close()
                settle = [lost] + ([resume] if resume is not None else [])
                for task in settle:
                    task.cancel()
                await asyncio.gather(*settle, return_exceptions=True)
                # leadership lost (or stopping, or a control loop died):
                # halt — another replica may already be leading, and two
                # concurrent watchers double-analyze everything
                await self._halt_control_tasks()
            for task in crashed:
                if task.exception() is not None:
                    # zombie-leader guard: a dead control loop must not
                    # leave this replica renewing the lease with no watcher
                    # running while the healthy standby is fenced out
                    raise task.exception()

    async def _halt_control_tasks(self) -> None:
        deposed = not self._stop.is_set()
        if deposed:
            # deposed, not stopping.  FIRST — before any cancellation can
            # run a handler that releases a claim — stop touching the
            # shared ledger: a deposed replica's appends, or a stale
            # compaction, must not clobber records the new leader is
            # writing.  The handle reopens via reload() when this replica
            # re-acquires (resume_pending).  The new leader re-runs the
            # cancelled analyses from the ledger as non-terminal, which is
            # the at-least-once contract.
            self.pipeline.claims.abandon()
        for task in self._control_tasks:
            task.cancel()
        await asyncio.gather(*self._control_tasks, return_exceptions=True)
        self._control_tasks = []
        if deposed:
            # the watcher's detached analysis tasks survive its
            # cancellation, but a deposed leader must not keep analyzing:
            # cancelling them cancels their generations on the engine,
            # whose worker frees the rows and pages at its next step
            self.watcher.cancel_inflight()
            await self.watcher.drain()

    async def stop(self) -> None:
        self._stop.set()
        if self.health_server is not None:
            await self.health_server.stop()
        if self.completion_task is not None and not self.completion_task.done():
            self.completion_task.cancel()  # stop mid-weight-load
            await asyncio.gather(self.completion_task, return_exceptions=True)
        self.completion_task = None
        # swap-then-act: detach the server reference BEFORE the awaits so a
        # concurrent stop() can't re-enter stop/close on a half-torn-down
        # server
        completion_server, self.completion_server = self.completion_server, None
        if completion_server is not None:
            await completion_server.stop()
            await asyncio.to_thread(completion_server.engine.close)
        # graceful drain: in-flight analyses finish (their own deadlines
        # usually end them sooner) or are cancelled at the grace boundary —
        # a wedged analysis must not hold SIGTERM past the pod's
        # terminationGracePeriod and get the whole process SIGKILLed with
        # unflushed journals
        try:
            await asyncio.wait_for(
                self.watcher.drain(), timeout=self.config.shutdown_grace_s
            )
        except asyncio.TimeoutError:
            log.warning(
                "in-flight analyses still running after the %.0fs shutdown "
                "grace; cancelling them", self.config.shutdown_grace_s,
            )
            self.watcher.cancel_inflight()
            await self.watcher.drain()
        for task in [*self._tasks, *self._control_tasks]:
            task.cancel()
        await asyncio.gather(
            *self._tasks, *self._control_tasks, return_exceptions=True
        )
        self._tasks = []
        self._control_tasks = []
        if self.memory is not None:
            if self.config.memory_configmap:
                # final forced snapshot: incidents inserted inside the last
                # flush interval must survive a PVC-less restart
                try:
                    namespace = getattr(self.api, "namespace", None) or "default"
                    await self.memory.maybe_flush_to_configmap(
                        self.api, namespace, force=True
                    )
                except Exception:  # noqa: BLE001 - shutdown must complete
                    log.warning("final incident snapshot failed", exc_info=True)
            self.memory.close()  # flush+close the incident journal handle
        if self.recorder is not None:
            # barrier on the flight-recorder writer thread: the last
            # analyses' traces (and any black-box dump) must be on disk
            # before the process exits
            try:
                self.recorder.flush()
            except Exception:  # noqa: BLE001 - shutdown must complete
                log.warning("flight-recorder flush failed", exc_info=True)
        self.pipeline.claims.close()  # terminal ledger records are on disk
        if self.elector is not None:
            # release LAST so the standby takes over a fully drained state
            # (and at once, instead of waiting out the lease duration)
            await self.elector.release()
        log.info("operator stopped")

    async def run_forever(self) -> None:
        await self.start()
        try:
            await asyncio.gather(*self._tasks)
        finally:
            await self.stop()


# --------------------------------------------------------------------------
# demo harness
# --------------------------------------------------------------------------


async def run_demo(
    logfile: Optional[str] = None,
    provider_id: str = "template",
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Full control-plane pass over the fake apiserver on ``device``;
    returns a summary dict (also printed by the CLI)."""
    from ..schema import (
        AIProvider,
        AIProviderRef,
        AIProviderSpec,
        ContainerState,
        ContainerStateTerminated,
        ContainerStateWaiting,
        ContainerStatus,
        LabelSelector,
        ObjectMeta,
        Pod,
        PodmortemSpec,
        PodStatus,
    )
    from ..schema.crds import Podmortem

    api = FakeKubeApi()
    config = OperatorConfig(
        pattern_cache_directory="/nonexistent-demo-cache",
        health_port=0,  # ephemeral: demo runs shouldn't contend for :8080
    )
    operator = Operator(api, config=config, device=device)

    # user objects: one AIProvider + one Podmortem watching app=payment
    await api.create_obj(AIProvider(
        metadata=ObjectMeta(name="demo-provider", namespace="podmortem-system"),
        spec=AIProviderSpec(provider_id=provider_id, model_id="demo-model"),
    ))
    await api.create_obj(Podmortem(
        metadata=ObjectMeta(name="watch-payment", namespace="podmortem-system"),
        spec=PodmortemSpec(
            pod_selector=LabelSelector(match_labels={"app": "payment"}),
            ai_provider_ref=AIProviderRef(name="demo-provider", namespace="podmortem-system"),
            ai_analysis_enabled=True,
        ),
    ))

    await operator.start()
    await asyncio.sleep(0.05)  # let watches register + caches prime

    # the failing pod
    if logfile is None:
        logfile = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "tests", "fixtures", "crashloop_quarkus.log",
        )

    def _read_crash_log() -> str:
        with open(logfile, encoding="utf-8", errors="replace") as f:
            return f.read()

    crash_log = await asyncio.to_thread(_read_crash_log)
    pod = Pod(
        metadata=ObjectMeta(name="payment-7f9c", namespace="prod", labels={"app": "payment"}),
        status=PodStatus(phase="Running", container_statuses=[ContainerStatus(
            name="app", restart_count=3,
            state=ContainerState(waiting=ContainerStateWaiting(reason="CrashLoopBackOff")),
            last_state=ContainerState(terminated=ContainerStateTerminated(
                exit_code=1, finished_at="2026-07-28T09:14:03Z")),
        )]),
    )
    api.set_pod_log("prod", "payment-7f9c", crash_log, previous=True)
    await api.create_obj(pod)
    # the watcher reacts to MODIFIED (reference :107); poke the pod.
    # Demo calls hit the in-memory fake, but they wear the same per-call
    # budget the production control plane does (graftlint GL003)
    await asyncio.wait_for(
        api.patch("Pod", "payment-7f9c", "prod",
                  {"metadata": {"labels": {"poked": "1"}}}),
        timeout=config.kube_call_timeout_s,
    )

    await asyncio.sleep(0.1)
    await operator.watcher.drain()

    events = await asyncio.wait_for(
        api.list("Event"), timeout=config.kube_call_timeout_s
    )
    stored_pod = await asyncio.wait_for(
        api.get("Pod", "payment-7f9c", "prod"),
        timeout=config.kube_call_timeout_s,
    )
    podmortem = await asyncio.wait_for(
        api.get("Podmortem", "watch-payment", "podmortem-system"),
        timeout=config.kube_call_timeout_s,
    )
    readiness = await operator.readiness.check()
    await operator.stop()

    return {
        "events": [
            {"reason": e.get("reason"), "type": e.get("type"),
             "target": f"{e.get('regarding', {}).get('kind')}/{e.get('regarding', {}).get('name')}",
             "note": (e.get("note") or "")[:160]}
            for e in events
        ],
        "pod_annotations": stored_pod.get("metadata", {}).get("annotations", {}),
        "podmortem_status": podmortem.get("status", {}),
        "ready": readiness.ready,
        "metrics": operator.metrics.snapshot(),
    }


def _main(argv: Optional[list[str]] = None) -> int:
    import argparse
    import json
    import sys

    parser = argparse.ArgumentParser(prog="operator_tpu_torch.operator")
    parser.add_argument("--demo", action="store_true",
                        help="run the control plane against the in-memory fake apiserver")
    parser.add_argument("--logfile", help="log file for the demo failure pod")
    parser.add_argument("--provider", default="template",
                        help="providerId for the demo AIProvider (template|tpu-native)")
    parser.add_argument("--device", default=None,
                        help="device of the engine and the similarity kernel (default cuda)")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s")
    if not args.demo:
        from .kubeapi import ApiError

        config = OperatorConfig.from_env()
        if config.aot_cache_path:
            # the kernels persist beside the AOT cache's records
            from ..utils.platform import enable_persistent_compilation_cache

            enable_persistent_compilation_cache(os.path.join(config.aot_cache_path, "kernels"))
        try:
            return asyncio.run(_run_real(config, device=args.device))
        except (ApiError, FileNotFoundError) as exc:
            print(
                f"error: no cluster access ({exc}); "
                "run in-cluster, point KUBECONFIG at a cluster, or use --demo",
                file=sys.stderr,
            )
            return 2
    try:
        summary = asyncio.run(run_demo(args.logfile, args.provider, device=args.device))
    except OSError as exc:
        print(f"error: cannot read demo log file: {exc}", file=sys.stderr)
        return 2
    try:
        print(json.dumps(summary, indent=2))
    except BrokenPipeError:
        sys.stderr.close()
    return 0


async def _run_real(
    config: OperatorConfig,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """In-cluster / kubeconfig mode: the deployed entry point
    (``python -m operator_tpu_torch.operator``), on ``device`` (``cuda``
    unless the caller asks for another), until SIGTERM or SIGINT."""
    import signal

    from .httpapi import HttpKubeApi

    # from_env reads the serviceaccount token / kubeconfig from disk:
    # startup-once, but _run_real is already on the loop, so offload
    api = await asyncio.to_thread(HttpKubeApi.from_env)
    operator = Operator(api, config=config, device=device)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await operator.start()
    try:
        stopped = asyncio.create_task(stop.wait())
        tasks = [*operator._tasks, stopped]
        done, _ = await asyncio.wait(tasks, return_when=asyncio.FIRST_COMPLETED)
        for task in done:
            if task is not stopped and task.exception() is not None:
                raise task.exception()
    finally:
        await operator.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
