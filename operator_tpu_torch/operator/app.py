"""Operator application wiring + demo harness.

The port's own copy of ``operator_tpu/operator/app.py``.  ``Operator``
composes the control plane: pattern engine, analysis pipeline, pod-failure
watcher, the Podmortem and AIProvider reconcilers, and health checks, all
over one ``KubeApi``.  The startup sequence is the reference's: the claim
ledger resumes, the reconcilers register, the pod watcher starts,
readiness gates on pattern availability.

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

Not ported yet (ROADMAP.md Queue 1 item 5a), and refused when the config
turns it on (``NotImplementedError`` naming the item): leader election
(``lease.py``), the autoscaler, endpoint discovery, and the real API
server (``httpapi.py``, the CLI without ``--demo``); the pattern
library's git sync (``patternsync.py``) is refused at ``start()`` when a
PatternLibrary CR asks for it.

``python -m operator_tpu_torch.operator --demo [--provider tpu-native]
[--device cpu]`` runs the whole control plane against the in-memory fake
apiserver, injects a CrashLoopBackOff failure, and prints the emitted
events, annotations, and CR status.
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
from .pipeline import AnalysisPipeline
from .providers import HTTP_PROVIDER_IDS, ProviderRegistry, default_registry
from .reconciler import AIProviderReconciler, PodmortemReconciler
from .storage import AnalysisStorageService
from .watcher import PodFailureWatcher, PodmortemCache

log = logging.getLogger(__name__)

#: where a refusal points the reader
_ITEM = "ROADMAP.md Queue 1 item 5a"


def _not_ported(feature: str, how: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to operator_tpu_torch yet ({_ITEM}); {how}"
    )


def _refuse_unported(config: OperatorConfig) -> None:
    """Raise for a config that turns on a part of the JAX operator the
    port does not have yet."""
    unported = (
        ("LEADER_ELECTION", config.leader_election, "leader election (operator/lease.py)"),
        ("AUTOSCALE_ENABLED", config.autoscale_enabled, "the autoscaler (operator/autoscale.py)"),
        ("DISCOVERY_ENABLED", config.discovery_enabled,
         "endpoint discovery (router/discovery.py)"),
    )
    for name, on, feature in unported:
        if on:
            raise _not_ported(feature, f"unset {name}")


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
        _refuse_unported(self.config)
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

    def _fleet_view(self) -> dict:
        """``GET /fleet`` body: the backend's per-replica rows + rollup,
        plus the serverless-fleet fields (no autoscaler in the port:
        ``desiredReplicas`` and ``lastScaleReason`` stay null)."""
        view = (
            self._http_backend.fleet_view()
            if self._http_backend is not None
            else {"replicas": {}, "fleet": {}}
        )
        view["fleetSize"] = len(view.get("replicas") or {})
        view["desiredReplicas"] = None
        view["lastScaleReason"] = None
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
            await loop.run_in_executor(None, engine.warmup)
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
                "engine bring-up ready in %.1fs", time.monotonic() - bringup_t0,
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

    async def _refuse_pattern_sync(self) -> None:
        """The git sync of PatternLibrary CRs is not ported: a cluster that
        has one must not have its libraries silently left unsynced."""
        libraries = await asyncio.wait_for(
            self.api.list("PatternLibrary"), timeout=self.config.kube_call_timeout_s
        )
        if libraries:
            name = (libraries[0].get("metadata") or {}).get("name")
            raise _not_ported(
                "the pattern library's git sync (operator/patternsync.py)",
                f"PatternLibrary {name!r} asks for it; mount the synced "
                "libraries under PATTERN_CACHE_DIRECTORY instead",
            )

    # ------------------------------------------------------------------
    async def start(self) -> None:
        log.info("operator starting (namespaces: %s)",
                 self.config.watch_namespaces or "ALL")
        await self._refuse_pattern_sync()
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
        # resume any claims a crashed predecessor left in the ledger, then
        # run the control loops — resume must COMPLETE first, or the
        # watcher's pre-watch sweep could claim a failure that
        # ClaimLedger.reload() then re-lists as pending and analyzes a
        # second time, concurrently
        self._tasks = [
            asyncio.create_task(self._single_replica_cycle(), name="claims-resume"),
        ]
        if self._http_backend is not None and self.config.router_health_poll_s > 0:
            # background /healthz polling: load-fed shedding needs load
            # reports even when no analysis traffic produces them
            self._tasks.append(asyncio.create_task(
                self._health_poll_loop(), name="replica-health-poll"
            ))

    def _spawn_control_tasks(self) -> list[asyncio.Task]:
        return [
            asyncio.create_task(self.watcher.run(self._stop), name="pod-watcher"),
            asyncio.create_task(self.podmortem_reconciler.run(self._stop), name="podmortem-reconciler"),
            asyncio.create_task(self.aiprovider_reconciler.run(self._stop), name="aiprovider-reconciler"),
        ]

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
        print(
            f"error: {_not_ported('the Kubernetes API client (operator/httpapi.py)', 'use --demo')}",
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


if __name__ == "__main__":
    raise SystemExit(_main())
