"""AI provider backends + resolution of AIProvider CRs into runtime config.

The port's own copy of ``operator_tpu/operator/providers.py``.  Providers
are in-process backends behind one async interface:

- ``tpu-native``  — the in-tree serving engine on the card (registered by
  the operator as a lazy factory, ``operator/app.py``);
- ``template``    — deterministic pattern-based explanations, no model
  (fallback + tests);
- ``openai`` / ``ollama`` / ``openai-compatible`` — the OpenAI-compatible
  HTTP client (:class:`OpenAICompatProvider`): urllib in a worker thread,
  routed over the N serving replicas an ``apiUrl`` names through the
  port's :class:`~..router.EngineRouter` (consistent-hash affinity,
  per-replica breakers, load-fed shedding, requeue-once failover).
  Endpoint discovery (``router/discovery.py``) feeds
  ``dynamic_router``, the router of an AIProvider with no ``apiUrl``.

Config resolution mirrors AIInterfaceClient.convertToProviderConfig: CR
spec + defaults + auth token base64-decoded from the referenced Secret.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import urllib.parse
import urllib.request
from collections import OrderedDict
from typing import Callable, Optional, Protocol

from ..router import EngineRouter, Replica, RouterError, request_key
from ..router.health import BreakerBoard, CircuitBreaker  # noqa: F401
from ..schema.analysis import AIProviderConfig, AIResponse, AnalysisRequest
from ..schema.crds import AIProvider
from ..schema.kube import Secret
from ..utils.deadline import Deadline
from .kubeapi import ApiError, KubeApi, NotFoundError

log = logging.getLogger(__name__)

#: the providerIds the OpenAI-compatible client serves
HTTP_PROVIDER_IDS = ("openai", "ollama", "openai-compatible")


class AIProviderBackend(Protocol):
    async def generate(self, request: AnalysisRequest) -> AIResponse: ...


class ProviderError(Exception):
    pass


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------


class ProviderRegistry:
    def __init__(self) -> None:
        self._backends: dict[str, AIProviderBackend] = {}
        self._factories: dict[str, Callable[[], AIProviderBackend]] = {}

    def register(self, provider_id: str, backend: AIProviderBackend) -> None:
        self._backends[provider_id] = backend

    def register_factory(self, provider_id: str, factory: Callable[[], AIProviderBackend]) -> None:
        """Lazy registration — the tpu-native backend loads model weights, so
        it materialises on first use, not at import."""
        self._factories[provider_id] = factory

    def resolve(self, provider_id: Optional[str]) -> AIProviderBackend:
        pid = provider_id or "template"
        backend = self._backends.get(pid)
        if backend is None and pid in self._factories:
            try:
                backend = self._factories[pid]()
            except Exception as exc:  # noqa: BLE001 - degrade to ProviderError
                # keep the factory registered: the failure may be transient
                # (e.g. the card busy); the pipeline stores a pattern-only result
                raise ProviderError(f"provider {pid!r} failed to initialise: {exc}") from exc
            del self._factories[pid]
            self._backends[pid] = backend
        if backend is None:
            if pid in HTTP_PROVIDER_IDS:
                backend = OpenAICompatProvider()
                self._backends[pid] = backend
            else:
                raise ProviderError(f"unknown providerId {pid!r}")
        return backend

    def has(self, provider_id: str) -> bool:
        """Is a backend (or factory) already registered for this id? —
        wiring code must not clobber an injected test/real backend."""
        return provider_id in self._backends or provider_id in self._factories

    def known_ids(self) -> list[str]:
        return sorted(
            set(self._backends) | set(self._factories) | {"openai", "ollama", "template"}
        )


def default_registry() -> ProviderRegistry:
    registry = ProviderRegistry()
    registry.register("template", TemplateProvider())
    return registry


# --------------------------------------------------------------------------
# CR -> config resolution
# --------------------------------------------------------------------------


async def resolve_provider_config(
    api: KubeApi,
    provider: AIProvider,
    *,
    deadline: Optional[Deadline] = None,
) -> AIProviderConfig:
    """CR spec + defaults + auth token from the referenced Secret.  The
    Secret read spends from ``deadline`` (the analysis envelope residue);
    a timeout degrades exactly like a fetch error — config without a token."""
    spec = provider.spec
    token: Optional[str] = None
    auth = spec.authentication_ref
    if auth is not None and auth.secret_name:
        try:
            secret_dict = await asyncio.wait_for(
                api.get(
                    "Secret", auth.secret_name, provider.metadata.namespace or "default"
                ),
                timeout=deadline.remaining() if deadline is not None else None,
            )
            token = Secret.parse(secret_dict).decoded(auth.secret_key or "token")
            if token is None:
                log.warning(
                    "secret %s has no key %s", auth.secret_name, auth.secret_key or "token"
                )
        except NotFoundError:
            log.warning("auth secret %s not found for provider %s",
                        auth.secret_name, provider.metadata.name)
        except (ApiError, asyncio.TimeoutError) as exc:
            log.warning("failed reading auth secret for %s: %s",
                        provider.metadata.name, str(exc) or "timed out")
    return AIProviderConfig(
        provider_id=spec.provider_id,
        api_url=spec.api_url,
        model_id=spec.model_id,
        auth_token=token,
        timeout_seconds=spec.timeout_seconds,
        max_retries=spec.max_retries,
        caching_enabled=spec.caching_enabled,
        prompt_template=spec.prompt_template,
        max_tokens=spec.max_tokens,
        temperature=spec.temperature,
        additional_config=dict(spec.additional_config),
    )


# --------------------------------------------------------------------------
# response cache (reference cachingEnabled, AIInterfaceClient.java:80)
# --------------------------------------------------------------------------


class ResponseCache:
    """Small LRU keyed on the analysis evidence, so a crash-looping pod
    replaying one failure doesn't re-run generation every restart."""

    def __init__(self, maxsize: int = 256) -> None:
        self.maxsize = maxsize
        self._entries: OrderedDict[str, AIResponse] = OrderedDict()

    @staticmethod
    def key(request: AnalysisRequest) -> str:
        result = request.analysis_result
        config = request.provider_config
        basis = {
            "provider": config.provider_id if config else None,
            "model": config.model_id if config else None,
            "patterns": [
                (e.matched_pattern.id if e.matched_pattern else None,
                 e.context.matched_line if e.context else None)
                for e in (result.events if result else [])[:8]
            ],
            # near-miss recalls change the rendered prompt, so they are
            # part of the response identity too
            "prior": [p.fingerprint for p in request.prior_incidents],
        }
        return hashlib.sha256(json.dumps(basis, sort_keys=True).encode()).hexdigest()

    def get(self, key: str) -> Optional[AIResponse]:
        response = self._entries.get(key)
        if response is not None:
            self._entries.move_to_end(key)
        return response

    def put(self, key: str, response: AIResponse) -> None:
        self._entries[key] = response
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------


class TemplateProvider:
    """Deterministic explanation straight from the pattern result — the
    zero-model fallback, formatted with the Root Cause / Fix sections the
    event truncation preserves (reference EventService.java:282-301)."""

    async def generate(self, request: AnalysisRequest) -> AIResponse:
        result = request.analysis_result
        config = request.provider_config or AIProviderConfig()
        if result is None or not result.events:
            return AIResponse(
                explanation="Root Cause: no known failure pattern matched the logs.\n"
                "Fix: inspect the pod logs manually.",
                provider_id="template",
                model_id=config.model_id,
            )
        top = result.top_events(3)
        primary = top[0]
        name = primary.matched_pattern.name if primary.matched_pattern else "unknown failure"
        lines = [f"Root Cause: {name}."]
        if primary.context and primary.context.matched_line:
            lines.append(f'Evidence: "{primary.context.matched_line.strip()[:200]}"')
        if len(top) > 1:
            others = ", ".join(
                e.matched_pattern.name for e in top[1:] if e.matched_pattern and e.matched_pattern.name
            )
            if others:
                lines.append(f"Related signals: {others}.")
        remediation = primary.matched_pattern.remediation if primary.matched_pattern else None
        lines.append(f"Fix: {remediation.strip()}" if remediation else
                     "Fix: inspect the surrounding log context.")
        return AIResponse(
            explanation="\n".join(lines),
            provider_id="template",
            model_id=config.model_id,
        )


def replica_set(api_url: str) -> list[Replica]:
    """Parse a CR's ``apiUrl`` into the replica set it names.

    ``apiUrl`` accepts a single endpoint (the pre-router form) or a
    comma/whitespace-separated list of them — N serving replicas behind
    one AIProvider.  Every entry must be scheme-qualified (``http://`` /
    ``https://`` with a host): once routing multiplies endpoints, a bare
    ``host:8000`` would fail deep inside urllib with a message naming
    neither the CR nor the offending entry — reject it HERE with a clear
    :class:`ProviderError` instead.  Each replica's id is its normalized
    URL (stable across restarts, readable in spans and metrics)."""
    replicas: list[Replica] = []
    seen: set[str] = set()
    for raw in api_url.replace(",", " ").split():
        url = raw.rstrip("/")
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.netloc:
            raise ProviderError(
                f"invalid apiUrl entry {raw!r}: must be an absolute "
                "http(s)://host[:port][/path] URL (scheme-qualified; "
                "comma-separate multiple replicas)"
            )
        if url not in seen:
            seen.add(url)
            replicas.append(Replica(id=url, url=url))
    if not replicas:
        raise ProviderError("apiUrl names no endpoints")
    return replicas


def _completions_url(base: str) -> str:
    """Accept any of: bare host, .../v1, or a full .../chat/completions
    URL (the documented OpenAI base is https://api.openai.com/v1)."""
    url = base.rstrip("/")
    if url.endswith("/chat/completions"):
        return url
    if url.endswith("/v1"):
        return f"{url}/chat/completions"
    return f"{url}/v1/chat/completions"


class OpenAICompatProvider:
    """OpenAI-compatible chat-completions client (covers ``openai`` and
    ``ollama`` providerIds).  Blocking urllib runs in a worker thread;
    retries honour the CR's maxRetries (reference defaults :78-84).

    The CR's ``apiUrl`` may name N replicas (comma-separated, or the
    per-pod DNS names of the headless serving Service): dispatch then
    runs through an :class:`~..router.EngineRouter` per distinct replica
    set — consistent-hash affinity on the incident fingerprint / prompt
    prefix, per-replica breakers, load-fed shedding, and requeue-ONCE
    failover with the residual deadline.  Router state (and so
    breaker/health history) persists across calls per replica set.
    """

    def __init__(
        self,
        opener: Optional[Callable] = None,
        *,
        metrics=None,
        router_vnodes: int = 64,
        shed_pressure: int = 8,
        replica_failure_threshold: int = 3,
        replica_reset_s: float = 10.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        # injectable for tests; defaults to urllib
        self._opener = opener or urllib.request.urlopen
        #: opt-in chaos seam (utils/faultinject.py): consulted before each
        #: outbound attempt under site "http.provider" (ctx: attempt,
        #: replica) and each health probe under "http.healthz"
        self.fault_plan = None
        #: value-aware overload ladder (router/value.py): the pipeline
        #: stamps its policy here; router_for hands it to every router so
        #: the pre-dispatch verdict (shed / degrade / serve) and the
        #: supervisor requeue discipline share one value model
        self.overload_policy = None
        self._metrics = metrics
        self._router_vnodes = router_vnodes
        self._shed_pressure = shed_pressure
        self._replica_failure_threshold = replica_failure_threshold
        self._replica_reset_s = replica_reset_s
        self._clock = clock
        #: one router per distinct replica set, created on first use —
        #: breaker state must survive across requests or a dead replica
        #: would be re-probed by every analysis
        self._routers: dict[tuple[str, ...], EngineRouter] = {}

    #: sentinel replica-set key for the DISCOVERY-driven router: its
    #: membership is mutated live by endpoint discovery
    #: (router/discovery.py) instead of being derived from apiUrl
    DYNAMIC_KEY: tuple[str, ...] = ("<discovery>",)

    def dynamic_router(self) -> EngineRouter:
        """The endpoint-watch fleet's router (created empty on first
        use).  Living in ``_routers`` means ``fleet_view()`` and the
        health-poll sweep cover discovered replicas for free; when it has
        members, :meth:`generate` prefers it over the static apiUrl set —
        the serving fleet scales without a single CR edit or restart."""
        router = self._routers.get(self.DYNAMIC_KEY)
        if router is None:
            router = EngineRouter(
                [],
                vnodes=self._router_vnodes,
                shed_pressure=self._shed_pressure,
                failure_threshold=self._replica_failure_threshold,
                reset_s=self._replica_reset_s,
                clock=self._clock,
                metrics=self._metrics,
            )
            self._routers[self.DYNAMIC_KEY] = router
        router.fault_plan = self.fault_plan
        router.policy = self.overload_policy
        return router

    async def prewarm_replica(
        self, replica: Replica, *, timeout_s: float = 5.0
    ) -> bool:
        """The discovery loop's join gate: one bounded ``GET /healthz``
        probe against a replica that just appeared in the Endpoints.  A
        200 with ``status == "ok"`` admits it — and the probe body's load
        report primes the health board (queue depth, KV inventory) BEFORE
        the first routed request, so the new member joins warm, not
        blind.  Anything else (still compiling its warmup grid, foreign
        body, unreachable) defers the join to the next Endpoints event."""

        split = urllib.parse.urlsplit(replica.url)
        health_url = f"{split.scheme}://{split.netloc}/healthz"

        def probe() -> dict:
            if self.fault_plan is not None:
                self.fault_plan.apply("http.healthz", replica=replica.id)
            req = urllib.request.Request(health_url, method="GET")
            with self._opener(req, timeout=timeout_s) as resp:
                payload = json.loads(resp.read().decode())
            if not isinstance(payload, dict) or not isinstance(
                payload.get("status"), str
            ):
                raise ValueError(f"foreign /healthz body: {payload!r}")
            return payload

        payload = await asyncio.to_thread(probe)  # raising defers the join
        if payload["status"] != "ok":
            return False
        router = self.dynamic_router()
        router.mark_probe(replica.id, True)
        load = payload.get("load")
        if isinstance(load, dict):
            from ..router.health import ReplicaLoad

            router.report_load(replica.id, ReplicaLoad.parse(load))
        return True

    def router_for(self, replicas: list[Replica]) -> EngineRouter:
        key = tuple(sorted(r.id for r in replicas))
        router = self._routers.get(key)
        if router is None:
            router = EngineRouter(
                replicas,
                vnodes=self._router_vnodes,
                shed_pressure=self._shed_pressure,
                failure_threshold=self._replica_failure_threshold,
                reset_s=self._replica_reset_s,
                clock=self._clock,
                metrics=self._metrics,
            )
            self._routers[key] = router
        router.fault_plan = self.fault_plan
        router.policy = self.overload_policy
        return router

    def fleet_view(self) -> dict:
        """Fleet perf roll-up across EVERY routed replica set — the body
        the operator's token-gated ``GET /fleet`` serves.  Rows come from
        each router's HealthBoard (fed by the health-poll sweep below);
        a replica appearing in several sets keeps one row (same id, same
        /healthz body — last board wins)."""
        from ..router.health import fleet_rollup

        replicas: dict = {}
        for router in list(self._routers.values()):
            replicas.update(router.health.fleet_view()["replicas"])
        fleet = fleet_rollup(replicas)
        # the overload ladder's storm signal, fleet-wide: the best offer
        # any routed replica can make — what the autoscaler bursts on
        fleet["pressure"] = self.fleet_pressure()
        return {"replicas": replicas, "fleet": fleet}

    def fleet_pressure(self) -> "Optional[float]":
        """Least-loaded healthy replica's queue pressure across every
        routed set (None = no healthy replica anywhere)."""
        pressures = [
            p
            for p in (
                router.fleet_pressure()
                for router in list(self._routers.values())
            )
            if p is not None
        ]
        return min(pressures) if pressures else None

    async def poll_replica_health(self, *, timeout_s: float = 5.0) -> int:
        """Active ``GET /healthz`` sweep over every routed replica set,
        feeding each router's HealthBoard (probe verdict + load report).

        Without this, load reports arrive only when request traffic
        happens to feed ``report_load`` — between analyses the shed
        decision flies blind and only the passive breaker gates a sick
        replica (ROADMAP multi-engine item (b)).  The operator runs it
        on a background cadence (``router_health_poll_s``); each probe
        is a blocking urllib GET in a worker thread bounded by
        ``timeout_s`` at the call.  A failed probe marks the replica
        not-ready (the router's health gate skips it) — never raises.
        Returns the number of replicas successfully polled."""
        from ..router.health import ReplicaLoad

        async def poll_one(router: EngineRouter, replica: Replica) -> bool:
            split = urllib.parse.urlsplit(replica.url)
            health_url = f"{split.scheme}://{split.netloc}/healthz"

            def probe(url=health_url):
                if self.fault_plan is not None:
                    # chaos seam: partition/timeout scenarios inject here
                    self.fault_plan.apply("http.healthz", replica=replica.id)
                req = urllib.request.Request(url, method="GET")
                with self._opener(req, timeout=timeout_s) as resp:
                    payload = json.loads(resp.read().decode())
                if not isinstance(payload, dict) or not isinstance(
                    payload.get("status"), str
                ):
                    # valid JSON but not our shape (an LB answering "ok"
                    # or {"healthy": true} in front of a dead engine):
                    # same verdict as an unreachable replica — a foreign
                    # body must neither readmit the replica nor escape
                    # the per-probe handling below (one odd replica
                    # aborting the WHOLE sweep would blind the health
                    # feed for every healthy sibling too)
                    raise ValueError(f"foreign /healthz body: {payload!r}")
                return payload

            try:
                payload = await asyncio.to_thread(probe)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - a dead replica IS the signal
                router.mark_probe(replica.id, False)
                if self._metrics is not None:
                    self._metrics.incr("router_health_poll_failed")
                return False
            # only the one status OUR serving /healthz emits counts as
            # ready; "degraded" (supervisor gave up) and anything foreign
            # leave the replica gated
            router.mark_probe(replica.id, payload["status"] == "ok")
            load = payload.get("load")
            if isinstance(load, dict):
                router.report_load(replica.id, ReplicaLoad.parse(load))
            if self._metrics is not None:
                self._metrics.incr("router_health_poll")
            return True

        # fan the probes out: serially, N black-holed replicas would
        # hold the sweep N x timeout_s — stale health data exactly when
        # replicas are failing, the condition the poll exists for.  The
        # sweep's wall time is ONE probe timeout regardless of fleet size
        results = await asyncio.gather(*(
            poll_one(router, replica)
            for router in list(self._routers.values())
            for replica in router.replicas()
        ))
        return sum(results)

    async def generate(self, request: AnalysisRequest) -> AIResponse:
        config = request.provider_config or AIProviderConfig()
        # discovery-driven fleet first: when the endpoint watch has
        # populated the dynamic router, IT is the replica set — the CR's
        # apiUrl (typically the headless Service DNS) is the bootstrap
        # fallback for installs without discovery (an EMPTY dynamic
        # router falls through rather than failing every request while
        # the fleet is scaled to zero mid-wake)
        router = self._routers.get(self.DYNAMIC_KEY)
        if router is not None and len(router) > 0:
            router.fault_plan = self.fault_plan
            router.policy = self.overload_policy
        else:
            router = None
        if router is None:
            if not config.api_url:
                return AIResponse(error="provider has no apiUrl", provider_id=config.provider_id)
            try:
                replicas = replica_set(config.api_url)
            except ProviderError as exc:
                # a malformed apiUrl is a CONFIG error, not backend weather:
                # surface it verbatim (it names the offending entry) instead
                # of letting urllib produce "unknown url type" noise
                return AIResponse(error=str(exc), provider_id=config.provider_id,
                                  model_id=config.model_id)
            router = self.router_for(replicas)
        from ..serving.prompts import build_prompt  # shared with tpu-native path

        prompt = build_prompt(request)
        # value-aware overload ladder (router/value.py): consult the
        # policy BEFORE building the dispatch — shed returns here with no
        # network traffic at all; degrade truncates analysis depth AND
        # drops the cross-replica requeue allowance to 1 attempt (a
        # depth-truncated answer is not worth a second replica's time —
        # the supervisor-requeue leg of shed-lowest-value-first)
        max_tokens = max(1, config.max_tokens)
        attempts = max(1, config.max_retries)
        degraded = False
        if router.policy is not None:
            verdict = router.overload_verdict(
                value=router.policy.model.value(
                    slo_class=request.slo_class,
                    residual_s=request.deadline_s,
                    recall_p=request.recall_p,
                ),
                request_id=request_key(prompt),
                site="provider",
            )
            if verdict is not None and verdict.action == "shed":
                from ..obs import annotate_root
                from ..obs.sloledger import SLO_OUTCOME_ATTR

                annotate_root(SLO_OUTCOME_ATTR, "shed", overwrite=False)
                return AIResponse(
                    error=(
                        "request shed by overload ladder: lowest value "
                        "under storm (router/value.py)"
                    ),
                    provider_id=config.provider_id,
                    model_id=config.model_id,
                    deadline_outcome="shed",
                )
            if verdict is not None and verdict.action == "degrade":
                max_tokens = max(
                    16, int(max_tokens * verdict.degrade_tokens_frac)
                )
                attempts = 1
                degraded = True
        body = {
            "model": config.model_id,
            "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens,
            "temperature": config.temperature,
        }
        payload_bytes = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        if config.auth_token:
            headers["Authorization"] = f"Bearer {config.auth_token}"
        # W3C trace context: the analysis trace crosses into the external
        # backend (and any proxy between) — its serving-side spans join
        # OUR trace id (obs/).
        # Captured here on the event loop; the blocking call runs in a
        # worker thread where the ambient span is not visible.
        from ..obs import current_traceparent

        traceparent = current_traceparent()
        if traceparent:
            headers["traceparent"] = traceparent
        # idempotency key: a deterministic digest of the rendered prompt,
        # NOT a uuid — at-least-once dispatch (the cross-replica requeue)
        # stays deduplicatable downstream, and a seeded chaos replay
        # produces the identical key
        request_id = request_key(prompt)
        headers["x-podmortem-request-id"] = request_id

        def call(url: str, timeout_s: Optional[float]) -> AIResponse:
            req = urllib.request.Request(
                url, data=payload_bytes, headers=headers, method="POST"
            )
            with self._opener(req, timeout=timeout_s) as resp:
                payload = json.loads(resp.read().decode())
            text = payload["choices"][0]["message"]["content"]
            usage = payload.get("usage", {})
            return AIResponse(
                explanation=text,
                provider_id=config.provider_id,
                model_id=config.model_id,
                prompt_tokens=usage.get("prompt_tokens"),
                completion_tokens=usage.get("completion_tokens"),
                deadline_outcome=(
                    "completed" if request.deadline_s is not None else None
                ),
            )

        async def send(replica: Replica, attempt: int, budget_s: Optional[float]) -> AIResponse:
            # the CR's per-attempt read timeout never reaches past the
            # residual deadline the router hands this attempt
            timeout_s = float(config.timeout_seconds)
            if budget_s is not None:
                timeout_s = min(timeout_s, budget_s)
            if self.fault_plan is not None:
                # apply_async: delay/jitter actions shape provider latency
                # without blocking the loop
                await self.fault_plan.apply_async(
                    "http.provider", attempt=attempt, replica=replica.id
                )
            return await asyncio.to_thread(
                call, _completions_url(replica.url), timeout_s
            )

        # deadline budget: ABSOLUTE across the whole dispatch — retries
        # and cross-replica requeues all spend from one envelope, so
        # retrying a dead backend can never eat more than the residue
        budget = (
            Deadline.start(request.deadline_s)
            if request.deadline_s is not None
            else None
        )
        # affinity: recurrences follow the incident fingerprint (recall
        # caches are per replica), first sightings follow the shared
        # prompt prefix (the prefix-cache reuse unit)
        affinity = EngineRouter.affinity_key(
            prefix=prompt, fingerprint=request.fingerprint
        )
        try:
            outcome = await router.dispatch(
                send,
                key=affinity,
                request_id=request_id,
                deadline=budget,
                attempts=attempts,
                tokens=max_tokens,
            )
        except RouterError as exc:
            deadline_spent = budget is not None and budget.remaining() <= 0.0
            last = exc.last_error
            detail = f": {last}" if last is not None else ""
            return AIResponse(
                error=(
                    f"deadline exceeded during provider dispatch{detail}"
                    if deadline_spent
                    else f"provider failed after retries ({exc}){detail}"
                ),
                provider_id=config.provider_id,
                model_id=config.model_id,
                deadline_outcome="deadline-exceeded" if deadline_spent else None,
                replica_id=exc.tried[-1] if exc.tried else None,
            )
        response: AIResponse = outcome.response
        # the routed replica surfaces in the response metadata — the
        # flight recorder's span attrs and status entries both read it
        response.replica_id = outcome.replica_id
        response.requeues = outcome.requeues
        if degraded and response.explanation and not response.error:
            # the ladder truncated this analysis's depth: a DISTINCT
            # terminal outcome, not conflated with deadline truncation
            response.deadline_outcome = "degraded"
        return response
