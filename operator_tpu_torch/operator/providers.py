"""AI provider backends + resolution of AIProvider CRs into runtime config.

The port's own copy of ``operator_tpu/operator/providers.py``.  Providers
are in-process backends behind one async interface:

- ``tpu-native``  — the in-tree serving engine on the card (registered by
  the operator as a lazy factory, ``operator/app.py``);
- ``template``    — deterministic pattern-based explanations, no model
  (fallback + tests);
- ``openai`` / ``ollama`` / ``openai-compatible`` — the OpenAI-compatible
  HTTP client and its replica router are not ported yet (ROADMAP.md Queue
  1 item 5a): these ids resolve through a factory that raises
  ``NotImplementedError`` naming the item, so the pipeline stores the
  pattern result with the error in an Event, as it does for any provider
  whose factory raises.

Config resolution mirrors AIInterfaceClient.convertToProviderConfig: CR
spec + defaults + auth token base64-decoded from the referenced Secret.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
from collections import OrderedDict
from typing import Callable, Optional, Protocol

from ..router.health import BreakerBoard, CircuitBreaker  # noqa: F401
from ..schema.analysis import AIProviderConfig, AIResponse, AnalysisRequest
from ..schema.crds import AIProvider
from ..schema.kube import Secret
from ..utils.deadline import Deadline
from .kubeapi import ApiError, KubeApi, NotFoundError

log = logging.getLogger(__name__)

#: the providerIds the JAX package serves with its OpenAI-compatible client
HTTP_PROVIDER_IDS = ("openai", "ollama", "openai-compatible")


def http_provider_unported() -> "AIProviderBackend":
    """The factory behind every HTTP providerId: the OpenAI-compatible
    client is not ported yet."""
    raise NotImplementedError(
        "the OpenAI-compatible HTTP provider (openai, ollama, openai-compatible) "
        "is not ported to operator_tpu_torch yet (ROADMAP.md Queue 1 item 5a); "
        "use providerId tpu-native or template"
    )


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
                self.register_factory(pid, http_provider_unported)
                return self.resolve(pid)
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
