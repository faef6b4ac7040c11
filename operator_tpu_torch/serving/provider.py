"""The ``tpu-native`` AI provider and the serving engine it runs on.

The counterpart of ``operator_tpu/serving/provider.py``:
:class:`TPUNativeProvider` turns an ``AnalysisRequest`` into a prompt
(``serving/prompts.py``, the AIProvider CR's ``promptTemplate``,
``maxTokens`` and ``temperature``) and an explanation from the in-process
engine; :func:`build_serving_engine` builds that engine, shared with the
HTTP server; :func:`build_tpu_native_provider` is the provider factory.

``build_serving_engine`` follows ``operator_tpu/serving/provider.py:build_serving_engine``.
The environment is read through the port's copy of ``OperatorConfig``
(``utils/config.py``), so one environment resolves to the same settings
in both packages: ``OPERATOR_TPU_MODEL`` (else ``MODEL_ID``,
``tinyllama-1.1b``), ``WEIGHT_DTYPE`` over ``SERVING_DTYPE`` (``int8``; or
``bf16``), ``MAX_BATCH_SIZE`` (32), ``KV_PAGE_SIZE`` (64), ``KV_PAGES`` (0 =
worst case), ``SAMPLE_TOP_K`` (64), ``STEP_RING_CAPACITY`` (512),
``KV_CACHE_MODE`` (``paged``), ``SCHED_MODE`` (``continuous``, or ``wave``),
``ALLOW_RANDOM_WEIGHTS``, ``CHECKPOINT_DIR``.  The continuous scheduler
reads ``SCHED_CHUNK`` (64), ``SCHED_TOKEN_BUDGET`` (0 = auto),
``SCHED_PIPELINE_DEPTH`` (2), ``SPEC_DECODE`` (true), ``SPEC_LOOKUP_K`` (4)
and the block-hash prefix cache, ``KV_PREFIX_CACHE`` (true) with its
host-RAM pool ``KV_HOST_POOL_MB`` (0 = none); the wave engine reads
``DECODE_BLOCK`` (4), ``PIPELINE_DEPTH`` (2) and
``OPERATOR_TPU_PAGED_KERNEL`` (``v1``/``v2``).

A knob whose feature is not ported is refused when it is set away from
its default, naming the ROADMAP Queue 1 item that ports it:
``KV_CACHE_MODE=contiguous`` (item 8), ``PREFILL_CHUNK`` (item 7),
``SERVING_MESH`` (item 11), ``LORA_DIR`` (item 9), ``AOT_CACHE_PATH``
(item 10) and ``KV_FABRIC`` (item 5b).  The reference would fall back to
the wave engine for a mesh or LoRA on the continuous path; the port does
not serve something else quietly.  As in the reference, the queue limit
and the overload ladder are not read here: the caller that wants them
sets ``Scheduler.queue_limit``, ``Scheduler.overload_policy`` and
``Generator.overload_policy`` (the operator's pipeline, in the reference).

Weights: ``CHECKPOINT_DIR`` names a local HF-layout safetensors
checkpoint; its weights stream onto the engine's device on a background
thread (``models/loader.py:load_params_async``), quantized group by group
when serving int8, and its own ``tokenizer.json`` is the tokenizer
(``models/tokenizer.py:load_tokenizer``, which falls back to bytes for a
directory without one, as the reference does).  Without a checkpoint the
engine serves seeded random weights only when
``ALLOW_RANDOM_WEIGHTS=true`` — the same opt-in the JAX provider asks
for.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Mapping, Optional, Union

import torch

from ..fabric.disagg import normalize_role
from ..models.configs import get_config
from ..models.llama import init_params
from ..models.loader import load_params_async
from ..models.tokenizer import load_tokenizer
from ..obs import annotate_root, current_trace_id
from ..ops.paged_attention import _kernel_version
from ..schema.analysis import AIResponse, AnalysisRequest
from ..utils.config import OperatorConfig
from .engine import Generator, ServingEngine
from .prompts import build_prompt, template_preamble
from .sched.scheduler import Scheduler
from .types import DeadlineExceeded, SamplingParams

log = logging.getLogger(__name__)

__all__ = [
    "MissingCheckpoint",
    "TPUNativeProvider",
    "build_serving_engine",
    "build_tpu_native_provider",
]

#: ``additionalConfig`` keys whose features are not ported
_NOT_PORTED_EXTRA = ("guided_regex", "guided_json", "lora_adapter")


class MissingCheckpoint(RuntimeError):
    """No weights to serve and random weights were not allowed."""


class TPUNativeProvider:
    """AIProviderBackend serving explanations from the in-process engine."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        model_id: str,
        register_template_prefixes: bool = True,
    ) -> None:
        self.engine = engine
        self.model_id = model_id
        #: follows the operator's PREFIX_CACHE config, as in the reference
        self.register_template_prefixes = register_template_prefixes
        # custom promptTemplates already seen — one note per template
        self._registered_templates: set[str] = set()

    def _ensure_template_prefix(self, template: Optional[str]) -> None:
        """The reference registers a custom template's static preamble as
        the wave engine's shared KV prefix (``engine.add_prefix``), once
        per template.  That prefix is not ported (ROADMAP Queue 1 item 6):
        this notes it once per template and carries on.  On the
        continuous path the block-hash prefix cache shares the template's
        head anyway."""
        if not self.register_template_prefixes:
            return
        if not template or template in self._registered_templates:
            return
        self._registered_templates.add(template)
        if not template_preamble(template):
            log.warning("promptTemplate does not render; prefix not cached")
            return
        log.info(
            "custom template preamble not registered as a shared prefix: the "
            "wave engine's shared prefix is not ported (ROADMAP.md Queue 1 item 6)"
        )

    def _error(self, message: str, **extra) -> AIResponse:
        return AIResponse(
            error=message, provider_id="tpu-native", model_id=self.model_id, **extra,
        )

    async def generate(self, request: AnalysisRequest) -> AIResponse:
        config = request.provider_config
        self._ensure_template_prefix(config.prompt_template if config else None)
        extra = (config.additional_config or {}) if config else {}
        asked = [key for key in _NOT_PORTED_EXTRA if extra.get(key)]
        if asked:
            # the pipeline's degrade path: a pattern-only result, not a raise
            return self._error(
                f"additionalConfig {', '.join(asked)}: guided decoding and LoRA "
                "adapters are not ported to operator_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 9)"
            )
        prompt = build_prompt(request)
        # deadline budget: the pipeline's residual envelope becomes an
        # absolute admission deadline — the engine clamps max_tokens to the
        # roofline fit or rejects outright (serving/admission.py)
        abs_deadline = None
        if request.deadline_s is not None:
            abs_deadline = self.engine.generator._clock() + max(0.0, request.deadline_s)
        params = SamplingParams(
            max_tokens=(config.max_tokens if config and config.max_tokens else 500),
            temperature=(
                config.temperature if config and config.temperature is not None else 0.3
            ),
            deadline=abs_deadline,
            trace_tag=current_trace_id(),
        )
        try:
            # priority 10: pod-failure explanations admit ahead of external
            # completion-API callers sharing the engine
            result = await self.engine.generate(prompt, params, priority=10)
        except asyncio.CancelledError:
            raise
        except DeadlineExceeded as exc:
            # no card time was spent: admission refused the residue
            return self._error(
                f"deadline exceeded before generation: {exc}",
                deadline_outcome="deadline-exceeded",
            )
        except Exception as exc:  # noqa: BLE001 - pipeline degrades to pattern-only
            log.exception("tpu-native generation failed")
            # flag the ambient trace for a black-box dump
            annotate_root("blackbox", "engine-error", overwrite=False)
            return self._error(str(exc))
        outcome = None
        if abs_deadline is not None:
            outcome = "truncated" if result.finish_reason == "deadline" else "completed"
        return AIResponse(
            explanation=result.text,
            provider_id="tpu-native",
            model_id=self.model_id,
            prompt_tokens=result.prompt_tokens,
            completion_tokens=result.completion_tokens,
            deadline_outcome=outcome,
        )


def _refuse_unported(config: OperatorConfig) -> None:
    """Raise for a knob set away from its default whose feature is not
    ported, naming its ROADMAP Queue 1 item."""
    unported = (
        ("PREFILL_CHUNK", config.prefill_chunk, "7", "the wave engine's chunked prefill"),
        ("SERVING_MESH", config.serving_mesh, "11", "multi-device serving"),
        ("LORA_DIR", config.lora_dir, "9", "LoRA adapters"),
        ("AOT_CACHE_PATH", config.aot_cache_path, "10", "the AOT executable cache"),
        ("KV_FABRIC", config.kv_fabric, "5b", "the fleet KV fabric"),
    )
    for name, value, item, feature in unported:
        if value:
            raise NotImplementedError(
                f"{name}={value!r}: {feature} is not ported to "
                f"operator_tpu_torch yet (ROADMAP.md Queue 1 item {item}); "
                f"unset {name}"
            )


def build_serving_engine(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    *,
    seed: int = 0,
    config: Optional[OperatorConfig] = None,
) -> "tuple[ServingEngine, str]":
    """Build ``(engine, model_id)`` from ``environ`` (default
    ``os.environ``) on ``device`` (default ``cuda``).  ``config`` (the
    operator's) takes the place of ``OperatorConfig.from_env(environ)``,
    as the JAX package's ``build_serving_engine`` takes it; the model id is read
    from ``OPERATOR_TPU_MODEL`` in ``environ`` either way."""
    from ..utils.device import resolve_device

    env = dict(os.environ if environ is None else environ)
    config = OperatorConfig.from_env(env) if config is None else config
    device = resolve_device(device)
    model_id = (env.get("OPERATOR_TPU_MODEL") or "").strip() or config.model_id
    model_config = get_config(model_id)
    # WEIGHT_DTYPE (when set) wins over the serving_dtype default
    serving_dtype = (config.weight_dtype or config.serving_dtype or "bf16").lower()
    if serving_dtype not in ("int8", "bf16", "bfloat16"):
        raise ValueError(f"unknown serving dtype {serving_dtype!r}")
    if config.sched_mode not in ("continuous", "wave"):
        raise ValueError(
            f"unknown sched_mode {config.sched_mode!r}: expected 'wave' or 'continuous'"
        )
    if config.kv_cache_mode == "contiguous":
        raise NotImplementedError(
            "KV_CACHE_MODE=contiguous is not ported to operator_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 8, 'Wave engine: contiguous KV'); use paged"
        )
    if config.kv_cache_mode != "paged":
        raise ValueError(f"unknown KV_CACHE_MODE {config.kv_cache_mode!r}: expected 'paged'")
    _refuse_unported(config)
    if config.sched_mode == "wave":
        _kernel_version(env)  # an unknown decode-kernel selector fails here
    checkpoint_dir = config.checkpoint_dir
    tokenizer = load_tokenizer(checkpoint_dir)
    quantize = serving_dtype == "int8"
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        log.info("loading %s weights from %s", model_id, checkpoint_dir)
        # quantize-at-load: each layer group quantizes as it lands, so an
        # int8 load peaks at the int8 tree plus one bf16 group
        handle = load_params_async(
            checkpoint_dir, model_config, torch.bfloat16, device=device, quantize=quantize,
        )
        params = handle.result()
        log.info("weight stream finished in %.1fs", handle.seconds or 0.0)
    elif config.allow_random_weights:
        log.warning(
            "no checkpoint for %s (checkpoint_dir=%r); using seeded random init "
            "— output will be non-linguistic (ALLOW_RANDOM_WEIGHTS set)",
            model_id, checkpoint_dir,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(model_config, gen, torch.bfloat16, device=device, quantize=quantize)
    else:
        raise MissingCheckpoint(
            f"providerId tpu-native needs weights for {model_id!r} but "
            f"checkpoint_dir={checkpoint_dir!r} does not exist; mount a "
            f"checkpoint or set ALLOW_RANDOM_WEIGHTS=true (testing only)"
        )
    generator = Generator(
        params, model_config, tokenizer,
        max_slots=config.max_batch_size,
        max_seq=min(model_config.max_seq_len, 2048),
        page_size=config.kv_page_size,
        kv_pages=config.kv_pages or None,
        cache_dtype=torch.bfloat16,
        sample_top_k=config.sample_top_k,
        decode_block=config.decode_block,
        pipeline_depth=config.pipeline_depth,
        step_ring_capacity=config.step_ring_capacity,
        seed=seed,
        device=device,
    )
    if config.sched_mode == "wave":
        log.info("serving mode: WAVE engine (sched_mode=%s)", config.sched_mode)
        # the JAX provider primes the default template's shared prefix
        # here; the port has no shared-prefix path yet (Queue 1 item 6)
        log.info("shared-prefix priming is not ported; every prompt is prefilled in full")
        return _with_role(ServingEngine(generator), config), model_id
    # automatic block-hash prefix caching (serving/kvstore.py), with an
    # optional host-RAM tier for evicted blocks (ops/kv_transfer.py)
    kvstore = None
    if config.kv_prefix_cache:
        from .kvstore import PrefixKVStore

        host_pool = None
        if config.kv_host_pool_mb > 0:
            from ..ops.kv_transfer import HostKVPool

            host_pool = HostKVPool(config.kv_host_pool_mb)
        kvstore = PrefixKVStore(
            config.kv_page_size, host_pool=host_pool, metrics=generator.metrics,
        )
    scheduler = Scheduler(
        generator,
        chunk=config.sched_chunk,
        token_budget=config.sched_token_budget,
        pipeline_depth=config.sched_pipeline_depth,
        spec_decode=config.spec_decode,
        spec_lookup_k=config.spec_lookup_k,
        kvstore=kvstore,
    )
    log.info(
        "serving mode: CONTINUOUS scheduler (pipeline_depth=%d "
        "spec_decode=%s spec_lookup_k=%d kv_prefix_cache=%s "
        "kv_host_pool_mb=%d); SCHED_MODE=wave opts out",
        scheduler.depth, scheduler.spec_k > 0, scheduler.spec_k,
        scheduler._kvstore is not None, config.kv_host_pool_mb,
    )
    return _with_role(ServingEngine(generator, scheduler), config), model_id


def _with_role(engine: ServingEngine, config: OperatorConfig) -> ServingEngine:
    """The disaggregation role ``/healthz`` advertises (``REPLICA_ROLE``),
    validated as the reference does; the router prefers, never filters,
    by it."""
    engine.replica_role = normalize_role(config.replica_role)
    return engine


def build_tpu_native_provider(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    *,
    seed: int = 0,
    config: Optional[OperatorConfig] = None,
) -> TPUNativeProvider:
    """Factory for the ``tpu-native`` provider: builds the shared engine
    once (:func:`build_serving_engine`, ``config`` as there); every
    AIProvider CR with ``providerId: tpu-native`` then multiplexes onto
    the same batch."""
    env = dict(os.environ if environ is None else environ)
    config = OperatorConfig.from_env(env) if config is None else config
    engine, model_id = build_serving_engine(device, env, seed=seed, config=config)
    return TPUNativeProvider(
        engine, model_id=model_id, register_template_prefixes=config.prefix_cache,
    )
