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
``DECODE_BLOCK`` (4), ``PIPELINE_DEPTH`` (2), ``PREFILL_CHUNK`` (0 = one
pass; else a longer wave is prefilled that many tokens per round while
live slots decode) and ``OPERATOR_TPU_PAGED_KERNEL`` (``v1``/``v2``),
and with ``PREFIX_CACHE`` (true) primes the default template's static
preamble as the shared KV prefix; the provider registers each custom
``promptTemplate``'s preamble once (``engine.add_prefix``).  Both loops are supervised
by default, as in the reference: ``ENGINE_SUPERVISOR`` (true) with
``SUPERVISOR_STALL_S`` (120) and ``SUPERVISOR_JOIN_GRACE_S`` (10) build the
engine's ``SupervisorPolicy``.  The fleet KV fabric, on the continuous
path: ``KV_FABRIC`` (false) gives the engine a ``FabricFetcher`` over an
empty index (``KV_FABRIC_FETCH_TIMEOUT_S`` 2, ``KV_FABRIC_CONCURRENCY``
4; ``SERVING_REPLICA_ID`` or ``POD_NAME`` is the replica's own id and
``OPERATOR_TPU_API_TOKEN`` the peers' bearer token), ``KV_FABRIC_MIRROR``
(true) mirrors new prompt blocks into the host pool when there is one,
``KV_FABRIC_PEERS`` (comma-separated peer URLs) adds a ``PeerPoller``
every ``KV_FABRIC_POLL_S`` (5); ``REPLICA_ROLE`` (``mixed``) is the role
``/healthz`` advertises.

Multi-LoRA: every ``<name>.safetensors`` under ``LORA_DIR`` becomes an
adapter a request selects by name (``parallel/lora.py:load_lora``); a
file that does not load, is empty, differs from the first adapter in
targets or shapes, or is named like the base model is dropped alone,
with a warning, as in the reference.  The mixed step has no LoRA path,
so adapters under ``SCHED_MODE=continuous`` fall back to the wave engine
with the reference's warning.  The provider reads the AIProvider's
``additionalConfig``: ``lora_adapter`` selects an adapter,
``guided_regex`` (at most 1,024 characters) or ``guided_json`` (a JSON
Schema, lowered to a regex by ``serving/json_schema.py``) constrains the
explanation.

The serving programs are CUDA graphs on the card (``serving/graphs.py``),
captured by the warmup grid the caller runs (``ServingEngine.precompile``
with ``WARMUP_GRID``, as the operator does) or at each key's first use.
``AOT_CACHE_PATH`` (with ``AOT_CACHE_SALT``) gives the generator an
``AotCache`` keyed by the JAX package's fingerprint: capture records and
the kernel libraries persist there, so a warm boot builds nothing and
records every capture as a hit (``serving/aotcache.py``).

``KV_CACHE_MODE=contiguous`` builds the wave engine over a contiguous
cache (``Generator(paged=False)``, ``max_slots x max_seq`` reserved up
front, no shared-prefix priming); under ``SCHED_MODE=continuous`` it
falls back to the wave engine with the reference's warning, as LoRA
adapters do.  Any other mode raises ``ValueError`` (the reference serves
anything but ``paged`` contiguous).  ``SERVING_MESH`` (``auto`` or
``dp=N,tp=N[,fsdp=N]``, the reference's ``_parse_mesh_plan``) serves on
a mesh of the process group's ranks (``parallel/mesh.py:make_mesh``; one
process makes its own one-rank group), falling back to the wave engine
with the reference's warning under ``SCHED_MODE=continuous``: every rank
loads its shard (the sharded load, or its cut of the seeded weights) and
builds its generator; rank 0 gets the engine and drives the others
(``serving/meshserve.py``), which get a :class:`MeshFollower` to run.  As
in the reference, the queue limit
and the overload ladder are not read here: the caller that wants them
sets ``Scheduler.queue_limit``, ``Scheduler.overload_policy`` and
``Generator.overload_policy`` (the operator's pipeline, in the reference).

Weights: ``CHECKPOINT_DIR`` names a local HF-layout safetensors
checkpoint; its weights stream onto the engine's device on a background
thread (``models/loader.py:load_params_async``), quantized group by group
when serving int8, and its own ``tokenizer.json`` is the tokenizer
(``models/tokenizer.py:load_tokenizer``: any model, normalizer,
pre-tokenizer and decoder of the ``tokenizers`` library; the byte
fallback for a directory without one, a lone SentencePiece
``tokenizer.model`` included, as the reference does).  Without a checkpoint the
engine serves seeded random weights only when
``ALLOW_RANDOM_WEIGHTS=true`` — the same opt-in the JAX provider asks
for.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any, Mapping, Optional, Union

import torch

from ..fabric.disagg import normalize_role
from ..models.configs import get_config
from ..models.llama import init_params
from ..models.loader import load_params_async
from ..models.tokenizer import load_tokenizer
from ..obs import annotate_root, current_trace_id
from ..ops.paged_attention import _kernel_version
from ..parallel.lora import load_lora
from ..schema.analysis import AIResponse, AnalysisRequest
from ..utils.config import OperatorConfig
from .engine import Generator, ServingEngine, SupervisorPolicy
from .prompts import DEFAULT_TEMPLATE, build_prompt, template_preamble
from .sched.scheduler import Scheduler
from .types import DeadlineExceeded, SamplingParams

log = logging.getLogger(__name__)

__all__ = [
    "MissingCheckpoint",
    "TPUNativeProvider",
    "build_serving_engine",
    "build_tpu_native_provider",
]


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

    async def _ensure_template_prefix(self, template: Optional[str]) -> None:
        """Register a custom template's static preamble as a shared KV
        prefix, once per template: later waves of its requests prefill
        only their variable remainder (the default template's preamble is
        primed when the engine is built)."""
        if not self.register_template_prefixes:
            return
        if not template or template in self._registered_templates:
            return
        self._registered_templates.add(template)
        preamble = template_preamble(template)
        if not preamble:
            # build_prompt falls back to the default template for it: its
            # preamble would hold pages for a prefix no prompt starts with
            log.warning("promptTemplate does not render; prefix not cached")
            return
        try:
            cached = await self.engine.add_prefix(preamble)
            if cached:
                log.info("custom template preamble cached: %d tokens", cached)
        except Exception:  # noqa: BLE001 - an optimisation must never fail a request
            log.warning("custom template prefix registration failed", exc_info=True)

    def _error(self, message: str, **extra) -> AIResponse:
        return AIResponse(
            error=message, provider_id="tpu-native", model_id=self.model_id, **extra,
        )

    async def generate(self, request: AnalysisRequest) -> AIResponse:
        config = request.provider_config
        await self._ensure_template_prefix(config.prompt_template if config else None)
        prompt = build_prompt(request)
        # per-CR LoRA adapter: additionalConfig.lora_adapter names a
        # registered adapter; CRs with different adapters share one batch
        extra = (config.additional_config or {}) if config else {}
        adapter = extra.get("lora_adapter") or None
        # per-CR constrained decoding: a guided_regex pattern or a
        # guided_json schema (lowered onto the same regex automaton).  A
        # bad pattern or schema is a CONFIG error: this provider's
        # generation fails (the pipeline stores the pattern-only result)
        # rather than silently dropping the constraint the CR asked for
        guided_regex = extra.get("guided_regex") or None
        guided_schema = extra.get("guided_json") or None
        if guided_regex is not None and (
            not isinstance(guided_regex, str) or len(guided_regex) > 1024
        ):
            # the HTTP entry point's bound: an unbounded pattern from one
            # misconfigured CR must not stall the automaton build
            return self._error(
                "additionalConfig.guided_regex must be a string of <=1024 chars"
            )
        if guided_schema is not None:
            if guided_regex is not None:
                return self._error(
                    "additionalConfig guided_json and guided_regex are "
                    "mutually exclusive"
                )
            from .json_schema import lower_guided_json

            try:
                guided_regex = lower_guided_json(guided_schema)
            except ValueError as exc:
                return self._error(f"additionalConfig.guided_json: {exc}")
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
            adapter=adapter,
            guided_regex=guided_regex,
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


def _parse_mesh_plan(spec: str, devices: list, model_config: Any) -> Any:
    """'auto' or 'dp=2,tp=4[,fsdp=1]' -> MeshPlan (the reference's
    ``_parse_mesh_plan``); ``devices`` are the process group's ranks'
    cards (one process: one)."""
    from ..parallel.mesh import MeshPlan, plan_for

    if spec == "auto":
        # the cards, so tp sizing uses their memory, not the fallback budget
        return plan_for(len(devices), config=model_config, devices=devices)
    sizes = {"dp": 1, "fsdp": 1, "tp": 1}
    for part in spec.split(","):
        axis, _, value = part.strip().partition("=")
        if axis not in sizes or not value.isdigit():
            raise ValueError(
                f"bad serving_mesh {spec!r}: expected 'auto' or 'dp=N,tp=N[,fsdp=N]'"
            )
        sizes[axis] = int(value)
    plan = MeshPlan(**sizes)
    if plan.total > len(devices):
        raise ValueError(
            f"serving_mesh {spec!r} needs {plan.total} devices, found {len(devices)}"
        )
    return plan


def _serving_mesh(spec: str, device: torch.device, model_config: Any) -> Any:
    """The serving mesh of ``SERVING_MESH``: over the launcher's process
    group (joined here, with :data:`meshserve.FOLLOWER_TIMEOUT_S` as its
    collectives' timeout), or a one-rank group of this process."""
    from datetime import timedelta

    import torch.distributed as dist

    from ..parallel.mesh import initialize_distributed, launched, make_mesh, mesh_summary
    from .meshserve import FOLLOWER_TIMEOUT_S

    if not dist.is_initialized() and launched():
        initialize_distributed(timeout=timedelta(seconds=FOLLOWER_TIMEOUT_S))
    world = dist.get_world_size() if dist.is_initialized() else 1
    plan = _parse_mesh_plan(spec, [device] * world, model_config)
    mesh = make_mesh(plan, device_type=device.type)
    log.info("sharded serving: %s", mesh_summary(mesh))
    return mesh


def _load_lora_dir(
    lora_dir: str, model_id: str, device: torch.device
) -> Optional[dict]:
    """The multi-LoRA registry: every ``<name>.safetensors`` under
    ``lora_dir`` that loads and matches the first adapter's targets and
    shapes (one pass serves the whole stack); a bad file drops only its
    own adapter.  None when no adapter is usable."""
    if not os.path.isdir(lora_dir):
        log.warning(
            "lora_dir %r does not exist or is not a directory; "
            "multi-LoRA serving disabled", lora_dir,
        )
        return None
    adapters = {}
    for fname in sorted(os.listdir(lora_dir)):
        if not fname.endswith(".safetensors"):
            continue
        name = fname[: -len(".safetensors")]
        try:
            adapters[name] = load_lora(os.path.join(lora_dir, fname), device=device)
        except Exception:  # noqa: BLE001 - one bad file must not stop serving
            log.warning("LoRA adapter %s unusable; skipping", fname, exc_info=True)
    signature = None
    for name in sorted(adapters):
        adapter = adapters[name]
        sig = tuple(
            (target, tuple(adapter[target]["a"].shape), tuple(adapter[target]["b"].shape))
            for target in sorted(adapter)
        )
        if not sig:
            log.warning("LoRA adapter %r is empty; skipping", name)
            del adapters[name]
        elif name == model_id:
            log.warning(
                "LoRA adapter %r collides with the base model id and "
                "would be unroutable over the API; skipping", name,
            )
            del adapters[name]
        elif signature is None:
            signature = sig
        elif sig != signature:
            log.warning(
                "LoRA adapter %r has targets/shapes %s != %s of the first "
                "adapter; skipping (adapters must match to share one "
                "compiled program)", name, sig, signature,
            )
            del adapters[name]
    log.info("multi-LoRA serving: %s", sorted(adapters) or "none loaded")
    return adapters or None


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
    from ``OPERATOR_TPU_MODEL`` in ``environ`` either way.  A row holds
    ``SERVING_MAX_SEQ`` positions, up to the model's ``max_seq_len``, or
    the reference's ``min(max_seq_len, 2048)`` when it is unset or 0.  With a
    ``SERVING_MESH`` of several ranks, a rank other than 0 gets a
    ``serving/meshserve.py:MeshFollower`` in the engine's place: its
    ``run()`` serves rank 0's calls until rank 0's engine closes."""
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
    if config.kv_cache_mode not in ("paged", "contiguous"):
        # stricter than the reference, which serves anything but "paged"
        # contiguous
        raise ValueError(
            f"unknown KV_CACHE_MODE {config.kv_cache_mode!r}: expected 'paged' or 'contiguous'"
        )
    paged = config.kv_cache_mode == "paged"
    mesh = None
    if config.serving_mesh:
        mesh = _serving_mesh(config.serving_mesh, device, model_config)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
    lora_adapters = None
    if config.lora_dir:
        lora_adapters = _load_lora_dir(config.lora_dir, model_id, device)
    wave = config.sched_mode == "wave"
    if not wave and (lora_adapters or not paged or mesh is not None):
        # the mixed step has paged KV only, and no mesh or LoRA path: the
        # reference's fallback
        log.warning(
            "sched_mode=continuous requires paged KV, no mesh and no "
            "LoRA adapters (paged=%s mesh=%s lora=%s); falling back "
            "to the wave engine", paged, mesh is not None, bool(lora_adapters),
        )
        wave = True
    if wave:
        _kernel_version(env)  # an unknown decode-kernel selector fails here
    checkpoint_dir = config.checkpoint_dir
    tokenizer = load_tokenizer(checkpoint_dir)
    quantize = serving_dtype == "int8"
    prefill_chunk = config.prefill_chunk or None
    max_seq = config.serving_max_seq or min(model_config.max_seq_len, 2048)
    if not 0 < max_seq <= model_config.max_seq_len:
        raise ValueError(
            f"SERVING_MAX_SEQ={max_seq} is outside {model_id}'s context of "
            f"{model_config.max_seq_len} positions"
        )
    aot = None
    if config.aot_cache_path:
        from .aotcache import AotCache, generator_fingerprint

        try:
            aot = AotCache(config.aot_cache_path, generator_fingerprint(
                config=model_config,
                weight_dtype="int8" if quantize else "bfloat16",
                max_slots=config.max_batch_size,
                max_seq=max_seq,
                paged=paged,
                page_size=config.kv_page_size,
                kv_pages=config.kv_pages or None,
                decode_block=config.decode_block,
                sample_top_k=config.sample_top_k,
                pipeline_depth=config.pipeline_depth,
                prefill_chunk=prefill_chunk,
                sched_pipeline_depth=config.sched_pipeline_depth,
                spec_width=1 + (config.spec_lookup_k if config.spec_decode else 0),
                kv_prefix_cache=config.kv_prefix_cache,
                lora_names=sorted(lora_adapters) if lora_adapters else (),
                mesh=mesh,
            ))
        except Exception:  # noqa: BLE001 - the cache is an optimisation only
            log.warning("AOT executable cache disabled", exc_info=True)
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        log.info("loading %s weights from %s", model_id, checkpoint_dir)
        # quantize-at-load: each layer group quantizes as it lands, so an
        # int8 load peaks at the int8 tree plus one bf16 group
        handle = load_params_async(
            checkpoint_dir, model_config, torch.bfloat16, device=device, quantize=quantize,
            mesh=mesh,
        )
        params = handle.result()
        log.info("weight stream finished in %.1fs", handle.seconds or 0.0)
    elif config.allow_random_weights:
        log.warning(
            "no checkpoint for %s (checkpoint_dir=%r); using seeded random init "
            "— output will be non-linguistic (ALLOW_RANDOM_WEIGHTS set)",
            model_id, checkpoint_dir,
        )
        params = _seeded_params(model_config, seed, device, quantize, mesh)
    else:
        raise MissingCheckpoint(
            f"providerId tpu-native needs weights for {model_id!r} but "
            f"checkpoint_dir={checkpoint_dir!r} does not exist; mount a "
            f"checkpoint or set ALLOW_RANDOM_WEIGHTS=true (testing only)"
        )
    generator = Generator(
        params, model_config, tokenizer,
        max_slots=config.max_batch_size,
        max_seq=max_seq,
        page_size=config.kv_page_size,
        kv_pages=config.kv_pages or None,
        cache_dtype=torch.bfloat16,
        sample_top_k=config.sample_top_k,
        decode_block=config.decode_block,
        pipeline_depth=config.pipeline_depth,
        step_ring_capacity=config.step_ring_capacity,
        seed=seed,
        device=device,
        lora_adapters=lora_adapters,
        lora_alpha=config.lora_alpha,
        aot_cache=aot,
        prefill_chunk=prefill_chunk,
        paged=paged,
        mesh=mesh,
    )
    if mesh is not None and mesh.size() > 1:
        from torch.distributed import get_rank

        from .meshserve import MeshDriver, MeshFollower, command_group

        group = command_group()
        if get_rank() != 0:
            # the follower makes rank 0's calls (priming included) in order
            return MeshFollower(generator, group), model_id
        MeshDriver(generator, group)
    # supervised by default (the reference's production wiring): a stalled
    # or errored loop resets the engine and requeues in-flight requests
    # once with their residual deadlines
    supervisor = None
    if config.engine_supervisor:
        supervisor = SupervisorPolicy(
            stall_timeout_s=config.supervisor_stall_s,
            join_grace_s=config.supervisor_join_grace_s,
        )
    if wave:
        log.info("serving mode: WAVE engine (sched_mode=%s)", config.sched_mode)
        if config.prefix_cache and paged:
            # every explanation request shares the default template's
            # static preamble: its KV is cached once, and each wave of
            # such prompts prefills only its remainder.  Continuous mode
            # skips it: the scheduler's block-hash cache shares the head,
            # and primed pages would only shrink its pool; so does a
            # contiguous engine, which has no pages to prime
            try:
                generator.set_shared_prefix(template_preamble(DEFAULT_TEMPLATE))
            except Exception:  # noqa: BLE001 - an optimisation must never block startup
                log.warning("shared-prefix priming failed; serving without it", exc_info=True)
        engine = ServingEngine(generator, supervisor=supervisor)
        return _with_role(engine, config), model_id
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
        # the fleet KV fabric: mirror newly registered prompt blocks into
        # the host pool so peers can fetch them over GET /kv/blocks/{hash}
        fabric_mirror=(
            config.kv_fabric
            and config.kv_fabric_mirror
            and kvstore is not None
            and kvstore.host_pool is not None
        ),
    )
    log.info(
        "serving mode: CONTINUOUS scheduler (pipeline_depth=%d "
        "spec_decode=%s spec_lookup_k=%d kv_prefix_cache=%s "
        "kv_host_pool_mb=%d); SCHED_MODE=wave opts out",
        scheduler.depth, scheduler.spec_k > 0, scheduler.spec_k,
        scheduler._kvstore is not None, config.kv_host_pool_mb,
    )
    engine = _with_role(ServingEngine(generator, scheduler, supervisor=supervisor), config)
    if config.kv_fabric:
        _with_fabric(engine, config, env)
    return engine, model_id


def _seeded_params(model_config: Any, seed: int, device: torch.device, quantize: bool,
                   mesh: Any) -> Any:
    """The seeded random weights, on a mesh cut to this rank's shards.
    Every rank draws the whole tree (the same draws on every rank);
    ranks sharing a card draw in turn, each keeping only its shards, so
    the card never holds more than one rank's whole tree."""
    def draw() -> Any:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(model_config, gen, torch.bfloat16, device=device, quantize=quantize)
        if mesh is None:
            return params
        from ..parallel.mesh import ServingShard

        local = ServingShard(mesh).local_params(params, model_config, quantized=quantize)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return local

    if mesh is None or device.type != "cuda" or mesh.size() <= torch.cuda.device_count():
        return draw()
    import torch.distributed as dist

    params = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            params = draw()
        dist.barrier()
    return params


def _with_role(engine: ServingEngine, config: OperatorConfig) -> ServingEngine:
    """The disaggregation role ``/healthz`` advertises (``REPLICA_ROLE``),
    validated as the reference does; the router prefers, never filters,
    by it."""
    engine.replica_role = normalize_role(config.replica_role)
    return engine


def _with_fabric(engine: ServingEngine, config: OperatorConfig, env: Mapping[str, str]) -> None:
    """The fleet KV fabric, as the reference wires it: a fetcher over a
    private empty index, fed by an in-process router's ``kv_index`` (the
    caller sets ``engine.fabric.index``) or by the ``KV_FABRIC_PEERS``
    poller; with neither, the empty-index gate makes the fabric cost a
    request nothing."""
    from ..fabric.fetch import FabricFetcher
    from ..fabric.index import FabricIndex

    metrics = engine.generator.metrics
    self_id = env.get("SERVING_REPLICA_ID") or env.get("POD_NAME") or ""
    engine.fabric = FabricFetcher(
        FabricIndex(),
        api_token=env.get("OPERATOR_TPU_API_TOKEN") or None,
        timeout_s=config.kv_fabric_fetch_timeout_s,
        concurrency=config.kv_fabric_concurrency,
        self_id=self_id,
        metrics=metrics,
    )
    peers = [u.strip() for u in config.kv_fabric_peers.split(",") if u.strip()]
    if peers:
        from ..fabric.peers import PeerPoller

        engine.fabric_poller = PeerPoller(
            engine.fabric.index,
            peers=peers,
            self_id=self_id,
            poll_s=config.kv_fabric_poll_s,
            timeout_s=config.kv_fabric_fetch_timeout_s,
            metrics=metrics,
        )
    log.info(
        "fleet KV fabric: fetch timeout %.2fs concurrency %d role %s "
        "mirror %s peers %s",
        config.kv_fabric_fetch_timeout_s, config.kv_fabric_concurrency,
        engine.replica_role, config.kv_fabric_mirror,
        ",".join(peers) or "<in-process index>",
    )


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
