"""Build the port's serving engine from the serving environment.

The counterpart of ``operator_tpu/serving/provider.py:build_serving_engine``.
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

Weights: the checkpoint loader is not ported yet, so a configured
checkpoint directory is refused, and without one the engine serves
seeded random weights only when ``ALLOW_RANDOM_WEIGHTS=true`` — the same
opt-in the JAX provider asks for.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional, Union

import torch

from ..models.configs import get_config
from ..models.llama import init_params
from ..models.tokenizer import ByteTokenizer
from ..ops.paged_attention import _kernel_version
from ..utils.config import OperatorConfig
from .engine import Generator, ServingEngine
from .sched.scheduler import Scheduler

log = logging.getLogger(__name__)

__all__ = ["MissingCheckpoint", "build_serving_engine"]


class MissingCheckpoint(RuntimeError):
    """No weights to serve and random weights were not allowed."""


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
) -> "tuple[ServingEngine, str]":
    """Build ``(engine, model_id)`` from ``environ`` (default
    ``os.environ``) on ``device`` (default ``cuda``)."""
    from ..utils.device import resolve_device

    env = dict(os.environ if environ is None else environ)
    config = OperatorConfig.from_env(env)
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
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        raise NotImplementedError(
            f"checkpoint loading ({checkpoint_dir!r}) is not ported to "
            f"operator_tpu_torch yet (ROADMAP.md Queue 1 item 4); unset "
            f"CHECKPOINT_DIR and set ALLOW_RANDOM_WEIGHTS=true to serve "
            f"random weights"
        )
    if not config.allow_random_weights:
        raise MissingCheckpoint(
            f"no checkpoint for {model_id!r} (checkpoint_dir="
            f"{checkpoint_dir!r}); set ALLOW_RANDOM_WEIGHTS=true (testing only)"
        )
    log.warning(
        "no checkpoint for %s; using seeded random init — output will be "
        "non-linguistic (ALLOW_RANDOM_WEIGHTS set)", model_id,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(
        model_config, gen, torch.bfloat16, device=device,
        quantize=serving_dtype == "int8",
    )
    generator = Generator(
        params, model_config, ByteTokenizer(),
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
        return ServingEngine(generator), model_id
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
    return ServingEngine(generator, scheduler), model_id
