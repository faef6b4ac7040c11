"""Build the port's serving engine from the serving environment.

The counterpart of ``operator_tpu/serving/provider.py:build_serving_engine``
with the JAX package's environment names and defaults:
``OPERATOR_TPU_MODEL`` (``tinyllama-1.1b``), ``SERVING_DTYPE`` (``int8``;
or ``bf16``), ``MAX_BATCH_SIZE`` (32), ``KV_PAGE_SIZE`` (64),
``KV_CACHE_MODE`` (``paged``, the only mode ported), ``SCHED_MODE``
(``continuous``, or ``wave``), ``ALLOW_RANDOM_WEIGHTS`` (false),
``CHECKPOINT_DIR``.  The continuous scheduler reads ``SCHED_CHUNK`` (64),
``SCHED_TOKEN_BUDGET`` (0 = auto), ``SCHED_PIPELINE_DEPTH`` (2) and
``SPEC_DECODE`` (true); the wave engine ``DECODE_BLOCK`` (4),
``PIPELINE_DEPTH`` (2) and ``OPERATOR_TPU_PAGED_KERNEL`` (``v1``/``v2``).

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
from .engine import Generator, ServingEngine
from .sched.scheduler import Scheduler

log = logging.getLogger(__name__)

__all__ = ["MissingCheckpoint", "build_serving_engine"]

_TRUE = ("1", "true", "yes", "on")


class MissingCheckpoint(RuntimeError):
    """No weights to serve and random weights were not allowed."""


def _flag(env: Mapping[str, str], name: str, default: bool) -> bool:
    raw = env.get(name, "").strip().lower()
    return default if not raw else raw in _TRUE


def _int(env: Mapping[str, str], name: str, default: int) -> int:
    raw = env.get(name, "").strip()
    return int(raw) if raw else default


def build_serving_engine(
    device: Union[str, torch.device, None] = None,
    environ: Optional[Mapping[str, str]] = None,
    *,
    seed: int = 0,
) -> "tuple[ServingEngine, str]":
    """Build ``(engine, model_id)`` from ``environ`` (default
    ``os.environ``) on ``device`` (default ``cuda``)."""
    from ..utils.device import resolve_device

    env = os.environ if environ is None else environ
    device = resolve_device(device)
    model_id = env.get("OPERATOR_TPU_MODEL", "").strip() or "tinyllama-1.1b"
    config = get_config(model_id)
    serving_dtype = (env.get("SERVING_DTYPE", "").strip() or "int8").lower()
    if serving_dtype not in ("int8", "bf16", "bfloat16"):
        raise ValueError(f"unknown serving dtype {serving_dtype!r}")
    sched_mode = (env.get("SCHED_MODE", "").strip() or "continuous").lower()
    if sched_mode not in ("continuous", "wave"):
        raise ValueError(
            f"unknown sched_mode {sched_mode!r}: expected 'wave' or 'continuous'"
        )
    kv_mode = (env.get("KV_CACHE_MODE", "").strip() or "paged").lower()
    if kv_mode == "contiguous":
        raise NotImplementedError(
            "KV_CACHE_MODE=contiguous is not ported to operator_tpu_torch yet "
            "(ROADMAP.md Queue 1, 'Wave engine: contiguous KV'); use paged"
        )
    if kv_mode != "paged":
        raise ValueError(f"unknown KV_CACHE_MODE {kv_mode!r}: expected 'paged'")
    if sched_mode == "wave":
        _kernel_version(env)  # an unknown decode-kernel selector fails here
    checkpoint_dir = env.get("CHECKPOINT_DIR", "").strip()
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        raise NotImplementedError(
            f"checkpoint loading ({checkpoint_dir!r}) is not ported to "
            f"operator_tpu_torch yet; unset CHECKPOINT_DIR and set "
            f"ALLOW_RANDOM_WEIGHTS=true to serve random weights"
        )
    if not _flag(env, "ALLOW_RANDOM_WEIGHTS", False):
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
        config, gen, torch.bfloat16, device=device,
        quantize=serving_dtype == "int8",
    )
    generator = Generator(
        params, config, ByteTokenizer(),
        max_slots=_int(env, "MAX_BATCH_SIZE", 32),
        max_seq=min(config.max_seq_len, 2048),
        page_size=_int(env, "KV_PAGE_SIZE", 64),
        cache_dtype=torch.bfloat16,
        decode_block=_int(env, "DECODE_BLOCK", 4),
        pipeline_depth=_int(env, "PIPELINE_DEPTH", 2),
        seed=seed,
        device=device,
    )
    if sched_mode == "wave":
        log.info(
            "serving mode: WAVE engine (sched_mode=%s decode_block=%d "
            "pipeline_depth=%d)", sched_mode, generator.decode_block,
            generator.pipeline_depth,
        )
        # the JAX provider primes the default template's shared prefix
        # here; the port has no shared-prefix path yet
        log.info("shared-prefix priming is not ported; every prompt is prefilled in full")
        return ServingEngine(generator), model_id
    scheduler = Scheduler(
        generator,
        chunk=_int(env, "SCHED_CHUNK", 64),
        token_budget=_int(env, "SCHED_TOKEN_BUDGET", 0),
        pipeline_depth=_int(env, "SCHED_PIPELINE_DEPTH", 2),
        spec_decode=_flag(env, "SPEC_DECODE", True),
    )
    log.info(
        "serving mode: CONTINUOUS scheduler (pipeline_depth=%d spec_decode=%s "
        "spec_lookup_k=%d); SCHED_MODE=wave opts out",
        scheduler.depth, scheduler.spec_k > 0, scheduler.spec_k,
    )
    return ServingEngine(generator, scheduler), model_id
