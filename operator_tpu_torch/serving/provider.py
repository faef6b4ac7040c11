"""Build the port's serving engine from the serving environment.

The counterpart of ``operator_tpu/serving/provider.py:build_serving_engine``
for the continuous path, with the JAX package's environment names and
defaults: ``OPERATOR_TPU_MODEL`` (``tinyllama-1.1b``), ``SERVING_DTYPE``
(``int8``; or ``bf16``), ``MAX_BATCH_SIZE`` (32), ``KV_PAGE_SIZE`` (64),
``SCHED_CHUNK`` (64), ``SCHED_TOKEN_BUDGET`` (0 = auto),
``SCHED_PIPELINE_DEPTH`` (2), ``SPEC_DECODE`` (true),
``ALLOW_RANDOM_WEIGHTS`` (false), ``CHECKPOINT_DIR``.

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
        seed=seed,
        device=device,
    )
    scheduler = Scheduler(
        generator,
        chunk=_int(env, "SCHED_CHUNK", 64),
        token_budget=_int(env, "SCHED_TOKEN_BUDGET", 0),
        pipeline_depth=_int(env, "SCHED_PIPELINE_DEPTH", 2),
        spec_decode=_flag(env, "SPEC_DECODE", True),
    )
    return ServingEngine(generator, scheduler), model_id
