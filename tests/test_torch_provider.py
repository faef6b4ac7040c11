"""The port's ``build_serving_engine`` against the JAX package's: every
serving knob the reference reads resolves to the same setting in both,
through each package's ``OperatorConfig.from_env``; a knob whose feature
is not ported is refused with a message naming its ROADMAP Queue 1 item.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.serving import provider as jax_provider  # noqa: E402
from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig  # noqa: E402
from operator_tpu_torch.models.quant import is_quantized  # noqa: E402
from operator_tpu_torch.serving.provider import build_serving_engine  # noqa: E402
from operator_tpu_torch.utils.config import OperatorConfig  # noqa: E402

BASE = {
    "OPERATOR_TPU_MODEL": "tiny-test",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "MAX_BATCH_SIZE": "4",
    "KV_PAGE_SIZE": "16",
}


def _weights(params, quantized) -> str:
    if quantized:
        return "int8"
    leaf = params["embed"]
    return str(leaf.dtype).replace("torch.", "")


def _resolved(engine, sched, params_dtype) -> dict:
    g = engine.generator
    store = sched._kvstore if sched is not None else None
    return {
        "num_pages": g.allocator.num_pages,
        "sample_top_k": g.sample_top_k,
        "weights": params_dtype,
        "ring_capacity": g.step_clock.ring.capacity,
        "page_size": g.page_size,
        "max_slots": g.max_slots,
        "continuous": sched is not None,
        "spec_k": sched.spec_k if sched is not None else None,
        "chunk": sched.chunk if sched is not None else None,
        "depth": sched.depth if sched is not None else None,
        "prefix_cache": store is not None,
        "host_pool_bytes": (
            store.host_pool.capacity_bytes
            if store is not None and store.host_pool is not None else None
        ),
    }


def _port(env) -> dict:
    engine, model_id = build_serving_engine("cpu", env)
    try:
        params = engine.generator.params
        dtype = _weights(params, is_quantized(params))
        return {"model": model_id, **_resolved(engine, engine.scheduler, dtype)}
    finally:
        engine.close()


def _jax(env, monkeypatch) -> dict:
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    engine, model_id = jax_provider.build_serving_engine(JaxOperatorConfig.from_env(env))
    params = engine.generator.params
    dtype = "int8" if jax_quant.is_quantized(params) else str(params["embed"].dtype)
    return {"model": model_id, **_resolved(engine, engine._sched, dtype)}


@pytest.mark.parametrize("knob,value", [
    (None, None),  # the defaults: int8, prefix cache on, no host pool
    ("SPEC_LOOKUP_K", "1"),
    ("SAMPLE_TOP_K", "8"),
    ("KV_PAGES", "9"),
    ("WEIGHT_DTYPE", "bf16"),
    ("SERVING_DTYPE", "bf16"),
    ("KV_PREFIX_CACHE", "false"),
    ("KV_HOST_POOL_MB", "64"),
    ("STEP_RING_CAPACITY", "7"),
    ("SCHED_CHUNK", "32"),
    ("SCHED_PIPELINE_DEPTH", "1"),
    ("SPEC_DECODE", "false"),
    ("SCHED_MODE", "wave"),
])
def test_provider_knob_resolves_as_the_jax_package(knob, value, monkeypatch):
    env = dict(BASE)
    if knob is not None:
        env[knob] = value
    port_config = dataclasses.asdict(OperatorConfig.from_env(env))
    assert port_config == dataclasses.asdict(JaxOperatorConfig.from_env(env))
    got = _port(env)
    assert got == _jax(env, monkeypatch)
    pins = {
        "SPEC_LOOKUP_K": ("spec_k", 1),
        "SAMPLE_TOP_K": ("sample_top_k", 8),
        "KV_PAGES": ("num_pages", 9),
        "WEIGHT_DTYPE": ("weights", "bfloat16"),
        "KV_PREFIX_CACHE": ("prefix_cache", False),
        "KV_HOST_POOL_MB": ("host_pool_bytes", 64 << 20),
        "STEP_RING_CAPACITY": ("ring_capacity", 7),
    }
    if knob in pins:
        key, want = pins[knob]
        assert got[key] == want
    if knob is None:
        assert got["weights"] == "int8" and got["prefix_cache"]
        assert got["host_pool_bytes"] is None


def test_weight_dtype_wins_over_serving_dtype():
    got = _port({**BASE, "WEIGHT_DTYPE": "int8", "SERVING_DTYPE": "bf16"})
    assert got["weights"] == "int8"


@pytest.mark.parametrize("knob,value,item", [
    ("PREFILL_CHUNK", "32", "item 7"),
    ("SERVING_MESH", "tp=2", "item 11"),
    ("LORA_DIR", "/nonexistent/adapters", "item 9"),
    ("AOT_CACHE_PATH", "/nonexistent/aot", "item 10"),
    ("KV_FABRIC", "true", "item 5b"),
    ("KV_CACHE_MODE", "contiguous", "item 8"),
])
def test_provider_refuses_unported_knobs_naming_their_item(knob, value, item):
    for mode in ("continuous", "wave"):
        with pytest.raises(NotImplementedError, match=item) as info:
            build_serving_engine("cpu", {**BASE, "SCHED_MODE": mode, knob: value})
        assert knob in str(info.value)


def test_provider_leaves_the_overload_ladder_to_the_caller():
    engine, _ = build_serving_engine("cpu", {**BASE, "SCHED_QUEUE_LIMIT": "3"})
    try:
        assert engine.scheduler.queue_limit == 0
        assert engine.scheduler.overload_policy is None
        assert engine.generator.overload_policy is None
    finally:
        engine.close()
