"""The warmup grid (``Generator.precompile_grid``, ``ServingEngine.precompile``)
against the JAX package's (``tests/test_precompile.py`` mirrored, on
TINY_TEST without a shared prefix, which the port does not have yet).

Every program the admission policy can select is captured before
readiness: after the grid, varied traffic records no first use of a
program key (on the CPU a program's capture is its first use, so the
compile watch sees exactly what the card would capture).  The grid's keys
are the JAX generator's: the same prefill buckets ``(n_pad, t_pad,
guided)`` and the same decode programs at each level.  The operator runs
the grid before its engine reports ready.
"""

import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.operator import FakeKubeApi, Operator  # noqa: E402
from operator_tpu_torch.serving.aotcache import serving_compile_events  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.provider import build_serving_engine  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.compilewatch import CompileWatcher  # noqa: E402
from operator_tpu_torch.utils.config import OperatorConfig  # noqa: E402

SHAPE = dict(max_slots=4, max_seq=128, page_size=16, decode_block=2)


@pytest.fixture(scope="module")
def params():
    jax_params = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax_params, params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _generator(torch_params, **kw):
    return Generator(
        torch_params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
        device="cpu", **{**SHAPE, **kw},
    )


def _drain(gen, waves, **params):
    sampling = SamplingParams(max_tokens=3, temperature=0.0, stop_on_eos=False, **params)
    for wave in waves:
        gen.admit(list(wave), [sampling] * len(wave))
        while gen.num_active or gen._inflight_blocks:
            gen.step()


def test_grid_covers_varied_traffic_with_zero_midrun_captures(params):
    watch = CompileWatcher()
    try:
        gen = _generator(params[1])
        report = gen.precompile_grid("serving")
        assert report["programs"] > 0 and report["skipped_waves"] == 0
        # clean state after the grid: all slots free, all pages back
        assert gen.num_active == 0 and not gen._inflight_blocks
        assert gen.allocator.available == gen.allocator.num_pages - 1
        watch.mark()
        _drain(gen, [
            ["err " * 20],                     # n=1
            ["x " * 40] * 3,                   # odd n -> pad 4
            ["a completely different prompt"],
            ["z"] * 2,
            ["evidence " * 200] * 2,           # over budget -> truncated
        ])
        events = serving_compile_events(watch.events_since_mark())
        assert events == [], f"mid-run captures: {events}"
    finally:
        watch.close()


def test_grid_off_level_captures_nothing(params):
    gen = _generator(params[1])
    report = gen.precompile_grid("off")
    assert report == {"level": "off", "programs": 0, "seconds": 0.0}
    assert not gen._prefill_fns and gen.graphs.captures == 0


def test_grid_rejects_unknown_level(params):
    gen = _generator(params[1])
    with pytest.raises(ValueError, match="warmup grid level"):
        gen.precompile_grid("everything")


def test_full_level_covers_guided_traffic(params):
    watch = CompileWatcher()
    try:
        gen = _generator(params[1])
        gen.precompile_grid("full")
        assert gen._decode_guided_program.keys()
        watch.mark()
        # the automaton shape the grid warmed with: tables restack into
        # the captured buffer, no program is captured
        _drain(gen, [["status"], ["state " * 8] * 2], guided_choice=("warm", "cold"))
        events = watch.events_since_mark()
        assert events == [], f"mid-run captures: {events}"
    finally:
        watch.close()


@pytest.mark.parametrize("level", ["serving", "full"])
def test_grid_keys_match_the_jax_generator(params, level):
    jax_params, torch_params = params
    jax_gen = BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
        cache_dtype=jnp.float32, **SHAPE,
    )
    want = jax_gen.precompile_grid(level)
    gen = _generator(torch_params)
    got = gen.precompile_grid(level)
    assert set(got) == set(want)
    assert got["programs"] == want["programs"]
    assert gen._prefill_fns == set(jax_gen._prefill_fns)
    assert bool(gen._decode_program.keys()) == (jax_gen._decode_fn is not None)
    assert bool(gen._decode_guided_program.keys()) == (jax_gen._decode_fn_guided is not None)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_engine_precompile_returns_the_jax_dict(mode):
    engine, _ = build_serving_engine("cpu", {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16", "SCHED_MODE": mode,
    })
    try:
        off = asyncio.run(engine.precompile("off"))
        assert off == {"level": "off", "programs": 0, "seconds": 0.0}
        with pytest.raises(ValueError, match="warmup grid level"):
            asyncio.run(engine.precompile("everything"))
        report = asyncio.run(engine.precompile("serving"))
        keys = {"level", "programs", "seconds"}
        if mode == "wave":
            keys.add("skipped_waves")
        else:
            assert report["programs"] == 1
            assert engine.generator.graphs.programs["mixed_fn"].keys() == {
                engine.scheduler.program_key}
        assert set(report) == keys and report["programs"] > 0
        watch = CompileWatcher()
        try:
            engine.generate_batch(["pod crashed", "exit 137 " * 12],
                                  SamplingParams(max_tokens=4, temperature=0.0))
            assert watch.events() == []
        finally:
            watch.close()
        with pytest.raises(RuntimeError, match="before the engine starts"):
            asyncio.run(engine.precompile("serving"))
    finally:
        engine.close()


@pytest.mark.parametrize("level", ["serving", "full"])
def test_operator_precompiles_before_readiness(level, monkeypatch):
    """``WARMUP_GRID``: the operator's completion API runs the engine's
    grid at its level before the first request, and readiness stays cold
    until the grid returns."""
    monkeypatch.setenv("OPERATOR_TPU_MODEL", "tiny-test")
    gate = threading.Event()
    entered = threading.Event()
    levels = []
    real = ServingEngine._precompile

    def held(self, grid_level):
        levels.append(grid_level)
        entered.set()
        assert gate.wait(60)
        return real(self, grid_level)

    monkeypatch.setattr(ServingEngine, "_precompile", held)
    config = OperatorConfig(
        health_port=-1, completion_api_port=0, completion_api_host="127.0.0.1",
        allow_random_weights=True, max_batch_size=4, kv_page_size=16,
        sched_mode="wave", warmup_grid=level,
        pattern_cache_directory="/nonexistent")

    async def body():
        operator = Operator(FakeKubeApi(), config=config, device="cpu")
        await operator.start()
        try:
            assert await asyncio.to_thread(entered.wait, 60)
            await asyncio.sleep(0.05)
            assert operator.engine_warmth == "loading"
            cold = await operator.readiness.check()
            gate.set()
            await asyncio.wait_for(operator.completion_task, 120)
            engine = operator.completion_server.engine
            return cold, operator.engine_warmth, engine.generator._program_count()
        finally:
            gate.set()
            await operator.stop()

    cold, warmth, programs = asyncio.run(body())
    assert levels == [level]
    assert not cold.ready
    assert warmth == "ready" and programs > 0
