"""The PyTorch port's wave engine against the JAX ``BatchedGenerator``.

Greedy token ids of ``operator_tpu_torch``'s wave ``Generator`` (``admit``
+ ``step``, no scheduler) on the CPU must be byte-identical to JAX
``BatchedGenerator(paged=True)`` driven by the same calls, on the same
``TINY_TEST`` f32 weights: decode blocks of 1 and 4 at pipeline depths 1
and 2 with flash prefill off and on, a wave admitted only in part under
page pressure, slots and pages recycled across more requests than slots,
and ``max_tokens=1``.  The port's wave ``ServingEngine`` must give the
same tokens, leave no slot or page held, and ``build_serving_engine``
must build it from ``SCHED_MODE=wave`` (with ``KV_CACHE_MODE=contiguous``
too) and refuse bad settings.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.ops import flash_prefill  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.provider import build_serving_engine  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

PROMPTS = [
    "pod crashed with exit code 137",
    "a much longer prompt " * 5,  # > 64 tokens: the 128-token bucket
    "OOMKilled OOMKilled OOMKilled",
    "liveness probe failed",
    "ImagePullBackOff",
]
MAX_TOKENS = 10


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _drive(generator, prompts, params_list, admissions=None):
    """The same calls on either package's generator: admit the head of
    the line into free slots (partial admission leaves the rest in line),
    step, collect finished results.  Returns the token ids per prompt."""
    line = list(range(len(prompts)))
    owner, results = {}, {}
    for _ in range(3000):
        free = generator.free_slots()
        if line and free:
            batch = line[: len(free)]
            slots = generator.admit(
                [prompts[i] for i in batch], [params_list[i] for i in batch]
            )
            if admissions is not None:
                admissions.append((len(batch), len(slots)))
            for i, slot in zip(batch, slots):
                owner[slot] = i
            line = line[len(slots):]
        for slot, result in generator.step():
            results[owner.pop(slot)] = result.token_ids
        if len(results) == len(prompts):
            return [results[i] for i in range(len(prompts))]
    raise AssertionError(f"not every request finished: {sorted(results)}")


def _jax_generator(jax_params, **kw):
    return BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
        cache_dtype=jnp.float32, metrics=MetricsRegistry(), **kw,
    )


def _torch_generator(torch_params, **kw):
    return Generator(
        torch_params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
        device="cpu", **kw,
    )


def _assert_no_leaks(generator):
    """Every slot free, every page free but the registered shared
    prefixes' (the JAX engine's leak audit)."""
    assert len(generator.free_slots()) == generator.max_slots
    assert generator.allocator.available == (
        generator.allocator.num_pages - 1 - generator.prefix_held_pages
    )
    assert not generator._inflight_blocks


SHAPE = dict(max_slots=4, max_seq=128, page_size=16)


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("block,depth", [(1, 1), (1, 2), (4, 1), (4, 2)])
def test_wave_greedy_tokens_match_jax(jax_params, torch_params, monkeypatch,
                                      block, depth, flash):
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", "1" if flash else "0")
    jax_sampling = [JaxSamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)] * len(PROMPTS)
    want = _drive(
        _jax_generator(jax_params, decode_block=block, pipeline_depth=depth, **SHAPE),
        PROMPTS, jax_sampling,
    )
    before = flash_prefill.launches
    generator = _torch_generator(
        torch_params, decode_block=block, pipeline_depth=depth, **SHAPE
    )
    got = _drive(
        generator, PROMPTS,
        [SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)] * len(PROMPTS),
    )
    assert got == want
    assert flash_prefill.launches == before  # CPU tensors: the plain version
    _assert_no_leaks(generator)
    assert generator.prefill_waves >= 2  # five prompts, four slots
    assert generator.blocks_dispatched > 0


def test_partial_admission_under_page_pressure_matches_jax(jax_params, torch_params):
    """Pages for exactly two worst-case sequences, six requests each
    demanding the worst case (the tests/test_paged_serving.py shape):
    admission must go partial, and every request's tokens match JAX."""
    shape = dict(max_slots=4, max_seq=64, page_size=8, kv_pages=2 * (64 // 8) + 1)
    prompts = [f"pod {i} failed" for i in range(6)]
    want = _drive(
        _jax_generator(jax_params, **shape), prompts,
        [JaxSamplingParams(max_tokens=50, temperature=0.0, stop_on_eos=False)] * 6,
    )
    admissions = []
    generator = _torch_generator(torch_params, **shape)
    got = _drive(
        generator, prompts,
        [SamplingParams(max_tokens=50, temperature=0.0, stop_on_eos=False)] * 6,
        admissions,
    )
    assert got == want
    assert all(len(tokens) == 50 for tokens in got)
    assert any(admitted < requested for requested, admitted in admissions), admissions
    assert max(admitted for _, admitted in admissions) <= 2
    _assert_no_leaks(generator)


def test_page_recycling_and_max_tokens_1_match_jax(jax_params, torch_params):
    """Two slots serve eight requests, so slots and pages are recycled
    wave after wave; three of the requests take a single token, one of
    them with a prompt truncated to max_seq - 1 tokens, whose slot's
    decode-ahead blocks run past the end of its page table."""
    shape = dict(max_slots=2, max_seq=128, page_size=16, decode_block=4, pipeline_depth=2)
    prompts = PROMPTS + ["CrashLoopBackOff", "exit 1", "x" * 300]
    budgets = [MAX_TOKENS, 1, MAX_TOKENS, 7, 1, MAX_TOKENS, 3, 1]
    want = _drive(
        _jax_generator(jax_params, **shape), prompts,
        [JaxSamplingParams(max_tokens=n, temperature=0.0) for n in budgets],
    )
    generator = _torch_generator(torch_params, **shape)
    granted = []
    allocate = generator.allocator.allocate

    def spy(count):
        pages = allocate(count)
        granted.extend(pages)
        return pages

    generator.allocator.allocate = spy
    got = _drive(
        generator, prompts,
        [SamplingParams(max_tokens=n, temperature=0.0) for n in budgets],
    )
    assert got == want
    assert [len(t) for t in got][1] == 1 and [len(t) for t in got][4] == 1
    assert len(granted) > len(set(granted))  # pages were handed out again
    _assert_no_leaks(generator)


def test_generate_single_prompt_matches_jax(jax_params, torch_params):
    """``generate`` admits one prompt and steps the whole batch until it
    finishes, in both packages."""
    shape = dict(decode_block=4, pipeline_depth=2, **SHAPE)
    jax_generator = _jax_generator(jax_params, **shape)
    generator = _torch_generator(torch_params, **shape)
    for prompt in PROMPTS[:2]:
        want = jax_generator.generate(
            prompt, JaxSamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
        )
        got = generator.generate(prompt, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0))
        assert got.token_ids == want.token_ids
        assert (got.finish_reason, got.prompt_tokens) == (want.finish_reason, want.prompt_tokens)


def test_wave_serving_engine_matches_jax_and_backpressures(jax_params, torch_params):
    shape = dict(max_slots=4, max_seq=64, page_size=8, kv_pages=2 * (64 // 8) + 1)
    prompts = [f"pod {i} failed" for i in range(6)]
    want = _drive(
        _jax_generator(jax_params, **shape), prompts,
        [JaxSamplingParams(max_tokens=50, temperature=0.0, stop_on_eos=False)] * 6,
    )
    generator = _torch_generator(torch_params, **shape)
    admissions = []
    admit = generator.admit

    def spy(batch_prompts, params_list):
        slots = admit(batch_prompts, params_list)
        admissions.append((len(batch_prompts), len(slots)))
        return slots

    generator.admit = spy
    engine = ServingEngine(generator)
    try:
        engine.warmup()
        admissions.clear()
        results = engine.generate_batch(
            prompts, SamplingParams(max_tokens=50, temperature=0.0, stop_on_eos=False)
        )
        assert [r.token_ids for r in results] == want
        assert all(r.finish_reason == "length" for r in results)
        assert max(admitted for _, admitted in admissions) <= 2
        report = engine.load_report()
        assert report.steps > 0 and report.inflight == 0
    finally:
        engine.close()
    _assert_no_leaks(generator)


def test_oversized_request_fails_alone(torch_params):
    generator = _torch_generator(torch_params, max_slots=4, max_seq=128, page_size=16,
                                 kv_pages=5)
    engine = ServingEngine(generator)
    try:
        big = engine.submit("x" * 4096, SamplingParams(max_tokens=128, temperature=0.0))
        small = engine.submit("ok", SamplingParams(max_tokens=4, temperature=0.0))
        with pytest.raises(ValueError, match="KV pages"):
            big.result(timeout=120)
        assert 1 <= len(small.result(timeout=120).token_ids) <= 4
    finally:
        engine.close()


_WAVE_ENV = {
    "OPERATOR_TPU_MODEL": "tiny-test",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "SERVING_DTYPE": "bf16",
    "MAX_BATCH_SIZE": "4",
    "KV_PAGE_SIZE": "16",
    "SCHED_MODE": "wave",
}


def test_provider_builds_the_wave_engine():
    engine, model_id = build_serving_engine("cpu", _WAVE_ENV)
    try:
        assert model_id == "tiny-test" and engine.scheduler is None
        g = engine.generator
        assert (g.decode_block, g.pipeline_depth) == (4, 2)
        # PREFIX_CACHE (on by default) primes the default template's preamble
        assert g.prefix_held_pages > 0
        engine.warmup()
        [result] = engine.generate_batch(["pod crashed"], SamplingParams(max_tokens=6, temperature=0.0))
        assert 1 <= result.completion_tokens <= 6
        _assert_no_leaks(g)
    finally:
        engine.close()


@pytest.mark.parametrize("key,value,error", [
    ("SCHED_MODE", "waves", ValueError),
    ("OPERATOR_TPU_PAGED_KERNEL", "v3", ValueError),
    ("KV_CACHE_MODE", "contiguous", None),  # ported: a build that succeeds
    ("KV_CACHE_MODE", "ring", ValueError),
])
def test_provider_refuses_bad_settings(key, value, error):
    if error is None:
        engine, _ = build_serving_engine("cpu", {**_WAVE_ENV, key: value})
        try:
            assert engine.scheduler is None and not engine.generator.paged
        finally:
            engine.close()
        return
    with pytest.raises(error, match=value):
        build_serving_engine("cpu", {**_WAVE_ENV, key: value})


def test_wave_line_admits_higher_priority_first(torch_params):
    """The wave loop's waiting line orders by priority, FIFO within a
    class, as the reference's ``(-priority, seq)`` admission queue does."""
    import concurrent.futures

    from operator_tpu_torch.serving.engine import _Submission

    engine = ServingEngine(_torch_generator(torch_params, max_slots=1, max_seq=64, page_size=16))
    for name, priority in (("a", 0), ("b", 10), ("c", 0), ("d", 10), ("e", 5), ("f", -1)):
        engine._submissions.put(
            _Submission(name, SamplingParams(), 0.0, priority, concurrent.futures.Future()))
    assert engine._take_submissions(block=False)
    assert [item.prompt for item in engine._waiting] == ["b", "d", "e", "a", "c", "f"]
    engine.close()
