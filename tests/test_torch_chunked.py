"""The port's chunked prefill against the JAX package's.

The paged, non-mesh cases of ``tests/test_chunked_prefill.py`` and the
three guided cases of ``tests/test_guided.py`` that run through a chunked
job, each on the port's wave ``Generator`` and the JAX
``BatchedGenerator(paged=True)`` with the same calls, on ``TINY_TEST``
f32 weights from ``PRNGKey(0)`` carried across by ``params_from_jax``:
greedy token ids byte for byte, the same chunk programs.  The contiguous
cases are in ``tests/test_torch_contiguous.py``, the mesh ones in
``tests/test_torch_sharded_serving.py``.  Beyond the JAX files: a prefixed
wave never chunks, the warmup grid's chunk and finish keys are the JAX
grid's, a failed chunk leaves the engine's tables untouched, and a
request cancelled while its slot is reserved releases its grant once.
"""

import asyncio
import re
import time

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
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

GREEDY = dict(max_tokens=6, temperature=0.0, stop_on_eos=False)
CHOICES = ("CRITICAL", "HIGH", "MEDIUM", "LOW")
# byte tokenizer: ~1 token per char (+BOS)
PROMPTS = [
    "pod was OOMKilled " * 7,            # ~126 tokens -> t_pad 128
    "short prompt",                       # ~12 tokens  -> t_pad 64
    "disk pressure eviction event " * 4,  # ~116 tokens
]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _generator(params, **kw):
    return Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=kw.pop("max_seq", 160),
        cache_dtype=torch.float32, page_size=16, decode_block=2, device="cpu", **kw,
    )


def _jax_generator(jax_params, **kw):
    return BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), max_slots=4,
        max_seq=kw.pop("max_seq", 160), cache_dtype=jnp.float32, paged=True,
        page_size=16, decode_block=2, **kw,
    )


@pytest.fixture
def both(params, jax_params):
    return lambda **kw: (_generator(params, **dict(kw)), _jax_generator(jax_params, **dict(kw)))


def _sampling(generator, **kw):
    cls = SamplingParams if isinstance(generator, Generator) else JaxSamplingParams
    return cls(**kw)


def _run(generator, prompts, samplings):
    slots = generator.admit(prompts, samplings)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s] for s in slots]


def _drain(generator, prompts, **kw):
    sampling = _sampling(generator, **(kw or GREEDY))
    return [r.token_ids for r in _run(generator, prompts, [sampling] * len(prompts))]


def _no_leaks(generator):
    assert generator._prefill_job is None and not generator._reserved
    assert len(generator.free_slots()) == generator.max_slots
    assert generator.allocator.available == (
        generator.allocator.num_pages - 1 - generator.prefix_held_pages
    )


# ---------------------------------------------------------------------------
# tests/test_chunked_prefill.py (paged, no mesh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_matches_oneshot(both, params, chunk):
    port, ref = both(prefill_chunk=chunk)
    got = _drain(port, PROMPTS)
    assert got == _drain(ref, PROMPTS)
    assert got == _drain(_generator(params), PROMPTS)
    assert set(port._chunk_fns) == set(ref._chunk_fns) and port._chunk_fns
    assert set(port._finish_fns) == set(ref._finish_fns)
    _no_leaks(port)


def test_short_bucket_takes_oneshot_path(both, params):
    port, ref = both(prefill_chunk=64)
    tokens = _drain(port, ["tiny"])  # bucket 64 == chunk
    assert port._prefill_job is None and not port._chunk_fns
    assert tokens == _drain(ref, ["tiny"]) == _drain(_generator(params), ["tiny"])


def test_decode_interleaves_with_chunks(both, params):
    """A wave admitted BEFORE a long chunked prefill keeps decoding while
    the chunks run: its tokens accumulate between chunk rounds."""
    got = []
    for generator in both(prefill_chunk=64):
        long_sampling = _sampling(generator, max_tokens=4, temperature=0.0, stop_on_eos=False)
        [first] = generator.admit(["early wave"], [_sampling(
            generator, max_tokens=30, temperature=0.0, stop_on_eos=False)])
        assert generator._prefill_job is None  # one-shot: decoding at once
        generator.step()
        before = len(generator.slots[first].generated)
        assert before > 0
        [late] = generator.admit([PROMPTS[0]], [long_sampling])
        assert generator._prefill_job is not None  # a multi-chunk job
        generator.step()  # one chunk, and the early wave still decodes
        assert len(generator.slots[first].generated) > before
        assert generator._prefill_job is not None
        results = {}
        while generator.num_active:
            for slot_id, result in generator.step():
                results[slot_id] = result
        assert set(results) == {first, late}
        got.append((results[first].token_ids, results[late].token_ids))
    assert got[0] == got[1]
    expected = _drain(_generator(params), [PROMPTS[0]],
                      max_tokens=4, temperature=0.0, stop_on_eos=False)
    assert [got[0][1]] == expected


def test_reserved_slots_not_reallocated(both):
    for generator in both(prefill_chunk=16):
        [slot] = generator.admit([PROMPTS[0]], [_sampling(generator, **GREEDY)])
        assert generator._prefill_job is not None
        assert slot not in generator.free_slots()
        assert generator.num_decoding == 0
        assert generator.num_active == 1
        # a wave admitted meanwhile takes other slots, one-shot
        [other] = generator.admit(["next"], [_sampling(generator, **GREEDY)])
        assert other != slot and generator._prefill_job is not None
        while generator.num_active:
            generator.step()


def test_generate_sync_with_chunking(both):
    port, ref = both(prefill_chunk=16)
    got = port.generate(PROMPTS[0], SamplingParams(**GREEDY))
    assert got.token_ids == ref.generate(PROMPTS[0], JaxSamplingParams(**GREEDY)).token_ids


def test_partial_final_chunk_parity(both, params):
    """t_pad clamped to a non-multiple of the chunk (max_seq 160, chunk 64:
    chunks of 64, 64 and 32)."""
    prompt = "container exceeded its memory limit and was evicted by kubelet " * 3
    sampling = dict(max_tokens=4, temperature=0.0, stop_on_eos=False)
    port, ref = both(prefill_chunk=64)
    got = _drain(port, [prompt], **sampling)
    assert got == _drain(ref, [prompt], **sampling)
    assert (1, 160, 32) in port._chunk_fns
    assert set(port._chunk_fns) == set(ref._chunk_fns)
    assert got == _drain(_generator(params), [prompt], **sampling)


@pytest.mark.parametrize("chunk", [0, -3])
def test_bad_chunk_value_rejected(params, chunk):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _generator(params, prefill_chunk=chunk)


# ---------------------------------------------------------------------------
# tests/test_guided.py through a chunked job
# ---------------------------------------------------------------------------


def test_guided_with_chunked_prefill(params):
    """Guided requests through a multi-chunk prefill: the first token is
    masked at the finish program and decode stays constrained."""
    generator = _generator(params, max_seq=128, prefill_chunk=16)
    long_prompt = "classify the severity of this oom killed pod " * 3
    sampling = SamplingParams(max_tokens=16, temperature=1.2, guided_choice=CHOICES)
    [slot] = generator.admit([long_prompt], [sampling])
    assert generator._prefill_job is not None
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    assert results[slot].text in CHOICES
    result = generator.generate(long_prompt, SamplingParams(
        max_tokens=20, temperature=1.0, guided_regex=r"[0-9]{2}ms"))
    assert re.fullmatch(r"[0-9]{2}ms", result.text)


def test_guided_chunked_greedy_matches_jax(both):
    """A greedy guided row and a free row through one chunked job: the
    JAX generator's tokens."""
    long_prompt = "classify the severity of this oom killed pod " * 3
    got = []
    for generator in both(max_seq=128, prefill_chunk=16):
        results = _run(generator, [long_prompt, "free " + long_prompt], [
            _sampling(generator, max_tokens=12, temperature=0.0, guided_choice=CHOICES),
            _sampling(generator, **GREEDY),
        ])
        got.append([r.token_ids for r in results])
    assert got[0] == got[1]
    assert ByteTokenizer().decode(got[0][0]) in CHOICES


def test_recycled_slot_after_guided_is_unconstrained_chunked(both):
    """A guided request leaves a slot; another guided request keeps the
    tables live; a long UNGUIDED prompt recycles the slot through the
    chunked path and must decode unconstrained (its guided-free greedy
    tokens, the JAX generator's)."""
    free = dict(max_tokens=8, temperature=0.0, stop_on_eos=False)
    long_prompt = "an unguided long prompt about an evicted pod " * 3
    got = []
    for generator, solo_gen in zip(both(max_seq=128, prefill_chunk=16),
                                   both(max_seq=128, prefill_chunk=16)):
        solo = solo_gen.generate(long_prompt, _sampling(solo_gen, **free))
        done = generator.generate("pick", _sampling(
            generator, max_tokens=8, temperature=0.8, guided_choice=("red", "green")))
        assert done.text in ("red", "green")
        [keeper] = generator.admit(["hold"], [_sampling(
            generator, max_tokens=40, temperature=0.7, guided_choice=CHOICES)])
        [recycled] = generator.admit([long_prompt], [_sampling(generator, **free)])
        assert generator._prefill_job is not None
        results = {}
        while generator.num_active:
            for slot_id, result in generator.step():
                results[slot_id] = result
        assert results[recycled].token_ids == solo.token_ids
        assert results[keeper].text in CHOICES
        got.append(results[recycled].token_ids)
    assert got[0] == got[1]


def test_table_restack_between_job_chunks(params):
    """Automaton ids are resolved at the finish: a guided one-shot wave
    admitted between a guided job's chunks restacks the tables, and the
    job's rows must still bind the right automaton."""
    generator = _generator(params, max_seq=128, prefill_chunk=16)
    long_prompt = "classify the severity of this oom killed pod " * 3
    [job_slot] = generator.admit([long_prompt], [SamplingParams(
        max_tokens=16, temperature=1.0, guided_choice=("zz-last", "zz-least"))])
    assert generator._prefill_job is not None
    index_before = dict(generator._guided_index)
    [short] = generator.admit(["pick"], [SamplingParams(
        max_tokens=12, temperature=0.9, guided_choice=("aa-first", "ab-second"))])
    assert generator._guided_index != index_before
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    assert results[short].text in ("aa-first", "ab-second")
    assert results[job_slot].text in ("zz-last", "zz-least")


# ---------------------------------------------------------------------------
# beyond the JAX files
# ---------------------------------------------------------------------------

PREFIX = (
    "You are a Kubernetes failure analyst. Explain the failure using the "
    "pattern evidence and log excerpts provided below; answer with Root "
    "Cause and Fix sections. "
)


def test_a_prefixed_wave_never_chunks(both, params):
    """A suffix-only prefill is short already: a prefix-shared wave takes
    the prefixed program even where its full length would chunk."""
    prompts = [PREFIX + "Pod web-1 exit 137 oom", PREFIX + "Pod db-0 crashloop"]
    got = []
    for generator in both(max_seq=512, prefill_chunk=16):
        generator.set_shared_prefix(PREFIX)
        got.append(_drain(generator, prompts))
        assert generator._prefix_fns and not generator._chunk_fns
    assert got[0] == got[1] == _drain(_generator(params, max_seq=512), prompts)


@pytest.mark.parametrize("with_prefix", [False, True], ids=["plain", "prefix"])
def test_grid_keys_with_chunking_match_the_jax_generator(both, with_prefix):
    port, ref = both(max_seq=256, prefill_chunk=64)
    if with_prefix:
        for generator in (port, ref):
            generator.set_shared_prefix(PREFIX)
    want = ref.precompile_grid("serving")
    got = port.precompile_grid("serving")
    assert got["programs"] == want["programs"]
    for name in ("_chunk_fns", "_finish_fns", "_prefix_fns"):
        assert set(getattr(port, name)) == set(getattr(ref, name)), name
    assert port._prefill_fns == set(ref._prefill_fns)
    assert port._chunk_fns and port._finish_fns
    _no_leaks(port)


def test_a_failed_chunk_leaves_the_tables_untouched(params):
    """The job's tables commit only from the finish program's return: a
    chunk that raises leaves the engine's page table and lengths as they
    were; a reset then frees every slot and page."""
    generator = _generator(params, prefill_chunk=64)
    [live] = generator.admit(["early wave"], [SamplingParams(**GREEDY)])  # one-shot
    generator.admit([PROMPTS[0]], [SamplingParams(**GREEDY)])  # a job of two chunks
    assert generator._prefill_job is not None
    table = generator.paged_cache.page_table.clone()
    lengths_before = generator.paged_cache.lengths.clone()
    chunk = generator._prefill_chunk

    def broken(*args, **kwargs):
        raise RuntimeError("device error in a chunk")

    generator._prefill_chunk = broken
    with pytest.raises(RuntimeError, match="device error"):
        generator.step()
    generator._prefill_chunk = chunk
    assert torch.equal(generator.paged_cache.page_table, table)
    assert torch.equal(generator.paged_cache.lengths, lengths_before)
    assert generator.slots[live].active
    generator.reset()
    _no_leaks(generator)


def test_a_request_cancelled_while_reserved_releases_its_grant_once(params):
    """Through the wave loop: a request whose caller goes away while its
    slot is reserved by a chunked job is freed once the job's wave goes
    live; every page and slot comes back, and the other request of the
    wave finishes."""
    generator = _generator(params, prefill_chunk=16)
    engine = ServingEngine(generator, admission_wait_s=0.0)
    sampling = SamplingParams(max_tokens=40, temperature=0.0, stop_on_eos=False)

    async def drive():
        keep = asyncio.ensure_future(engine.generate(PROMPTS[2], sampling))
        gone = asyncio.ensure_future(engine.generate(PROMPTS[0], sampling))
        for _ in range(400):
            if generator._reserved:
                break
            await asyncio.sleep(0.005)
        assert generator._reserved, "the chunked job never started"
        gone.cancel()
        result = await asyncio.wait_for(keep, 60)
        with pytest.raises(asyncio.CancelledError):
            await gone
        return result

    try:
        result = asyncio.run(drive())
        assert len(result.token_ids) == 40
        deadline = time.time() + 30
        while (generator.num_active or engine._pending) and time.time() < deadline:
            time.sleep(0.02)
        assert not engine._pending
        _no_leaks(generator)
    finally:
        engine.close()


def test_aot_fingerprint_carries_the_chunk(params, tmp_path, monkeypatch):
    """``AOT_CACHE_PATH``'s fingerprint names the chunk ``build_serving_engine``
    passes (the JAX provider's value), and a generator given a cache path
    fingerprints its own ``prefill_chunk``."""
    from operator_tpu.serving import provider as jax_provider
    from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig
    from operator_tpu_torch.serving.provider import build_serving_engine

    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16", "SCHED_MODE": "wave",
           "PREFILL_CHUNK": "32", "AOT_CACHE_PATH": str(tmp_path / "aot")}
    engine, _ = build_serving_engine("cpu", env)
    try:
        assert engine.generator.prefill_chunk == 32
        got = engine.generator._aot.payload["prefill_chunk"]
    finally:
        engine.close()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref, _ = jax_provider.build_serving_engine(JaxOperatorConfig.from_env(env))
    assert got == ref.generator._aot.payload["prefill_chunk"] == 32
    own = _generator(params, prefill_chunk=16, aot_cache=str(tmp_path / "own"))
    assert own._aot.payload["prefill_chunk"] == 16
