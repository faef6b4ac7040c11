"""The port's contiguous KV cache against the JAX package's.

``Generator(paged=False)`` (``KV_CACHE_MODE=contiguous``) on the CPU
against JAX ``BatchedGenerator(paged=False)`` driven by the same calls,
on ``TINY_TEST`` f32 weights from ``PRNGKey(0)`` carried across by
``params_from_jax``: greedy token ids byte for byte.  The contiguous
cases of the JAX files:

- ``tests/test_models.py::test_qwen2_decode_parity_paths`` and
  ``tests/test_paged_serving.py::TestPagedDecodeParity::test_matches_contiguous_decode``:
  ``decode_step`` logits within 1e-4 (``DECODE_ATOL``) of the JAX
  function's, of the paged decode's and of the full forward's;
- ``TestDecodeBlockParity::test_block_matches_single_step[contiguous]``,
  ``TestSlidingWindowParity::test_paged_matches_contiguous_with_window``,
  ``tests/test_serving.py``'s ``generator``-fixture cases that check
  tokens or admission, ``TestDecodeAheadPipelining``'s contiguous cases
  (``test_max_seq_guard_respects_depth`` included) and the contiguous
  half of ``test_decode_unroll_token_parity`` (the JAX block with and
  without ``DECODE_UNROLL``, greedy);
- ``tests/test_chunked_prefill.py::test_chunked_matches_oneshot[*-False]``
  and ``::test_generate_sync_with_chunking``;
- ``tests/test_guided.py::test_output_is_always_a_choice[*-False]`` and
  ``tests/test_multilora.py::test_mixed_adapters_match_merged_engines[False]``.

Beyond the JAX files: a write at the ``max_seq`` edge clamps as JAX's
``dynamic_update_slice`` does and raises nothing; a recycled slot's stale
row never reaches its next occupant's tokens; the contiguous and paged
AOT fingerprints differ; the warmup grid's keys and program count are the
JAX generator's; the shared-prefix calls return 0 with JAX's warning;
``reset`` zeroes the cache and the offsets in place; and ``/healthz``'s
load report of a contiguous replica is the JAX server's.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models import llama as jax_llama  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.serving import programs as jax_programs  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from operator_tpu.serving.httpserver import CompletionServer as JaxCompletionServer  # noqa: E402
from operator_tpu.serving.provider import TPUNativeProvider as JaxProvider  # noqa: E402
from operator_tpu.patterns.semantic import HashingEmbedder as JaxHashingEmbedder  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.models.llama import KVCache, decode_step, decode_step_paged, forward  # noqa: E402
from operator_tpu_torch.ops.paged_attention import PagedKVCache, write_tokens  # noqa: E402
from operator_tpu_torch.parallel import lora  # noqa: E402
from operator_tpu_torch.patterns.semantic import HashingEmbedder  # noqa: E402
from operator_tpu_torch.serving.aotcache import fingerprint_digest  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.provider import TPUNativeProvider  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402
from test_torch_completion_api import WALL_CLOCK, _server, call  # noqa: E402
from test_torch_engine import event_loop_thread  # noqa: E402

#: a decode step's logits against the JAX function's (f32, reductions in
#: other orders) and against the full forward's, as the JAX tests hold them
DECODE_ATOL = 1e-4
#: the JAX Qwen2 test's tolerance for the full forward
QWEN_ATOL = 2e-4
GREEDY = dict(temperature=0.0, stop_on_eos=False)
CHOICES = ("CRITICAL", "HIGH", "MEDIUM", "LOW")
# byte tokenizer: one token per character, plus BOS
CHUNK_PROMPTS = [
    "pod was OOMKilled " * 7,            # ~126 tokens -> t_pad 128
    "short prompt",                       # t_pad 64
    "disk pressure eviction event " * 4,  # ~116 tokens
]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _port(params, config=TINY_TEST, **kw):
    return Generator(
        params, config, ByteTokenizer(), cache_dtype=torch.float32, device="cpu",
        paged=kw.pop("paged", False),
        **{"max_slots": 4, "max_seq": 128, "page_size": 16, **kw},
    )


def _jax(params, config=JAX_TINY_TEST, **kw):
    return BatchedGenerator(
        params, config, JaxByteTokenizer(), cache_dtype=jnp.float32,
        paged=kw.pop("paged", False),
        **{"max_slots": 4, "max_seq": 128, "page_size": 16, **kw},
    )


def _sampling(generator, **kw):
    cls = SamplingParams if isinstance(generator, Generator) else JaxSamplingParams
    return cls(**kw)


def _results(generator, prompts, samplings):
    """Admit one wave and step until it (and every block in flight) is
    done; the results in prompt order."""
    slots = generator.admit(prompts, samplings)
    done = {}
    while generator.num_active or generator._inflight_blocks:
        for slot_id, result in generator.step():
            done[slot_id] = result
    return [done[s] for s in slots]


def _tokens(generator, prompts, **kw):
    sampling = _sampling(generator, **{**GREEDY, "max_tokens": 8, **kw})
    return [r.token_ids for r in _results(generator, prompts, [sampling] * len(prompts))]


def _np(tensor):
    return tensor.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the model's contiguous decode
# ---------------------------------------------------------------------------


def test_decode_step_matches_jax_and_the_paged_decode(jax_params, params):
    """``test_matches_contiguous_decode``: prefill 13 tokens, decode 4
    steps through the contiguous cache; each step's logits against JAX
    ``decode_step`` and against the port's paged decode."""
    config = TINY_TEST
    tokens_np = np.random.RandomState(0).randint(0, config.vocab_size, (1, 13)).astype(np.int32)
    tokens = torch.from_numpy(tokens_np)
    positions = torch.arange(13, dtype=torch.int32)[None]
    cache = KVCache.create(config, 1, 64, dtype=torch.float32, device="cpu")
    logits, cache = forward(params, config, tokens, positions, cache=cache)
    jax_cache = jax_llama.KVCache.create(JAX_TINY_TEST, 1, 64, dtype=jnp.float32)
    jax_logits, jax_cache = jax_llama.forward(
        jax_params, JAX_TINY_TEST, jnp.asarray(tokens_np), jnp.asarray(_np(positions)),
        cache=jax_cache,
    )
    np.testing.assert_allclose(_np(logits), np.asarray(jax_logits), atol=DECODE_ATOL)

    page = 8
    paged = PagedKVCache.create(config.num_layers, 9, page, config.num_kv_heads,
                                config.head_dim, 1, 8, dtype=torch.float32, device="cpu")
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    length = torch.tensor([13], dtype=torch.int32)
    for index in range(config.num_layers):
        zero = torch.zeros(1, dtype=torch.int32)
        write_tokens(paged.k_pages[index], table, cache.k[index, :, :13], zero, length)
        write_tokens(paged.v_pages[index], table, cache.v[index, :, :13], zero, length)
    paged = PagedKVCache(paged.k_pages, paged.v_pages, table, length)

    token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    offset = torch.tensor([13], dtype=torch.int32)
    for _ in range(4):
        step, cache = decode_step(params, config, token, offset[:, None], cache, offset)
        jax_step, jax_cache = jax_llama.decode_step(
            jax_params, JAX_TINY_TEST, jnp.asarray(_np(token)),
            jnp.asarray(_np(offset))[:, None], jax_cache, jnp.asarray(_np(offset)),
        )
        paged_step, paged = decode_step_paged(params, config, token, paged)
        np.testing.assert_allclose(_np(step), np.asarray(jax_step), atol=DECODE_ATOL)
        np.testing.assert_allclose(_np(step), _np(paged_step), atol=DECODE_ATOL)
        token = step.argmax(-1).to(torch.int32)[:, None]
        offset = offset + 1


def test_qwen2_contiguous_decode_parity():
    """The contiguous half of ``test_qwen2_decode_parity_paths``: random
    q/k/v biases, prefill 6 then decode 4 through the cache, every
    position's logits against the full forward of both packages."""
    config = dataclasses.replace(JAX_TINY_TEST, name="tiny-qwen", attention_bias=True,
                                 rope_theta=1_000_000.0, rms_norm_eps=1e-6)
    port_config = dataclasses.replace(TINY_TEST, name="tiny-qwen", attention_bias=True,
                                      rope_theta=1_000_000.0, rms_norm_eps=1e-6)
    jax_tree = jax_init_params(config, jax.random.PRNGKey(2), dtype=jnp.float32)
    layers = dict(jax_tree["layers"])
    for name, key in zip(("bq", "bk", "bv"), jax.random.split(jax.random.PRNGKey(3), 3)):
        layers[name] = jax.random.normal(key, layers[name].shape, jnp.float32) * 0.5
    jax_tree = {**jax_tree, "layers": layers}
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))
    tokens_np = np.array(jax.random.randint(jax.random.PRNGKey(4), (2, 10), 0,
                                            config.vocab_size, dtype=jnp.int32))
    positions_np = np.broadcast_to(np.arange(10, dtype=np.int32)[None], (2, 10))
    full, _ = jax_llama.forward(jax_tree, config, jnp.asarray(tokens_np),
                                jnp.asarray(positions_np))
    full = np.asarray(full)
    tokens, positions = torch.from_numpy(tokens_np), torch.from_numpy(positions_np.copy())
    cache = KVCache.create(port_config, 2, 16, dtype=torch.float32, device="cpu")
    prefill, cache = forward(params, port_config, tokens[:, :6], positions[:, :6],
                             cache=cache, cache_offset=0)
    np.testing.assert_allclose(_np(prefill), full[:, :6], rtol=QWEN_ATOL, atol=QWEN_ATOL)
    for i in range(6, 10):
        step, cache = decode_step(params, port_config, tokens[:, i: i + 1],
                                  positions[:, i: i + 1], cache, i)
        np.testing.assert_allclose(_np(step), full[:, i], rtol=QWEN_ATOL, atol=QWEN_ATOL)


def test_a_write_at_the_max_seq_edge_clamps_as_jax(jax_params, params):
    """Rows at the last position, one past it and far past it, and a
    4-token write that would cross the end: no raise, and the cache and
    logits are JAX's, whose ``dynamic_update_slice`` clamps each row's
    start so its tokens fit."""
    rng = np.random.RandomState(1)
    max_seq, b = 16, 4
    k0 = rng.normal(size=(TINY_TEST.num_layers, b, max_seq, TINY_TEST.num_kv_heads,
                          TINY_TEST.head_dim)).astype(np.float32)
    v0 = rng.normal(size=k0.shape).astype(np.float32)
    for t, offsets_np in ((1, [15, 16, 40, 3]), (4, [14, 12, 16, 0])):
        tokens_np = rng.randint(0, TINY_TEST.vocab_size, (b, t)).astype(np.int32)
        offsets = np.asarray(offsets_np, np.int32)
        positions_np = offsets[:, None] + np.arange(t, dtype=np.int32)[None]
        cache = KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
        logits, cache = forward(params, TINY_TEST, torch.from_numpy(tokens_np),
                                torch.from_numpy(positions_np), cache=cache,
                                cache_offset=torch.from_numpy(offsets))
        jax_logits, jax_cache = jax_llama.forward(
            jax_params, JAX_TINY_TEST, jnp.asarray(tokens_np), jnp.asarray(positions_np),
            cache=jax_llama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
            cache_offset=jnp.asarray(offsets),
        )
        np.testing.assert_allclose(_np(cache.k), np.asarray(jax_cache.k), atol=1e-5)
        np.testing.assert_allclose(_np(cache.v), np.asarray(jax_cache.v), atol=1e-5)
        np.testing.assert_allclose(_np(logits), np.asarray(jax_logits), atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# the wave engine, contiguous, against the JAX generator
# ---------------------------------------------------------------------------

_BLOCKS: dict = {}


@pytest.mark.parametrize("block,depth,flash", [(1, 1, "0"), (4, 2, "1")],
                         ids=["block1-dense", "block4-flash"])
def test_block_matches_single_step_and_jax(jax_params, params, block, depth, flash,
                                           monkeypatch):
    """``test_block_matches_single_step[contiguous]``: max_tokens 7 (no
    multiple of the block), the same tokens at blocks 1 and 4, each the
    JAX generator's; with flash prefill off and on."""
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", flash)
    prompts = ["pod failed exit code 137", "OOMKilled in payments", "a longer prompt " * 6]
    kw = dict(max_slots=4, decode_block=block, pipeline_depth=depth)
    got = _results(_port(params, **kw), prompts,
                   [SamplingParams(max_tokens=7, **GREEDY)] * 3)
    want = _results(_jax(jax_params, **kw), prompts,
                    [JaxSamplingParams(max_tokens=7, **GREEDY)] * 3)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(r.completion_tokens == 7 and r.finish_reason == "length" for r in got)
    _BLOCKS[block] = [r.token_ids for r in got]
    if len(_BLOCKS) == 2:
        assert _BLOCKS[1] == _BLOCKS[4]


@pytest.fixture(scope="module")
def pair(jax_params, params):
    """The ``generator`` fixture of ``tests/test_serving.py`` in both
    packages (contiguous, 4 slots, max_seq 128)."""
    return _port(params), _jax(jax_params)


def _clear(generator):
    if isinstance(generator, Generator):
        generator.reset()
    else:  # tests/test_serving.py's _reset
        from operator_tpu.serving.engine import _Slot

        generator.slots = [_Slot() for _ in range(generator.max_slots)]
        generator.offsets = jnp.zeros((generator.max_slots,), jnp.int32)


def _serving_case(generator, case):
    """One ``TestBatchedGenerator`` case on either package; returns what
    the two must agree on."""
    sp = lambda **kw: _sampling(generator, **kw)  # noqa: E731
    _clear(generator)
    if case == "single":
        r = generator.generate("pod crashed with exit code 137", sp(max_tokens=8, temperature=0.0))
        assert r.finish_reason in ("stop", "length") and 0 < r.completion_tokens <= 8
        return r.token_ids, r.prompt_tokens
    if case == "batched_matches_single":
        p1, p2 = "short prompt", "a noticeably longer prompt with more tokens in it"
        alone = []
        for p in (p1, p2):
            _clear(generator)
            alone.append(generator.generate(p, sp(max_tokens=5, temperature=0.0)).token_ids)
        _clear(generator)
        together = [r.token_ids for r in _results(
            generator, [p1, p2], [sp(max_tokens=5, temperature=0.0)] * 2)]
        assert together == alone
        return together
    if case == "admission_mid_decode":
        [first] = generator.admit(["first request"], [sp(max_tokens=10, temperature=0.0)])
        for _ in range(3):
            generator.step()
        before = list(generator.slots[first].generated)
        [second] = generator.admit(["second request arriving later"],
                                   [sp(max_tokens=3, temperature=0.0)])
        assert second != first
        assert generator.slots[first].generated[: len(before)] == before
        done = {}
        while len(done) < 2:
            for slot_id, result in generator.step():
                done[slot_id] = result
        _clear(generator)
        solo = generator.generate("first request", sp(max_tokens=10, temperature=0.0))
        assert done[first].token_ids == solo.token_ids
        return done[first].token_ids, done[second].token_ids
    if case == "max_tokens_one":
        r = generator.generate("boom", sp(max_tokens=1, temperature=0.0, stop_on_eos=False))
        assert r.completion_tokens == 1 and r.finish_reason == "length"
        return r.token_ids
    if case == "truncated":
        r = generator.generate("log line\n" * 500, sp(max_tokens=4, temperature=0.0))
        assert r.prompt_tokens <= generator.max_seq and r.completion_tokens >= 1
        return r.token_ids, r.prompt_tokens
    assert case == "too_many"
    with pytest.raises(AssertionError):
        generator.admit(["a"] * 5, [sp()] * 5)
    return None


@pytest.mark.parametrize("case", ["single", "batched_matches_single", "admission_mid_decode",
                                  "max_tokens_one", "truncated", "too_many"])
def test_serving_generator_cases_match_jax(pair, case):
    port, ref = pair
    assert _serving_case(port, case) == _serving_case(ref, case)


@pytest.mark.parametrize("case", ["depth_parity", "recycling", "max_seq_guard"])
def test_decode_ahead_pipelining_contiguous(jax_params, params, case):
    """``TestDecodeAheadPipelining`` with ``paged=False``: sampled tokens
    the same at depths 1, 2 and 3 (the port's sampler against itself),
    greedy ones the JAX generator's; a slot recycled while a block is in
    flight gets a fresh run's tokens; the max_seq guard stops depth x
    block short of the end."""
    shape = dict(max_slots=2, max_seq=128, decode_block=4)
    if case == "depth_parity":
        prompts = ["pod crashed exit 137", "probe failed on 8080"]
        sampled = SamplingParams(max_tokens=11, temperature=0.7, top_p=0.9, stop_on_eos=False)
        outs = [[r.token_ids for r in _results(_port(params, pipeline_depth=d, seed=7, **shape),
                                               prompts, [sampled] * 2)] for d in (1, 2, 3)]
        assert outs[0] == outs[1] == outs[2]
        greedy = dict(max_tokens=11, **GREEDY)
        assert _tokens(_port(params, pipeline_depth=2, **shape), prompts, **greedy) == \
            _tokens(_jax(jax_params, pipeline_depth=2, **shape), prompts, **greedy)
        return
    if case == "recycling":
        got = []
        for generator in (_port(params, pipeline_depth=2, **{**shape, "decode_block": 2}),
                          _jax(jax_params, pipeline_depth=2, **{**shape, "decode_block": 2})):
            short = _sampling(generator, max_tokens=3, **GREEDY)
            long = _sampling(generator, max_tokens=20, **GREEDY)
            [a, _] = generator.admit(["first short", "long runner xxxxx"], [short, long])
            results, recycled = {}, None
            while generator.num_active or generator._inflight_blocks:
                for slot, res in generator.step():
                    results.setdefault(slot, []).append(res.token_ids)
                if a in results and recycled is None:
                    [recycled] = generator.admit(["second short"], [short])
                    assert recycled == a
            assert len(results[a]) == 2 and all(len(r) == 3 for r in results[a])
            got.append(results)
        assert got[0] == got[1]
        fresh = _port(params, pipeline_depth=1, **{**shape, "decode_block": 2})
        assert got[0][a][1] == fresh.generate(
            "second short", SamplingParams(max_tokens=3, **GREEDY)).token_ids
        return
    got = []
    for generator in (_port(params, pipeline_depth=3, **{**shape, "max_slots": 1}),
                      _jax(jax_params, pipeline_depth=3, **{**shape, "max_slots": 1})):
        [result] = _results(generator, ["x" * 40],
                            [_sampling(generator, max_tokens=10_000, **GREEDY)])
        assert result.finish_reason == "length"
        assert result.prompt_tokens + result.completion_tokens <= 128 - 3 * 4 + 4
        got.append(result.token_ids)
    assert got[0] == got[1]


def test_decode_unroll_token_parity_contiguous(jax_params, params, monkeypatch):
    """The JAX block as a scan and straight-lined (``DECODE_UNROLL``), both
    the port's tokens: the port's block is one enqueued sequence either
    way."""
    kw = dict(max_slots=2, decode_block=4, seed=5)
    prompt = ["pod oom killed"]
    want = _tokens(_port(params, **kw), prompt, max_tokens=9)
    for unroll in (False, True):
        monkeypatch.setattr(jax_programs.ProgramBuilderMixin, "DECODE_UNROLL", unroll)
        assert _tokens(_jax(jax_params, **kw), prompt, max_tokens=9) == want


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_matches_oneshot(jax_params, params, chunk):
    """``test_chunked_matches_oneshot[*-False]``: the chunked job's tokens
    are the one-shot wave's and the JAX generator's, through the same
    chunk and finish programs; no slot stays reserved."""
    kw = dict(max_seq=160, decode_block=2)
    port = _port(params, prefill_chunk=chunk, **kw)
    ref = _jax(jax_params, prefill_chunk=chunk, **kw)
    got = _tokens(port, CHUNK_PROMPTS, max_tokens=6)
    assert got == _tokens(ref, CHUNK_PROMPTS, max_tokens=6)
    assert got == _tokens(_port(params, **kw), CHUNK_PROMPTS, max_tokens=6)
    assert set(port._chunk_fns) == set(ref._chunk_fns) and port._chunk_fns
    assert set(port._finish_fns) == set(ref._finish_fns)
    assert port._prefill_job is None and not port._reserved
    assert len(port.free_slots()) == port.max_slots


def test_generate_sync_with_chunking(jax_params, params):
    kw = dict(max_seq=160, decode_block=2, prefill_chunk=16)
    got = _port(params, **kw).generate(CHUNK_PROMPTS[0], SamplingParams(max_tokens=6, **GREEDY))
    want = _jax(jax_params, **kw).generate(CHUNK_PROMPTS[0],
                                           JaxSamplingParams(max_tokens=6, **GREEDY))
    assert got.token_ids == want.token_ids


def test_paged_matches_contiguous_with_window():
    """A sliding window of 24 over a longer prompt: contiguous and paged
    give the same greedy tokens, the JAX contiguous generator's, and the
    window changes them against full attention."""
    jax_config = dataclasses.replace(JAX_TINY_TEST, sliding_window=24, name="tiny-sw")
    config = dataclasses.replace(TINY_TEST, sliding_window=24, name="tiny-sw")
    jax_tree = jax_init_params(jax_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))
    prompt = ["CrashLoopBackOff: container exited 137 after OOM in payments"]
    contiguous = _tokens(_port(params, config, max_slots=2), prompt, max_tokens=20)
    assert contiguous == _tokens(_port(params, config, max_slots=2, paged=True), prompt,
                                 max_tokens=20)
    assert contiguous == _tokens(_jax(jax_tree, jax_config, max_slots=2), prompt, max_tokens=20)
    full = dataclasses.replace(config, sliding_window=None)
    assert contiguous != _tokens(_port(params, full, max_slots=2), prompt, max_tokens=20)


@pytest.mark.parametrize("temperature", [0.0, 1.3])
def test_output_is_always_a_choice(jax_params, params, temperature):
    """``test_output_is_always_a_choice[*-False]``: the answer is one of
    the choices and stops; greedy answers are the JAX generator's."""
    port = _port(params, decode_block=2)
    ref = _jax(jax_params, decode_block=2) if temperature == 0.0 else None
    for prompt in ("severity?", "what level", "classify: oom"):
        result = port.generate(prompt, SamplingParams(
            max_tokens=16, temperature=temperature, guided_choice=CHOICES))
        assert result.text in CHOICES and result.finish_reason == "stop", result.text
        if ref is not None:
            want = ref.generate(prompt, JaxSamplingParams(
                max_tokens=16, temperature=0.0, guided_choice=CHOICES))
            assert result.token_ids == want.token_ids


def _jax_adapter(seed):
    base = jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(seed), rank=4,
                              dtype=jnp.float32)
    return {name: {"a": f["a"], "b": jax.random.normal(
        jax.random.PRNGKey(seed + 100), f["b"].shape, jnp.float32) * 0.2}
        for name, f in base.items()}


def test_mixed_adapters_match_merged_engines(jax_params, params):
    """``test_mixed_adapters_match_merged_engines[False]``: one contiguous
    batch of base + two adapters gives each merged single-model engine's
    tokens, and the JAX multi-LoRA batch's."""
    jax_adapters = {"incident": _jax_adapter(1), "verbose": _jax_adapter(2)}
    adapters = {name: params_from_jax(jax.tree_util.tree_map(np.array, a))
                for name, a in jax_adapters.items()}
    prompts = ["oom killed", "crash loop", "disk is full"]
    names = [None, "incident", "verbose"]
    kw = dict(decode_block=2)
    mixed = [r.token_ids for r in _results(
        _port(params, lora_adapters=adapters, **kw), prompts,
        [SamplingParams(max_tokens=8, adapter=n, **GREEDY) for n in names])]
    expected = []
    for prompt, name in zip(prompts, names):
        weights = params if name is None else lora.merge_lora(params, adapters[name])
        expected += _tokens(_port(weights, **kw), [prompt])
    assert mixed == expected
    assert mixed == [r.token_ids for r in _results(
        _jax(jax_params, lora_adapters=jax_adapters, **kw), prompts,
        [JaxSamplingParams(max_tokens=8, adapter=n, **GREEDY) for n in names])]


# ---------------------------------------------------------------------------
# beyond the JAX files
# ---------------------------------------------------------------------------


def test_recycled_slot_stale_row_is_masked(params):
    """A long occupant leaves its KV in the slot's row past the next
    occupant's length; the mask hides it: the short request's tokens are
    a fresh generator's, while the row still holds the old KV."""
    generator = _port(params, max_slots=1, decode_block=2, pipeline_depth=2)
    _tokens(generator, ["a long first occupant " * 3], max_tokens=40)
    stale = generator.cache.k[:, 0, 80:100].clone()
    assert stale.abs().sum() > 0
    got = _tokens(generator, ["short"], max_tokens=6)
    assert got == _tokens(_port(params, max_slots=1, decode_block=2, pipeline_depth=2),
                          ["short"], max_tokens=6)
    assert torch.equal(generator.cache.k[:, 0, 80:100], stale)


def test_aot_fingerprints_differ_by_layout(params, tmp_path):
    caches = {paged: _port(params, paged=paged, aot_cache=str(tmp_path))._aot
              for paged in (False, True)}
    assert caches[False].payload["paged"] is False and caches[True].payload["paged"] is True
    assert fingerprint_digest(caches[False].payload) != fingerprint_digest(caches[True].payload)
    assert caches[False].dir != caches[True].dir


@pytest.mark.parametrize("level,chunk", [("serving", None), ("full", 64)])
def test_grid_keys_match_the_jax_generator(jax_params, params, level, chunk):
    """The contiguous grid captures the JAX generator's programs under its
    keys: prefill buckets, chunk and finish programs, decode blocks."""
    kw = dict(max_slots=2, decode_block=2, prefill_chunk=chunk)
    ref = _jax(jax_params, **kw)
    want = ref.precompile_grid(level)
    port = _port(params, **kw)
    got = port.precompile_grid(level)
    assert set(got) == set(want) and got["programs"] == want["programs"]
    assert port._prefill_fns == set(ref._prefill_fns)
    assert set(port._chunk_fns) == set(ref._chunk_fns)
    assert set(port._finish_fns) == set(ref._finish_fns)
    assert bool(port._decode_guided_program.keys()) == (ref._decode_fn_guided is not None)
    assert port.num_active == 0 and not port._inflight_blocks


def test_shared_prefix_calls_return_zero_with_the_warning(jax_params, params, caplog):
    preamble = "You are a Kubernetes failure analyst. " * 8
    for generator in (_port(params), _jax(jax_params)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert generator.set_shared_prefix(preamble) == 0
            assert generator.add_shared_prefix(preamble) == 0
        messages = [r.getMessage() for r in caplog.records]
        assert messages == ["set_shared_prefix needs paged KV; ignoring",
                            "add_shared_prefix needs paged KV; ignoring"]
        assert generator.prefix_held_pages == 0 and not generator._prefixes


def test_reset_zeroes_the_cache_and_offsets_in_place(params):
    """The recovery path: the cache, the offsets and the last tokens are
    zeroed in place (the decode graphs read them by address) and the
    next wave is a fresh engine's."""
    generator = _port(params, decode_block=2)
    first = _tokens(generator, ["pod crashed", "exit 137"])
    held = (generator.cache.k, generator.cache.v, generator.offsets)
    generator.admit(["left mid-flight"], [SamplingParams(max_tokens=20, **GREEDY)])
    generator.step()
    generator.reset()
    now = (generator.cache.k, generator.cache.v, generator.offsets)
    assert all(a is b for a, b in zip(held, now))
    assert all(not t.any() for t in (*now, generator.last_tokens))
    assert generator.num_active == 0 and generator.allocator is None
    assert _tokens(generator, ["pod crashed", "exit 137"]) == first
    generator.reset(fresh=True)
    assert generator.cache.k is not held[0] and not generator.offsets.any()
    assert _tokens(generator, ["pod crashed", "exit 137"]) == first


def test_healthz_load_report_matches_the_jax_server(jax_params, params):
    """A contiguous wave replica's ``/healthz`` load report has the JAX
    server's keys, and its values apart from wall-clock readings (no
    pages: 0 free of 0); ``/metrics.json`` has its stages and counters."""
    kw = dict(max_slots=4, max_seq=128, decode_block=2, pipeline_depth=2)
    with event_loop_thread() as run:
        async def start():
            jax_engine = JaxServingEngine(_jax(jax_params, metrics=JaxMetricsRegistry(), **kw),
                                          admission_wait_s=0.005)
            port_engine = ServingEngine(_port(params, metrics=MetricsRegistry(), **kw),
                                        admission_wait_s=0.005)
            servers = {
                "jax": _server(JaxCompletionServer, jax_engine, JaxProvider,
                               JaxHashingEmbedder(dim=64)),
                "port": _server(CompletionServer, port_engine, TPUNativeProvider,
                                HashingEmbedder(dim=64)),
            }
            for server in servers.values():
                await server.start()
            return servers

        servers = run(start())
        try:
            ports = {name: s.bound_port for name, s in servers.items()}
            for prompt in ("pod crashed with exit code 137", "OOMKilled " * 4):
                replies = {name: call(port, "POST", "/v1/completions",
                                      {"prompt": prompt, "max_tokens": 5, "temperature": 0.0})
                           for name, port in ports.items()}
                texts = {name: json.loads(r[2])["choices"][0]["text"]
                         for name, r in replies.items()}
                assert texts["port"] == texts["jax"]
            health = {name: json.loads(call(port, "GET", "/healthz", token=None)[2])
                      for name, port in ports.items()}
            stats = {name: json.loads(call(port, "GET", "/metrics.json")[2])
                     for name, port in ports.items()}
        finally:
            async def stop():
                for server in servers.values():
                    await server.stop()
                await servers["jax"].engine.close()

            run(stop())
            servers["port"].engine.close()
    load = {name: h["load"] for name, h in health.items()}
    assert sorted(load["port"]) == sorted(load["jax"])
    same = {name: {k: v for k, v in report.items() if k not in WALL_CLOCK}
            for name, report in load.items()}
    assert same["port"] == same["jax"]
    assert same["port"]["kvPagesFree"] == same["port"]["kvPagesTotal"] == 0
    for section in ("stages", "counters", "histograms"):
        assert sorted(stats["port"][section]) == sorted(stats["jax"][section]), section
