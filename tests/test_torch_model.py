"""The PyTorch port's model math against the JAX package's.

``rms_norm``, ``rope_frequencies`` (plain and llama3 scaling),
``apply_rope``, ``quantize_matrix`` and ``mm`` (f32 and int8), the
sampler, the model registry and the byte tokenizer — each against its
JAX twin on inputs drawn once with numpy, with the tolerance stated per
test; and ``params_from_jax`` must carry a JAX ``init_params`` /
``quantize_params`` tree across bit for bit, bf16 included.

The wave engine's passes: ``forward`` with a mini cache (flash prefill on
and off, dense and query-chunked attention, per-sequence offsets, the
``logits_at`` gather), without a cache, and ``decode_step_paged`` (with and
without a sliding window, f32 and int8 weights) against the JAX functions
on the same weights carried across by ``params_from_jax``; logits within
2e-4 (f32 sums of a few hundred terms, in another order), caches exactly
or within the same bound.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import configs as jax_configs  # noqa: E402
from operator_tpu.models import llama as jax_llama  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.ops.paged_attention import PagedKVCache as JaxPagedKVCache  # noqa: E402
from operator_tpu_torch.models import configs, llama, quant  # noqa: E402
from operator_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from operator_tpu_torch.ops.paged_attention import PagedKVCache  # noqa: E402
from operator_tpu_torch.serving.sampling import sample  # noqa: E402


def _np(tensor):
    return tensor.detach().cpu().numpy()


def test_model_registry_matches_jax():
    for name, jax_cfg in jax_configs._REGISTRY.items():
        assert dataclasses.asdict(configs.get_config(name)) == dataclasses.asdict(jax_cfg)
    assert dataclasses.asdict(configs.scaled(configs.TINYLLAMA_1_1B, num_layers=2)) == (
        dataclasses.asdict(jax_configs.scaled(jax_configs.TINYLLAMA_1_1B, num_layers=2))
    )


def test_byte_tokenizer_matches_jax():
    text = "pod web-7d9f OOMKilled (exit 137) — ünïcode"
    assert ByteTokenizer().encode(text) == JaxByteTokenizer().encode(text)
    ids = JaxByteTokenizer().encode(text) + [300, 2, 0]
    assert ByteTokenizer().decode(ids) == JaxByteTokenizer().decode(ids)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = _np(llama.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # f32, one rsqrt


@pytest.mark.parametrize("name", ["tiny-test", "tinyllama-1.1b", "llama-3.1-8b", "llama-3.2-1b"])
def test_rope_frequencies_match_jax(name):
    want = np.asarray(jax_llama.rope_frequencies(jax_configs.get_config(name)))
    got = _np(llama.rope_frequencies(configs.get_config(name)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)  # f32 pow/divide


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 2048, size=(2, 7)).astype(np.int32)
    inv = np.array(jax_llama.rope_frequencies(jax_configs.TINY_TEST))
    want = np.asarray(jax_llama.apply_rope(jnp.asarray(x), jnp.asarray(positions), jnp.asarray(inv)))
    got = _np(llama.apply_rope(
        torch.from_numpy(x), torch.from_numpy(positions), torch.from_numpy(inv)
    ))
    # cos/sin of angles up to ~2048 rad: the two libms differ by an ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_quantize_matrix_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 48, 40)).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    want = jax_quant.quantize_matrix(jnp.asarray(w))
    got = quant.quantize_matrix(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(got["q"]), np.asarray(want["q"]))
    np.testing.assert_allclose(_np(got["s"]), np.asarray(want["s"]), rtol=1e-7, atol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_mm_matches_jax(quantized):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 48)).astype(np.float32)
    w = rng.normal(size=(48, 40)).astype(np.float32) * 0.1
    jw = jax_quant.quantize_matrix(jnp.asarray(w)) if quantized else jnp.asarray(w)
    tw = (
        {k: torch.from_numpy(np.asarray(v)) for k, v in jw.items()}
        if quantized else torch.from_numpy(w)
    )
    want = np.asarray(jax_quant.mm(jnp.asarray(x), jw))
    got = _np(quant.mm(torch.from_numpy(x), tw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)  # f32 sums of 48 terms


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_tree_equal(got[key], want[key])
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got.view(torch.int16)), want.view(np.int16))
    else:
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
def test_params_from_jax_round_trips(dtype, quantized):
    tree = jax_llama.init_params(
        jax_configs.TINY_TEST, jax.random.PRNGKey(0), dtype=getattr(jnp, dtype)
    )
    if quantized:
        tree = jax_quant.quantize_params(tree, jax_configs.TINY_TEST)
    numpy_tree = jax.tree_util.tree_map(np.asarray, tree)
    got = llama.params_from_jax(numpy_tree)
    _assert_tree_equal(got, numpy_tree)
    assert quant.is_quantized(got) == quantized
    # stacked [L, in, out] layout kept
    wq = got["layers"]["wq"]["q"] if quantized else got["layers"]["wq"]
    cfg = configs.TINY_TEST
    assert tuple(wq.shape) == (cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.head_dim)


def test_init_params_shapes_and_quantize():
    cfg = configs.TINY_TEST
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, torch.float32, device="cpu", quantize=True)
    reference = jax.eval_shape(
        lambda: jax_quant.quantize_params(
            jax_llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32), cfg
        )
    )
    flat = jax.tree_util.tree_flatten_with_path(reference)[0]
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path


def test_greedy_sampling_matches_jax_argmax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    logits[2, [3, 17]] = 9.0  # a tie: the first index wins in both
    temp = np.zeros(6, np.float32)
    top_p = np.full(6, 0.9, np.float32)
    got = _np(sample(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                     torch.from_numpy(temp), torch.from_numpy(top_p)))
    np.testing.assert_array_equal(got, np.argmax(logits, axis=-1))
    assert got[2] == 3


def test_sampled_distribution_matches_the_nucleus():
    """temperature + top-k + nucleus: empirical frequencies of 20k draws
    within 0.015 of the distribution the JAX sampler defines (renormalised
    softmax over the kept candidates)."""
    logits = np.asarray([2.0, 1.5, 1.0, 0.5, 0.0, -1.0, -3.0, -5.0], np.float32)
    temp, top_p, top_k, draws = 0.8, 0.9, 6, 20000
    scaled = logits / temp
    order = np.argsort(-scaled, kind="stable")[:top_k]
    probs = np.exp(scaled[order] - scaled[order].max())
    probs /= probs.sum()
    keep = (np.cumsum(probs) - probs) < top_p
    want = np.zeros_like(logits)
    want[order[keep]] = probs[keep] / probs[keep].sum()
    got = _np(sample(
        torch.from_numpy(np.tile(logits, (draws, 1))),
        torch.Generator().manual_seed(1),
        torch.full((draws,), temp), torch.full((draws,), top_p), top_k,
    ))
    freq = np.bincount(got, minlength=logits.size) / draws
    np.testing.assert_allclose(freq, want, rtol=0, atol=0.015)


# ---------------------------------------------------------------------------
# forward and decode_step_paged
# ---------------------------------------------------------------------------

LOGIT_ATOL = 2e-4


def _tiny_params(quantized=False, window=None):
    cfg = jax_configs.TINY_TEST
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    tree = jax_llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantized:
        tree = jax_quant.quantize_params(tree, cfg)
    numpy_tree = jax.tree_util.tree_map(np.asarray, tree)
    ours_cfg = dataclasses.replace(configs.TINY_TEST, sliding_window=window)
    return cfg, tree, ours_cfg, llama.params_from_jax(numpy_tree)


@pytest.mark.parametrize("attention", ["dense", "chunked", "flash"])
def test_prefill_forward_with_a_mini_cache_matches_jax(monkeypatch, attention):
    """The wave prefill's call: a right-padded bucket through a fresh
    mini cache at offset 0 with kv_valid = pos < lengths."""
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", "1" if attention == "flash" else "0")
    jcfg, jparams, cfg, params = _tiny_params()
    b, t = 3, 64
    rng = np.random.default_rng(5)
    ids = rng.integers(3, cfg.vocab_size, size=(b, t)).astype(np.int32)
    lengths = np.asarray([64, 17, 1], np.int32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t))
    kv_valid = positions < lengths[:, None]
    q_chunk = 16 if attention == "chunked" else None
    want_logits, want_cache = jax_llama.forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(positions),
        cache=jax_llama.KVCache.create(jcfg, b, t, dtype=jnp.float32),
        cache_offset=0, kv_valid=jnp.asarray(kv_valid), q_chunk=q_chunk,
        prefill_lengths=jnp.asarray(lengths),
    )
    cache = llama.KVCache.create(cfg, b, t, dtype=torch.float32, device="cpu")
    got_logits, got_cache = llama.forward(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(positions.copy()),
        cache=cache, cache_offset=0, kv_valid=torch.from_numpy(kv_valid.copy()),
        q_chunk=q_chunk, prefill_lengths=torch.from_numpy(lengths),
    )
    assert got_cache is cache  # written in place
    np.testing.assert_allclose(_np(got_logits), np.asarray(want_logits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(cache.k), np.asarray(want_cache.k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(cache.v), np.asarray(want_cache.v), rtol=0, atol=1e-5)
    # the prefill's gather before the vocab head: the same rows
    last, _ = llama.forward(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(positions.copy()),
        cache=llama.KVCache.create(cfg, b, t, dtype=torch.float32, device="cpu"),
        cache_offset=0, kv_valid=torch.from_numpy(kv_valid.copy()), q_chunk=q_chunk,
        prefill_lengths=torch.from_numpy(lengths),
        logits_at=torch.from_numpy(lengths - 1),
    )
    want_last = np.asarray(want_logits)[np.arange(b), lengths - 1]
    np.testing.assert_allclose(_np(last), want_last, rtol=0, atol=LOGIT_ATOL)


def test_forward_without_a_cache_matches_jax():
    jcfg, jparams, cfg, params = _tiny_params()
    rng = np.random.default_rng(6)
    ids = rng.integers(3, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    positions = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24)).copy()
    want, _ = jax_llama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(positions))
    got, cache = llama.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(positions))
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_forward_at_per_sequence_offsets_matches_jax():
    """Ragged offsets (a [B] tensor): each row writes and attends at its
    own position of a cache that already holds earlier tokens."""
    jcfg, jparams, cfg, params = _tiny_params()
    b, s, t = 3, 32, 2
    rng = np.random.default_rng(7)
    k0 = rng.normal(size=(cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    v0 = rng.normal(size=k0.shape).astype(np.float32)
    offsets = np.asarray([5, 0, 29], np.int32)
    ids = rng.integers(3, cfg.vocab_size, size=(b, t)).astype(np.int32)
    positions = (offsets[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    want, want_cache = jax_llama.forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(positions),
        cache=jax_llama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0)),
        cache_offset=jnp.asarray(offsets),
    )
    cache = llama.KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    got, _ = llama.forward(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(positions),
        cache=cache, cache_offset=torch.from_numpy(offsets),
    )
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(_np(cache.k), np.asarray(want_cache.k), rtol=0, atol=1e-5)


def test_pick_q_chunk_matches_jax():
    for shape in [(1, 64, 64, 8), (16, 2048, 2048, 32), (8, 4096, 4096, 32), (3, 96, 96, 4)]:
        assert llama._pick_q_chunk(*shape) == jax_llama._pick_q_chunk(*shape), shape


def test_make_causal_mask_matches_jax():
    rng = np.random.default_rng(8)
    q_pos = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40)).copy()
    kv_valid = rng.random((2, 40)) < 0.8
    for window in (None, 6):
        want = jax_llama.make_causal_mask(
            jnp.asarray(q_pos), jnp.asarray(kv_pos), jnp.asarray(kv_valid),
            sliding_window=window,
        )
        got = llama.make_causal_mask(
            torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
            torch.from_numpy(kv_valid), sliding_window=window,
        )
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("quantized,window", [(False, None), (True, None), (False, 6)])
def test_decode_step_paged_matches_jax(quantized, window):
    """One decode token per row over a paged cache holding earlier
    tokens: rows at lengths 9, 1 and 30, and a released row (all-zero
    table, length 0) writing to the trash page."""
    jcfg, jparams, cfg, params = _tiny_params(quantized, window)
    b, page, pps = 4, 8, 4
    num_pages = b * pps + 1
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, num_pages, page, cfg.num_kv_heads, cfg.head_dim)
    k_pages = rng.normal(size=shape).astype(np.float32)
    v_pages = rng.normal(size=shape).astype(np.float32)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    table[3] = 0
    lengths = np.asarray([9, 1, 30, 0], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    want_logits, want_cache = jax_llama.decode_step_paged(
        jparams, jcfg, jnp.asarray(tokens),
        JaxPagedKVCache(
            k_pages=jnp.asarray(k_pages), v_pages=jnp.asarray(v_pages),
            page_table=jnp.asarray(table), lengths=jnp.asarray(lengths),
        ),
    )
    paged = PagedKVCache(
        k_pages=torch.from_numpy(k_pages.copy()), v_pages=torch.from_numpy(v_pages.copy()),
        page_table=torch.from_numpy(table), lengths=torch.from_numpy(lengths),
    )
    got_logits, got_cache = llama.decode_step_paged(
        params, cfg, torch.from_numpy(tokens), paged
    )
    assert got_cache.k_pages is paged.k_pages  # written in place
    np.testing.assert_allclose(_np(got_logits), np.asarray(want_logits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(_np(got_cache.lengths), np.asarray(want_cache.lengths))
    # page 0 (trash) takes the released row's write in either package
    for ours, theirs in ((got_cache.k_pages, want_cache.k_pages),
                         (got_cache.v_pages, want_cache.v_pages)):
        np.testing.assert_allclose(_np(ours)[:, 1:], np.asarray(theirs)[:, 1:],
                                   rtol=0, atol=1e-5)
