"""The PyTorch port's model math against the JAX package's.

``rms_norm``, ``rope_frequencies`` (plain and llama3 scaling),
``apply_rope``, ``quantize_matrix`` and ``mm`` (f32 and int8), the
sampler, the model registry and the byte tokenizer — each against its
JAX twin on inputs drawn once with numpy, with the tolerance stated per
test; and ``params_from_jax`` must carry a JAX ``init_params`` /
``quantize_params`` tree across bit for bit, bf16 included.
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
from operator_tpu_torch.models import configs, llama, quant  # noqa: E402
from operator_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
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
