"""The port's multi-LoRA serving against the JAX package's.

``parallel/lora.py`` and the model's ``_lora_path`` against the JAX
functions on the same seeded factors (``TINY_TEST``, f32, the JAX
weights and adapters bridged through numpy; the adapters' ``b`` drawn
nonzero, since ``init_lora`` zeros it and would make every adapter a
no-op): the low-rank delta, ``forward`` (dense and flash prefill) and
``decode_step_paged`` logits with per-row ``lora_indices``, the merge
(quantized base included), the stack and the zero adapter.  Adapter
files round trip in both directions and are byte for byte the JAX
package's.

Through the wave engine: a batch of base and two adapters equals three
engines over ``merge_lora`` weights; the zero adapter is the base
model; an unknown adapter fails only its own request; the HTTP front
lists the adapters and routes ``model``; ``LORA_DIR`` drops each bad
file alone, as the JAX loader does, and under ``SCHED_MODE=continuous``
falls back to the wave engine.
"""

import asyncio
import contextlib
import json
import logging
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models import llama as jax_llama  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.ops.paged_attention import PagedKVCache as JaxPagedKVCache  # noqa: E402
from operator_tpu.parallel import lora as jax_lora  # noqa: E402
from operator_tpu.serving import provider as jax_provider  # noqa: E402
from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, llama, params_from_jax  # noqa: E402
from operator_tpu_torch.models.loader import write_safetensors  # noqa: E402
from operator_tpu_torch.ops.paged_attention import PagedKVCache  # noqa: E402
from operator_tpu_torch.parallel import lora  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.provider import build_serving_engine  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

RANK = 4
#: f32 logits of the LoRA passes against JAX's (two libraries' f32
#: reductions in different orders): one decode step differs by about 4e-6
#: at logits of magnitude 3.6; a 64-token prefill by up to 1.1e-4, so it
#: keeps the model tests' prefill tolerance
DECODE_LOGIT_ATOL = 1e-5
PREFILL_LOGIT_ATOL = 2e-4


def _np(tensor):
    return tensor.detach().cpu().numpy()


def _jax_adapter(seed, rank=RANK):
    base = jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(seed), rank=rank,
                              dtype=jnp.float32)
    return {
        name: {"a": f["a"], "b": jax.random.normal(
            jax.random.PRNGKey(seed + 100), f["b"].shape, jnp.float32) * 0.2}
        for name, f in base.items()
    }


def _port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.array, tree))


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return _port(jax_params)


@pytest.fixture(scope="module")
def jax_adapters():
    return {"incident": _jax_adapter(1), "verbose": _jax_adapter(2)}


@pytest.fixture(scope="module")
def adapters(jax_adapters):
    return {name: _port(a) for name, a in jax_adapters.items()}


def _stacks(jax_adapters):
    zero = jax_lora.zero_lora(JAX_TINY_TEST, rank=RANK, dtype=jnp.float32)
    jax_stack = jax_lora.stack_adapters(
        [zero, jax_adapters["incident"], jax_adapters["verbose"]])
    return jax_stack, _port(jax_stack)


# ---------------------------------------------------------------------------
# the functions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_row", [False, True])
def test_lora_path_matches_jax(jax_adapters, per_row):
    jax_stack, stack = _stacks(jax_adapters)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(3, 5, TINY_TEST.hidden_size)).astype(np.float32)
    idx = np.asarray([2, 0, 1], np.int32) if per_row else None
    factors = {k: v[1] for k, v in (jax_stack["wq"] if per_row else
                                    jax_adapters["incident"]["wq"]).items()}
    want = jax_llama._lora_path(
        jnp.asarray(h), factors, 16.0, None if idx is None else jnp.asarray(idx))
    got = llama._lora_path(
        torch.from_numpy(h), {k: torch.from_numpy(np.array(v)) for k, v in factors.items()},
        16.0, None if idx is None else torch.from_numpy(idx))
    # f32: the deltas reach |20| at these scales, so the bound is relative too
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_forward_with_stacked_adapters_matches_jax(
    monkeypatch, jax_params, params, jax_adapters, attention
):
    """The wave prefill's call with per-row adapters: a right-padded
    bucket through a mini cache, rows on base, incident and verbose."""
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", "1" if attention == "flash" else "0")
    jax_stack, stack = _stacks(jax_adapters)
    cfg = TINY_TEST
    b, t = 3, 64
    rng = np.random.default_rng(5)
    ids = rng.integers(3, cfg.vocab_size, size=(b, t)).astype(np.int32)
    lengths = np.asarray([64, 17, 1], np.int32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    kv_valid = positions < lengths[:, None]
    idx = np.asarray([0, 1, 2], np.int32)
    want, want_cache = jax_llama.forward(
        jax_params, JAX_TINY_TEST, jnp.asarray(ids), jnp.asarray(positions),
        cache=jax_llama.KVCache.create(JAX_TINY_TEST, b, t, dtype=jnp.float32),
        cache_offset=0, kv_valid=jnp.asarray(kv_valid), prefill_lengths=jnp.asarray(lengths),
        lora=jax_stack, lora_alpha=16.0, lora_indices=jnp.asarray(idx),
    )
    got, cache = llama.forward(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(positions),
        cache=llama.KVCache.create(cfg, b, t, dtype=torch.float32, device="cpu"),
        cache_offset=0, kv_valid=torch.from_numpy(kv_valid),
        prefill_lengths=torch.from_numpy(lengths),
        lora=stack, lora_alpha=16.0, lora_indices=torch.from_numpy(idx),
    )
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(_np(got)[row, :n], np.asarray(want)[row, :n],
                                   rtol=0, atol=PREFILL_LOGIT_ATOL)
    np.testing.assert_allclose(_np(cache.k)[:, 0], np.asarray(want_cache.k)[:, 0],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_paged_with_adapters_matches_jax(jax_params, jax_adapters, quantized):
    jax_tree = jax_quant.quantize_params(jax_params, JAX_TINY_TEST) if quantized else jax_params
    params = _port(jax_tree)
    jax_stack, stack = _stacks(jax_adapters)
    cfg = TINY_TEST
    b, page, pps = 4, 8, 4
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, b * pps + 1, page, cfg.num_kv_heads, cfg.head_dim)
    k_pages = rng.normal(size=shape).astype(np.float32)
    v_pages = rng.normal(size=shape).astype(np.float32)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    lengths = np.asarray([9, 1, 30, 4], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    idx = np.asarray([1, 2, 0, 1], np.int32)
    want, _ = jax_llama.decode_step_paged(
        jax_tree, JAX_TINY_TEST, jnp.asarray(tokens),
        JaxPagedKVCache(k_pages=jnp.asarray(k_pages), v_pages=jnp.asarray(v_pages),
                        page_table=jnp.asarray(table), lengths=jnp.asarray(lengths)),
        lora=jax_stack, lora_alpha=16.0, lora_indices=jnp.asarray(idx),
    )
    got, _ = llama.decode_step_paged(
        params, cfg, torch.from_numpy(tokens),
        PagedKVCache(k_pages=torch.from_numpy(k_pages), v_pages=torch.from_numpy(v_pages),
                     page_table=torch.from_numpy(table), lengths=torch.from_numpy(lengths)),
        lora=stack, lora_alpha=16.0, lora_indices=torch.from_numpy(idx),
    )
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=DECODE_LOGIT_ATOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_merge_matches_jax(jax_params, jax_adapters, quantized):
    jax_tree = jax_quant.quantize_params(jax_params, JAX_TINY_TEST) if quantized else jax_params
    want = jax_lora.apply_lora(jax_tree, jax_adapters["incident"], alpha=16.0)
    got = lora.merge_lora(_port(jax_tree), _port(jax_adapters["incident"]), alpha=16.0)
    for name in lora.DEFAULT_TARGETS:
        assert got["layers"][name].dtype == torch.float32
        np.testing.assert_allclose(_np(got["layers"][name]),
                                   np.asarray(want["layers"][name]), rtol=0, atol=1e-5)
    # un-targeted matrices are the base's own objects
    assert got["layers"]["w_up"] is not None


def test_stack_zero_and_init_contract(jax_adapters):
    jax_stack, stack = _stacks(jax_adapters)
    for name in lora.DEFAULT_TARGETS:
        for factor in ("a", "b"):
            np.testing.assert_array_equal(_np(stack[name][factor]),
                                          np.asarray(jax_stack[name][factor]))
    # [n_layers, n_adapters, in, r]: the layer axis leads
    assert stack["wq"]["a"].shape == (TINY_TEST.num_layers, 3, TINY_TEST.hidden_size, RANK)
    zero = lora.zero_lora(TINY_TEST, rank=RANK, dtype=torch.float32, device="cpu")
    assert all(not f[k].any() for f in zero.values() for k in ("a", "b"))
    gen = torch.Generator().manual_seed(0)
    fresh = lora.init_lora(TINY_TEST, gen, rank=16, dtype=torch.float32, device="cpu")
    assert set(fresh) == set(lora.DEFAULT_TARGETS)
    assert fresh["wo"]["a"].shape == (TINY_TEST.num_layers, TINY_TEST.num_heads
                                      * TINY_TEST.head_dim, 16)
    assert not fresh["wo"]["b"].any()
    assert abs(float(fresh["wq"]["a"].std()) - 16 ** -0.5) < 0.02
    assert lora.lora_param_count(fresh) == jax_lora.lora_param_count(
        jax_lora.init_lora(JAX_TINY_TEST, jax.random.PRNGKey(0), rank=16))
    with pytest.raises(ValueError, match="rank/shape mismatch"):
        lora.stack_adapters([zero, fresh])
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora.init_lora(TINY_TEST, gen, targets=("wz",), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_files_round_trip_both_ways(tmp_path, jax_adapters, dtype):
    jax_dtype = getattr(jnp, dtype)
    source = jax.tree_util.tree_map(lambda x: x.astype(jax_dtype), jax_adapters["incident"])
    jax_path, port_path = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_lora.save_lora(source, jax_path)
    lora.save_lora(_port(source), port_path)
    # the JAX package's byte layout, byte for byte
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    from_jax = lora.load_lora(jax_path, dtype=torch.float32, device="cpu")
    from_port = jax_lora.load_lora(port_path, dtype=jnp.float32)
    for name, factors in source.items():
        for factor, value in factors.items():
            want = np.asarray(value.astype(jnp.float32))
            np.testing.assert_array_equal(_np(from_jax[name][factor]), want)
            np.testing.assert_array_equal(np.asarray(from_port[name][factor]), want)


def test_load_lora_refuses_a_file_that_is_not_an_adapter(tmp_path):
    path = str(tmp_path / "x.safetensors")
    write_safetensors(path, {"model.embed": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a LoRA adapter file"):
        lora.load_lora(path, device="cpu")
    write_safetensors(path, {"lora.wq.a": torch.zeros(1, 2, 2)})
    with pytest.raises(ValueError, match="missing a factor"):
        lora.load_lora(path, device="cpu")


# ---------------------------------------------------------------------------
# the wave engine
# ---------------------------------------------------------------------------

PROMPTS = ["oom killed", "crash loop", "disk is full"]
GREEDY = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)


def _generator(params, lora_adapters=None, **kw):
    return Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128,
        cache_dtype=torch.float32, page_size=16, decode_block=2, device="cpu",
        lora_adapters=lora_adapters, **kw,
    )


def _run(generator, prompts, sampling):
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s].token_ids for s in slots]


def test_mixed_adapters_match_merged_engines(params, adapters):
    """One batch of base + two adapters reproduces, token for token, three
    single-model engines over base, merge(incident), merge(verbose)."""
    names = [None, "incident", "verbose"]
    mixed = _run(_generator(params, adapters), PROMPTS, [
        SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False, adapter=n)
        for n in names])
    expected = []
    for prompt, name in zip(PROMPTS, names):
        weights = params if name is None else lora.merge_lora(params, adapters[name])
        expected += _run(_generator(weights), [prompt], [GREEDY])
    assert mixed == expected
    assert mixed[1] != _run(_generator(params), [PROMPTS[1]], [GREEDY])[0]


def test_zero_adapter_is_identity(params, adapters):
    zero = {"zero": lora.zero_lora(TINY_TEST, rank=RANK, dtype=torch.float32, device="cpu")}
    multi = _run(_generator(params, {**adapters, **zero}), ["pod failed"] * 2, [
        GREEDY, SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False,
                               adapter="zero")])
    plain = _run(_generator(params), ["pod failed"], [GREEDY])
    assert multi == plain * 2


def test_unknown_adapter_rejected(params, adapters):
    generator = _generator(params, adapters)
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        generator.admit(["x"], [SamplingParams(max_tokens=2, adapter="nope")])
    assert generator.adapter_names == ["incident", "verbose"]
    assert generator.allocator.available == generator.allocator.num_pages - 1
    with pytest.raises(ValueError, match="unknown LoRA adapter"):
        _generator(params).admit(["x"], [SamplingParams(max_tokens=2, adapter="incident")])


def test_unknown_adapter_fails_only_that_request(params, adapters):
    engine = ServingEngine(_generator(params, adapters), admission_wait_s=0.005)

    async def scenario():
        with pytest.raises(ValueError, match="unknown LoRA adapter 'typo'"):
            await engine.generate("x", SamplingParams(max_tokens=2, adapter="typo"))
        return await engine.generate(
            "y", SamplingParams(max_tokens=2, temperature=0.0, adapter="incident"))

    try:
        assert asyncio.run(scenario()).completion_tokens >= 1
    finally:
        engine.close()


@contextlib.contextmanager
def _serving(server):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    try:
        run(server.start())
        try:
            yield f"http://127.0.0.1:{server.bound_port}"
        finally:
            run(server.stop())
    finally:
        server.engine.close()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url, data=data,
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_completion_api_routes_adapters(params, adapters):
    engine = ServingEngine(_generator(params, adapters), admission_wait_s=0.005)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    direct = _generator(params, adapters).generate(
        "oom killed", SamplingParams(max_tokens=6, temperature=0.0, adapter="incident"))
    with _serving(server) as base:
        status, models = _call(f"{base}/v1/models")
        assert status == 200
        assert [m["id"] for m in models["data"]][:3] == ["tiny-test", "incident", "verbose"]
        assert models["data"][1]["parent"] == "tiny-test"
        request = {"prompt": "oom killed", "max_tokens": 6, "temperature": 0.0}
        status, adapted = _call(f"{base}/v1/completions", {**request, "model": "incident"})
        assert status == 200 and adapted["model"] == "incident"
        assert adapted["choices"][0]["text"] == direct.text
        status, err = _call(f"{base}/v1/completions", {**request, "model": "gpt-4"})
        assert status == 404 and "not found" in err["error"]["message"]


# ---------------------------------------------------------------------------
# LORA_DIR through build_serving_engine, against the JAX provider
# ---------------------------------------------------------------------------

ENV = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
       "MAX_BATCH_SIZE": "2", "DECODE_BLOCK": "2", "KV_PAGE_SIZE": "16"}


def _jax_adapter_names(lora_dir):
    config = JaxOperatorConfig(model_id="tiny-test", allow_random_weights=True,
                               max_batch_size=2, decode_block=2, lora_dir=lora_dir)
    engine, _ = jax_provider.build_serving_engine(config)
    try:
        return engine.generator.adapter_names, engine._sched is None
    finally:
        engine._executor.shutdown(wait=False)


def test_lora_dir_loader_isolates_bad_adapters(tmp_path, jax_adapters, caplog):
    """A good adapter, an empty file, a rank-mismatched adapter, a corrupt
    file, a truncated one and one named like the base model: only the
    good one registers, in both packages, and the default continuous
    mode falls back to the wave engine."""
    from safetensors.numpy import save_file

    lora_dir = tmp_path / "loras"
    lora_dir.mkdir()
    jax_lora.save_lora(jax_adapters["incident"], str(lora_dir / "good.safetensors"))
    save_file({}, str(lora_dir / "empty.safetensors"))
    jax_lora.save_lora(_jax_adapter(9, rank=RANK * 2), str(lora_dir / "rank8.safetensors"))
    (lora_dir / "corrupt.safetensors").write_bytes(b"not a safetensors file")
    whole = (lora_dir / "good.safetensors").read_bytes()
    (lora_dir / "truncated.safetensors").write_bytes(whole[: len(whole) // 2])
    jax_lora.save_lora(jax_adapters["verbose"], str(lora_dir / "tiny-test.safetensors"))
    with caplog.at_level(logging.WARNING):
        engine, model_id = build_serving_engine("cpu", {**ENV, "LORA_DIR": str(lora_dir)})
    try:
        assert model_id == "tiny-test"
        assert engine.generator.adapter_names == ["good"]
        assert engine.scheduler is None  # continuous -> wave fallback
        assert (engine.generator.decode_block, engine.generator.pipeline_depth) == (2, 2)
    finally:
        engine.close()
    text = caplog.text
    for needle in ("truncated.safetensors unusable", "corrupt.safetensors unusable",
                   "'empty' is empty", "'rank8' has targets/shapes",
                   "collides with the base model id", "falling back to the wave engine"):
        assert needle in text, needle
    assert _jax_adapter_names(str(lora_dir)) == (["good"], True)


def test_lora_dir_missing_warns_and_keeps_the_continuous_path(tmp_path, caplog):
    missing = str(tmp_path / "does-not-exist")
    with caplog.at_level(logging.WARNING):
        engine, _ = build_serving_engine("cpu", {**ENV, "LORA_DIR": missing})
    try:
        assert engine.generator.adapter_names == []
        assert engine.scheduler is not None
    finally:
        engine.close()
    assert any("lora_dir" in r.message for r in caplog.records)
    assert _jax_adapter_names(missing) == ([], False)
