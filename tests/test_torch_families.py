"""The model families beyond Llama through the port's continuous engine.

Three tiny f32 variants of ``TINY_TEST`` carry the features of the
registry's other families: a 24-token sliding window (Mistral), q/k/v
biases with seven query heads per KV head (Qwen2.5-7B's group), and tied
embeddings with llama3 RoPE scaling and groups of three (Llama-3.2-3B).
Each runs through the port's ``ServingEngine`` (the mixed step, the
plain ragged attention on the CPU) and through the JAX
``BatchedGenerator`` + ``Scheduler``, built as ``tests/test_torch_engine.py``
builds them, on the same weights (JAX ``init_params``, the biases drawn
from a seed, carried over by ``params_from_jax``), in f32 and in int8
(each package's ``quantize_params``), at pipeline depth 1 and 2 with
prompt-lookup speculation on.  Greedy token ids, the plans of every step,
the speculation counters and the prefix cache's economy must be the JAX
engine's exactly.

Cases: prompts of at least three windows; a prefix-cache hit over a
prefix longer than the window; verify rows whose queries straddle the
window's start; seven-head groups whose 16-token chunks cut a token's
heads at the kernel's 64-row tile boundary (the card's tiles; the CPU
runs the plain version).  The mixed step's sampled logits are held to
the JAX step's within ``LOGIT_ATOL`` on packed waves past the window.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import configs as jax_configs  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.quant import quantize_params as jax_quantize_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.ops.paged_attention import PagedKVCache as JaxPagedKVCache  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.kvstore import PrefixKVStore as JaxPrefixKVStore  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.serving.sched.mixed import make_mixed_fn  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry  # noqa: E402
from operator_tpu_torch.models import ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.models import configs as port_configs  # noqa: E402
from operator_tpu_torch.models.quant import quantize_params  # noqa: E402
from operator_tpu_torch.ops.paged_attention import PagedKVCache  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.kvstore import PrefixKVStore  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.sched import mixed as mixed_module  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

WINDOW = 24
SLOTS, MAX_SEQ, PAGE, CHUNK, BUDGET = 4, 128, 16, 16, 32
MAX_TOKENS = 10
#: the mixed step's sampled logits, port against JAX: the tolerance
#: ``tests/test_torch_mixed.py`` holds the pages to (f32 sums in
#: different orders)
LOGIT_ATOL = 1e-5
KV_ATOL = 1e-5

#: every prompt is at least three windows long (byte tokenizer: one token
#: per character, plus BOS); the repeated words give prompt-lookup drafts,
#: so verify rows run past the window's start
PROMPTS = [
    "pod web-7d9f8c crashed with exit code 137, reason OOMKilled, memory limit 512Mi",
    "OOMKilled " * 8,
    "a much longer prompt " * 5,
]
#: two prompts sharing a 65-token head (64 of it cached: four pages,
#: longer than the window); the second runs after the first finished
SHARED = "kubelet: Back-off restarting failed container app in pod web-7d9f8c "[:64]
HIT_PROMPTS = [SHARED + "exit code 137", SHARED + "reason OOMKilled"]


def _variants(configs) -> dict:
    """The three variants of one package's ``TINY_TEST`` (each package has
    its own config classes)."""
    tiny = configs.TINY_TEST
    return {
        "window": replace(tiny, name="tiny-window", sliding_window=WINDOW),
        "bias_g7": replace(tiny, name="tiny-bias-g7", num_heads=14, num_kv_heads=2,
                           attention_bias=True),
        # original context 64: band 0 kept, bands 1-2 smoothed, the rest
        # slowed by the factor (all three branches of the llama3 rule)
        "tied_scaled_g3": replace(
            tiny, name="tiny-tied-g3", num_heads=6, num_kv_heads=2, tie_embeddings=True,
            rope_theta=500_000.0,
            rope_scaling=configs.RopeScaling(factor=32.0, original_max_positions=64),
        ),
    }


JAX_VARIANTS = _variants(jax_configs)
VARIANTS = _variants(port_configs)


def _jax_params(name: str, weights: str):
    config = JAX_VARIANTS[name]
    params = jax_init_params(config, jax.random.PRNGKey(0), dtype=jnp.float32)
    if config.attention_bias:
        # JAX initialises the biases to zero: draw them, so they count
        rng = np.random.default_rng(1)
        layers = dict(params["layers"])
        for bias in ("bq", "bk", "bv"):
            layers[bias] = jnp.asarray(
                0.5 * rng.standard_normal(layers[bias].shape).astype(np.float32))
        params = {**params, "layers": layers}
    if weights == "int8":
        params = jax_quantize_params(params, config)
    return params


_PARAMS: dict = {}


def params(name: str, weights: str) -> tuple:
    """(JAX tree, the port's tree) of one variant; the port's int8 tree is
    its own ``quantize_params`` of the f32 tree, held equal to JAX's."""
    key = (name, weights)
    if key not in _PARAMS:
        jax_tree = _jax_params(name, weights)
        port = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))
        if weights == "int8":
            f32 = params_from_jax(jax.tree_util.tree_map(
                np.asarray, _jax_params(name, "float32")))
            own = quantize_params(f32, VARIANTS[name])
            for leaf in ("wq", "w_down"):
                assert torch.equal(own["layers"][leaf]["q"], port["layers"][leaf]["q"])
            port = own
        _PARAMS[key] = (jax_tree, port)
    return _PARAMS[key]


def _drive(sched, prompts, sampling):
    """Enqueue ``prompts`` together and step until all finish: (greedy ids
    per prompt, the plan trace).  Both packages' schedulers take the same
    calls."""
    sched.plan_log = []
    ids = {sched.enqueue(p, sampling): p for p in prompts}
    done = {}
    for _ in range(400):
        for outcome in sched.step():
            done[outcome.req_id] = outcome
        if len(done) == len(ids):
            break
    assert len(done) == len(ids)
    return [done[r].result.token_ids for r in ids], sched.plan_log


def _jax_sched(name, weights, depth, store):
    generator = BatchedGenerator(
        params(name, weights)[0], JAX_VARIANTS[name], JaxByteTokenizer(), paged=True,
        cache_dtype=jnp.float32, metrics=MetricsRegistry(), max_slots=SLOTS,
        max_seq=MAX_SEQ, page_size=PAGE,
    )
    return JaxScheduler(
        generator, chunk=CHUNK, token_budget=BUDGET, pipeline_depth=depth,
        spec_decode=True, kvstore=JaxPrefixKVStore(PAGE) if store else None,
    )


def _port_engine(name, weights, depth, store):
    generator = Generator(
        params(name, weights)[1], VARIANTS[name], ByteTokenizer(), max_slots=SLOTS,
        max_seq=MAX_SEQ, page_size=PAGE, cache_dtype=torch.float32, device="cpu",
    )
    sched = Scheduler(
        generator, chunk=CHUNK, token_budget=BUDGET, pipeline_depth=depth,
        spec_decode=True, kvstore=PrefixKVStore(PAGE) if store else None,
    )
    return ServingEngine(generator, sched)


def _runs(sched, runs):
    """Each list of prompts in turn on one scheduler: (tokens, plans) per
    run, then the speculation counters (not their host times) and the
    prefix cache's economy."""
    sampling = (JaxSamplingParams if isinstance(sched, JaxScheduler) else SamplingParams)(
        max_tokens=MAX_TOKENS, temperature=0.0)
    out = [_drive(sched, prompts, sampling) for prompts in runs]
    stats = sched.stats()
    spec = {k: v for k, v in stats["spec_decode"].items() if not k.endswith("_ms")}
    return out, spec, stats["kv_economy"]


_JAX_RUNS: dict = {}


def jax_runs(name, weights, depth, case):
    key = (name, weights, depth, case)
    if key not in _JAX_RUNS:
        runs = [PROMPTS] if case == "cobatched" else [[p] for p in HIT_PROMPTS]
        _JAX_RUNS[key] = _runs(_jax_sched(name, weights, depth, case == "prefix_hit"), runs)
    return _JAX_RUNS[key]


def _assert_no_leaks(engine):
    generator = engine.generator
    assert len(generator.free_slots()) == generator.max_slots
    accounting = engine.scheduler.page_accounting()
    assert accounting["row_pages"] == 0
    assert (accounting["available"] + accounting["store_pages"] + accounting["prefix_pages"]
            == accounting["total"])


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_cobatched_greedy_matches_jax(name, weights, depth):
    """The three long prompts together: greedy ids, every step's plan and
    the speculation counters are the JAX engine's; verify rounds ran, on
    rows past the window for the window variant."""
    want, want_spec, _ = jax_runs(name, weights, depth, "cobatched")
    engine = _port_engine(name, weights, depth, store=False)
    try:
        got, spec, _ = _runs(engine.scheduler, [PROMPTS])
        _assert_no_leaks(engine)
    finally:
        engine.close()
    assert min(len(p) for p in PROMPTS) + 1 >= 3 * WINDOW
    assert got[0][0] == want[0][0]
    assert got[0][1] == want[0][1]
    assert spec == want_spec
    assert spec["verify_rounds"] > 0


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefix_hit_past_the_window_matches_jax(name, weights, depth):
    """Two prompts sharing a head of four pages (64 tokens, over two
    windows), one after the other on one engine with the prefix cache:
    the second reuses the four pages; greedy ids, plans and the cache's
    economy are the JAX engine's."""
    want, _, want_economy = jax_runs(name, weights, depth, "prefix_hit")
    engine = _port_engine(name, weights, depth, store=True)
    try:
        got, _, economy = _runs(engine.scheduler, [[p] for p in HIT_PROMPTS])
        _assert_no_leaks(engine)
    finally:
        engine.close()
    assert [run[0] for run in got] == [run[0] for run in want]
    assert [run[1] for run in got] == [run[1] for run in want]
    assert economy == want_economy
    assert economy["prefill_tokens_saved"] == len(SHARED) > WINDOW


# ---------------------------------------------------------------------------
# the mixed step alone: sampled logits and pages on packed waves
# ---------------------------------------------------------------------------

PPS = MAX_SEQ // PAGE
NUM_PAGES = SLOTS * PPS + 1
WIDTH = 3
#: wave -> per-slot work (slot, kind, pos0, count, n_drafts, from_prev);
#: every row reaches past the 24-token window
WAVES = {
    "prefill": [(0, "prefill", 48, 16, 0, False), (1, "finish", 16, 11, 0, False)],
    "decode": [(0, "decode", 90, 1, 0, False), (1, "decode", 30, 1, 0, True),
               (2, "decode", 25, 1, 0, False), (3, "decode", 120, 1, 0, False)],
    "mixed": [(0, "decode", 70, 1, 0, True), (1, "prefill", 32, 16, 0, False),
              (3, "finish", 64, 5, 0, False)],
    # verify rows of 1 + k queries whose windows start on both sides of a
    # page edge (at 32..34 and 63..65 with a window of 24)
    "verify": [(0, "verify", 55, 3, 2, False), (1, "decode", 40, 1, 0, False),
               (2, "verify", 86, 3, 2, False)],
}
ORDER = ("ids", "rows", "pos", "valid", "in_row", "q_start", "q_count", "kv_len",
         "latest", "from_prev", "sample_start", "spec_len")


def _pack(wave, rng, vocab):
    """Pack a wave as the scheduler's dispatch does."""
    flat = {name: np.zeros((BUDGET,), np.int32) for name in ("ids", "rows", "pos", "in_row")}
    valid = np.zeros((BUDGET,), bool)
    from_prev = np.zeros((BUDGET,), bool)
    per_slot = {name: np.zeros((SLOTS,), np.int32)
                for name in ("q_start", "q_count", "sample_start", "spec_len")}
    kv_len = rng.integers(0, 30, size=SLOTS).astype(np.int32)
    cursor = 0
    for slot, _, pos0, count, n_drafts, chained in wave:
        span = slice(cursor, cursor + count)
        flat["ids"][span] = 0 if chained else rng.integers(3, vocab, size=count)
        flat["pos"][span] = np.arange(pos0, pos0 + count)
        flat["rows"][span] = slot
        flat["in_row"][span] = np.arange(count)
        valid[span] = True
        from_prev[span] = chained
        per_slot["q_start"][slot] = cursor
        per_slot["q_count"][slot] = count
        per_slot["sample_start"][slot] = cursor + count - 1 - n_drafts
        per_slot["spec_len"][slot] = n_drafts
        kv_len[slot] = pos0 + count
        cursor += count
    return dict(flat, valid=valid, from_prev=from_prev, kv_len=kv_len, **per_slot,
                latest=rng.integers(3, vocab, size=SLOTS).astype(np.int32),
                temp=np.zeros((SLOTS,), np.float32), top_p=np.ones((SLOTS,), np.float32))


def _cache(config, rng):
    shape = (config.num_layers, NUM_PAGES, PAGE, config.num_kv_heads, config.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    table = (1 + rng.permutation(NUM_PAGES - 1)).reshape(SLOTS, PPS).astype(np.int32)
    return k, v, table


_STEPS: dict = {}


def _steps(name, weights):
    """(JAX mixed fn, its logits list, the port's step) for one variant:
    each records the sampled positions' logits of its last call."""
    if (name, weights) not in _STEPS:
        generator = BatchedGenerator(
            params(name, weights)[0], JAX_VARIANTS[name], JaxByteTokenizer(), paged=True,
            cache_dtype=jnp.float32, metrics=MetricsRegistry(), max_slots=SLOTS,
            max_seq=MAX_SEQ, page_size=PAGE,
        )
        seen = []
        sample = generator._sample

        def recording(logits, *args):
            jax.debug.callback(lambda x: seen.append(np.asarray(x)), logits)
            return sample(logits, *args)

        generator._sample = recording  # read when the step is traced
        jax_fn = make_mixed_fn(generator, BUDGET, CHUNK, spec_width=WIDTH)
        step = mixed_module.make_mixed_step(
            VARIANTS[name], max_slots=SLOTS, t_budget=BUDGET, chunk=CHUNK,
            spec_width=WIDTH, device="cpu",
        )
        _STEPS[(name, weights)] = (jax_fn, seen, step)
    return _STEPS[(name, weights)]


@pytest.mark.parametrize("wave", list(WAVES))
@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_mixed_step_logits_match_jax(name, weights, wave, monkeypatch):
    jax_tree, port_tree = params(name, weights)
    config = VARIANTS[name]
    jax_fn, seen, step = _steps(name, weights)
    seed = sum(map(ord, name + wave))
    k, v, table = _cache(config, np.random.default_rng(seed))
    packed = _pack(WAVES[wave], np.random.default_rng(seed + 1), config.vocab_size)

    seen.clear()
    paged = JaxPagedKVCache(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                            page_table=jnp.asarray(table), lengths=jnp.zeros((SLOTS,), jnp.int32))
    new, toks, accept, latest, _ = jax_fn(
        jax_tree, paged, *[jnp.asarray(packed[n]) for n in ORDER], jax.random.PRNGKey(0),
        jnp.asarray(packed["temp"]), jnp.asarray(packed["top_p"]))
    jax.effects_barrier()
    want = {"k": np.asarray(new.k_pages), "v": np.asarray(new.v_pages),
            "toks": np.asarray(toks), "accept": np.asarray(accept),
            "latest": np.asarray(latest), "logits": seen[-1].reshape(SLOTS, WIDTH, -1)}

    logits = []
    real = mixed_module._logits
    monkeypatch.setattr(mixed_module, "_logits",
                        lambda *args: logits.append(real(*args)) or logits[-1])
    paged = PagedKVCache(k_pages=torch.from_numpy(k.copy()), v_pages=torch.from_numpy(v.copy()),
                         page_table=torch.from_numpy(table.copy()),
                         lengths=torch.zeros((SLOTS,), dtype=torch.int32))
    new, toks, accept, latest, _ = step(
        port_tree, paged, *[torch.from_numpy(packed[n].copy()) for n in ORDER],
        torch.Generator().manual_seed(0), torch.from_numpy(packed["temp"]),
        torch.from_numpy(packed["top_p"]))

    scheduled = packed["q_count"] > 0
    meaningful = scheduled[:, None] & (np.arange(WIDTH)[None] <= packed["spec_len"][:, None])
    assert (packed["kv_len"][scheduled] > WINDOW).all()
    np.testing.assert_allclose(logits[-1].numpy()[meaningful], want["logits"][meaningful],
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_array_equal(toks.numpy()[meaningful], want["toks"][meaningful])
    np.testing.assert_array_equal(accept.numpy(), want["accept"])
    np.testing.assert_array_equal(latest.numpy(), want["latest"])
    np.testing.assert_allclose(new.k_pages.numpy()[:, 1:], want["k"][:, 1:], rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(new.v_pages.numpy()[:, 1:], want["v"][:, 1:], rtol=0, atol=KV_ATOL)


def test_variants_carry_the_families_features():
    """The variants are what the docstring says, in both packages, and
    each registry's full-width families have the same features."""
    for configs, variants in ((jax_configs, JAX_VARIANTS), (port_configs, VARIANTS)):
        assert variants["window"].sliding_window == WINDOW
        assert variants["bias_g7"].q_per_kv == 7 and variants["bias_g7"].attention_bias
        tied = variants["tied_scaled_g3"]
        assert tied.q_per_kv == 3 and tied.tie_embeddings and tied.rope_scaling.factor == 32.0
        assert configs.get_config("mistral-7b").sliding_window == 4096
        assert configs.get_config("qwen2.5-7b").q_per_kv == 7
        assert configs.get_config("qwen2.5-1.5b").q_per_kv == 6
        assert configs.get_config("llama-3.2-3b").q_per_kv == 3
    port = {k: v for k, v in vars(VARIANTS["tied_scaled_g3"]).items() if k != "rope_scaling"}
    ref = {k: v for k, v in vars(JAX_VARIANTS["tied_scaled_g3"]).items() if k != "rope_scaling"}
    assert port == ref
    assert vars(VARIANTS["tied_scaled_g3"].rope_scaling) == vars(
        JAX_VARIANTS["tied_scaled_g3"].rope_scaling)


def test_provider_serves_past_the_references_context_when_asked():
    """``build_serving_engine`` keeps the reference's 2,048-position cap
    unless ``SERVING_MAX_SEQ`` names a longer context (up to the model's),
    read through ``OperatorConfig`` as the other serving settings: a
    2,100-token prompt is truncated to the cap by default and served whole
    at 4,096, where the window variant's mask runs past the cap; more than
    the model's context is refused."""
    from operator_tpu_torch.serving.provider import build_serving_engine

    port_configs.register_config(replace(VARIANTS["window"], name="tiny-window-4k",
                                         max_seq_len=4096))
    env = {"OPERATOR_TPU_MODEL": "tiny-window-4k", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "2", "KV_PAGE_SIZE": "64", "SERVING_DTYPE": "bf16"}
    prompt = ("x" * 50 + "\n") * 41 + "y" * 8  # 2,099 characters: 2,100 tokens
    sampling = SamplingParams(max_tokens=2, temperature=0.0)
    served = {}
    for max_seq in (None, 4096):
        setting = {} if max_seq is None else {"SERVING_MAX_SEQ": str(max_seq)}
        engine, _ = build_serving_engine("cpu", {**env, **setting})
        try:
            served[max_seq] = (engine.generator.max_seq,
                               engine.generate_batch([prompt], sampling)[0].prompt_tokens)
        finally:
            engine.close()
    assert served[4096] == (4096, len(prompt) + 1)
    assert served[None][0] == 2048 and served[None][1] < len(prompt) + 1
    with pytest.raises(ValueError, match="outside"):
        build_serving_engine("cpu", {**env, "SERVING_MAX_SEQ": "8192"})


# ---------------------------------------------------------------------------
# the wave engine (decode kernel K2/K3, flash prefill K4 on the card)
# ---------------------------------------------------------------------------


def _wave_drive(generator, sampling):
    """``admit`` + ``step`` on either package's wave generator (the calls
    ``tests/test_torch_wave.py`` drives): the greedy ids per prompt."""
    slots = generator.admit(list(PROMPTS), [sampling] * len(PROMPTS))
    assert len(slots) == len(PROMPTS)
    owner = dict(zip(slots, range(len(PROMPTS))))
    results = {}
    for _ in range(200):
        for slot, result in generator.step():
            results[owner[slot]] = result.token_ids
        if len(results) == len(PROMPTS):
            return [results[i] for i in range(len(PROMPTS))]
    raise AssertionError(f"not every request finished: {sorted(results)}")


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("weights", ["float32", "int8"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_wave_engine_matches_jax(name, weights, flash, monkeypatch):
    """The three long prompts in one prefill wave, then decode blocks of
    4 at depth 2, on the wave engine of each package: greedy ids equal,
    with the prefill dense and through flash prefill (read at each
    prefill, as JAX reads it at trace time)."""
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", "1" if flash else "0")
    shape = dict(max_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE, decode_block=4,
                 pipeline_depth=2)
    jax_tree, port_tree = params(name, weights)
    want = _wave_drive(
        BatchedGenerator(jax_tree, JAX_VARIANTS[name], JaxByteTokenizer(), paged=True,
                         cache_dtype=jnp.float32, metrics=MetricsRegistry(), **shape),
        JaxSamplingParams(max_tokens=MAX_TOKENS, temperature=0.0))
    generator = Generator(port_tree, VARIANTS[name], ByteTokenizer(), cache_dtype=torch.float32,
                          device="cpu", **shape)
    got = _wave_drive(generator, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0))
    assert got == want
    assert len(generator.free_slots()) == generator.max_slots
