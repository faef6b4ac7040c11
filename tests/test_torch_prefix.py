"""The port's registered shared prefixes against the JAX package's.

Every non-mesh case of ``tests/test_prefix_cache.py``, each run on the
port's wave ``Generator`` and the JAX ``BatchedGenerator(paged=True)``
with the same calls, on ``TINY_TEST`` f32 weights from ``PRNGKey(0)``
carried across by ``params_from_jax``: greedy token ids byte for byte,
the same registry, page accounting, counters and shared lengths.  The
prefix mesh case waits for multi-device serving (ROADMAP Queue 1 item
11).  Beyond the JAX file: the prefix pages are read-only (their bytes
before and after prefixed and plain waves), the built prefix KV equals
JAX's within the f32 tolerance, the warmup grid's prefixed keys are the
JAX grid's, and the provider primes the default template's preamble in
wave mode and registers a custom ``promptTemplate``'s once.
"""

import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.serving import provider as jax_provider  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.schema.analysis import (  # noqa: E402
    AIProviderConfig,
    AnalysisRequest,
    PodFailureData,
)
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.prompts import DEFAULT_TEMPLATE, template_preamble  # noqa: E402
from operator_tpu_torch.serving.provider import (  # noqa: E402
    build_serving_engine,
    build_tpu_native_provider,
)
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402

PREFIX = (
    "You are a Kubernetes failure analyst. Explain the failure using the "
    "pattern evidence and log excerpts provided below; answer with Root "
    "Cause and Fix sections. "
)
PREFIX_B = (
    "Summarise this incident for an executive audience in plain words, "
    "avoiding jargon, then list remediation steps in order of priority. "
)
GREEDY = dict(max_tokens=6, temperature=0.0, stop_on_eos=False)
#: f32 KV of the two packages' prefix builds: the same products, other orders
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _generator(params, **kw):
    return Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=4,
        max_seq=kw.pop("max_seq", 512), cache_dtype=torch.float32, page_size=16,
        decode_block=2, device="cpu", **kw,
    )


def _jax_generator(jax_params, **kw):
    return BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), max_slots=4,
        max_seq=kw.pop("max_seq", 512), cache_dtype=jnp.float32, paged=True,
        page_size=16, decode_block=2, **kw,
    )


def _sampling(generator, **kw):
    cls = SamplingParams if isinstance(generator, Generator) else JaxSamplingParams
    return cls(**kw)


def _drain(generator, prompts, sampling=None):
    sampling = sampling or _sampling(generator, **GREEDY)
    slots = generator.admit(prompts, [sampling] * len(prompts))
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s].token_ids for s in slots]


@pytest.fixture
def both(params, jax_params):
    """A factory of (port, JAX) generator pairs of one shape."""
    return lambda **kw: (_generator(params, **dict(kw)), _jax_generator(jax_params, **dict(kw)))


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py, case by case against the JAX generator
# ---------------------------------------------------------------------------


def test_set_prefix_accounting(both):
    for generator in both():
        before = generator.allocator.available
        cached = generator.set_shared_prefix(PREFIX)
        assert cached > 0 and cached % generator.page_size == 0
        held = cached // generator.page_size
        assert generator.allocator.available == before - held
        assert len(generator._prefix_pages) == held
        # re-setting releases the old pages first (no leak)
        generator.set_shared_prefix(PREFIX + "extra tail of instructions here")
        assert generator.allocator.available <= before - held
    port, ref = both()
    assert port.set_shared_prefix(PREFIX) == ref.set_shared_prefix(PREFIX)
    assert port._prefix_tokens == ref._prefix_tokens
    assert port.allocator.available == ref.allocator.available


def test_too_short_prefix_is_not_cached(both):
    for generator in both():
        assert generator.set_shared_prefix("tiny") == 0
        assert generator._prefix_pages == []


def test_greedy_parity_with_uncached(both, params):
    prompts = [
        PREFIX + "Pod web-1 exit 137 oom",
        PREFIX + "Pod db-0 crashloop backoff restarts 12",
        PREFIX + "Pod api-2 liveness probe failed on 8080",
    ]
    port, ref = both()
    assert port.set_shared_prefix(PREFIX) == ref.set_shared_prefix(PREFIX) > 0
    cached = _drain(port, prompts)
    assert cached == _drain(ref, prompts)
    assert cached == _drain(_generator(params), prompts)


def test_pages_balance_and_prefix_survives_teardown(both, params):
    port, ref = both()
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
    held = len(port._prefix_pages)
    free_before = port.allocator.available
    assert _drain(port, [PREFIX + "alpha", PREFIX + "beta"]) == _drain(
        ref, [PREFIX + "alpha", PREFIX + "beta"]
    )
    # every wave page came back; the prefix pages are still held
    assert port.allocator.available == free_before == ref.allocator.available
    assert len(port._prefix_pages) == held
    again = _drain(port, [PREFIX + "alpha"])
    assert again == _drain(ref, [PREFIX + "alpha"])
    assert again == _drain(_generator(params), [PREFIX + "alpha"])


def test_mixed_wave_falls_back(both):
    prompts = [PREFIX + "matching prompt", "completely different prompt"]
    port, ref = both()
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
    assert _drain(port, prompts) == _drain(ref, prompts)
    assert port.metrics.counter("prefill_waves_prefix") == 0


def test_interaction_with_guided_and_sampling(params):
    generator = _generator(params)
    generator.set_shared_prefix(PREFIX)
    [a, b] = generator.admit(
        [PREFIX + "severity?", PREFIX + "free text"],
        [SamplingParams(max_tokens=16, temperature=0.9, guided_choice=("CRITICAL", "LOW")),
         SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)],
    )
    assert generator.metrics.counter("prefill_waves_prefix") == 1
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    assert results[a].text in ("CRITICAL", "LOW")
    assert len(results[b].token_ids) == 8


def test_guided_prefixed_wave_matches_jax_greedy(both):
    """A guided row and a free row on the shared prefix, both greedy: the
    guided program masks the first token from the start state, and both
    rows' tokens are the JAX generator's."""
    prompts = [PREFIX + "severity?", PREFIX + "free text"]
    got = []
    for generator in both():
        generator.set_shared_prefix(PREFIX)
        slots = generator.admit(prompts, [
            _sampling(generator, max_tokens=12, temperature=0.0,
                      guided_choice=("CRITICAL", "LOW")),
            _sampling(generator, **GREEDY),
        ])
        results = {}
        while generator.num_active:
            for slot_id, result in generator.step():
                results[slot_id] = result
        got.append([results[s].token_ids for s in slots])
    assert got[0] == got[1]
    assert ByteTokenizer().decode(got[0][0]) in ("CRITICAL", "LOW")


def test_truncation_preserves_prefix_and_tail(both):
    """Over-budget prompts drop their MIDDLE when they start with the
    cached prefix; the truncated wave takes the PLAIN program (all or
    nothing), an untruncated one the prefixed program."""
    port, ref = both(max_seq=256)
    evidence = "the unique evidence marker at the very end"
    long_prompt = PREFIX + ("middle filler " * 100) + evidence
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
    ids = port.tokenizer.encode(long_prompt)
    budget = 200
    truncated = port._truncate_prompt(list(ids), budget)
    assert truncated == ref._truncate_prompt(list(ids), budget)
    assert len(truncated) == budget
    head = next(
        i for i, (a, b) in enumerate(zip(truncated, port._prefix_tokens + [None] * budget))
        if a != b
    )
    assert head > 0 and head % port.page_size == 0 and head <= budget // 2
    assert truncated[:head] == port._prefix_tokens[:head]
    assert evidence in port.tokenizer.decode(truncated[-len(evidence):])
    assert port._wave_shared_prefix([truncated], [SamplingParams()]) == 0
    outs = []
    for generator in (port, ref):
        outs.append(_drain(generator, [long_prompt], _sampling(
            generator, max_tokens=8, temperature=0.0, stop_on_eos=False)))
        assert not generator._prefix_fns and generator._prefill_fns
        outs.append(_drain(generator, [PREFIX + "short suffix"], _sampling(
            generator, max_tokens=8, temperature=0.0, stop_on_eos=False)))
        assert generator._prefix_fns
    assert outs[:2] == outs[2:]
    assert set(port._prefix_fns) == set(ref._prefix_fns)
    assert port._prefill_fns == set(ref._prefill_fns)
    # without a cached prefix: plain tail-only truncation (head == 0)
    plain = _generator(port.params, max_seq=256)
    assert plain._truncate_prompt(list(ids), budget) == ids[-budget:]


def test_lora_wave_never_shares(both):
    for generator in both():
        generator.set_shared_prefix(PREFIX)
        toks = [generator.tokenizer.encode(PREFIX + "suffix")]
        assert generator._wave_shared_prefix(toks, [_sampling(generator)]) > 0
        assert generator._wave_shared_prefix(
            toks, [_sampling(generator, adapter="some-adapter")]
        ) == 0


def test_empty_token_list_never_shares(both):
    for generator in both():
        generator.set_shared_prefix(PREFIX)
        good = generator.tokenizer.encode(PREFIX + "suffix")
        s = _sampling(generator)
        assert generator._wave_shared_prefix([good, []], [s, s]) == 0
        assert generator._wave_shared_prefix([[]], [s]) == 0


def test_set_prefix_refuses_while_active(both):
    for generator in both():
        generator.admit([PREFIX + "busy"], [_sampling(
            generator, max_tokens=8, temperature=0.0, stop_on_eos=False)])
        with pytest.raises(RuntimeError, match="idle"):
            generator.set_shared_prefix(PREFIX)
        while generator.num_active:
            generator.step()
        assert generator.set_shared_prefix(PREFIX) > 0


def test_reset_reprimes_prefix(both, params):
    port, ref = both()
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
        tokens_before = list(generator._prefix_tokens)
        generator.reset()
        assert generator._prefix_tokens == tokens_before
    again = _drain(port, [PREFIX + "after reset"])
    assert again == _drain(ref, [PREFIX + "after reset"])
    assert again == _drain(_generator(params), [PREFIX + "after reset"])


def test_two_prefixes_each_get_exact_reuse(both, params):
    port, ref = both()
    plain = _generator(params)
    for generator in (port, ref):
        assert generator.add_shared_prefix(PREFIX) > 0
        assert generator.add_shared_prefix(PREFIX_B) > 0
        assert len(generator._prefixes) == 2
    for pre in (PREFIX, PREFIX_B):
        prompts = [pre + "pod oomkilled", pre + "disk pressure on node"]
        toks = [port.tokenizer.encode(p) for p in prompts]
        shared, pages = port._wave_prefix_match(toks, [SamplingParams(**GREEDY)] * 2)
        assert shared > 0 and pages, pre
        assert shared == ref._wave_prefix_match(toks, [JaxSamplingParams(**GREEDY)] * 2)[0]
        got = _drain(port, prompts)
        assert got == _drain(ref, prompts) == _drain(plain, prompts)


def test_mixed_template_wave_takes_plain_path(both, params):
    prompts = [PREFIX + "suffix one", PREFIX_B + "suffix two"]
    port, ref = both()
    for generator in (port, ref):
        generator.add_shared_prefix(PREFIX)
        generator.add_shared_prefix(PREFIX_B)
        toks = [generator.tokenizer.encode(p) for p in prompts]
        assert generator._wave_shared_prefix(toks, [_sampling(generator, **GREEDY)] * 2) == 0
    got = _drain(port, prompts)
    assert got == _drain(ref, prompts) == _drain(_generator(params), prompts)


def test_longest_matching_prefix_wins(both):
    longer = PREFIX + "Always cite the exact log line as evidence. "
    for generator in both():
        assert generator.add_shared_prefix(PREFIX) > 0
        n_long = generator.add_shared_prefix(longer)
        assert n_long > 0
        toks = [generator.tokenizer.encode(longer + "pod crashed hard")]
        shared, pages = generator._wave_prefix_match(toks, [_sampling(generator, **GREEDY)])
        assert shared == n_long, (shared, n_long)
        assert len(pages) == n_long // generator.page_size


def test_add_prefix_idempotent_and_capped(both):
    counts = []
    for generator in both():
        first = generator.add_shared_prefix(PREFIX)
        held = generator.prefix_held_pages
        assert generator.add_shared_prefix(PREFIX) == first  # no duplicate
        assert generator.prefix_held_pages == held
        for i in range(generator.MAX_SHARED_PREFIXES + 2):
            generator.add_shared_prefix(f"registry filler template number {i}: " + "pad " * 30)
        assert len(generator._prefixes) <= generator.MAX_SHARED_PREFIXES
        counts.append((len(generator._prefixes), generator.prefix_held_pages))
        generator.clear_shared_prefixes()
        assert generator.prefix_held_pages == 0
        assert generator.allocator.available == generator.allocator.num_pages - 1
    assert counts[0] == counts[1]


def test_reset_reprimes_all_registered_prefixes(both, params):
    port, ref = both()
    for generator in (port, ref):
        generator.add_shared_prefix(PREFIX)
        generator.add_shared_prefix(PREFIX_B)
        held = generator.prefix_held_pages
        generator.reset()
        assert len(generator._prefixes) == 2
        assert generator.prefix_held_pages == held
        toks = [generator.tokenizer.encode(PREFIX_B + "after recovery")]
        assert generator._wave_shared_prefix(toks, [_sampling(generator, **GREEDY)]) > 0
    prompts = [PREFIX_B + "after recovery"]
    got = _drain(port, prompts)
    assert got == _drain(ref, prompts) == _drain(_generator(params), prompts)


def test_wave_path_counters(params, jax_params):
    counters = []
    for generator in (_generator(params, metrics=MetricsRegistry()),
                      _jax_generator(jax_params, metrics=JaxMetricsRegistry())):
        generator.add_shared_prefix(PREFIX)
        _drain(generator, [PREFIX + "fast path"])
        _drain(generator, ["something else entirely"])
        snapshot = generator.metrics.snapshot()["counters"]
        counters.append((snapshot.get("prefill_waves_prefix", 0),
                         snapshot.get("prefill_waves_plain", 0)))
    assert counters[0] == counters[1] == (1, 1)


# ---------------------------------------------------------------------------
# beyond the JAX file
# ---------------------------------------------------------------------------


def test_prefix_pages_are_read_only(params):
    """The suffix scatter starts at the shared length: the prefix pages'
    bytes are the same before and after prefixed waves (greedy and
    sampled, padded rows included) and a plain wave."""
    generator = _generator(params)
    generator.set_shared_prefix(PREFIX)
    pages = torch.tensor(generator._prefix_pages)
    paged = generator.paged_cache
    before = (paged.k_pages[:, pages].clone(), paged.v_pages[:, pages].clone())
    _drain(generator, [PREFIX + "one", PREFIX + "two, a longer suffix", PREFIX + "three"])
    _drain(generator, [PREFIX + "sampled"], SamplingParams(max_tokens=5, temperature=0.8))
    _drain(generator, ["a plain wave"])
    assert generator.metrics.counter("prefill_waves_prefix") == 2
    paged = generator.paged_cache
    assert torch.equal(paged.k_pages[:, pages], before[0])
    assert torch.equal(paged.v_pages[:, pages], before[1])


def test_prefix_build_equals_the_jax_pages(both):
    """The built prefix KV in its pages is the JAX build's, within the f32
    tolerance."""
    port, ref = both()
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
    assert port._prefix_pages == ref._prefix_pages
    pages = np.asarray(port._prefix_pages)
    for name in ("k_pages", "v_pages"):
        got = getattr(port.paged_cache, name)[:, pages].numpy()
        want = np.asarray(getattr(ref.paged_cache, name))[:, pages]
        np.testing.assert_allclose(got, want, atol=KV_TOL, rtol=0)


@pytest.mark.parametrize("level", ["serving", "full"])
def test_grid_keys_with_a_prefix_match_the_jax_generator(both, level):
    """With a registered prefix the grid captures the JAX grid's prefixed
    keys beside its plain ones, and counts the same programs."""
    port, ref = both(max_seq=256)
    for generator in (port, ref):
        generator.set_shared_prefix(PREFIX)
    want = ref.precompile_grid(level)
    got = port.precompile_grid(level)
    assert got["programs"] == want["programs"]
    assert set(port._prefix_fns) == set(ref._prefix_fns)
    assert port._prefix_fns
    assert port._prefill_fns == set(ref._prefill_fns)
    # the grid leaves only the prefix's pages held
    assert port.allocator.available == port.allocator.num_pages - 1 - port.prefix_held_pages


TINY_ENV = {
    "OPERATOR_TPU_MODEL": "tiny-test",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "MAX_BATCH_SIZE": "4",
    "KV_PAGE_SIZE": "16",
}


@pytest.mark.parametrize("mode,prefix_cache", [
    ("wave", None), ("wave", "false"), ("continuous", None),
])
def test_provider_primes_the_default_preamble_as_the_jax_provider(mode, prefix_cache,
                                                                  monkeypatch):
    """``build_serving_engine`` primes the default template's static
    preamble in wave mode with ``PREFIX_CACHE`` on, as the JAX provider
    does: the same tokens and pages held; continuous mode and
    ``PREFIX_CACHE=false`` prime nothing."""
    env = {**TINY_ENV, "SCHED_MODE": mode}
    if prefix_cache is not None:
        env["PREFIX_CACHE"] = prefix_cache
    engine, _ = build_serving_engine("cpu", env)
    try:
        g = engine.generator
        got = ([e["tokens"] for e in g._prefixes], g.prefix_held_pages)
        assert engine._audit_leaks() == {}
    finally:
        engine.close()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref, _ = jax_provider.build_serving_engine(JaxOperatorConfig.from_env(env))
    want = ([e["tokens"] for e in ref.generator._prefixes], ref.generator.prefix_held_pages)
    assert got == want
    primed = mode == "wave" and prefix_cache is None
    assert bool(got[1]) == primed
    if primed:
        preamble = ByteTokenizer().encode(template_preamble(DEFAULT_TEMPLATE))
        assert got[0][0] == preamble[: len(got[0][0])]


CUSTOM_TEMPLATE = (
    "You are the on-call bot of the payments team. Answer in one line with "
    "the cause.\nPod {pod_name}: {log_tail}\nCause:"
)


def _request(pod_log: str) -> AnalysisRequest:
    return AnalysisRequest(
        failure_data=PodFailureData(logs=pod_log),
        provider_config=AIProviderConfig(
            prompt_template=CUSTOM_TEMPLATE, max_tokens=4, temperature=0.0,
        ),
    )


def test_provider_registers_a_custom_template_once(jax_params):
    """A custom ``promptTemplate``'s preamble is registered once through
    ``engine.add_prefix`` (on the worker) and the next request's wave
    shares it; the registry's tokens are what the JAX generator
    registers for the same preamble."""
    provider = build_tpu_native_provider("cpu", {**TINY_ENV, "SCHED_MODE": "wave",
                                                 "PREFIX_CACHE": "true"})
    engine = provider.engine
    g = engine.generator
    try:
        primed = len(g._prefixes)
        calls = []
        add_prefix = engine.add_prefix

        async def counted(text):
            calls.append(text)
            return await add_prefix(text)

        engine.add_prefix = counted

        async def drive():
            first = await provider.generate(_request("OOMKilled exit 137"))
            second = await provider.generate(_request("liveness probe failed"))
            return first, second

        first, second = asyncio.run(drive())
        assert first.error is None and second.error is None, (first, second)
        assert calls == [template_preamble(CUSTOM_TEMPLATE)]
        assert len(g._prefixes) == primed + 1
        assert g.metrics.counter("prefill_waves_prefix") == 2
        custom = g._prefixes[-1]["tokens"]
    finally:
        engine.close()
    ref = _jax_generator(jax_params, max_seq=256)
    ref.add_shared_prefix(template_preamble(CUSTOM_TEMPLATE))
    assert custom == ref._prefix_tokens
