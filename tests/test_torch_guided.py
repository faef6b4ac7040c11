"""The port's guided decoding against the JAX package's.

The automaton builders (``serving/guided.py``, ``serving/regex_dfa.py``)
are numpy copies: their transition tables must be ``np.array_equal`` to
the JAX package's on ``ByteTokenizer`` and on the builtin BPE, and they
must refuse what the JAX builders refuse, with the same words (the
port's ``HFTokenizer`` included, as the JAX package refuses its
transformers-backed one).  The byte DFA agrees with Python's ``re`` on
seeded strings.

Through the wave engine (``TINY_TEST``, f32, the JAX weights bridged
through numpy): a guided request's output is always in its language,
greedy or sampled (sampled streams are held as distributions only:
every sample is a choice or matches); an unguided neighbour is
unperturbed; a recycled slot loses its guided occupant's state; and the
greedy tokens of a batch mixing base, two LoRA adapters, a guided
choice and a guided regex are byte for byte the JAX
``BatchedGenerator``'s.  Bad specs fail their own request at submit and
over the HTTP front (400), never the co-batched wave.
"""

import asyncio
import contextlib
import json
import os
import re
import secrets
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
from operator_tpu.models.bpe import BPETokenizer as JaxBPETokenizer  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.parallel import init_lora as jax_init_lora  # noqa: E402
from operator_tpu.serving import guided as jax_guided  # noqa: E402
from operator_tpu.serving import regex_dfa as jax_regex_dfa  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.models.bpe import BPETokenizer  # noqa: E402
from operator_tpu_torch.models.tokenizer import HFTokenizer  # noqa: E402
from operator_tpu_torch.serving import guided, regex_dfa  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

CHOICES = ("CRITICAL", "HIGH", "MEDIUM", "LOW")
TOKENIZERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tokenizers")


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _tokenizers(kind):
    if kind == "byte":
        return ByteTokenizer(), JaxByteTokenizer()
    return BPETokenizer.load_builtin(), JaxBPETokenizer.load_builtin()


def _generator(params, **kw):
    return Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128,
        cache_dtype=torch.float32, page_size=16, decode_block=2, device="cpu", **kw,
    )


def _run(generator, prompts, sampling):
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s] for s in slots]


# ---------------------------------------------------------------------------
# the automaton tables against the JAX builders
# ---------------------------------------------------------------------------

CHOICE_SETS = [
    ("ab", "ac"),
    CHOICES,
    ("CrashLoopBackOff", "OOMKilled", "ImagePullBackOff", "Error"),
    ("yes", "no", "maybe so", "ünïcode"),
]


@pytest.mark.parametrize("kind", ["byte", "bpe"])
@pytest.mark.parametrize("choices", CHOICE_SETS, ids=lambda c: "-".join(c)[:24])
def test_choice_tables_equal_jax(kind, choices):
    tok, jax_tok = _tokenizers(kind)
    got = guided.build_choice_automaton(choices, tok, tok.vocab_size)
    want = jax_guided.build_choice_automaton(choices, jax_tok, jax_tok.vocab_size)
    assert got.num_states == want.num_states and got.choices == want.choices
    assert np.array_equal(got.transition, want.transition)


REGEXES = [
    r"(CRITICAL|HIGH|LOW)",
    r"exit code [0-9]{1,3}",
    r"\d{1,3} errors?",
    r"pod-\w+(\.\d+)?",
    r"[a-f0-9]{4}",
    r'\{"reason":"(OOMKilled|Error)","confidence":(0|-?[1-9][0-9]*)\}',
]


@pytest.mark.parametrize("kind", ["byte", "bpe"])
@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_tables_equal_jax(kind, pattern):
    tok, jax_tok = _tokenizers(kind)
    got = regex_dfa.compile_regex_automaton(
        pattern, tok, tok.vocab_size, max_states=1 << 14
    )
    want = jax_regex_dfa.compile_regex_automaton(
        pattern, jax_tok, jax_tok.vocab_size, max_states=1 << 14
    )
    assert got.num_states == want.num_states and got.choices == want.choices
    assert np.array_equal(got.transition, want.transition)
    # no reachable state leaves the sampler an all -inf row: pruning keeps
    # every state the start reaches with at least one allowed token
    reachable, frontier = {0}, [0]
    while frontier:
        row = got.transition[frontier.pop()]
        for nxt in set(row[row >= 0].tolist()) - reachable:
            reachable.add(nxt)
            frontier.append(nxt)
    assert all((got.transition[s] >= 0).any() for s in reachable)


def test_stack_and_identity_equal_jax():
    tok = ByteTokenizer()
    automata = [guided.identity_automaton(tok.vocab_size),
                guided.build_choice_automaton(CHOICES, tok, tok.vocab_size)]
    jax_automata = [jax_guided.identity_automaton(tok.vocab_size),
                    jax_guided.build_choice_automaton(CHOICES, JaxByteTokenizer(),
                                                      tok.vocab_size)]
    got = guided.stack_automata(automata, tok.vocab_size, state_pad=32)
    want = jax_guided.stack_automata(jax_automata, tok.vocab_size, state_pad=32)
    assert got.shape == (2, 32, tok.vocab_size) and np.array_equal(got, want)
    assert (automata[0].transition == 0).all()


class _NoEos(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_id = None


class _JaxNoEos(JaxByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_id = None


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("case", ["empty", "tokenizes_to_nothing", "no_eos", "table_cap"])
def test_choice_refusals_equal_jax(case):
    byte, jax_byte = ByteTokenizer(), JaxByteTokenizer()
    args = {
        "empty": ((), byte, jax_byte, byte.vocab_size),
        "tokenizes_to_nothing": (("",), byte, jax_byte, byte.vocab_size),
        "no_eos": (("x",), _NoEos(), _JaxNoEos(), 259),
        "table_cap": (("x" * 200,), byte, jax_byte, 200_000),
    }[case]
    choices, tok, jax_tok, vocab = args
    got = _message(guided.build_choice_automaton, choices, tok, vocab)
    assert got == _message(jax_guided.build_choice_automaton, choices, jax_tok, vocab)
    assert {"empty": "at least one", "tokenizes_to_nothing": "tokenizes to nothing",
            "no_eos": "eos", "table_cap": "16M cap"}[case] in got


BAD_PATTERNS = [
    r"(?i)x", r"a{1,999}", r"a{", r"[z-a]", r"(", r"*a",  # unsupported syntax
    r"a^b", r"a$b",  # interior anchors
    r"a+?", r"a*?", r"a??", r"a+*", r"a{2}?",  # lazy / stacked quantifiers
    r"\bword", r"\x41", r"\A", r"\u0041",  # alphanumeric escapes
]


@pytest.mark.parametrize("pattern", BAD_PATTERNS)
def test_regex_refusals_equal_jax(pattern):
    got = _message(regex_dfa._compile_byte_dfa, pattern, 4096)
    assert got == _message(jax_regex_dfa._compile_byte_dfa, pattern, 4096)


def test_unrealisable_pattern_and_state_cap_refused_as_jax():
    tok, jax_tok = ByteTokenizer(), JaxByteTokenizer()
    # a vocab cut below the bytes 'x'..'z' need: no token can emit them
    vocab = tok.SPECIALS + ord("x")
    got = _message(regex_dfa.compile_regex_automaton, r"[x-z]+", tok, vocab, max_states=1024)
    assert "cannot be realised" in got
    assert got == _message(
        jax_regex_dfa.compile_regex_automaton, r"[x-z]+", jax_tok, vocab, max_states=1024
    )
    got = _message(regex_dfa.compile_regex_automaton, r"[a-z]{20}", tok, 259, max_states=8)
    assert "DFA states" in got
    assert got == _message(
        jax_regex_dfa.compile_regex_automaton, r"[a-z]{20}", jax_tok, 259, max_states=8
    )


def test_hf_tokenizer_is_refused_for_regex_and_served_for_choices():
    """The JAX package refuses ``guided_regex`` for its transformers-backed
    tokenizer; the port refuses it for its in-tree ``HFTokenizer`` with
    the same words.  ``guided_choice`` works with any tokenizer."""
    tok = HFTokenizer(os.path.join(TOKENIZERS, "llama_sp"))
    got = _message(regex_dfa.compile_regex_automaton, r"(yes|no)", tok,
                   tok.vocab_size, max_states=1024)
    assert got == _message(jax_regex_dfa.token_byte_table, object(), 8)
    automaton = guided.build_choice_automaton(("yes", "no"), tok, tok.vocab_size)
    assert automaton.transition[0, tok.encode("yes", add_bos=False)[0]] > 0


RE_CASES = {
    r"(CRITICAL|HIGH|LOW)": ["CRITICAL", "HIGH", "LOW", "MEDIUM", "HI"],
    r"\d{1,3} errors?": ["7 errors", "42 error", "999 errors", "errors", "1234 errors"],
    r"[a-f0-9]{4}": ["beef", "00ff", "beefy", "xyzw", "abc"],
    r"pod-\w+(\.\d+)?": ["pod-a", "pod-x7.12", "pod-", "pod-a."],
    r"a+b*c?": ["a", "aabbc", "b", "aaac", "abcc"],
    r"^(yes|no)$": ["yes", "no", "^yes$", "yesno"],
    r"\.\[": [".[", "a[", "."],
}


def _dfa_fullmatch(transition, accepting, text):
    state = 0
    for byte in text.encode():
        state = transition[state, byte] if state >= 0 else -1
        if state < 0:
            return False
    return bool(accepting[state])


@pytest.mark.parametrize("pattern", sorted(RE_CASES))
def test_byte_dfa_agrees_with_python_re_and_jax(pattern):
    transition, accepting = regex_dfa._compile_byte_dfa(pattern, 4096)
    jax_transition, jax_accepting = jax_regex_dfa._compile_byte_dfa(pattern, 4096)
    assert np.array_equal(transition, jax_transition)
    assert np.array_equal(accepting, jax_accepting)
    # seeded random subjects over the pattern's alphabet, plus the cases
    rng = np.random.default_rng(7)
    alphabet = list("abcdefxyzCRITHGLOWpod-.[7 0129ers^$")
    subjects = list(RE_CASES[pattern]) + [
        "".join(rng.choice(alphabet, size=rng.integers(0, 9))) for _ in range(300)
    ]
    bare = pattern.strip("^$")
    for subject in subjects:
        want = re.fullmatch(bare, subject) is not None
        assert _dfa_fullmatch(transition, accepting, subject) == want, (pattern, subject)


# ---------------------------------------------------------------------------
# the wave engine
# ---------------------------------------------------------------------------


def test_cache_eviction_spares_protected_specs(params):
    generator = _generator(params)
    specs = [("choice", (f"spec-{i:02d}",)) for i in range(40)]
    generator._guided_protect = frozenset(specs)
    for spec in specs:
        generator._ensure_automaton(spec)
    assert all(spec in generator._guided_cache for spec in specs)
    generator._guided_protect = frozenset()
    for i in range(40, 120):
        generator._ensure_automaton(("choice", (f"spec-{i}",)))
    assert len(generator._guided_cache) <= 32


def test_oversized_choice_set_rejected_at_submit(params):
    generator = _generator(params)
    huge = tuple(secrets.token_hex(64) for _ in range(256))  # ~32k states
    with pytest.raises(ValueError, match="cap"):
        generator._ensure_automaton(("choice", huge))


@pytest.mark.parametrize("temperature", [0.0, 1.3])
def test_output_is_always_a_choice(params, temperature):
    generator = _generator(params)
    sampling = SamplingParams(max_tokens=16, temperature=temperature, guided_choice=CHOICES)
    for prompt in ("severity?", "what level", "classify: oom"):
        [result] = _run(generator, [prompt], [sampling])
        assert result.text in CHOICES, result.text
        assert result.finish_reason == "stop"


@pytest.mark.parametrize("pattern", [r"(yes|no)", r"\d{2,4} errors", r"sev-[A-Z]+"])
def test_regex_output_matches_pattern(params, pattern):
    generator = _generator(params)
    for temperature in (0.0, 1.2):
        [result] = _run(generator, ["classify"], [SamplingParams(
            max_tokens=24, temperature=temperature, guided_regex=pattern)])
        assert re.fullmatch(pattern, result.text), (pattern, result.text)


def test_sampled_streams_stay_in_their_languages(params):
    """Sampled guided streams agree with JAX only in distribution: every
    sample of a mixed batch is a choice or matches its regex."""
    generator = _generator(params)
    for seed in range(3):
        generator._rng.manual_seed(seed)
        regex, choice = _run(generator, ["a", "b"], [
            SamplingParams(max_tokens=20, temperature=1.0, guided_regex=r"[0-9]{3}ms"),
            SamplingParams(max_tokens=20, temperature=1.0, guided_choice=("on", "off")),
        ])
        assert re.fullmatch(r"[0-9]{3}ms", regex.text)
        assert choice.text in ("on", "off")


def test_guided_and_free_requests_share_a_batch(params):
    free = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
    [solo] = _run(_generator(params), ["free prompt"], [free])
    mixed, chosen = _run(_generator(params), ["free prompt", "severity?"], [
        free, SamplingParams(max_tokens=16, temperature=0.0, guided_choice=CHOICES)])
    assert mixed.token_ids == solo.token_ids
    assert chosen.text in CHOICES


def test_multiple_choice_sets_then_the_unguided_block(params):
    generator = _generator(params)
    sets = (("yes", "no"), ("alpha", "beta", "gamma"), CHOICES)
    results = _run(generator, ["a", "b", "c"], [
        SamplingParams(max_tokens=16, temperature=0.9, guided_choice=s) for s in sets])
    for result, allowed in zip(results, sets):
        assert result.text in allowed
    # back to the unguided block once every guided slot finished
    assert generator._guided_tables is None and generator.guided_state is None


def test_slot_recycling_between_guided_waves(params):
    generator = _generator(params)
    for spec in (("red", "green"), ("up", "down"), ("red", "green")):
        [result] = _run(generator, ["pick"], [
            SamplingParams(max_tokens=8, temperature=1.1, guided_choice=spec)])
        assert result.text in spec


def test_recycled_slot_after_guided_is_unconstrained(params):
    """The stale-state hazard: a guided request finishes in a slot with a
    nonzero DFA state while another guided request keeps the tables
    stacked; an unguided request then takes the slot.  It must decode
    unconstrained (the identity binding resets the slot) and equal its
    solo greedy tokens; the freed slot's row never faces an all -inf
    mask (``torch.multinomial`` would raise on it)."""
    free = SamplingParams(max_tokens=8, temperature=0.0, stop_on_eos=False)
    [solo] = _run(_generator(params), ["free prompt"], [free])
    generator = _generator(params)
    short, long_ = generator.admit(["severity?", "keep going"], [
        SamplingParams(max_tokens=16, temperature=0.7, guided_choice=("ok",)),
        SamplingParams(max_tokens=40, temperature=0.7, guided_regex=r"[a-z]{30}"),
    ])
    results = {}
    while short not in results:
        for slot_id, result in generator.step():
            results[slot_id] = result
    assert results[short].text == "ok" and generator._guided_tables is not None
    [recycled] = generator.admit(["free prompt"], [free])
    assert recycled == short
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    assert results[recycled].token_ids == solo.token_ids
    assert re.fullmatch(r"[a-z]{30}", results[long_].text)


def test_device_state_equals_a_host_replay(params):
    """The DFA state is carried through each block on the device and read
    back with nothing: after every block it equals a host replay of the
    slot's tokens through the transition table, and no step leaves the
    automaton (the EOS self-loop holds it once the match is complete)."""
    generator = _generator(params, pipeline_depth=1)
    pattern = r"[a-z]{12}"
    table = regex_dfa.compile_regex_automaton(
        pattern, ByteTokenizer(), TINY_TEST.vocab_size, max_states=1 << 14
    ).transition
    [slot] = generator.admit(["x"], [SamplingParams(
        max_tokens=64, temperature=1.0, stop_on_eos=False, guided_regex=pattern)])
    for _ in range(8):
        generator.step()
        state = 0
        for token in generator.slots[slot].generated:
            state = table[state, token]
            assert state >= 0
        assert int(generator.guided_state[slot]) == state


# ---------------------------------------------------------------------------
# the mixed batch against the JAX engine
# ---------------------------------------------------------------------------


def _jax_adapter(seed):
    """Rank-4 adapter with NONZERO b (init_lora zeros b)."""
    base = jax_init_lora(JAX_TINY_TEST, jax.random.PRNGKey(seed), rank=4, dtype=jnp.float32)
    return {
        name: {"a": f["a"], "b": jax.random.normal(
            jax.random.PRNGKey(seed + 100), f["b"].shape, jnp.float32) * 0.2}
        for name, f in base.items()
    }


MIXED_PROMPTS = ["oom killed", "crash loop", "disk is full", "severity?", "count them"]
MIXED_KW = [
    {},
    {"adapter": "incident"},
    {"adapter": "verbose"},
    {"guided_choice": ("CrashLoopBackOff", "OOMKilled", "Error"), "adapter": "incident"},
    {"guided_regex": r"exit code [0-9]{1,3}"},
]


def test_mixed_base_adapter_and_guided_batch_equals_jax(jax_params, params):
    jax_adapters = {"incident": _jax_adapter(1), "verbose": _jax_adapter(2)}
    adapters = {
        name: {t: {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
               for t, f in a.items()}
        for name, a in jax_adapters.items()
    }
    jax_gen = BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), max_slots=8, max_seq=128,
        cache_dtype=jnp.float32, paged=True, page_size=16, decode_block=2,
        pipeline_depth=2, lora_adapters=jax_adapters,
    )
    gen = Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=8, max_seq=128,
        cache_dtype=torch.float32, page_size=16, decode_block=2, pipeline_depth=2,
        device="cpu", lora_adapters=adapters,
    )
    want = _run(jax_gen, MIXED_PROMPTS,
                [JaxSamplingParams(max_tokens=20, temperature=0.0, **kw) for kw in MIXED_KW])
    got = _run(gen, MIXED_PROMPTS,
               [SamplingParams(max_tokens=20, temperature=0.0, **kw) for kw in MIXED_KW])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert got[3].text in MIXED_KW[3]["guided_choice"]
    assert re.fullmatch(MIXED_KW[4]["guided_regex"], got[4].text)
    assert got[1].token_ids != got[0].token_ids or got[2].token_ids != got[0].token_ids


# ---------------------------------------------------------------------------
# submit-time validation and the HTTP front
# ---------------------------------------------------------------------------


def test_validation_surfaces_to_caller(params):
    engine = ServingEngine(_generator(params), admission_wait_s=0.005)

    async def scenario():
        with pytest.raises(ValueError, match="at least one"):
            await engine.generate("x", SamplingParams(guided_choice=()))
        with pytest.raises(ValueError, match="mutually exclusive"):
            await engine.generate("x", SamplingParams(guided_choice=("a",), guided_regex="a"))
        with pytest.raises(ValueError, match="not supported"):
            engine.submit("x", SamplingParams(guided_regex=r"(?i)x"))
        # the loop is alive and co-batched traffic unaffected
        return await engine.generate("y", SamplingParams(
            max_tokens=8, temperature=0.0, guided_choice=("ok", "fail")))

    try:
        assert asyncio.run(scenario()).text in ("ok", "fail")
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


def _post(url, body):
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("body,status,check", [
    ({"guided_choice": list(CHOICES), "temperature": 0.8}, 200, CHOICES),
    ({"guided_regex": r"\d{1,3} errors", "temperature": 1.1}, 200, r"\d{1,3} errors"),
    ({"guided_choice": "not-a-list"}, 400, "guided_choice must be"),
    ({"guided_regex": r"(?i)bad"}, 400, "not supported"),
    ({"guided_regex": "a", "guided_choice": ["b"]}, 400, "exclusive"),
])
def test_api_guided_fields(params, body, status, check):
    engine = ServingEngine(_generator(params), admission_wait_s=0.005)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    with _serving(server) as base:
        code, payload = _post(f"{base}/v1/completions",
                              {"prompt": "how many errors?", "max_tokens": 24, **body})
    assert code == status, payload
    if status != 200:
        assert check in payload["error"]["message"]
    elif isinstance(check, tuple):
        assert payload["choices"][0]["text"] in check
    else:
        assert re.fullmatch(check, payload["choices"][0]["text"])
