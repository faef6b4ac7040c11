"""The port's JSON Schema lowering (guided_json) against the JAX package's.

``serving/json_schema.py`` is a copy: ``schema_to_regex`` must give the
JAX function's pattern, string for string, for every schema of the JAX
package's own tests (and a root-cause schema like the card's drive's),
refuse the same schemas with the same words, and stay inside its
budgets; at tinyllama's 32,000-id vocab the root cause's table fits the
16M-entry cap with a 32-character summary and not with 64, in both.  The patterns are held semantically against Python's ``re``
too.  Through the port's wave engine (``TINY_TEST``, f32, the JAX
weights) the constrained output parses and validates, sampled or
greedy, and the greedy tokens equal the JAX ``BatchedGenerator``'s.
"""

import json
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
from operator_tpu.serving import json_schema as jax_json_schema  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.serving.engine import Generator  # noqa: E402
from operator_tpu_torch.serving.json_schema import lower_guided_json, schema_to_regex  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402

SEVERITY = {
    "type": "object",
    "properties": {
        "severity": {"enum": ["CRITICAL", "HIGH", "MEDIUM", "LOW"]},
        "confident": {"type": "boolean"},
    },
}

#: a root cause: an enum, an integer and a bounded string (the card's
#: drive caps the summary at 32 characters: see the table-cap test)
ROOT_CAUSE = {
    "type": "object",
    "properties": {
        "reason": {"enum": ["CrashLoopBackOff", "OOMKilled", "ImagePullBackOff", "Error"]},
        "confidence": {"type": "integer"},
        "summary": {"type": "string", "maxLength": 64},
    },
    "required": ["reason", "confidence", "summary"],
}

SCHEMAS = {
    "integer": {"type": "integer"},
    "number": {"type": "number"},
    "boolean": {"type": "boolean"},
    "null": {"type": "null"},
    "string": {"type": "string"},
    "string_bounds": {"type": "string", "minLength": 1, "maxLength": 3},
    "string_min_only": {"type": "string", "minLength": 2},
    "enum": {"enum": ["a b", 3, True, None]},
    "const": {"const": "x.y"},
    "severity": SEVERITY,
    "severity_partial": {**SEVERITY, "required": ["severity"]},
    "severity_all_optional": {**SEVERITY, "required": []},
    "array_bounds": {"type": "array", "items": {"type": "integer"},
                     "minItems": 1, "maxItems": 3},
    "array_empty_ok": {"type": "array", "items": {"type": "boolean"}},
    "array_min_only": {"type": "array", "items": {"type": "boolean"}, "minItems": 2},
    "nesting": {"type": "object", "properties": {
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 2},
        "code": {"anyOf": [{"type": "integer"}, {"type": "null"}]},
    }},
    "one_of": {"oneOf": [{"type": "boolean"}, {"enum": ["x"]}]},
    "root_cause": ROOT_CAUSE,
}


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schema_regex_equals_jax(name):
    schema = SCHEMAS[name]
    assert schema_to_regex(schema) == jax_json_schema.schema_to_regex(schema)
    text = json.dumps(schema)
    assert lower_guided_json(text) == jax_json_schema.lower_guided_json(text)


def _full(schema, doc):
    return re.fullmatch(schema_to_regex(schema), doc, re.DOTALL) is not None


@pytest.mark.parametrize("name,doc,want", [
    ("integer", "-42", True), ("integer", "007", False),
    ("number", "3.25e-2", True), ("null", "null", True),
    ("string", '"hi \\n there"', True), ("string", '"unterminated', False),
    ("string", '"a\nb"', False), ("string", '"\\u00e9"', True),
    ("string_bounds", '"ab"', True), ("string_bounds", '""', False),
    ("string_bounds", '"abcd"', False),
    ("string_min_only", '"' + "x" * 200 + '"', True),
    ("enum", '"a b"', True), ("enum", '"c"', False),
    ("const", '"x.y"', True), ("const", '"xzy"', False),
    ("severity", '{"severity":"LOW","confident":true}', True),
    ("severity", '{"severity":"nope","confident":true}', False),
    ("severity_partial", '{"severity":"LOW"}', True),
    ("severity_all_optional", "{}", True),
    ("severity_all_optional", '{"confident":true}', True),
    ("array_bounds", "[1,2,3]", True), ("array_bounds", "[]", False),
    ("array_bounds", "[1,2,3,4]", False), ("array_empty_ok", "[]", True),
    ("array_min_only", "[" + ",".join(["true"] * 80) + "]", True),
    ("nesting", '{"tags":["a","b"],"code":137}', True),
    ("nesting", '{"tags":["a"],"code":"x"}', False),
    ("root_cause", '{"reason":"OOMKilled","confidence":90,"summary":"heap"}', True),
    ("root_cause", '{"reason":"Oops","confidence":90,"summary":"heap"}', False),
])
def test_lowered_patterns_match_documents(name, doc, want):
    assert _full(SCHEMAS[name], doc) == want


REJECTED = [
    ({"type": "object"}, "properties"),
    ({"type": "array"}, "items"),
    ({"$ref": "#/x"}, "not supported"),
    ({"type": "object", "properties": {"a": {"type": "string"}},
      "additionalProperties": True}, "additionalProperties"),
    ({"type": "string", "maxLength": 500}, "maxLength"),
    ({"type": "frobnicate"}, "unsupported schema"),
    ("{not json", "not valid JSON"),
    ({"type": "object", "properties": {"a": {"type": "boolean"}}, "required": 5},
     "list of property names"),
    ({"type": "object", "properties": {"a": {"type": "boolean"}}, "required": [["a"]]},
     "list of property names"),
    ({"enum": [float("inf")]}, "no JSON representation"),
    ({"type": "object", "properties": {f"p{i}": {"type": "boolean"} for i in range(33)}},
     "at most 32"),
    ({"type": "object", "required": [], "properties": {
        f"property-number-{i:02d}": {"enum": [f"value-{i}-{j}" for j in range(8)]}
        for i in range(32)}}, "char budget"),
]


@pytest.mark.parametrize("index", range(len(REJECTED)))
def test_rejections_equal_jax(index):
    schema, needle = REJECTED[index]
    with pytest.raises(ValueError) as got:
        schema_to_regex(schema)
    with pytest.raises(ValueError) as want:
        jax_json_schema.schema_to_regex(schema)
    assert needle in str(got.value) and str(got.value) == str(want.value)


def test_deep_nesting_rejected_fast():
    """The budget fires during recursion: 45 nested arrays would otherwise
    build a ~2^45-byte string before an after-the-fact check ran."""
    schema: dict = {"type": "integer"}
    for _ in range(45):
        schema = {"type": "array", "items": schema, "maxItems": 1}
    started = time.perf_counter()
    with pytest.raises(ValueError, match="char budget"):
        schema_to_regex(schema)
    assert time.perf_counter() - started < 1.0


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _run(generator, prompts, sampling):
    slots = generator.admit(prompts, sampling)
    results = {}
    while generator.num_active:
        for slot_id, result in generator.step():
            results[slot_id] = result
    return [results[s] for s in slots]


def _port(params):
    return Generator(
        params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128,
        cache_dtype=torch.float32, page_size=16, decode_block=2, device="cpu",
    )


def test_engine_output_validates_against_schema(params):
    regex = schema_to_regex(SEVERITY)
    results = _run(_port(params), ["classify this oom kill", "and this crashloop"], [
        SamplingParams(max_tokens=48, temperature=1.0, guided_regex=regex),
        SamplingParams(max_tokens=48, temperature=0.7, guided_regex=regex),
    ])
    for result in results:
        doc = json.loads(result.text)
        assert doc["severity"] in ("CRITICAL", "HIGH", "MEDIUM", "LOW")
        assert isinstance(doc["confident"], bool)


def test_greedy_json_equals_jax(jax_params, params):
    regex = schema_to_regex(SEVERITY)
    prompts = ["classify this oom kill", "and this crashloop"]
    jax_gen = BatchedGenerator(
        jax_params, JAX_TINY_TEST, JaxByteTokenizer(), max_slots=4, max_seq=128,
        cache_dtype=jnp.float32, paged=True, page_size=16, decode_block=2,
    )
    want = _run(jax_gen, prompts, [
        JaxSamplingParams(max_tokens=48, temperature=0.0, guided_regex=regex)] * 2)
    got = _run(_port(params), prompts, [
        SamplingParams(max_tokens=48, temperature=0.0, guided_regex=regex)] * 2)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for result in got:
        assert json.loads(result.text)["severity"] in ("CRITICAL", "HIGH", "MEDIUM", "LOW")


@pytest.mark.parametrize("summary,fits", [(32, True), (64, False)])
def test_root_cause_table_cap_at_a_32000_vocab_equals_jax(summary, fits):
    """tinyllama-1.1b's 32,000-id vocab: a root cause with a 32-character
    summary fits the 16M-entry table cap; with 64 characters its DFA
    needs 620 states and both packages refuse it in the same words."""
    from operator_tpu.serving.regex_dfa import compile_regex_automaton as jax_compile
    from operator_tpu_torch.serving.regex_dfa import compile_regex_automaton

    schema = {**ROOT_CAUSE, "properties": {
        **ROOT_CAUSE["properties"], "summary": {"type": "string", "maxLength": summary}}}
    regex = schema_to_regex(schema)
    if fits:
        got = compile_regex_automaton(regex, ByteTokenizer(), 32000, max_states=1 << 14)
        want = jax_compile(regex, JaxByteTokenizer(), 32000, max_states=1 << 14)
        assert got.num_states == want.num_states and got.num_states * 32000 <= 16_000_000
        assert np.array_equal(got.transition, want.transition)
        return
    with pytest.raises(ValueError, match="620 DFA states") as got:
        compile_regex_automaton(regex, ByteTokenizer(), 32000, max_states=1 << 14)
    with pytest.raises(ValueError) as want:
        jax_compile(regex, JaxByteTokenizer(), 32000, max_states=1 << 14)
    assert str(got.value) == str(want.value)
