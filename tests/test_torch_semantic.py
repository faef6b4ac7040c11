"""The port's semantic analysis path against the JAX package's.

The same inputs go through both packages on the CPU: the MiniLM encoder
(JAX params carried across with ``params_from_jax``), the built-in
pattern library, the literal prefilter, ``SemanticMatcher.match`` and
``PatternEngine.analyze`` on the 12 fixture logs (with the lexical
``HashingEmbedder`` and with a tiny ``NeuralEmbedder`` sharing params and
``tokenize``), failure fingerprints of the results, and
``IncidentIndex.query``; and a tiny ``transformers`` BERT checkpoint
through ``load_encoder_params``, ``NeuralEmbedder.from_checkpoint`` (each
package's WordPiece tokenizer) and ``build_embedder``'s ladder.  Pattern ids, best windows, contexts, digests and
orders must be equal; float tolerances are stated per test.  On the CPU
the similarity calls take the plain version of the kernel (K5); the
kernel itself is held to it on the card by ``tests/test_torch_kernels.py``.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.memory.fingerprint import failure_fingerprint as jax_fingerprint  # noqa: E402
from operator_tpu.memory.index import IncidentIndex as JaxIncidentIndex  # noqa: E402
from operator_tpu.memory.store import Incident as JaxIncident  # noqa: E402
from operator_tpu.models import encoder as jax_encoder  # noqa: E402
from operator_tpu.patterns import semantic as jax_semantic  # noqa: E402
from operator_tpu.patterns.engine import PatternEngine as JaxPatternEngine  # noqa: E402
from operator_tpu.patterns.loader import load_builtin_library as jax_builtin  # noqa: E402
from operator_tpu.patterns.prefilter import LiteralPrefilter as JaxPrefilter  # noqa: E402
from operator_tpu.schema.analysis import PodFailureData as JaxPodFailureData  # noqa: E402
from operator_tpu.schema.serde import to_dict as jax_to_dict  # noqa: E402
from operator_tpu_torch.memory import Incident, IncidentIndex, failure_fingerprint  # noqa: E402
from operator_tpu_torch.models import encoder  # noqa: E402
from operator_tpu_torch.ops import similarity  # noqa: E402
from operator_tpu_torch.patterns import semantic  # noqa: E402
from operator_tpu_torch.patterns.engine import PatternEngine  # noqa: E402
from operator_tpu_torch.patterns.loader import load_builtin_library  # noqa: E402
from operator_tpu_torch.patterns.prefilter import LiteralPrefilter  # noqa: E402
from operator_tpu_torch.schema.analysis import PodFailureData  # noqa: E402
from operator_tpu_torch.schema.serde import to_dict  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE_NAMES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".log"))

#: one MiniLM layer at full width (hidden 384, 12 heads of 32, MLP 1,536)
#: with a small vocabulary and position table
MINILM_ONE_LAYER = jax_encoder.EncoderConfig(
    name="minilm-width-1-layer", vocab_size=1000, num_layers=1, max_positions=64,
)

#: a pod whose container statuses add evidence lines (terminated with a
#: reason and message, a waiting reason, restarts)
POD = {
    "metadata": {"name": "web-7d9f8c", "namespace": "shop"},
    "status": {
        "phase": "Running",
        "containerStatuses": [{
            "name": "app", "restartCount": 4,
            "state": {"waiting": {"reason": "CrashLoopBackOff", "message": "back-off 40s"}},
            "lastState": {"terminated": {"exitCode": 137, "reason": "OOMKilled",
                                         "message": "memory limit 512Mi exceeded"}},
        }],
    },
}
EVENTS = [{"type": "Warning", "reason": "BackOff", "note": "Back-off restarting failed container"}]


def _read(name):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read()


def _tokenize(text):
    """Byte-level ids (the JAX memory tests' stand-in for WordPiece)."""
    return [b % jax_encoder.ENCODER_TINY_TEST.vocab_size for b in text.encode()]


@pytest.fixture(scope="module")
def tiny_params():
    """ENCODER_TINY_TEST weights from the JAX init: (JAX tree, port tree)."""
    tree = jax_encoder.init_encoder_params(jax_encoder.ENCODER_TINY_TEST, jax.random.PRNGKey(0))
    return tree, encoder.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def embedders(tiny_params):
    """name -> (JAX embedder, port embedder) computing the same function."""
    tree, params = tiny_params
    return {
        "hashing": (jax_semantic.HashingEmbedder(), semantic.HashingEmbedder()),
        "neural": (
            jax_semantic.NeuralEmbedder(tree, jax_encoder.ENCODER_TINY_TEST, _tokenize,
                                        max_tokens=64, batch_size=8),
            semantic.NeuralEmbedder(params, encoder.ENCODER_TINY_TEST, _tokenize,
                                    max_tokens=64, batch_size=8, device="cpu"),
        ),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "minilm_width_one_layer"])
def test_encode_matches_jax(name):
    """Padded masks (rows of 5, 17, 32 and 1 real tokens), atol 1e-5:
    the two packages sum in different orders."""
    config = jax_encoder.ENCODER_TINY_TEST if name == "tiny" else MINILM_ONE_LAYER
    tree = jax_encoder.init_encoder_params(config, jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    ids = rng.integers(1, config.vocab_size, size=(4, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < np.asarray([5, 17, 32, 1])[:, None]).astype(np.int32)
    ids = ids * mask  # padding ids are 0, as NeuralEmbedder pads
    want = np.asarray(jax_encoder.encode(tree, config, jnp.asarray(ids), jnp.asarray(mask)))
    port_config = encoder.EncoderConfig(**{
        f: getattr(config, f) for f in encoder.EncoderConfig.__dataclass_fields__
    })
    params = encoder.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    got = encoder.encode(params, port_config, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (4, config.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_configs_match_jax():
    for ours, theirs in ((encoder.MINILM_L6, jax_encoder.MINILM_L6),
                         (encoder.ENCODER_TINY_TEST, jax_encoder.ENCODER_TINY_TEST)):
        for field in encoder.EncoderConfig.__dataclass_fields__:
            assert getattr(ours, field) == getattr(theirs, field), field
    assert encoder.MINILM_L6.head_dim == 32


def test_init_encoder_params_has_the_jax_shapes():
    tree = jax_encoder.init_encoder_params(jax_encoder.ENCODER_TINY_TEST, jax.random.PRNGKey(0))
    ours = encoder.init_encoder_params(
        encoder.ENCODER_TINY_TEST, torch.Generator().manual_seed(0), device="cpu"
    )
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == 5 + 16
    for path, leaf in flat:
        node = ours
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32


# ---------------------------------------------------------------------------
# patterns: library, prefilter, similarity over the real pattern set
# ---------------------------------------------------------------------------


def test_builtin_library_equals_the_jax_loaders():
    ours, theirs = load_builtin_library(), jax_builtin()
    assert ours.name == theirs.name and ours.skipped == theirs.skipped == 0
    assert len(ours.patterns) == len(theirs.patterns) == 19
    for a, b in zip(ours.patterns, theirs.patterns):
        assert to_dict(a) == jax_to_dict(b)
        assert semantic.embedding_text(a) == jax_semantic.embedding_text(b)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_prefilter_candidates_match_jax(name):
    lines = _read(name).splitlines()
    ours = LiteralPrefilter(load_builtin_library().patterns)
    theirs = JaxPrefilter(jax_builtin().patterns)
    assert ours.full_scan_ids == theirs.full_scan_ids
    assert ours.num_anchored == theirs.num_anchored
    assert ours.candidate_lines(lines) == theirs.candidate_lines(lines)


# ---------------------------------------------------------------------------
# the semantic matcher and the engine on the 12 fixtures
# ---------------------------------------------------------------------------


def _matchers(embedders, kind):
    jax_emb, port_emb = embedders[kind]
    theirs = jax_semantic.SemanticMatcher(jax_emb)
    ours = semantic.SemanticMatcher(port_emb, device="cpu")
    assert ours.rebuild([load_builtin_library()]) == theirs.rebuild([jax_builtin()]) == 19
    return ours, theirs


def _event_key(event):
    c = event.context
    return (event.source, event.matched_pattern.id, event.matched_pattern.severity,
            c.line_number, c.matched_line, c.lines_before, c.lines_after)


def _assert_events_equal(ours, theirs):
    """Same events in the same order; scores equal after the 4-digit
    rounding of ``_to_event``, or one rounding step apart (unrounded, the
    semantic scores agree within 1e-5: test_semantic_scores_match_jax)."""
    assert [_event_key(e) for e in ours] == [_event_key(e) for e in theirs]
    for a, b in zip(ours, theirs):
        assert abs(a.score - b.score) <= 1e-4 + 1e-9, (a.matched_pattern.id, a.score, b.score)


@pytest.mark.parametrize("kind", ["hashing", "neural"])
def test_semantic_scores_match_jax(embedders, kind):
    """Per fixture, the windows' embeddings (atol 1e-5) and every
    pattern's best score (atol 1e-5) and best window (exact)."""
    ours, theirs = _matchers(embedders, kind)
    np.testing.assert_allclose(ours._state[1].numpy(), theirs._state[1], rtol=0, atol=1e-5)
    for name in FIXTURE_NAMES:
        lines = _read(name).splitlines()
        texts = [w.text for w in semantic.iter_windows(
            lines, window_lines=ours.window_lines, stride=ours.stride)]
        jax_emb = theirs.embedder.embed(texts)
        port_emb = ours.embedder.embed(texts)
        np.testing.assert_allclose(port_emb, jax_emb, rtol=0, atol=1e-5)
        want_s, want_i = theirs._score(jax_emb, theirs._state[0], theirs._state[1])
        got_s, got_i = ours._score(port_emb, ours._state[0], ours._state[1])
        np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("kind", ["hashing", "neural"])
def test_semantic_match_matches_jax(embedders, kind):
    ours, theirs = _matchers(embedders, kind)
    for name in FIXTURE_NAMES:
        lines = _read(name).splitlines()
        _assert_events_equal(ours.match(lines), theirs.match(lines))


@pytest.mark.parametrize("kind", ["regex_only", "hashing", "neural"])
def test_analyze_matches_jax_on_every_fixture(embedders, kind):
    """``PatternEngine.analyze`` (regex + prefilter + semantic merge +
    fold) on the 12 fixtures, one with a pod and events, and the failure
    fingerprint of each result."""
    if kind == "regex_only":
        ours, theirs = PatternEngine(), JaxPatternEngine()
    else:
        jax_emb, port_emb = embedders[kind]
        ours = PatternEngine(semantic=semantic.SemanticMatcher(port_emb, device="cpu"))
        theirs = JaxPatternEngine(semantic=jax_semantic.SemanticMatcher(jax_emb))
    for name in FIXTURE_NAMES:
        bundle = {"logs": _read(name)}
        if name == "oom_java.log":
            bundle.update(pod=POD, events=EVENTS)
        got = ours.analyze(PodFailureData.parse(bundle))
        want = theirs.analyze(JaxPodFailureData.parse(bundle))
        _assert_events_equal(got.events, want.events)
        assert got.summary.highest_severity == want.summary.highest_severity
        assert got.summary.total_events == want.summary.total_events
        assert got.summary.significant_events == want.summary.significant_events
        assert got.pod_name == want.pod_name
        assert failure_fingerprint(got).digest == jax_fingerprint(want).digest


def test_semantic_engine_builds_its_matcher_on_the_given_device():
    engine = PatternEngine(semantic=True, device="cpu")
    assert engine.semantic.device.type == "cpu" and engine.semantic.num_patterns == 19
    before = similarity.launches
    engine.analyze(PodFailureData(logs=_read("disk_full.log")))
    assert similarity.launches == before  # CPU tensors: the plain version


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, tiny_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, params = tiny_params
    for build in (
        lambda: semantic.SemanticMatcher(),
        lambda: PatternEngine(semantic=True),
        lambda: IncidentIndex(),
        lambda: semantic.NeuralEmbedder(params, encoder.ENCODER_TINY_TEST, _tokenize),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    PatternEngine()  # regex only: no device needed


@pytest.fixture(scope="module")
def bert_checkpoint(tmp_path_factory):
    """A tiny ``transformers`` BERT checkpoint (``save_pretrained``: f32
    safetensors and ``config.json``) with a WordPiece ``vocab.txt`` of the
    fixture logs' words and a lower-casing ``tokenizer_config.json``."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    from test_torch_tokenizer import _bert_vocab

    path = tmp_path_factory.mktemp("bert") / "minilm-tiny"
    vocab = _bert_vocab()
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128), add_pooling_layer=False)
    model.save_pretrained(str(path), safe_serialization=True)
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    (path / "tokenizer_config.json").write_text(
        '{"do_lower_case": true, "tokenizer_class": "BertTokenizer"}')
    return str(path)


def test_load_encoder_params_matches_jax(bert_checkpoint):
    got, config = encoder.load_encoder_params(bert_checkpoint, device="cpu")
    want, jax_config = jax_encoder.load_encoder_params(bert_checkpoint)
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_config)
    assert (config.hidden_size, config.num_layers, config.max_positions) == (64, 2, 128)
    flat_got = {**{k: v for k, v in got.items() if k != "layers"}, **got["layers"]}
    flat_want = {**{k: v for k, v in want.items() if k != "layers"}, **want["layers"]}
    assert sorted(flat_got) == sorted(flat_want)
    for name, value in flat_got.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(flat_want[name]), err_msg=name)
    assert encoder.encoder_config_from_hf_json(os.path.dirname(bert_checkpoint)) == encoder.MINILM_L6


def test_from_checkpoint_matches_jax(bert_checkpoint):
    """``NeuralEmbedder.from_checkpoint``: embeddings within 1e-5 of the
    JAX ones (each package's WordPiece tokenizer, the same weights), and
    ``PatternEngine.analyze`` finds the same events on every fixture."""
    ours = semantic.NeuralEmbedder.from_checkpoint(bert_checkpoint, device="cpu")
    theirs = jax_semantic.NeuralEmbedder.from_checkpoint(bert_checkpoint)
    assert (ours.max_tokens, ours.dim) == (theirs.max_tokens, theirs.dim) == (128, 64)
    texts = [line for name in FIXTURE_NAMES for line in _read(name).splitlines()]
    texts += ["", "Café OOMKilled [SEP] 日本", "x" * 400]
    for text in texts:
        assert ours.tokenize(text) == theirs.tokenize(text), text
    np.testing.assert_allclose(ours.embed(texts), theirs.embed(texts), rtol=0, atol=1e-5)
    port_engine = PatternEngine(semantic=semantic.SemanticMatcher(ours, device="cpu"))
    jax_engine = JaxPatternEngine(semantic=jax_semantic.SemanticMatcher(theirs))
    semantic_events = 0
    for name in FIXTURE_NAMES:
        got = port_engine.analyze(PodFailureData(logs=_read(name)))
        want = jax_engine.analyze(JaxPodFailureData(logs=_read(name)))
        _assert_events_equal(got.events, want.events)
        semantic_events += sum(e.source == "semantic" for e in got.events)
    assert semantic_events > 0


def test_build_embedder_takes_the_reference_ladder(bert_checkpoint, tmp_path, caplog):
    neural = semantic.build_embedder(bert_checkpoint, device="cpu")
    assert isinstance(neural, semantic.NeuralEmbedder) and neural.device.type == "cpu"
    with caplog.at_level("WARNING"):
        degraded = semantic.build_embedder(str(tmp_path), device="cpu")  # no weights
    assert isinstance(degraded, semantic.HashingEmbedder)
    assert "degrading to lexical" in caplog.text
    assert isinstance(jax_semantic.build_embedder(str(tmp_path)), jax_semantic.HashingEmbedder)
    assert semantic.build_embedder(str(tmp_path), fallback=False, device="cpu") is None
    assert isinstance(semantic.build_embedder(None), semantic.HashingEmbedder)
    assert semantic.build_embedder("", fallback=False) is None


# ---------------------------------------------------------------------------
# incident index
# ---------------------------------------------------------------------------


def _incidents(cls):
    rng = np.random.default_rng(11)
    texts = [_read(name) for name in FIXTURE_NAMES]
    out = []
    for i in range(40):
        lines = texts[i % len(texts)].splitlines()
        lo = int(rng.integers(0, max(1, len(lines) - 3)))
        out.append(cls(fingerprint=f"digest-{i:02d}", template="\n".join(lines[lo:lo + 3]),
                       pattern_ids=[f"p{i % 5}"], reason="OOMKilled" if i % 3 else None,
                       exit_code=137 if i % 4 else None))
    return out


@pytest.mark.parametrize("kind", ["hashing", "neural"])
def test_incident_index_query_matches_jax(embedders, kind):
    """The same digests in the same order, scores within 1e-5, through
    rebuild, add (a duplicate digest is a no-op) and remove."""
    jax_emb, port_emb = embedders[kind]
    ours, theirs = IncidentIndex(port_emb, device="cpu"), JaxIncidentIndex(jax_emb)
    assert ours.rebuild(_incidents(Incident)) == theirs.rebuild(_incidents(JaxIncident)) == 40
    extra = {"fingerprint": "digest-extra", "template": "x509: certificate has expired"}
    ours.add(Incident(**extra))
    theirs.add(JaxIncident(**extra))
    ours.add(Incident(fingerprint="digest-00", template="ignored"))
    theirs.add(JaxIncident(fingerprint="digest-00", template="ignored"))
    gone = ["digest-03", "digest-17", "nope"]
    ours.remove(gone)
    theirs.remove(gone)
    assert len(ours) == len(theirs) == 39
    queries = ["java.lang.OutOfMemoryError: Java heap space", "no such host backend.svc",
               "CrashLoopBackOff exit code 137", "x509 certificate expired", "   "]
    for text in queries:
        got, want = ours.query(text, k=5), theirs.query(text, k=5)
        assert [d for d, _ in got] == [d for d, _ in want], text
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=1e-5)
    ours.remove([f"digest-{i:02d}" for i in range(40)] + ["digest-extra"])
    assert len(ours) == 0 and ours.query("anything") == []
