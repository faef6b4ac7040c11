"""Each ``tokenizer.json`` component the port reads, against the JAX package.

One case per component (and per option that changes what it does), each
a variant of a committed fixture (``llama_sp``, ``llama3_bl``,
``minilm_wordpiece``, ``xlmr_unigram``) loaded by the port's
``HFTokenizer`` and the JAX ``HFTokenizer`` over ``AutoTokenizer``, held
equal on the special ids, ``vocab_size``, ``encode`` with and without BOS,
``encode`` with the post-processor's specials (against ``AutoTokenizer``)
and ``decode``; BPE dropout as the library draws it; every code point,
and seeded sequences, through each component that reads a Unicode
property (the normalization forms, ``Lowercase``, ``BertNormalizer``,
``Digits``, ``Whitespace``, ``single_word``, ``Precompiled``'s clusters)
against the library; the library's tables the port keeps
(``scripts/torch_text_tables.py``, each probed again); and where Python's
``unicodedata`` (Unicode 15.0) still disagrees with the library, which is
why the port keeps them.
"""

import copy
import importlib.util
import json
import math
import os
import random
import sys
import unicodedata

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from operator_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from operator_tpu_torch.models import tokenizer  # noqa: E402
from operator_tpu_torch.models.tokenization import charsmap, normalizers, onig  # noqa: E402
from operator_tpu_torch.models.tokenization import pre_tokenizers, tables  # noqa: E402
from operator_tpu_torch.models.tokenization import text as port_text  # noqa: E402
from test_torch_tokenizer import (EDGE_TEXTS, LLAMA3_BL, LLAMA3_BL_CONFIG, LLAMA_SP,  # noqa: E402
                                  LLAMA_SP_CONFIG, _many_scripts_texts, fixture_lines)
from test_torch_tokenizer_families import (METASPACE, MINILM_CONFIG, MINILM_WORDPIECE,  # noqa: E402
                                           PROMPTS, XLMR_CONFIG, XLMR_UNIGRAM,
                                           assert_same_tokenizer, charsmap_blob)

BASES = {"llama_sp": (LLAMA_SP, LLAMA_SP_CONFIG), "llama3_bl": (LLAMA3_BL, LLAMA3_BL_CONFIG),
         "minilm_wordpiece": (MINILM_WORDPIECE, MINILM_CONFIG),
         "xlmr_unigram": (XLMR_UNIGRAM, XLMR_CONFIG)}


def _load(base: str):
    path, config = BASES[base]
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as fh:
        return json.load(fh), copy.deepcopy(config)


def _files(tmp_path, name: str, spec: dict, config: dict) -> str:
    directory = tmp_path / name
    directory.mkdir()
    (directory / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (directory / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
    return str(directory)


def _pre(*steps) -> dict:
    return {"type": "Sequence", "pretokenizers": list(steps)}


def _split(pattern: dict, behavior: str, invert: bool = False) -> dict:
    return {"type": "Split", "pattern": pattern, "behavior": behavior, "invert": invert}


def _train_bpe(prefix: str, suffix: str) -> dict:
    """A BPE model with a continuing-subword prefix and an end-of-word
    suffix, trained on the fixture logs split on whitespace."""
    from tokenizers import models, pre_tokenizers, trainers

    trainer = tokenizers.Tokenizer(models.BPE(unk_token="[UNK]", continuing_subword_prefix=prefix,
                                              end_of_word_suffix=suffix))
    trainer.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer.train_from_iterator(fixture_lines(), trainers.BpeTrainer(
        vocab_size=900, min_frequency=2, show_progress=False, special_tokens=["[UNK]"],
        continuing_subword_prefix=prefix, end_of_word_suffix=suffix))
    return json.loads(trainer.to_str())["model"]


def _word_level_vocab(spec: dict) -> dict:
    words = sorted({w for line in fixture_lines() for w in line.split()})[:600]
    return {"<unk>": 0, **{w: i + 1 for i, w in enumerate(words)}}


#: name -> (base fixture, mutate(spec, config))
CASES = {
    # --- models ---
    "model_wordpiece": ("minilm_wordpiece", None),
    "model_wordpiece_prefix_max_chars": ("minilm_wordpiece", lambda s, c: (
        s["model"].update(max_input_chars_per_word=6),
        s["model"].update(continuing_subword_prefix="@@", vocab={
            (k.replace("##", "@@", 1) if k.startswith("##") else k): v
            for k, v in s["model"]["vocab"].items()}),
        s.update(decoder={"type": "WordPiece", "prefix": "@@", "cleanup": False}))),
    "model_wordlevel": ("minilm_wordpiece", lambda s, c: s.update(
        model={"type": "WordLevel", "vocab": _word_level_vocab(s), "unk_token": "<unk>"},
        normalizer=None, pre_tokenizer={"type": "WhitespaceSplit"}, post_processor=None,
        added_tokens=[], decoder=None) or c.update(tokenizer_class="PreTrainedTokenizerFast")),
    "model_unigram": ("xlmr_unigram", None),
    "model_unigram_no_byte_fallback": ("xlmr_unigram", lambda s, c: s["model"].update(
        byte_fallback=False)),
    "model_bpe_prefix_suffix": ("llama_sp", lambda s, c: s.update(
        model=_train_bpe("##", "</w>"), normalizer=None, added_tokens=[],
        pre_tokenizer={"type": "Whitespace"}, decoder={"type": "BPEDecoder", "suffix": "</w>"})),
    # --- normalizers ---
    "normalizer_bert_cased_accents_stripped": ("minilm_wordpiece", lambda s, c: (
        s["normalizer"].update(lowercase=False, strip_accents=True),
        c.update(do_lower_case=False, strip_accents=True))),
    "normalizer_bert_no_clean_no_chinese": ("minilm_wordpiece", lambda s, c: (
        s["normalizer"].update(clean_text=False, handle_chinese_chars=False),
        c.update(tokenize_chinese_chars=False))),
    "normalizer_bert_rebuilt_from_config": ("minilm_wordpiece", lambda s, c: c.update(
        do_lower_case=False)),
    "normalizer_byte_level": ("llama3_bl", lambda s, c: s.update(
        normalizer={"type": "ByteLevel"},
        pre_tokenizer=_split({"String": "Ġ"}, "MergedWithNext"))),
    "normalizer_lowercase": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].append(
        {"type": "Lowercase"})),
    "normalizer_nfd": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].__setitem__(
        0, {"type": "NFD"})),
    "normalizer_nfkc": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].__setitem__(
        0, {"type": "NFKC"})),
    "normalizer_nfkd": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].__setitem__(
        0, {"type": "NFKD"})),
    "normalizer_nmt": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].insert(
        0, {"type": "Nmt"})),
    "normalizer_precompiled": ("xlmr_unigram", None),
    "normalizer_replace_regex": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].append(
        {"type": "Replace", "pattern": {"Regex": r"\d+|[ \t]*\n"}, "content": "#"})),
    "normalizer_replace_empty_matches": ("xlmr_unigram", lambda s, c: s["normalizer"][
        "normalizers"].append({"type": "Replace", "pattern": {"Regex": "o*"}, "content": "-"})),
    "normalizer_strip": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].insert(
        1, {"type": "Strip", "strip_left": False, "strip_right": True})),
    "normalizer_strip_both": ("xlmr_unigram", lambda s, c: s["normalizer"]["normalizers"].insert(
        1, {"type": "Strip", "strip_left": True, "strip_right": True})),
    "normalizer_strip_accents": ("xlmr_unigram", lambda s, c: s["normalizer"].update(
        normalizers=[{"type": "NFD"}, {"type": "StripAccents"}, {"type": "Lowercase"}])),
    # --- pre-tokenizers ---
    "pre_bert": ("minilm_wordpiece", None),
    "pre_whitespace": ("minilm_wordpiece", lambda s, c: s.update(
        pre_tokenizer={"type": "Whitespace"})),
    "pre_whitespace_split": ("minilm_wordpiece", lambda s, c: s.update(
        pre_tokenizer={"type": "WhitespaceSplit"})),
    "pre_char_delimiter_split": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        {"type": "CharDelimiterSplit", "delimiter": "e"}, METASPACE))),
    "pre_digits": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        {"type": "Digits", "individual_digits": False}, METASPACE))),
    "pre_digits_individual": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        {"type": "Digits", "individual_digits": True}, METASPACE))),
    "pre_fixed_length": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        {**METASPACE, "split": False}, {"type": "FixedLength", "length": 4}))),
    "pre_metaspace_never": ("xlmr_unigram", lambda s, c: (
        s.update(pre_tokenizer={**METASPACE, "prepend_scheme": "never"}),
        s.update(decoder={**METASPACE, "prepend_scheme": "never"}))),
    **{f"pre_punctuation_{b.lower()}": ("xlmr_unigram", lambda s, c, b=b: s.update(
        pre_tokenizer=_pre({"type": "Punctuation", "behavior": b}, METASPACE)))
       for b in port_text.BEHAVIORS},
    **{f"pre_split_{b.lower()}{'_inverted' if inv else ''}": (
        "xlmr_unigram", lambda s, c, b=b, inv=inv: s.update(pre_tokenizer=_pre(
            _split({"Regex": r"\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+"}, b, inv), METASPACE)))
       for b in port_text.BEHAVIORS for inv in (False, True)},
    "pre_split_string": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        _split({"String": "::"}, "Removed"), METASPACE))),
    "pre_split_category_classes": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        _split({"Regex": r"\p{Lu}\p{Ll}*|\P{L}|\p{M}+|[\p{Nd}\p{Sc}]+|\w+|\p{^Zs}"},
               "Isolated"), METASPACE))),
    "pre_split_negated_in_class": ("xlmr_unigram", lambda s, c: s.update(pre_tokenizer=_pre(
        _split({"Regex": r"[^\P{L}a-z]+|[\S\d]|\h+|^\s|$"}, "Isolated"), METASPACE))),
    # --- decoders ---
    "decoder_ctc": ("minilm_wordpiece", lambda s, c: s.update(decoder={
        "type": "CTC", "pad_token": "[PAD]", "word_delimiter_token": "a", "cleanup": True})),
    "decoder_ctc_no_cleanup": ("xlmr_unigram", lambda s, c: s.update(decoder={
        "type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "▁", "cleanup": False})),
    "decoder_replace_regex": ("xlmr_unigram", lambda s, c: s.update(decoder={
        "type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"Regex": "▁+"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]})),
    "decoder_wordpiece_no_cleanup": ("minilm_wordpiece", lambda s, c: s["decoder"].update(
        cleanup=False)),
    # --- post-processors ---
    "post_bert_processing": ("minilm_wordpiece", lambda s, c: s.update(post_processor={
        "type": "BertProcessing", "sep": ["[SEP]", 102], "cls": ["[CLS]", 101]})),
    "post_roberta_processing": ("xlmr_unigram", lambda s, c: s.update(post_processor={
        "type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0],
        "trim_offsets": True, "add_prefix_space": True})),
    "post_byte_level_sequence": ("llama3_bl", None),
    "post_template_multi_id": ("xlmr_unigram", lambda s, c: s.update(post_processor={
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                   {"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "ends", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                           "ends": {"id": "ends", "ids": [2, 1], "tokens": ["</s>", "<pad>"]}}})),
    "post_llama_class": ("llama_sp", lambda s, c: c.update(add_eos_token=True)),
    # --- added tokens ---
    "added_single_word": ("xlmr_unigram", lambda s, c: s["added_tokens"].append({
        "id": len(s["model"]["vocab"]), "content": "error", "single_word": True, "lstrip": False,
        "rstrip": False, "normalized": False, "special": False})),
    "added_normalized": ("xlmr_unigram", lambda s, c: (
        s["normalizer"]["normalizers"].append({"type": "Lowercase"}),
        s["added_tokens"].append({
            "id": len(s["model"]["vocab"]), "content": "OOMKilled", "single_word": False,
            "lstrip": False, "rstrip": True, "normalized": True, "special": False}))),
    "added_class_defaults": ("xlmr_unigram", lambda s, c: (
        s.update(added_tokens=[t for t in s["added_tokens"] if t["content"] != "<mask>"]),
        [c.pop(k) for k in ("mask_token", "pad_token", "bos_token")])),
}


def _texts(name: str) -> list:
    rng = random.Random(name)
    return fixture_lines()[::2] + EDGE_TEXTS + PROMPTS + _many_scripts_texts(len(name), 40) + [
        "OOMKilled error errors xerror error_x -error- ÉRROR", "1234567 ٣٤٥ ²³ ½ 12.5%",
        "a::b :: c:::d", "[PAD][PAD] a|b", "oo o ooo", "x" * 9 + " " + "é" * 8,
        "".join(rng.choice("a\u00e9 \u0301\uff76\uff9e\u2460\uff21\u200b\xa0\t\n.\U0001f600") for _ in range(40))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_matches_the_jax_tokenizer(tmp_path, case):
    base, mutate = CASES[case]
    spec, config = _load(base)
    if mutate is not None:
        mutate(spec, config)
    tokenizers.Tokenizer.from_str(json.dumps(spec))  # the library reads the variant
    path = _files(tmp_path, case, spec, config)
    auto = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
    assert_same_tokenizer(tokenizer.HFTokenizer(path), jax_tokenizer.HFTokenizer(path),
                          _texts(case), seed=len(case), specials=auto)


# ---------------------------------------------------------------------------
# BPE dropout
# ---------------------------------------------------------------------------

DROPOUT_TEXT = "Back-off restarting failed container api in pod api-7d9f (exit code 137)"


def _dropout(tmp_path, p) -> str:
    spec, config = _load("llama_sp")
    spec["model"]["dropout"] = p
    return _files(tmp_path, f"dropout_{p}", spec, config)


def test_bpe_dropout_zero_and_one(tmp_path):
    """``dropout: 0`` is no dropout; ``dropout: 1`` skips every merge, as
    the library does (73 ids, one a character, against 22 on this text)."""
    plain = tokenizer.HFTokenizer(LLAMA_SP)
    zero = tokenizer.HFTokenizer(_dropout(tmp_path, 0.0), rng=random.Random(1))
    one_path = _dropout(tmp_path, 1.0)
    one = tokenizer.HFTokenizer(one_path, rng=random.Random(1))
    want_one = jax_tokenizer.HFTokenizer(one_path)
    for text in fixture_lines()[:40] + EDGE_TEXTS + [DROPOUT_TEXT]:
        assert zero.encode(text) == plain.encode(text), text
        assert one.encode(text) == want_one.encode(text), text
        assert one.decode(one.encode(text)) == want_one.decode(want_one.encode(text)), text
    assert (len(plain.encode(DROPOUT_TEXT, add_bos=False)),
            len(one.encode(DROPOUT_TEXT, add_bos=False))) == (22, 73)


def test_bpe_dropout_half_draws_as_the_library(tmp_path):
    """At ``p = 0.5`` every draw decodes back to its text, the port's
    draws come from the generator it was given (the same seed, the same
    draws; the global generator untouched), and the mean id count over
    2,000 draws lies within 4 standard errors of the library's."""
    path = _dropout(tmp_path, 0.5)
    state = random.getstate()
    ours = tokenizer.HFTokenizer(path, rng=random.Random(2024))
    again = tokenizer.HFTokenizer(path, rng=random.Random(2024))
    library = jax_tokenizer.HFTokenizer(path)
    got = [ours.encode(DROPOUT_TEXT, add_bos=False) for _ in range(2000)]
    assert [again.encode(DROPOUT_TEXT, add_bos=False) for _ in range(2000)] == got
    assert random.getstate() == state
    want = [library.encode(DROPOUT_TEXT, add_bos=False) for _ in range(2000)]
    assert all(ours.decode(ids) == DROPOUT_TEXT for ids in got[:200])
    assert len({tuple(ids) for ids in got}) > 20

    def mean_var(samples):
        counts = [len(ids) for ids in samples]
        mean = sum(counts) / len(counts)
        return mean, sum((n - mean) ** 2 for n in counts) / (len(counts) - 1)

    (m1, v1), (m2, v2) = mean_var(got), mean_var(want)
    assert abs(m1 - m2) <= 4 * math.sqrt(v1 / 2000 + v2 / 2000), (m1, m2, v1, v2)
    assert 22 < m1 < 73


# ---------------------------------------------------------------------------
# where Python's Unicode 15.0 and the library's 16.0 disagree
# ---------------------------------------------------------------------------

_ALL = [c for c in range(sys.maxunicode + 1) if not 0xD800 <= c < 0xE000]


def _library_class(pattern: str) -> set:
    """The code points the library's expression ``pattern`` matches alone."""
    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), behavior="removed")
    out = set()
    for lo in range(0, len(_ALL), 8192):
        chunk = "".join(map(chr, _ALL[lo:lo + 8192]))
        kept = set("".join(piece for piece, _ in split.pre_tokenize_str(chunk)))
        out.update(ord(c) for c in chunk if c not in kept)
    return out


def _port_class(pattern: str) -> set:
    """The code points the port's translation of a one-character class
    matches (every code point in one string)."""
    text = "".join(map(chr, _ALL))
    return {ord(text[a]) for a, _ in port_text.find_iter(port_text.translate_regex(pattern), text)}


def _cn(points) -> bool:
    return all(unicodedata.category(chr(c)) == "Cn" for c in points)


#: pattern -> code points the library matches that the port does not
#: (Unicode 16.0's new letters, numbers and marks while the port's classes
#: came from Python's 15.0; the port's classes are the library's own data
#: now, ``tokenization/unicode_tables.py``)
VERSION_GAP = {r"\p{L}": 0, r"\p{N}": 0, r"\p{M}": 0, r"\w": 0, r"\s": 0, r"\p{Lu}": 0}


@pytest.mark.parametrize("pattern", sorted(VERSION_GAP))
def test_unicode_classes_differ_only_by_version(pattern):
    """An expression class matches what the library's does on every code
    point: no Unicode version stands between them."""
    got, want = _port_class(pattern), _library_class(pattern)
    assert got <= want
    assert _cn(want - got) and len(want - got) == VERSION_GAP[pattern]
    assert got == want


#: form -> the code points (ranges) whose result differs between the
#: library and Python's ``unicodedata`` (Unicode 15.0) alone: the
#: library's normalization tables are older than Python's (the
#: compatibility mappings of Unicode 12.1-15.0's modifier letters and
#: digits; NFD differs on U+11938, lowercasing on 16.0's 55 capitals).
#: The port reads the library's own tables instead (``tokenization/tables.py``)
UNICODEDATA_DIFFERENCES = {
    "NFKC": [[0x32FF, 0x32FF], [0xA7F2, 0xA7F4], [0xAB69, 0xAB69], [0x10781, 0x10785],
             [0x10787, 0x107B0], [0x107B2, 0x107BA], [0x1E030, 0x1E06D], [0x1F16C, 0x1F16C],
             [0x1FBF0, 0x1FBF9]],
}


def _differences(library, ours) -> list:
    """Code points whose result differs, each normalized alone (a chunk
    joined by NUL first, which neither composes nor reorders)."""
    out = []
    for lo in range(0, len(_ALL), 8192):
        chunk = [c for c in _ALL[lo:lo + 8192] if c]
        joined = "\0".join(map(chr, chunk))
        if library(joined) != ours(joined):
            out += [c for c in chunk if library(chr(c)) != ours(chr(c))]
    return out


def _library_normalizer(form: str):
    return getattr(tokenizers.normalizers, form)().normalize_str


@pytest.mark.parametrize("form", ["Lowercase", "NFC", "NFD", "NFKC", "NFKD"])
def test_normalization_differs_by_version(form):
    """NFC, NFD, NFKC, NFKD and per-character lowercasing code point by
    code point: the port's (``build_normalizer``) is the library's on every
    one, though Python's ``unicodedata`` is of another Unicode."""
    ours = normalizers.build_normalizer({"type": form})
    assert _differences(_library_normalizer(form), ours) == []


@pytest.mark.parametrize("form", sorted(UNICODEDATA_DIFFERENCES))
def test_unicodedata_still_differs_from_the_library(form):
    """Why the port keeps the library's tables: ``unicodedata`` alone still
    disagrees with the library there."""
    plain = lambda s: unicodedata.normalize(form, s)  # noqa: E731
    assert _ranges(_differences(_library_normalizer(form), plain)) == \
        UNICODEDATA_DIFFERENCES[form]


#: the code points whose normalization differs by Unicode version, and
#: combining marks of several classes, for the sequence fuzz
def _fuzz_alphabet() -> list:
    cuts = [c for lo, hi in port_text.table("NORMALIZATION_CUTS") for c in range(lo, hi + 1)]
    lower = list(tables.LOWERCASE)
    marks = [0x0300, 0x0301, 0x0316, 0x0327, 0x0334, 0x0345, 0x05B0, 0x093C, 0x094D, 0x0E38,
             0x1DFA, 0x1E4EC, 0x16FF0, 0x11930, 0x11935, 0x302A, 0x3099]
    starters = [0x61, 0x41, 0x3A3, 0xC5, 0x1100, 0x1161, 0x11A8, 0xAC00, 0x915, 0x937, 0x2B820,
                0x4E00, 0x20, 0x10D40, 0x1E5F1, 0x6F, 0x3131, 0xFB01]
    return cuts + lower + marks + starters + [0x11938, 0x1F16C]


SEQUENCE_COMPONENTS = {
    **{form: {"type": form} for form in ("NFC", "NFD", "NFKC", "NFKD", "Lowercase")},
    "StripAccents": {"type": "StripAccents"},
    "BertNormalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": True, "lowercase": True},
}


def _library_component(spec: dict):
    kind = spec["type"]
    if kind == "BertNormalizer":
        options = {k: v for k, v in spec.items() if k != "type"}
        return tokenizers.normalizers.BertNormalizer(**options).normalize_str
    return getattr(tokenizers.normalizers, kind)().normalize_str


@pytest.mark.parametrize("name", sorted(SEQUENCE_COMPONENTS))
def test_normalizers_match_the_library_on_mixed_sequences(name):
    """Seeded random sequences of the code points where the Unicode
    versions differ, mixed with combining marks of several classes,
    starters that compose with them, Hangul jamo and ideographs: each
    normalizer gives the library's text."""
    spec = SEQUENCE_COMPONENTS[name]
    library, ours = _library_component(spec), normalizers.build_normalizer(spec)
    alphabet = _fuzz_alphabet()
    rng = np.random.default_rng(29)
    texts = ["".join(chr(alphabet[i]) for i in rng.integers(0, len(alphabet), rng.integers(1, 12)))
             for _ in range(3000)]
    bad = [t for t in texts if ours(t) != library(t)]
    assert bad == [], [[hex(ord(c)) for c in t] for t in bad[:5]]


def test_grapheme_extension_differs_only_by_version():
    """Which code points join the grapheme cluster of a letter before
    them (Extend, ZWJ, SpacingMark), read through the library's
    ``Precompiled`` (a cluster under 6 bytes that starts with a key is
    replaced whole): the port's clusters, on the break classes probed from
    ``Precompiled`` (``tables.GRAPHEMES``), agree on every code point.
    Planes 0, 1 and 14 are read: planes 2 and 3 hold ideographs only, 4 to
    13 nothing, 15 and 16 private use."""
    library = tokenizers.normalizers.Precompiled(charsmap_blob({"a": "A"}))
    points = [c for c in _ALL if (c < 0x20000 or 0xE0000 <= c < 0xF0000) and chr(c) not in "\r\n"]
    joined = set()
    for lo in range(0, len(points), 8192):
        chunk = points[lo:lo + 8192]
        pieces = library.normalize_str("\n".join("a" + chr(c) for c in chunk)).split("\n")
        joined.update(c for c, piece in zip(chunk, pieces) if piece == "A")
    ours = {c for c in points if len(charsmap.graphemes("a" + chr(c))) == 1}
    assert ours == joined


#: the pieces of texts whose grapheme clusters every rule decides: Hangul
#: syllables and jamo, emoji ZWJ sequences, regional indicators, Indic
#: conjuncts (GB9c), prepends, controls and spacing marks
GRAPHEME_PIECES = ["a", "\r", "\n", "\x07", "\u200d", "\u0301", "\u0300", "\u1100", "\u1161",
                   "\u11a8", "\uac00", "\uac01", "\xa9", "\U0001F600", "\u2764", "\U0001F3FB",
                   "\U0001F1E6", "\U0001F1E9", "\u0915", "\u0937", "\u094d", "\u09cd", "\u0995",
                   "\u093f", "\u0903", "\u0600", "\U000111C2", "\u0e33", "\ufe0f", "\u200c",
                   "\xad", "\u0915\u094d", "\u0995\u09cd", "\xa9\u200d", "\u1100\u1161",
                   "\U00016D63", "\U00011938"]


def test_precompiled_matches_the_library_on_random_clusters():
    """Seeded random texts over code points of every break class, through
    a charsmap that replaces every character (so a cluster under 6 bytes
    shows as one replacement): the port's ``Precompiled`` is the
    library's."""
    chars = {c for piece in GRAPHEME_PIECES for c in piece} - {"\r", "\n"}
    blob = charsmap_blob({c: f"<{ord(c):x}>" for c in chars})
    library = tokenizers.normalizers.Precompiled(blob)
    ours = charsmap.Precompiled(blob)
    rng = np.random.default_rng(31)
    texts = ["".join(GRAPHEME_PIECES[i]
                     for i in rng.integers(0, len(GRAPHEME_PIECES), rng.integers(1, 7)))
             for _ in range(6000)]
    bad = [t for t in texts if ours.normalize(t) != library.normalize_str(t)]
    assert bad == [], [[hex(ord(c)) for c in t] for t in bad[:5]]


# ---------------------------------------------------------------------------
# every code point through the port and the library
# ---------------------------------------------------------------------------


def _sweep(library, ours, item: str, separator: str) -> list:
    """Code points for which ``item.format(c)`` comes out of ``ours``
    otherwise than out of ``library`` (a chunk of them, joined by
    ``separator``, at a time)."""
    out = []
    points = [c for c in _ALL if chr(c) != separator]
    for lo in range(0, len(points), 8192):
        chunk = points[lo:lo + 8192]
        joined = separator.join(item.format(chr(c)) for c in chunk)
        if library(joined) != ours(joined):
            alone = [c for c in chunk if library(item.format(chr(c))) != ours(item.format(chr(c)))]
            # a difference only neighbours show: the chunk's range
            out += alone or [(chunk[0], chunk[-1])]
    return out


#: each option of the BERT normalizer alone, and the separator it leaves be
BERT_OPTIONS = {"strip_accents": "一", "handle_chinese_chars": "\n", "lowercase": "一",
                "clean_text": "一"}


@pytest.mark.parametrize("option", sorted(BERT_OPTIONS))
def test_bert_normalizer_matches_the_library_on_every_code_point(option):
    """``BertNormalizer`` with one option on: the port's (``bert_normalize``
    through ``build_normalizer``, the path of ``vocab.txt`` and
    ``tokenizer.json`` alike) is the library's on every code point, alone
    and after a letter."""
    spec = {"clean_text": False, "handle_chinese_chars": False, "strip_accents": False,
            "lowercase": False, option: True}
    library = tokenizers.normalizers.BertNormalizer(**spec).normalize_str
    ours = normalizers.build_normalizer({"type": "BertNormalizer", **spec})
    assert _sweep(library, ours, "a{}", BERT_OPTIONS[option]) == []


def _library_pieces(pre_tokenizer):
    return lambda text: [piece for piece, _ in pre_tokenizer.pre_tokenize_str(text)]


def _port_pieces(spec: dict):
    run = pre_tokenizers.build_pre_tokenizer(spec)
    return lambda text: [piece for piece, _ in run([(text, True)])]


#: pre-tokenizer -> (its spec, each code point's context)
PRE_TOKENIZER_SWEEPS = {
    "Digits": {"type": "Digits", "individual_digits": True},
    "Whitespace": {"type": "Whitespace"},
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZER_SWEEPS))
def test_pre_tokenizer_matches_the_library_on_every_code_point(name):
    """``Digits`` (``char::is_numeric``) and ``Whitespace`` (the ``regex``
    crate's ``\\w`` and ``\\s``): the port's pieces are the library's over
    every code point in order (a code point read into another class moves
    a piece's edge or splits it)."""
    spec = PRE_TOKENIZER_SWEEPS[name]
    library = getattr(tokenizers.pre_tokenizers, name)(
        **{k: v for k, v in spec.items() if k != "type"})
    assert _sweep(_library_pieces(library), _port_pieces(spec), "{}", "") == []


def test_single_word_matches_the_library_on_every_code_point(tmp_path):
    """An added token with ``single_word``: found, or not, between two of
    each code point as the library finds it (a word character on either
    side keeps it from matching)."""
    library = tokenizers.Tokenizer(tokenizers.models.WordLevel({"[UNK]": 0}, unk_token="[UNK]"))
    library.add_tokens([tokenizers.AddedToken("tok", single_word=True)])
    library.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text("{}")
    ours = tokenizer.HFTokenizer(str(tmp_path))

    def found_library(text):
        encoding = library.encode(text)
        return [start for (start, _), i in zip(encoding.offsets, encoding.ids) if i == 1]

    def found_ours(text):
        return [start for added, _, start in ours._split_added(text, ours._normalized_split)
                if added is not None]

    assert _sweep(found_library, found_ours, "{0}tok{0} ", "") == []


# ---------------------------------------------------------------------------
# the library's character tables (``scripts/torch_text_tables.py``)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_text_tables", os.path.join(REPO, "scripts", "torch_text_tables.py"))
generator = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(generator)


def _ranges(points) -> list:
    out: list = []
    for c in sorted(points):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return out


def _committed(name: str) -> set:
    return {c for lo, hi in port_text.table(name) for c in range(lo, hi + 1)
            if not 0xD800 <= c < 0xE000}


def test_library_tables_are_the_librarys():
    """The BERT normalizer's, ``StripAccents``' and ``BertPreTokenizer``'s
    tables are what the library gives now."""
    for name, points in generator.bert_tables().items():
        assert _ranges(_committed(name)) == _ranges(points), name


def _committed_graphemes() -> dict:
    return {name: {c for lo, hi in onig.decode(encoded) for c in range(lo, hi + 1)
                   if not 0xD800 <= c < 0xE000}
            for name, encoded in tables.GRAPHEMES.items()}


#: the rest of the generated tables, each probed again
TABLE_PROBES = {
    "NORMALIZATION_CUTS": lambda: generator.normalization_cuts(),
    "LOWERCASE": lambda: generator.lowercase_table(),
    "NUMERIC": lambda: generator.numeric_points(),
    "WORD": lambda: generator.whitespace_classes()[0],
    "SPACE": lambda: generator.whitespace_classes()[1],
    "GRAPHEMES": lambda: generator.cluster_tables(),
}


@pytest.mark.parametrize("name", sorted(TABLE_PROBES))
def test_text_tables_are_the_librarys(name):
    """Each table the generator writes is what the library gives now
    (``scripts/torch_text_tables.py --check`` in parts)."""
    probed = TABLE_PROBES[name]()
    if name == "LOWERCASE":
        assert tables.LOWERCASE == probed
    elif name == "GRAPHEMES":
        assert _committed_graphemes() == {k: set(v) for k, v in probed.items()}
    else:
        assert _ranges(_committed(name)) == _ranges(probed)


def test_text_tables_module_is_the_generators_rendering():
    """The committed module is the generator's rendering of its tables,
    byte for byte (so ``--check`` compares what the probes gave)."""
    committed = {name: _committed(name) for name in generator.SETS}
    committed.update(tokenizers=tokenizers.__version__, LOWERCASE=tables.LOWERCASE,
                     GRAPHEMES=_committed_graphemes())
    with open(generator.OUT, encoding="utf-8") as fh:
        assert generator.render(committed) == fh.read()
