"""Each ``tokenizer.json`` component the port reads, against the JAX package.

One case per component (and per option that changes what it does), each
a variant of a committed fixture (``llama_sp``, ``llama3_bl``,
``minilm_wordpiece``, ``xlmr_unigram``) loaded by the port's
``HFTokenizer`` and the JAX ``HFTokenizer`` over ``AutoTokenizer``, held
equal on the special ids, ``vocab_size``, ``encode`` with and without BOS,
``encode`` with the post-processor's specials (against ``AutoTokenizer``)
and ``decode``; BPE dropout as the library draws it; the library's
character tables the port keeps a copy of; and where Python's ``unicodedata``
(Unicode 15.0) and the library's tables (Rust's) disagree, or no longer do
(expression classes, read from the library's own Oniguruma data).
"""

import copy
import json
import math
import os
import random
import sys
import unicodedata

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from operator_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from operator_tpu_torch.models import tokenizer  # noqa: E402
from operator_tpu_torch.models.tokenization import charsmap, text as port_text  # noqa: E402
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


#: form -> the code points (ranges) whose result differs: the library's
#: normalization tables are older than Python's for NFKC and NFD (the
#: compatibility mappings of Unicode 12.1-14.0's modifier letters and
#: digits, U+11938's decomposition) and newer for case (16.0's letters)
NORMALIZATION_DIFFERENCES = {
    "Lowercase": [[0x1C89, 0x1C89], [0xA7CB, 0xA7CC], [0xA7CE, 0xA7CE], [0xA7D2, 0xA7D2],
                  [0xA7D4, 0xA7D4], [0xA7DA, 0xA7DA], [0xA7DC, 0xA7DC], [0x10D50, 0x10D65],
                  [0x16EA0, 0x16EB8]],
    "NFKC": [[0x32FF, 0x32FF], [0xA7F2, 0xA7F4], [0xAB69, 0xAB69], [0x10781, 0x10785],
             [0x10787, 0x107B0], [0x107B2, 0x107BA], [0x1E030, 0x1E06D], [0x1F16C, 0x1F16C],
             [0x1FBF0, 0x1FBF9]],
    "NFD": [[0x11938, 0x11938]],
}


def _differences(library, ours) -> list:
    """Code points whose result differs, each normalized alone (a chunk
    joined by NUL first, which neither composes nor reorders)."""
    out = []
    for lo in range(0, len(_ALL), 8192):
        chunk = _ALL[lo:lo + 8192]
        joined = "\0".join(map(chr, chunk))
        if library(joined) != ours(joined):
            out += [c for c in chunk if library(chr(c)) != ours(chr(c))]
    return out


@pytest.mark.parametrize("form", sorted(NORMALIZATION_DIFFERENCES))
def test_normalization_differs_by_version(form):
    """NFKC, NFD and per-character lowercasing code point by code point:
    where the library's tables and Python's ``unicodedata`` disagree
    (ROADMAP Queue 3)."""
    library = getattr(tokenizers.normalizers, form)().normalize_str
    ours = ((lambda s: "".join(c.lower() for c in s)) if form == "Lowercase"
            else (lambda s: unicodedata.normalize(form, s)))
    assert _ranges(_differences(library, ours)) == NORMALIZATION_DIFFERENCES[form]


def test_grapheme_extension_differs_only_by_version():
    """Which code points join the grapheme cluster of a letter before
    them (Extend, ZWJ, SpacingMark), read through the library's
    ``Precompiled`` (a cluster under 6 bytes that starts with a key is
    replaced whole): the port's clusters agree but on 51 code points
    Python 15.0 leaves unassigned (ROADMAP Queue 3).  Planes 0, 1 and 14
    are read: planes 2 and 3 hold ideographs only, 4 to 13 nothing, 15
    and 16 private use."""
    library = tokenizers.normalizers.Precompiled(charsmap_blob({"a": "A"}))
    points = [c for c in _ALL if (c < 0x20000 or 0xE0000 <= c < 0xF0000) and chr(c) not in "\r\n"]
    joined = set()
    for lo in range(0, len(points), 8192):
        chunk = points[lo:lo + 8192]
        pieces = library.normalize_str("\n".join("a" + chr(c) for c in chunk)).split("\n")
        joined.update(c for c, piece in zip(chunk, pieces) if piece == "A")
    ours = {c for c in points if len(charsmap.graphemes("a" + chr(c))) == 1}
    assert ours <= joined and _cn(joined - ours)
    assert len(joined - ours) == 51


# ---------------------------------------------------------------------------
# the library's character tables (``unicode_categories``, an older Unicode)
# ---------------------------------------------------------------------------

TABLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "operator_tpu_torch", "models", "tokenization", "tables.py")


def _probe(normalize, keep) -> set:
    """The code points ``keep(code point, its normalized text)`` selects,
    each normalized alone (a CJK ideograph between them, which none of
    the probes changes)."""
    out = set()
    points = [c for c in _ALL if c != 0x4E00]
    for lo in range(0, len(points), 8192):
        chunk = points[lo:lo + 8192]
        pieces = normalize("一".join(map(chr, chunk))).split("一")
        assert len(pieces) == len(chunk)
        out.update(c for c, piece in zip(chunk, pieces) if keep(c, piece))
    return out


def library_tables() -> dict:
    """``StripAccents``' non-spacing marks, what ``BertNormalizer``'s
    ``clean_text`` drops, and what ``BertPreTokenizer`` isolates (ASCII
    punctuation and ``unicode_categories``' punctuation)."""
    from tokenizers import normalizers, pre_tokenizers

    bert_clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                            strip_accents=False, lowercase=False)
    punctuation = pre_tokenizers.Punctuation(behavior="removed")

    def without_punctuation(text):
        return "".join(piece for piece, _ in punctuation.pre_tokenize_str(text))

    return {
        "MARK_NONSPACING": _probe(normalizers.StripAccents().normalize_str, lambda c, p: p == ""),
        "BERT_CONTROL": _probe(bert_clean.normalize_str, lambda c, p: p == ""),
        "PUNCTUATION": _probe(without_punctuation, lambda c, p: p == ""),
    }


def _ranges(points: set) -> list:
    out: list = []
    for c in sorted(points):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return out


def write_tables(path: str = TABLES) -> None:
    """Rewrite the port's copy of the library's tables."""
    lines = ['"""Character tables of the ``tokenizers`` library, as code point ranges.',
             "",
             "The library takes these predicates from the ``unicode_categories`` crate,",
             "whose tables are of an older Unicode (and shifted against it in places),",
             "so ``unicodedata`` cannot stand in for them:",
             "",
             "- ``MARK_NONSPACING``: ``is_mark_nonspacing`` (``StripAccents``, the BERT",
             "  normalizer's accent stripping);",
             "- ``BERT_CONTROL``: what the BERT normalizer's ``clean_text`` drops (NUL,",
             "  U+FFFD and ``is_other`` but tab, line feed and carriage return);",
             "- ``PUNCTUATION``: ASCII punctuation and ``is_punctuation``",
             "  (``BertPreTokenizer``, ``Punctuation``).",
             "",
             "Generated from the library by ``PYTHONPATH=. python",
             "tests/test_torch_tokenizer_components.py``; a test holds it to the library.",
             '"""',
             "",
             "from __future__ import annotations",
             ""]
    for name, points in library_tables().items():
        lines.append(f"{name} = (")
        row = "   "
        for lo, hi in _ranges(points):
            item = f" (0x{lo:X}, 0x{hi:X}),"
            if len(row) + len(item) > 99:
                lines.append(row)
                row = "   "
            row += item
        lines += [row, ")", ""]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines))


def test_library_tables_are_the_librarys():
    from operator_tpu_torch.models.tokenization import tables

    for name, points in library_tables().items():
        assert [list(r) for r in getattr(tables, name)] == _ranges(points), name


if __name__ == "__main__":
    sys.exit(write_tables())
