"""The port's tokenizers against the JAX package's and ``transformers``'.

- ``HFTokenizer`` (``operator_tpu_torch/models/tokenizer.py``, which reads
  ``tokenizer.json`` itself) against the JAX ``HFTokenizer`` over
  ``AutoTokenizer`` on the committed SentencePiece-style fixture
  (``tests/torch_tokenizers/llama_sp``, trained here by
  :func:`llama_sp_files` on the fixture logs) and its layout variants
  (``Metaspace`` pre-tokenizer and decoder, string merges, ``lstrip`` /
  ``rstrip`` added tokens, no byte fallback);
- the same on the committed byte-level fixture
  (``tests/torch_tokenizers/llama3_bl``, Llama-3's layout trained by
  :func:`llama3_bl_files`: the ``Split`` + ``ByteLevel`` pre-tokenizer,
  BPE with ``ignore_merges``, the ``ByteLevel`` decoder, the specials at
  Llama-3's ids) and its variants (Qwen2.5's ``NFC`` normalizer and
  one-digit numbers, GPT-2's ``ByteLevel`` with its own expression, a
  prefix space, the instruct EOS), over the fixture lines and seeded
  random texts of many scripts, and random ids up to 128,256;
- the ``tokenizer.json`` features that need Unicode Script data (the
  ``UnicodeScripts`` pre-tokenizer, Script classes in an expression),
  which must give the JAX package's ids;
- ``load_tokenizer``'s ladder against the JAX one (a lone SentencePiece
  ``tokenizer.model`` included);
- the builtin BPE against the JAX one;
- ``WordPieceTokenizer`` against ``transformers.BertTokenizer``, the fast
  tokenizer ``AutoTokenizer`` builds, and so the JAX
  ``NeuralEmbedder.from_checkpoint`` tokenizer.

Every comparison is exact (token ids, strings, special ids).

    PYTHONPATH=. python tests/test_torch_tokenizer.py   # rewrite the fixtures
"""

import copy
import glob
import json
import os
import random
import re
import sys
from collections import Counter

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from operator_tpu.models import bpe as jax_bpe  # noqa: E402
from operator_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from operator_tpu_torch.models import bpe  # noqa: E402
from operator_tpu_torch.models import tokenizer  # noqa: E402
from operator_tpu_torch.models.wordpiece import WordPieceTokenizer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_LOGS = sorted(glob.glob(os.path.join(HERE, "fixtures", "*.log")))
LLAMA_SP = os.path.join(HERE, "torch_tokenizers", "llama_sp")
#: ``tokenizer_config.json`` of the fixture: TinyLlama's fields
LLAMA_SP_CONFIG = {
    "tokenizer_class": "LlamaTokenizer",
    "bos_token": "<s>",
    "eos_token": "</s>",
    "unk_token": "<unk>",
    "pad_token": None,
    "add_bos_token": True,
    "add_eos_token": False,
    "clean_up_tokenization_spaces": False,
    "legacy": False,
    "model_max_length": 2048,
}

LLAMA3_BL = os.path.join(HERE, "torch_tokenizers", "llama3_bl")
#: Llama-3's ``Split`` expression, and Qwen2.5's (numbers one digit at a time)
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                  r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = LLAMA3_PATTERN.replace(r"\p{N}{1,3}", r"\p{N}")
#: ``tokenizer_config.json`` of the fixture: Meta-Llama-3-8B's fields
LLAMA3_BL_CONFIG = {
    "bos_token": "<|begin_of_text|>",
    "clean_up_tokenization_spaces": True,
    "eos_token": "<|end_of_text|>",
    "model_input_names": ["input_ids", "attention_mask"],
    "model_max_length": 1000000000000000019884624838656,
    "tokenizer_class": "PreTrainedTokenizerFast",
}

EDGE_TEXTS = [
    "",
    " ",
    "  two leading spaces",
    "trailing spaces  ",
    "héllo wörld, ñandú, Ærøskøbing",
    "日本語のログ: 接続が拒否されました",
    "emoji 😀🚀 and a flag 🇩🇪",
    "ctrl \x00\x01\x07\x1b[31mred\x1b[0m\ttab\r\nCRLF\x7f",
    "no-break\xa0space and line separator",
    "<s>",
    "</s> after",
    "before <s> between </s> after",
    "a<s>b</s>c<unk>d",
    "<<s>> <s/> </s",
]


def fixture_lines() -> list:
    return [line for path in FIXTURE_LOGS
            for line in open(path, encoding="utf-8").read().splitlines()]


def llama_sp_spec(vocab_size: int = 4000) -> dict:
    """A SentencePiece-style BPE ``tokenizer.json`` (TinyLlama's layout:
    ``<unk> <s> </s>``, the 256 ``<0xNN>`` byte tokens, then merges;
    ``Prepend`` + ``Replace`` normalizer, byte fallback, ``fuse_unk``,
    the ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoder) trained
    with ``tokenizers`` on the fixture logs (every merge seen twice: 1,405
    tokens; ``vocab_size`` is a ceiling)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    specials = ["<unk>", "<s>", "</s>"]
    trainer = tokenizers.Tokenizer(models.BPE(unk_token="<unk>"))
    trainer.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    trainer.train_from_iterator(fixture_lines(), trainers.BpeTrainer(
        vocab_size=vocab_size, min_frequency=2, show_progress=False,
        special_tokens=specials + [f"<0x{b:02X}>" for b in range(256)]))
    trained = json.loads(trainer.to_str())
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [t for t in trained["added_tokens"] if t["content"] in specials],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
        ]},
        "pre_tokenizer": None,
        "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"},
            {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0},
        ]},
        "model": {**trained["model"], "fuse_unk": True, "byte_fallback": True},
    }
    Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def llama_sp_files(directory: str, spec: "dict | None" = None, config: "dict | None" = None) -> str:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec or llama_sp_spec(), fh, ensure_ascii=False, indent=1)
        fh.write("\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump(config or LLAMA_SP_CONFIG, fh, indent=1)
        fh.write("\n")
    return directory


def llama3_specials() -> list:
    """Llama-3's 256 special tokens at ids 128,000..128,255."""
    names = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(4)] + [
        "<|start_header_id|>", "<|end_header_id|>", "<|reserved_special_token_4|>",
        "<|eot_id|>"] + [f"<|reserved_special_token_{i}|>" for i in range(5, 251)]
    return [{"id": 128000 + i, "content": name, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, name in enumerate(names)]


def llama3_bl_spec(vocab_size: int = 4000) -> dict:
    """A byte-level BPE ``tokenizer.json`` in Meta-Llama-3-8B's layout
    (no normalizer; ``Split`` by Llama-3's expression, ``Isolated``, then
    ``ByteLevel`` without the prefix space or its own expression; BPE
    with ``ignore_merges``; the ``ByteLevel`` decoder and post-processor;
    the 256 specials at 128,000) trained with ``tokenizers`` on the
    fixture logs from the 256 byte characters up (1,740 ids: the logs run
    out of merges; ``vocab_size`` is a ceiling).  The library numbers
    added tokens after the model's vocab, so the vocab is filled up to
    Llama-3's 128,000 with tokens no text can produce (``"␀<id>"``: a
    byte-level pre-token holds only the 256 byte characters)."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    trainer = Tokenizer(models.BPE(ignore_merges=True))
    trainer.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ])
    trainer.decoder = decoders.ByteLevel()
    trainer.train_from_iterator(fixture_lines(), trainers.BpeTrainer(
        vocab_size=vocab_size, min_frequency=1, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    trained = json.loads(trainer.to_str())
    byte_level = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                  "use_regex": True}
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": llama3_specials(),
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
        "post_processor": {"type": "Sequence", "processors": [
            {**byte_level, "add_prefix_space": True, "use_regex": True, "trim_offsets": False},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {
                 "id": "<|begin_of_text|>", "ids": [128000], "tokens": ["<|begin_of_text|>"]}}},
        ]},
        "decoder": byte_level,
        "model": {**trained["model"], "ignore_merges": True, "byte_fallback": False,
                  "fuse_unk": False},
    }
    _fill_vocab(spec, 128000)
    Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def _fill_vocab(spec, size: int) -> None:
    vocab = spec["model"]["vocab"]
    vocab.update({f"\u2400{i}": i for i in range(len(vocab), size)})


def llama3_bl_files(directory: str, spec: "dict | None" = None,
                    config: "dict | None" = None) -> str:
    return llama_sp_files(directory, spec or llama3_bl_spec(), config or LLAMA3_BL_CONFIG)


def _variant(tmp_path, name: str, mutate) -> str:
    with open(os.path.join(LLAMA_SP, "tokenizer.json"), encoding="utf-8") as fh:
        spec = json.load(fh)
    config = copy.deepcopy(LLAMA_SP_CONFIG)
    mutate(spec, config)
    path = llama_sp_files(str(tmp_path / name), spec, config)
    special_map = config.pop("special_tokens_map", None)
    if special_map is not None:
        with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
            json.dump(config, fh)
        with open(os.path.join(path, "special_tokens_map.json"), "w", encoding="utf-8") as fh:
            json.dump(special_map, fh)
    return path


def _metaspace_first(spec, config):
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": False}


def _metaspace_decoder(spec, config):
    _metaspace_first(spec, config)
    spec["decoder"] = {"type": "Metaspace", "replacement": "▁",
                       "prepend_scheme": "first", "split": False}


def _metaspace_split(spec, config):
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}


def _string_merges(spec, config):
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]


def _strip_specials(spec, config):
    spec["added_tokens"] = [{**t, "lstrip": True, "rstrip": True} for t in spec["added_tokens"]]


def _unk_only(spec, config):
    spec["model"]["byte_fallback"] = False


def _clean_up_and_pad(spec, config):
    """``clean_up_tokenization_spaces`` on; the special tokens named in the
    config only, not in ``added_tokens``; ``special_tokens_map.json``
    overriding the config's pad token."""
    spec["added_tokens"] = []
    config.update(clean_up_tokenization_spaces=True, pad_token="<s>",
                  bos_token={"content": "<s>", "__type": "AddedToken"},
                  special_tokens_map={"pad_token": "<unk>"})


VARIANTS = {
    "committed": None,
    "metaspace_first": _metaspace_first,
    "metaspace_decoder": _metaspace_decoder,
    "metaspace_split": _metaspace_split,
    "string_merges": _string_merges,
    "strip_specials": _strip_specials,
    "unk_only": _unk_only,
    "clean_up_and_pad": _clean_up_and_pad,
}


def _bl_variant(tmp_path, name: str, mutate) -> str:
    with open(os.path.join(LLAMA3_BL, "tokenizer.json"), encoding="utf-8") as fh:
        spec = json.load(fh)
    config = copy.deepcopy(LLAMA3_BL_CONFIG)
    mutate(spec, config)
    return llama3_bl_files(str(tmp_path / name), spec, config)


def _qwen2_5(spec, config):
    """Qwen2.5's layout: the ``NFC`` normalizer, numbers one digit at a
    time, merges applied to every word, its own specials and config."""
    spec["normalizer"] = {"type": "NFC"}
    spec["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": QWEN2_PATTERN}
    spec["model"]["ignore_merges"] = False
    spec["post_processor"] = None
    _fill_vocab(spec, 151643)
    spec["added_tokens"] = [
        {"id": 151643 + i, "content": name, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for i, name in enumerate(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])]
    config.clear()
    config.update({"bos_token": None, "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
                   "unk_token": None, "clean_up_tokenization_spaces": False,
                   "tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 131072})


def _gpt2_byte_level(spec, config):
    """GPT-2's layout: ``ByteLevel`` alone, splitting by its own
    expression, merges applied to every word."""
    spec["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False,
                             "trim_offsets": True, "use_regex": True}
    spec["model"]["ignore_merges"] = False


def _prefix_space(spec, config):
    spec["pre_tokenizer"]["pretokenizers"][1]["add_prefix_space"] = True


def _instruct_eos(spec, config):
    config["eos_token"] = "<|eot_id|>"


BYTE_LEVEL_VARIANTS = {
    "committed": None,
    "qwen2_5": _qwen2_5,
    "gpt2_byte_level": _gpt2_byte_level,
    "prefix_space": _prefix_space,
    "instruct_eos": _instruct_eos,
}


def _many_scripts_texts(seed: int, n: int) -> list:
    """Seeded texts over letters of several scripts, non-ASCII digits,
    combining marks, emoji, contractions in both cases, CRLF, runs of
    whitespace and the specials."""
    rng = random.Random(seed)
    pieces = [
        "error", "Pod", "ÉCHEC", "straße", "Ωμέγα", "данные", "日本語", "중국어", "العربية",
        "हिन्दी", "ไทย", "שלום", "٣٤٥", "४२", "１２３", "²³", "Ⅻ", "½", "12345", "7",
        "e\u0301", "\u0308", "n\u0303o", "😀", "🚀🇩🇪", "👩‍💻", "'s", "'S", "'ll", "'LL",
        "'Re", "'ve", "'M", "'d", "don't", "I'M", "\r\n", "\n\n", "\r", "\t", "   ",
        " ", "  \t ", "\xa0", "\u2028", "\u3000", "\x1c", "\x00", ".", ",", "!?", "->",
        "==", "/var/log", "<|begin_of_text|>", "<|eot_id|>", "<|endoftext|>", "<|im_end|>",
        "<|reserved_special_token_7|>", "<|", "|>", "Ġ", "Ċ", "\ufffd",
    ]
    return ["".join(rng.choice(pieces) + rng.choice(["", " ", "", "\n"])
                    for _ in range(rng.randrange(0, 24))) for _ in range(n)]


def _random_texts(seed: int, n: int) -> list:
    rng = random.Random(seed)
    alphabet = list("abc xyz<>/s.:=,?!'") + [" .", " 's", " n't", " ,", " ' ",
        "<s>", "</s>", "<unk>", "▁", "é", "日", "😀", "\n", "\t", "\x00", "  ", "\xa0", "error"]
    return ["".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 30))) for _ in range(n)]


def test_committed_fixture_regenerates(tmp_path):
    fresh = llama_sp_files(str(tmp_path / "llama_sp"))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(fresh, name), "rb") as a, open(os.path.join(LLAMA_SP, name), "rb") as b:
            assert a.read() == b.read(), name
    spec = json.load(open(os.path.join(LLAMA_SP, "tokenizer.json"), encoding="utf-8"))
    assert len(spec["model"]["vocab"]) <= 32000
    assert all(f"<0x{b:02X}>" in spec["model"]["vocab"] for b in range(256))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hf_tokenizer_matches_the_jax_tokenizer(tmp_path, variant):
    mutate = VARIANTS[variant]
    path = LLAMA_SP if mutate is None else _variant(tmp_path, variant, mutate)
    want = jax_tokenizer.HFTokenizer(path)
    got = tokenizer.HFTokenizer(path)
    assert (got.vocab_size, got.bos_id, got.eos_id, got.pad_id) == (
        want.vocab_size, want.bos_id, want.eos_id, want.pad_id)
    texts = fixture_lines() + EDGE_TEXTS + _random_texts(len(variant), 200)
    for text in texts:
        for add_bos in (True, False):
            ids = want.encode(text, add_bos=add_bos)
            assert got.encode(text, add_bos=add_bos) == ids, (text, add_bos)
        assert got.decode(ids) == want.decode(ids), text
    rng = random.Random(0)
    for _ in range(200):  # arbitrary ids, beyond the vocab included
        ids = [rng.randrange(0, got.vocab_size + 8) for _ in range(rng.randrange(0, 40))]
        assert got.decode(ids) == want.decode(ids), ids


def test_committed_byte_level_fixture_regenerates(tmp_path):
    fresh = llama3_bl_files(str(tmp_path / "llama3_bl"))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(fresh, name), "rb") as a, open(os.path.join(LLAMA3_BL, name), "rb") as b:
            assert a.read() == b.read(), name
    spec = json.load(open(os.path.join(LLAMA3_BL, "tokenizer.json"), encoding="utf-8"))
    assert spec["model"]["ignore_merges"] and not spec["model"]["byte_fallback"]
    ids = {t["content"]: t["id"] for t in spec["added_tokens"]}
    assert (ids["<|begin_of_text|>"], ids["<|end_of_text|>"], ids["<|eot_id|>"]) == (
        128000, 128001, 128009)
    assert len(ids) == 256
    assert len(spec["model"]["vocab"]) == 128000


@pytest.mark.parametrize("variant", sorted(BYTE_LEVEL_VARIANTS))
def test_byte_level_tokenizer_matches_the_jax_tokenizer(tmp_path, variant):
    mutate = BYTE_LEVEL_VARIANTS[variant]
    path = LLAMA3_BL if mutate is None else _bl_variant(tmp_path, variant, mutate)
    want = jax_tokenizer.HFTokenizer(path)
    got = tokenizer.HFTokenizer(path)
    assert (got.vocab_size, got.bos_id, got.eos_id, got.pad_id) == (
        want.vocab_size, want.bos_id, want.eos_id, want.pad_id)
    texts = (fixture_lines() + EDGE_TEXTS + _many_scripts_texts(len(variant), 300)
             + _random_texts(len(variant), 100))
    for text in texts:
        for add_bos in (True, False):
            ids = want.encode(text, add_bos=add_bos)
            assert got.encode(text, add_bos=add_bos) == ids, (text, add_bos)
        assert got.decode(ids) == want.decode(ids), text
    rng = random.Random(1)
    for _ in range(300):  # ids the tokenizer lacks (a seeded 128,256-id model samples them)
        ids = [rng.randrange(0, 128256) for _ in range(rng.randrange(0, 40))]
        ids += [rng.randrange(0, got.vocab_size) for _ in range(rng.randrange(0, 20))]
        rng.shuffle(ids)
        assert got.decode(ids) == want.decode(ids), ids


def _unicode_scripts(spec, config):
    spec["pre_tokenizer"]["pretokenizers"].insert(0, {"type": "UnicodeScripts"})


def _han_class(spec, config):
    spec["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": r"\p{Han}+|" + LLAMA3_PATTERN}


def _greek_replace(spec, config):
    spec["normalizer"] = {"type": "Replace", "pattern": {"Regex": r"\p{Greek}"}, "content": "?"}


#: the features that once waited on Unicode Script data (ROADMAP Queue 1
#: item 4d), now read from the library's own tables
SCRIPT_FEATURES = {
    "unicode_scripts_pre_tokenizer": _unicode_scripts,
    "han_class": _han_class,
    "greek_class_replace": _greek_replace,
}


@pytest.mark.parametrize("case", sorted(SCRIPT_FEATURES))
def test_a_script_feature_gives_the_jax_tokenizers_ids(tmp_path, case):
    """The ``UnicodeScripts`` pre-tokenizer and Script classes in an
    expression (a ``Split``, a ``Replace`` normalizer), through
    ``HFTokenizer`` and ``load_tokenizer``, give the JAX ``HFTokenizer``'s
    ids (over ``AutoTokenizer``) on texts of many scripts."""
    path = _bl_variant(tmp_path, case, SCRIPT_FEATURES[case])
    want = jax_tokenizer.HFTokenizer(path)
    texts = (fixture_lines()[:40] + EDGE_TEXTS + _many_scripts_texts(len(case), 120)
             + ["Hello中文abc Ελληνικά ひらがなカタカナー 123!", " 漢字かなカナ ー Ωμέγα"])
    for load in (tokenizer.HFTokenizer, tokenizer.load_tokenizer):
        got = load(path)
        assert type(got).__name__ == "HFTokenizer"
        for text in texts:
            assert got.encode(text, add_bos=False) == want.encode(text, add_bos=False), text


def _sentencepiece_model_only(directory: str) -> str:
    """A valid SentencePiece ``tokenizer.model`` (the ``llama_sp`` vocab,
    written with the protobuf schema ``transformers`` bundles) and a
    ``LlamaTokenizer`` config, without ``tokenizer.json``."""
    from transformers.utils import sentencepiece_model_pb2_new as sp

    os.makedirs(directory)
    spec = json.load(open(os.path.join(LLAMA_SP, "tokenizer.json"), encoding="utf-8"))
    model = sp.ModelProto()
    kinds = {"<unk>": model.SentencePiece.UNKNOWN, "<s>": model.SentencePiece.CONTROL,
             "</s>": model.SentencePiece.CONTROL}
    for piece, i in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1]):
        entry = model.pieces.add()
        entry.piece, entry.score = piece, -float(i)
        entry.type = kinds.get(piece, model.SentencePiece.BYTE if re.fullmatch(
            r"<0x[0-9A-F]{2}>", piece) else model.SentencePiece.NORMAL)
    model.trainer_spec.model_type = sp.TrainerSpec.BPE
    model.trainer_spec.byte_fallback = True
    model.normalizer_spec.add_dummy_prefix = True
    with open(os.path.join(directory, "tokenizer.model"), "wb") as fh:
        fh.write(model.SerializeToString())
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump(LLAMA_SP_CONFIG, fh)
    return directory


@pytest.mark.parametrize("spec", ["byte", "builtin-bpe", "directory", "byte-level-directory",
                                  "empty-directory", "tokenizer-model-only", None])
def test_load_tokenizer_ladder_matches_jax(tmp_path, spec, caplog):
    """Each rung as the JAX package takes it; a lone SentencePiece
    ``tokenizer.model`` is the byte fallback with the reference's warning
    (its ``transformers`` has no ``sentencepiece`` to read it)."""
    path = {"directory": LLAMA_SP, "byte-level-directory": LLAMA3_BL,
            "empty-directory": str(tmp_path)}.get(spec, spec)
    if spec == "tokenizer-model-only":
        path = _sentencepiece_model_only(str(tmp_path / "sp"))
        for load in (tokenizer.HFTokenizer, jax_tokenizer.HFTokenizer):
            with pytest.raises(Exception):
                load(path)
    with caplog.at_level("WARNING"):
        want = jax_tokenizer.load_tokenizer(path)
    warned = [r.getMessage() for r in caplog.records if "failed to load tokenizer" in r.getMessage()]
    caplog.clear()
    with caplog.at_level("WARNING"):
        got = tokenizer.load_tokenizer(path)
    assert [r.getMessage() for r in caplog.records
            if "failed to load tokenizer" in r.getMessage()] == warned
    assert type(got).__name__ == type(want).__name__
    assert (got.vocab_size, got.bos_id, got.eos_id, got.pad_id) == (
        want.vocab_size, want.bos_id, want.eos_id, want.pad_id)
    for text in fixture_lines()[:20] + EDGE_TEXTS:
        assert got.encode(text) == want.encode(text)


def test_builtin_bpe_matches_jax():
    got, want = bpe.BPETokenizer.load_builtin(), jax_bpe.BPETokenizer.load_builtin()
    assert got.merges == want.merges and got.vocab_size == want.vocab_size
    for text in fixture_lines() + EDGE_TEXTS:
        ids = want.encode(text)
        assert got.encode(text) == ids
        assert got.decode(ids) == want.decode(ids)
    corpus = [open(p, encoding="utf-8").read() for p in FIXTURE_LOGS]
    assert bpe.train_bpe(corpus, 600) == jax_bpe.train_bpe(corpus, 600)


def _bert_vocab() -> list:
    """Specials, then characters, ``##`` characters, the fixture logs'
    frequent words and a few subword pieces."""
    lines = fixture_lines()
    words = Counter(w for line in lines for w in re.findall(r"[a-z0-9]+", line.lower()))
    chars = sorted({c for line in lines for c in line.lower()} | set("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
    vocab += ["##" + c for c in chars] + [w for w, _ in words.most_common(300)]
    vocab += ["##ing", "##ed", "##s", "hello", "日", "本", "cafe"]
    return list(dict.fromkeys(vocab))


@pytest.mark.parametrize("lower", [True, False])
def test_wordpiece_matches_bert_tokenizers(tmp_path, lower):
    (tmp_path / "vocab.txt").write_text("\n".join(_bert_vocab()) + "\n", encoding="utf-8")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": lower, "tokenizer_class": "BertTokenizer", "model_max_length": 512}))
    slow = transformers.BertTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    fast = transformers.AutoTokenizer.from_pretrained(str(tmp_path), local_files_only=True)
    got = WordPieceTokenizer.from_dir(str(tmp_path))
    rng = random.Random(3)
    alphabet = list("abcXYZ .,!?-_'\"()[]#") + [
        "[CLS]", "[SEP]", "[cls]", "é", "É", "Café", "日本", "😀", "\x00", "\t", "\n", "\xa0",
        "​", "ﬁ", "Ⅻ", "a" * 120, "İ", "ǅ", "�", "¿", "«»", "—", "hello", "ing"]
    texts = fixture_lines() + EDGE_TEXTS + [
        "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 14))) for _ in range(400)]
    for text in texts:
        ids = fast.encode(text, add_special_tokens=True)
        assert got.encode(text) == ids, text
        assert slow.encode(text, add_special_tokens=True) == ids, text
    assert got.encode("pod crashed", add_special_tokens=False) == fast.encode(
        "pod crashed", add_special_tokens=False)


if __name__ == "__main__":
    sys.exit(print(llama_sp_files(LLAMA_SP), llama3_bl_files(LLAMA3_BL)))
