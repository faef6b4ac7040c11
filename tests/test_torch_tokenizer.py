"""The port's tokenizers against the JAX package's and ``transformers``'.

- ``HFTokenizer`` (``operator_tpu_torch/models/tokenizer.py``, which reads
  ``tokenizer.json`` itself) against the JAX ``HFTokenizer`` over
  ``AutoTokenizer`` on the committed SentencePiece-style fixture
  (``tests/torch_tokenizers/llama_sp``, trained here by
  :func:`llama_sp_files` on the fixture logs), its layout variants
  (``Metaspace`` pre-tokenizer and decoder, string merges, ``lstrip`` /
  ``rstrip`` added tokens, no byte fallback) and a byte-level tokenizer,
  which must raise ``NotImplementedError`` naming ROADMAP Queue 1 item 4a;
- ``load_tokenizer``'s ladder against the JAX one;
- the builtin BPE against the JAX one;
- ``WordPieceTokenizer`` against ``transformers.BertTokenizer``, the fast
  tokenizer ``AutoTokenizer`` builds, and so the JAX
  ``NeuralEmbedder.from_checkpoint`` tokenizer.

Every comparison is exact (token ids, strings, special ids).

    PYTHONPATH=. python tests/test_torch_tokenizer.py   # rewrite the fixture
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


def test_a_byte_level_tokenizer_raises_naming_item_4a(tmp_path):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    byte_level = Tokenizer(models.BPE())
    byte_level.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    byte_level.decoder = decoders.ByteLevel()
    byte_level.train_from_iterator(fixture_lines(), trainers.BpeTrainer(
        vocab_size=400, show_progress=False, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    path = tmp_path / "byte_level"
    path.mkdir()
    byte_level.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>"}))
    jax_tokenizer.HFTokenizer(str(path))  # the JAX package reads it
    for load in (tokenizer.HFTokenizer, tokenizer.load_tokenizer):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4a"):
            load(str(path))


@pytest.mark.parametrize("spec", ["byte", "builtin-bpe", "directory", "empty-directory", None])
def test_load_tokenizer_ladder_matches_jax(tmp_path, spec):
    path = {"directory": LLAMA_SP, "empty-directory": str(tmp_path)}.get(spec, spec)
    want = jax_tokenizer.load_tokenizer(path)
    got = tokenizer.load_tokenizer(path)
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
    sys.exit(print(llama_sp_files(LLAMA_SP)))
