"""The two tokenizer families beyond BPE against the JAX package's.

- ``tests/torch_tokenizers/minilm_wordpiece``: the ``tokenizer.json`` a
  sentence-transformers MiniLM checkpoint ships (WordPiece behind
  ``BertNormalizer`` and ``BertPreTokenizer``, the ``[CLS] $A [SEP]``
  template, the ``WordPiece`` decoder; ``BertTokenizer`` config), its
  vocab built from the fixture logs by :func:`minilm_vocab`;
- ``tests/torch_tokenizers/xlmr_unigram``: XLM-RoBERTa's layout
  (``XLMRobertaTokenizer`` config): a Unigram model trained by the
  library's ``UnigramTrainer`` on the fixture logs, with byte fallback,
  behind ``Precompiled`` (a charsmap of a few hundred rules written by
  :func:`charsmap_blob`, a darts-clone double array) and ``Replace(Regex
  " {2,}")`` and ``Metaspace``.  The trainer is not deterministic (its
  scores differ in the last bits between runs), so the committed model is
  held to ``AutoTokenizer`` through ``expected_ids.json`` and the layout
  around it is regenerated byte for byte;
- ``tests/torch_tokenizers/onig_logs``: a log tokenizer whose ``Split``
  expression only the port's own Oniguruma matcher runs (a recursive call
  for balanced brackets, the absent operator for a quoted string, a
  back reference under ``(?i)``, an unbounded look-behind, ``\\y``): a
  BPE model with byte fallback trained by the library on the fixture
  logs behind it; its ``expected_ids.json`` also names a prompt on which
  the library gives up (its retry limit), where the port's tokenizer
  raises ``RetryLimitError``;

each over the fixture lines, the edge texts and seeded texts of many
scripts (``encode`` with and without BOS, ``encode`` with the
post-processor's specials, ``decode`` of those ids and of seeded random
ids, the special ids and ``vocab_size``), every comparison exact; and the
encoder's tokenizer against ``operator_tpu/patterns/semantic.py``'s on
three checkpoint layouts.

    PYTHONPATH=. python tests/test_torch_tokenizer_families.py   # rewrite both
"""

import base64
import dataclasses
import json
import os
import random
import shutil
import struct
import sys
import unicodedata
from collections import Counter

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from operator_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from operator_tpu_torch.models import tokenizer  # noqa: E402
from test_torch_tokenizer import (EDGE_TEXTS, HERE, _many_scripts_texts,  # noqa: E402
                                  fixture_lines)

MINILM_WORDPIECE = os.path.join(HERE, "torch_tokenizers", "minilm_wordpiece")
ONIG_LOGS = os.path.join(HERE, "torch_tokenizers", "onig_logs")
XLMR_UNIGRAM = os.path.join(HERE, "torch_tokenizers", "xlmr_unigram")
XLMR_SCRIPTS = os.path.join(HERE, "torch_tokenizers", "xlmr_scripts")

#: the prompts whose ids ``expected_ids.json`` keeps (the card has no
#: ``tokenizers``: ``chip_smoke.py`` serves these and checks against it)
PROMPTS = [
    "Pod crashed OOMKilled",
    "java.lang.OutOfMemoryError: Java heap space at com.example.Cache.put(Cache.java:42)",
    "Back-off restarting failed container api in pod api-7d9f  (exit code 137)",
    "ＦＵＬＬ－ＷＩＤＴＨ ｌｏｇ ｌｉｎｅ：　ｅｒｒｏｒ ①②③ Ⅻ ﬁle ﬂag",
    "no\xa0break\u200bzero width and a soft\xadhyphen, cafe\u0301 re\u0301sume\u0301",
    "日本語のログ: 接続が拒否されました ｶﾞｲﾄﾞ",
    "emoji 😀🚀 👩\u200d💻 and a flag 🇩🇪 — données, straße, Ωμέγα",
    "panic: runtime error: index out of range [5] with length 3\n\ngoroutine 1 [running]:",
    "   leading spaces and    runs   of spaces   ",
    "<s> specials </s> <mask> <unk> [CLS] [SEP] [MASK] inside",
    "Liveness probe failed: HTTP probe failed with statuscode: 503",
    "",
]

#: the Script-aware fixture's prompts: the ones above and lines of many
#: scripts, where its ``UnicodeScripts`` and ``\\p{Han}``-style splits act
SCRIPT_PROMPTS = PROMPTS[:-1] + [
    "Hello中文abc Ελληνικά ひらがなカタカナー 123!",
    "节点 node-7 内存不足 (OOMKilled)，容器已重启 3 次",
    "ошибка: не удалось подключиться к базе данных postgres:5432",
    "خطأ في الاتصال بالخادم: انتهت المهلة بعد 30 ثانية",
    "त्रुटि: डिस्क भर गई है /var/lib/kubelet",
    "컨테이너 api 가 충돌했습니다 CrashLoopBackOff 상태",
    "Σφάλμα δικτύου στο pod web-0; δοκιμή ξανά σε 5s",
    "",
]
#: the log fixture's prompts: lines where each construct of its expression
#: acts (brackets, quotes, stretched letters, key=value, emoji)
LOG_PROMPTS = [
    "at com.acme.Foo.bar(Foo.java:42) [main] ERROR db=prod msg=\"conn (refused)\" AAAaargh "
    "\U0001F469\u200d\U0001F4BB done",
    "Pod crashed OOMKilled",
    "java.lang.OutOfMemoryError: Java heap space at com.example.Cache.put(Cache.java:42)",
    "Back-off restarting failed container api in pod api-7d9f  (exit code 137)",
    "level=error ts=2024-05-01T12:00:00Z caller=main.go:88 msg=\"listen tcp :8080: bind\"",
    "panic: runtime error: index out of range [5] with length 3\n\ngoroutine 1 [running]:",
    "readiness: probe=[http (get /healthz) [port 8080]] status: FAILED  retries= 3",
    "Nooooo!!! disk full, sooo sloooow \U0001F525\U0001F525 retry `kubectl logs`",
    "emoji \U0001F600\U0001F680 \U0001F469\u200d\U0001F4BB and a flag \U0001F1E9\U0001F1EA "
    "\u2014 données, straße",
    "Liveness probe failed: HTTP probe failed with statuscode: 503",
    "unbalanced ((( brackets ]] and \"an open quote",
    "",
]
#: a line on which the library gives up (its retry limit): an open
#: backquote before six words, which the ``\`(?:\w+\s?)*\``` branch
#: splits every way before it fails
LOG_GIVES_UP = "ERROR volume `data was not found for pod web on node worker after retry"
#: texts where Python's Unicode data and the library's differ: Devanagari
#: and Bengali spacing vowel signs (which the BERT normalizer's accent
#: stripping keeps), an ideograph of U+2B8xx (which it does not space),
#: Unicode 16.0 capitals and digits, U+11938 (which the library's NFD does
#: not decompose); the WordPiece fixture's vocabulary holds their pieces
UNICODE_PROMPTS = [
    "दुनिया কাজ error: डिस्क भर गई",
    "log\U0002B823line \U0002B8FF end",
    "\u1C89 TJE \uA7CB \U00010D50 digits \U00010D40\U00010D41",
    "pod \U0001190C\U00011938 ok",
]
#: the prompts each fixture's ``expected_ids.json`` keeps
FIXTURE_PROMPTS = {XLMR_SCRIPTS: SCRIPT_PROMPTS, ONIG_LOGS: LOG_PROMPTS,
                   MINILM_WORDPIECE: PROMPTS + UNICODE_PROMPTS}

#: ``tokenizer_config.json`` of all-MiniLM-L6-v2
MINILM_CONFIG = {
    "clean_up_tokenization_spaces": True,
    "cls_token": "[CLS]",
    "do_basic_tokenize": True,
    "do_lower_case": True,
    "mask_token": "[MASK]",
    "model_max_length": 512,
    "never_split": None,
    "pad_token": "[PAD]",
    "sep_token": "[SEP]",
    "strip_accents": None,
    "tokenize_chinese_chars": True,
    "tokenizer_class": "BertTokenizer",
    "unk_token": "[UNK]",
}
#: ``tokenizer_config.json`` of xlm-roberta-base
XLMR_CONFIG = {
    "bos_token": "<s>",
    "clean_up_tokenization_spaces": True,
    "cls_token": "<s>",
    "eos_token": "</s>",
    "mask_token": {"__type": "AddedToken", "content": "<mask>", "lstrip": True,
                   "normalized": True, "rstrip": False, "single_word": False},
    "model_max_length": 512,
    "pad_token": "<pad>",
    "sep_token": "</s>",
    "tokenizer_class": "XLMRobertaTokenizer",
    "unk_token": "<unk>",
}


def _special(token_id: int, content: str, **extra) -> dict:
    return {"id": token_id, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True, **extra}


def _write(directory: str, spec: dict, config: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False, indent=1)
        fh.write("\n")
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump(config, fh, indent=1)
        fh.write("\n")
    return directory


# ---------------------------------------------------------------------------
# the WordPiece fixture
# ---------------------------------------------------------------------------


def minilm_vocab() -> list:
    """MiniLM's layout (``[PAD]``, 99 ``[unusedN]``, ``[UNK] [CLS] [SEP]
    [MASK]`` at 100..103), then the fixture logs' characters (lowercased,
    accents stripped, and a few of other scripts), their ``##`` pieces,
    the 1,500 most frequent words (ties by spelling) and some suffixes;
    last the words of :data:`UNICODE_PROMPTS` as the library reads them,
    and every character of those and of the texts as written, alone and
    as ``##`` pieces (so a text read otherwise gets other ids, not
    ``[UNK]``)."""
    lines = [tokenizer_words(line) for line in fixture_lines()]
    words = Counter(w for line in lines for w in line)
    chars = sorted({c for line in lines for w in line for c in w} | set("日本語ωμέγαß"))
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += chars + ["##" + c for c in chars]
    vocab += sorted(words, key=lambda w: (-words[w], w))[:1500]
    vocab += ["##ing", "##ed", "##s", "##er", "##tion", "##ly", "cafe", "resume", "##able"]
    unicode_words = [w for text in UNICODE_PROMPTS for w in library_words(text)]
    unicode_chars = sorted({c for text in UNICODE_PROMPTS for c in text if not c.isspace()}
                           | {c for w in unicode_words for c in w})
    vocab += unicode_words + unicode_chars + ["##" + c for c in unicode_chars]
    return list(dict.fromkeys(vocab))


def library_words(text: str) -> list:
    """The library's BERT normalizer (all-MiniLM-L6-v2's options) and
    pre-tokenizer on ``text``."""
    normalizer = tokenizers.normalizers.BertNormalizer(
        clean_text=True, handle_chinese_chars=True, strip_accents=None, lowercase=True)
    return [w for w, _ in tokenizers.pre_tokenizers.BertPreTokenizer().pre_tokenize_str(
        normalizer.normalize_str(text))]


def tokenizer_words(text: str) -> list:
    from operator_tpu_torch.models.wordpiece import bert_normalize, bert_words

    return bert_words(bert_normalize(text))


def minilm_wordpiece_spec() -> dict:
    vocab = {token: i for i, token in enumerate(minilm_vocab())}
    specials = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [_special(i, name) for name, i in specials.items()],
        "normalizer": {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
                       "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {
                "[CLS]": {"id": "[CLS]", "ids": [101], "tokens": ["[CLS]"]},
                "[SEP]": {"id": "[SEP]", "ids": [102], "tokens": ["[SEP]"]}}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }
    tokenizers.Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def minilm_wordpiece_files(directory: str, spec: "dict | None" = None,
                           config: "dict | None" = None) -> str:
    return _write(directory, spec or minilm_wordpiece_spec(), config or MINILM_CONFIG)


# ---------------------------------------------------------------------------
# the Unigram fixture and its charsmap
# ---------------------------------------------------------------------------


def charsmap_rules() -> dict:
    """NFKC's rules for full-width ASCII, circled numbers, Roman numerals,
    ligatures, the wide spaces, super- and subscripts and half-width
    katakana; NBSP to a space; zero-width space, BOM and soft hyphen to
    nothing; and multi-character keys (a letter and its combining accent
    to the composed letter, one within a grapheme cluster under 6 bytes,
    one of 6)."""
    rules = {}
    for lo, hi in ((0xFF01, 0xFF5E), (0x2460, 0x2473), (0x2160, 0x216B), (0xFB00, 0xFB06),
                   (0x2000, 0x200A), (0x00B2, 0x00B3), (0x00B9, 0x00B9), (0x00BC, 0x00BE),
                   (0x2070, 0x2079), (0x2080, 0x2089), (0x3000, 0x3000), (0xFF61, 0xFF9F)):
        for cp in range(lo, hi + 1):
            char = chr(cp)
            norm = unicodedata.normalize("NFKC", char)
            if norm != char:
                rules[char] = norm
    rules.update({"\xa0": " ", "\u200b": "", "\ufeff": "", "\xad": "",
                  "e\u0301": "é", "a\u030a": "å", "ｶﾞ": "ガ"})
    return rules


def charsmap_blob(rules: dict) -> bytes:
    """SentencePiece's compiled charsmap: a ``u32`` byte size, a
    darts-clone double array over the keys' UTF-8 bytes (a unit holds its
    label in bits 0-7, a has-leaf flag in bit 8 and the XOR offset to its
    children from bit 10; a leaf unit, at offset ^ 0, holds the value with
    bit 31 set), and the NUL-ended values it points into.  Each node gets
    a base of its own, the first free one, breadth first."""
    strings = bytearray()
    offsets = {}
    for key in sorted(rules):
        offsets[key] = len(strings)
        strings += rules[key].encode("utf-8") + b"\0"
    root: dict = {}
    for key in rules:
        node = root
        for byte in key.encode("utf-8"):
            node = node.setdefault(byte, {})
        node[None] = offsets[key]
    units, used, bases = [0], {0}, set()
    queue = [(root, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        need = labels + ([0] if None in node else [])
        base = 1
        while base in bases or any(base ^ c in used for c in need):
            base += 1
        bases.add(base)
        assert pos ^ base < 1 << 21
        units += [0] * (max(base ^ c for c in need) + 1 - len(units))
        units[pos] |= (pos ^ base) << 10 | (1 << 8 if None in node else 0)
        used.update(base ^ c for c in need)
        if None in node:
            units[base] = node[None] | 1 << 31
        for c in labels:
            units[base ^ c] |= c
            queue.append((node[c], base ^ c))
    # whole blocks of 256 units, as darts-clone writes them (a lookup's
    # XOR with a byte stays inside its block; the reader does not check)
    units += [0] * (-len(units) % 256)
    trie = b"".join(struct.pack("<I", u) for u in units)
    return struct.pack("<I", len(trie)) + trie + bytes(strings)


def xlmr_normalizer() -> dict:
    return {"type": "Sequence", "normalizers": [
        {"type": "Precompiled",
         "precompiled_charsmap": base64.b64encode(charsmap_blob(charsmap_rules())).decode()},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "},
    ]}


METASPACE = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}


def train_unigram(vocab_size: int = 1200) -> dict:
    """A Unigram model trained on the normalized fixture logs (742 pieces:
    the logs run out; ``vocab_size`` is a ceiling)."""
    from tokenizers import models, trainers

    trainer = tokenizers.Tokenizer(models.Unigram())
    trainer.normalizer = tokenizers.normalizers.Sequence([
        tokenizers.normalizers.Precompiled(charsmap_blob(charsmap_rules())),
        tokenizers.normalizers.Replace(tokenizers.Regex(" {2,}"), " ")])
    trainer.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always")
    trainer.train_from_iterator(fixture_lines(), trainers.UnigramTrainer(
        vocab_size=vocab_size, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        unk_token="<unk>", show_progress=False, max_piece_length=16))
    return json.loads(trainer.to_str())["model"]


def xlmr_unigram_spec(model: "dict | None" = None) -> dict:
    """XLM-RoBERTa's ``tokenizer.json`` around a trained Unigram model
    (``<s> <pad> </s> <unk>`` first, then the pieces, the 256 ``<0xNN>``
    byte pieces at score 0 and ``<mask>`` last; byte fallback on)."""
    model = model or train_unigram()
    pieces = [p for p in model["vocab"] if not (p[0].startswith("<0x") or p[0] == "<mask>")]
    assert [p[0] for p in pieces[:4]] == ["<s>", "<pad>", "</s>", "<unk>"]
    vocab = pieces + [[f"<0x{b:02X}>", 0.0] for b in range(256)] + [["<mask>", 0.0]]
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [_special(0, "<s>"), _special(1, "<pad>"), _special(2, "</s>"),
                         _special(3, "<unk>"), _special(len(vocab) - 1, "<mask>", lstrip=True)],
        "normalizer": xlmr_normalizer(),
        "pre_tokenizer": METASPACE,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                               "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}},
        "decoder": METASPACE,
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": True},
    }
    tokenizers.Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def xlmr_unigram_files(directory: str, spec: "dict | None" = None,
                       config: "dict | None" = None) -> str:
    return _write(directory, spec or xlmr_unigram_spec(), config or XLMR_CONFIG)


#: the Script-aware pre-tokenizer: a cut wherever the script changes, the
#: Han, kana, Greek and Cyrillic runs again on their own, then Metaspace
SCRIPTS_PRE_TOKENIZER = {"type": "Sequence", "pretokenizers": [
    {"type": "UnicodeScripts"},
    {"type": "Split", "pattern": {
        "Regex": r"\p{Han}+|[\p{Hiragana}\p{Katakana}ー]+|\p{Greek}+|\p{Cyrl}+"},
     "behavior": "Isolated", "invert": False},
    METASPACE,
]}


def xlmr_scripts_spec(model: "dict | None" = None) -> dict:
    """The Unigram fixture with the Script-aware pre-tokenizer."""
    spec = xlmr_unigram_spec(model or committed_spec("xlmr_unigram")["model"])
    spec["pre_tokenizer"] = SCRIPTS_PRE_TOKENIZER
    tokenizers.Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def expected_ids(path: str) -> dict:
    """``AutoTokenizer``'s ids for the fixture's prompts (:data:`PROMPTS`
    unless :data:`FIXTURE_PROMPTS` names others), without and with the
    post-processor's specials; for the log fixture also the prompt on
    which the library gives up."""
    auto = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
    prompts = FIXTURE_PROMPTS.get(path, PROMPTS)
    out = {"prompts": prompts,
           "ids": [auto.encode(p, add_special_tokens=False) for p in prompts],
           "ids_with_special_tokens": [auto.encode(p, add_special_tokens=True) for p in prompts],
           "bos_id": auto.bos_token_id, "eos_id": auto.eos_token_id,
           "vocab_size": len(auto)}
    if path == ONIG_LOGS:
        assert library_gives_up(auto, LOG_GIVES_UP)
        out["gives_up"] = LOG_GIVES_UP
    return out


def library_gives_up(auto, text: str) -> bool:
    """Whether the library's tokenizer panics on ``text`` (its retry
    limit: ``pyo3_runtime.PanicException``, not an ``Exception``)."""
    try:
        auto.encode(text, add_special_tokens=False)
    except BaseException as err:  # noqa: BLE001 - the library's panic
        if "retry-limit-in-match" in str(err):
            return True
        raise
    return False


def write_expected_ids(path: str) -> None:
    with open(os.path.join(path, "expected_ids.json"), "w", encoding="utf-8") as fh:
        json.dump(expected_ids(path), fh, ensure_ascii=False, indent=1)
        fh.write("\n")


# ---------------------------------------------------------------------------
# the log fixture
# ---------------------------------------------------------------------------

#: the log fixture's ``Split`` expression: balanced (and nested) brackets
#: by a recursive call, a double-quoted string by the absent operator, a
#: backquoted phrase, a letter stretched three or more times (any case) by
#: a back reference under ``(?i)``, a value after ``=`` or ``:`` by an
#: unbounded look-behind, an emoji sequence to its grapheme boundary by
#: ``\\y``, then spaces, words and single characters
ONIG_LOGS_PATTERN = (r"(?<b>\((?:[^()\[\]]++|\g<b>)*\)|\[(?:[^()\[\]]++|\g<b>)*\])"
                     r'|"(?~")"|`(?:\w+\s?)*`|(?i)(?<r>\p{L})\k<r>{2,}|(?<=[=:]\s*)\w+'
                     r"|\p{Extended_Pictographic}\X*?\y|\s+|\w+|\S")
#: ``tokenizer_config.json`` of the log fixture (TinyLlama's specials)
ONIG_LOGS_CONFIG = {
    "bos_token": "<s>",
    "clean_up_tokenization_spaces": False,
    "eos_token": "</s>",
    "model_max_length": 2048,
    "tokenizer_class": "PreTrainedTokenizerFast",
    "unk_token": "<unk>",
}


def train_onig_logs(vocab_size: int = 2048) -> dict:
    """A BPE model trained by the library on the fixture logs split by
    :data:`ONIG_LOGS_PATTERN` (``<unk> <s> </s>``, the 256 ``<0xNN>`` byte
    tokens, then merges seen twice; ``vocab_size`` is a ceiling)."""
    from tokenizers import Regex, models, pre_tokenizers, trainers

    trainer = tokenizers.Tokenizer(models.BPE(unk_token="<unk>"))
    trainer.pre_tokenizer = pre_tokenizers.Split(Regex(ONIG_LOGS_PATTERN), "isolated")
    trainer.train_from_iterator(fixture_lines(), trainers.BpeTrainer(
        vocab_size=vocab_size, min_frequency=2, show_progress=False,
        special_tokens=["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]))
    return json.loads(trainer.to_str())["model"]


def onig_logs_spec(model: "dict | None" = None) -> dict:
    """The log fixture's ``tokenizer.json`` around a trained BPE model:
    byte fallback, ``<s>`` before every text, the ``ByteFallback`` and
    ``Fuse`` decoder."""
    model = model or train_onig_logs()
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [_special(0, "<unk>"), _special(1, "<s>"), _special(2, "</s>")],
        "normalizer": None,
        "pre_tokenizer": {"type": "Split", "pattern": {"Regex": ONIG_LOGS_PATTERN},
                          "behavior": "Isolated", "invert": False},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [{"type": "ByteFallback"},
                                                     {"type": "Fuse"}]},
        "model": {**model, "byte_fallback": True},
    }
    tokenizers.Tokenizer.from_str(json.dumps(spec))  # the library reads it
    return spec


def onig_logs_files(directory: str, spec: "dict | None" = None) -> str:
    return _write(directory, spec or onig_logs_spec(), ONIG_LOGS_CONFIG)


FIXTURES = {"minilm_wordpiece": MINILM_WORDPIECE, "xlmr_unigram": XLMR_UNIGRAM,
            "xlmr_scripts": XLMR_SCRIPTS, "onig_logs": ONIG_LOGS}


def committed_spec(name: str) -> dict:
    with open(os.path.join(FIXTURES[name], "tokenizer.json"), encoding="utf-8") as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


def test_scripts_fixture_regenerates(tmp_path):
    """The Script-aware fixture is the committed Unigram model in its
    layout, byte for byte."""
    _same_files(xlmr_unigram_files(str(tmp_path / "scripts"), xlmr_scripts_spec()), XLMR_SCRIPTS)


def _same_files(fresh: str, committed: str) -> None:
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(fresh, name), "rb") as a, \
                open(os.path.join(committed, name), "rb") as b:
            assert a.read() == b.read(), name


def test_log_fixture_regenerates(tmp_path):
    """The log fixture is the library's training on the fixture logs in
    its layout, byte for byte, and its expression takes the matcher."""
    from operator_tpu_torch.models.tokenization import onig

    _same_files(onig_logs_files(str(tmp_path / "logs")), ONIG_LOGS)
    assert os.path.getsize(os.path.join(ONIG_LOGS, "tokenizer.json")) < 1 << 20
    assert len(committed_spec("onig_logs")["model"]["vocab"]) <= 4096
    assert onig.compile_expression(ONIG_LOGS_PATTERN).engine == "matcher"


def test_the_log_fixture_gives_up_where_the_library_does():
    """On the marked prompt the library's tokenizer panics and the port's
    raises ``RetryLimitError``; on every other prompt both give
    ``expected_ids.json``'s ids."""
    from operator_tpu_torch.models.tokenization import onig_match

    with open(os.path.join(ONIG_LOGS, "expected_ids.json"), encoding="utf-8") as fh:
        expected = json.load(fh)
    auto = transformers.AutoTokenizer.from_pretrained(ONIG_LOGS, local_files_only=True)
    assert library_gives_up(auto, expected["gives_up"])
    port = tokenizer.HFTokenizer(ONIG_LOGS)
    with pytest.raises(onig_match.RetryLimitError):
        port.encode(expected["gives_up"], add_bos=False)
    assert [port.encode(p, add_bos=False) for p in expected["prompts"]] == expected["ids"]


def test_wordpiece_fixture_regenerates(tmp_path):
    _same_files(minilm_wordpiece_files(str(tmp_path / "wp")), MINILM_WORDPIECE)
    assert os.path.getsize(os.path.join(MINILM_WORDPIECE, "tokenizer.json")) < 1 << 20


def test_unigram_fixture_regenerates(tmp_path):
    """The layout around the committed model regenerates byte for byte; a
    fresh training gives a model the library reads in the same layout
    (its scores differ in the last bits from run to run)."""
    model = committed_spec("xlmr_unigram")["model"]
    _same_files(xlmr_unigram_files(str(tmp_path / "uni"), xlmr_unigram_spec(model)), XLMR_UNIGRAM)
    fresh = xlmr_unigram_spec()
    assert [p for p, _ in fresh["model"]["vocab"]][:4] == ["<s>", "<pad>", "</s>", "<unk>"]
    assert abs(len(fresh["model"]["vocab"]) - len(model["vocab"])) < 50
    assert os.path.getsize(os.path.join(XLMR_UNIGRAM, "tokenizer.json")) < 1 << 20
    assert 200 <= len(charsmap_rules()) < 1000


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_expected_ids_are_autotokenizers(name):
    with open(os.path.join(FIXTURES[name], "expected_ids.json"), encoding="utf-8") as fh:
        assert json.load(fh) == expected_ids(FIXTURES[name])


def test_the_charsmap_is_read_as_the_library_reads_it():
    """The library applies the test-written charsmap (the independent
    check that the blob is valid) and the port's reader agrees, rule by
    rule and on text around the rules."""
    from operator_tpu_torch.models.tokenization.charsmap import Precompiled

    rules = charsmap_rules()
    blob = charsmap_blob(rules)
    library = tokenizers.normalizers.Precompiled(blob)
    ours = Precompiled(blob)
    rng = random.Random(5)
    keys = sorted(rules)
    texts = keys + [f"x{k}y" for k in keys] + [
        "".join(rng.choice(keys + list("ab \u0301\u0308ｶﾞ😀\u200d")) for _ in range(12))
        for _ in range(300)]
    for text in texts:
        assert ours.normalize(text) == library.normalize_str(text), text
    for key, value in rules.items():
        if len(key) == 1:
            assert library.normalize_str(key) == value, key
    assert library.normalize_str("\u200b") == "" and library.normalize_str("e\u0301") == "é"


# ---------------------------------------------------------------------------
# the families against the JAX package
# ---------------------------------------------------------------------------


def _texts(seed: int) -> list:
    return fixture_lines() + EDGE_TEXTS + PROMPTS + _many_scripts_texts(seed, 250) + [
        "ＦＵＬＬ　ｗｉｄｔｈ ﬁ ① Ⅻ ｶﾞ ﾊﾟ e\u0301 a\u030a", "[CLS] [SEP] [MASK] [UNK] [PAD] x",
        "<mask> <s>x</s> <pad><unk>", "a" * 130 + " " + "é" * 120]


def assert_same_tokenizer(got, want, texts, *, seed: int = 0, specials=None) -> None:
    """Special ids, ``vocab_size``, ``encode`` with and without BOS,
    ``decode`` of those ids and of seeded random ids; with ``specials``
    (an ``AutoTokenizer``) also the post-processor's ids."""
    assert (got.vocab_size, got.bos_id, got.eos_id, got.pad_id) == (
        want.vocab_size, want.bos_id, want.eos_id, want.pad_id)
    for text in texts:
        for add_bos in (True, False):
            ids = want.encode(text, add_bos=add_bos)
            assert got.encode(text, add_bos=add_bos) == ids, (text, add_bos)
        assert got.decode(ids) == want.decode(ids), text
        if specials is not None:
            assert got.encode_with_special_tokens(text) == specials.encode(
                text, add_special_tokens=True), text
    rng = random.Random(seed)
    for _ in range(200):
        ids = [rng.randrange(0, got.vocab_size + 4) for _ in range(rng.randrange(0, 30))]
        assert got.decode(ids) == want.decode(ids), ids


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_family_matches_the_jax_tokenizer(name):
    path = FIXTURES[name]
    auto = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
    assert_same_tokenizer(tokenizer.HFTokenizer(path), jax_tokenizer.HFTokenizer(path),
                          _texts(len(name)), seed=len(name), specials=auto)
    got, want = tokenizer.load_tokenizer(path), jax_tokenizer.load_tokenizer(path)
    assert type(got).__name__ == type(want).__name__ == "HFTokenizer"


# ---------------------------------------------------------------------------
# the encoder's tokenizer on three checkpoint layouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_weights(tmp_path_factory):
    """A tiny BERT checkpoint over the WordPiece fixture's vocab: seeded
    weights under HF BERT names in ``model.safetensors`` and its
    ``config.json``."""
    pytest.importorskip("safetensors")
    import torch

    from operator_tpu_torch.models import encoder
    from operator_tpu_torch.models.loader import write_safetensors

    path = tmp_path_factory.mktemp("encoder") / "weights"
    path.mkdir()
    config = dataclasses.replace(encoder.ENCODER_TINY_TEST, vocab_size=len(minilm_vocab()),
                                 num_layers=1)
    params = encoder.init_encoder_params(config, torch.Generator().manual_seed(0), device="cpu")
    tensors = {hf: params[ours] for hf, ours in encoder._BERT_TOP_MAP.items()}
    for sub, (ours, transpose) in encoder._BERT_LAYER_MAP.items():
        stacked = params["layers"][ours]
        stacked = (stacked.transpose(-1, -2) if transpose else stacked).contiguous()
        for i in range(stacked.shape[0]):
            tensors[f"encoder.layer.{i}.{sub}"] = stacked[i]
    write_safetensors(str(path / "model.safetensors"), tensors)
    (path / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size, "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads, "max_position_embeddings": config.max_positions,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12}))
    return str(path)


def _layout(weights: str, directory: str, layout: str) -> str:
    shutil.copytree(weights, directory)
    if layout in ("vocab_txt", "both_disagreeing"):
        with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as fh:
            fh.write("\n".join(minilm_vocab()) + "\n")
    if layout in ("tokenizer_json", "both_disagreeing"):
        shutil.copy(os.path.join(MINILM_WORDPIECE, "tokenizer.json"), directory)
    config = dict(MINILM_CONFIG)
    if layout == "both_disagreeing":
        # the JSON's normalizer lowercases; the config says not to: the
        # BERT tokenizer class rebuilds the normalizer from the config
        config["do_lower_case"] = False
    with open(os.path.join(directory, "tokenizer_config.json"), "w") as fh:
        json.dump(config, fh)
    return directory


@pytest.mark.parametrize("layout", ["vocab_txt", "tokenizer_json", "both_disagreeing"])
def test_encoder_tokenizes_as_the_jax_encoder(encoder_weights, tmp_path, layout):
    """``NeuralEmbedder.from_checkpoint``'s tokenizer against the JAX
    encoder's ``AutoTokenizer``; a ``tokenizer.json``-only checkpoint is a
    neural embedder from ``build_embedder`` (it fell back to the lexical
    one when only ``vocab.txt`` was read)."""
    from operator_tpu.patterns import semantic as jax_semantic
    from operator_tpu_torch.patterns import semantic

    path = _layout(encoder_weights, str(tmp_path / layout), layout)
    ours = semantic.NeuralEmbedder.from_checkpoint(path, device="cpu")
    theirs = jax_semantic.NeuralEmbedder.from_checkpoint(path)
    texts = fixture_lines() + EDGE_TEXTS + PROMPTS + _many_scripts_texts(7, 100) + [
        "Pod crashed OOMKilled", "Café OOMKilled [SEP] 日本", "x" * 400]
    for text in texts:
        assert ours.tokenize(text) == theirs.tokenize(text), text
    assert ours.tokenize("Pod crashed OOMKilled")[0] == 101
    assert isinstance(semantic.build_embedder(path, device="cpu"), semantic.NeuralEmbedder)


@pytest.mark.parametrize("layout", ["vocab_txt", "tokenizer_json", "both_disagreeing"])
def test_encoder_tokenizes_unicode_texts_as_the_jax_encoder(encoder_weights, tmp_path, layout):
    """The texts where Python's Unicode data and the library's differ
    (:data:`UNICODE_PROMPTS`), through ``NeuralEmbedder.from_checkpoint``
    and the JAX encoder's ``AutoTokenizer``: the same ids, none of them
    ``[UNK]`` where the checkpoint lowercases (the vocabulary holds both
    readings' pieces)."""
    from operator_tpu.patterns import semantic as jax_semantic
    from operator_tpu_torch.patterns import semantic

    path = _layout(encoder_weights, str(tmp_path / layout), layout)
    ours = semantic.NeuralEmbedder.from_checkpoint(path, device="cpu")
    theirs = jax_semantic.NeuralEmbedder.from_checkpoint(path)
    for text in UNICODE_PROMPTS:
        ids = theirs.tokenize(text)
        assert ours.tokenize(text) == ids, text
        if layout != "both_disagreeing":
            assert 100 not in ids, text


if __name__ == "__main__":
    minilm_wordpiece_files(MINILM_WORDPIECE)
    xlmr_unigram_files(XLMR_UNIGRAM)
    xlmr_unigram_files(XLMR_SCRIPTS, xlmr_scripts_spec())
    onig_logs_files(ONIG_LOGS)
    for fixture in FIXTURES.values():
        write_expected_ids(fixture)
    sys.exit(print(*FIXTURES.values()))
