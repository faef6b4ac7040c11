"""BERT WordPiece tokenizer for the MiniLM-class encoder's checkpoints.

The counterpart of the ``transformers`` BERT tokenizer that the JAX
package reaches through ``AutoTokenizer`` for an encoder checkpoint
(``operator_tpu/patterns/semantic.py:NeuralEmbedder.from_checkpoint``),
without ``transformers``: the port depends on PyTorch alone.  It reads the directory's
``vocab.txt`` (one token per line, the line index is its id) and
``do_lower_case`` / ``tokenize_chinese_chars`` / ``strip_accents`` and the
special tokens from ``tokenizer_config.json``, and runs the steps of the
fast tokenizer ``AutoTokenizer`` builds from them:

1. special tokens (``[CLS]``, ``[SEP]``, ``[UNK]``, ``[PAD]``, ``[MASK]``)
   written in the text are split out first, case-sensitively;
2. the BERT normalizer: NUL, U+FFFD and control characters dropped,
   whitespace to a space, CJK ideographs spaced, accents stripped (the
   library's NFD, its non-spacing marks dropped) and then lowercased,
   character by character;
3. split on whitespace and around every punctuation character (ASCII
   punctuation and Unicode ``P*``);
4. greedy longest-match WordPiece with ``##`` continuation pieces; a word
   over 100 characters, or one with an unmatched remainder, is ``[UNK]``;
5. ``[CLS] ... [SEP]`` around the ids when ``add_special_tokens``.

Steps 2-4 are :func:`bert_normalize`, :func:`bert_words` and
:func:`wordpiece`, which a ``tokenizer.json``'s ``BertNormalizer``,
``BertPreTokenizer`` and ``WordPiece`` model run too
(``models/tokenization/``); the characters they drop, strip, space,
lowercase and isolate, and its NFD, are the library's own tables
(``models/tokenization/tables.py``), not ``unicodedata``'s.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

from .tokenization.text import WHITESPACE, in_ranges, normalize, table
from .tokenization.text import lowercase as lowercase_text

__all__ = ["WordPieceTokenizer", "bert_normalize", "bert_words", "wordpiece"]

#: the normalizer and the word split on ASCII text, where they reduce to
#: dropping the control characters, tabs and line ends to spaces, and
#: runs of letters and digits with each punctuation character alone
_ASCII_CLEAN = {**{i: None for i in (*range(9), 11, 12, *range(14, 32), 127)},
                9: " ", 10: " ", 13: " "}
_ASCII_WORDS = re.compile(r"[0-9A-Za-z]+|[!-/:-@\[-`{-~]")
#: the pre-tokenizer on any ASCII text: runs of what is neither
#: whitespace nor punctuation, and each punctuation character alone
_ASCII_SPLIT = re.compile(r"[^\t\n\x0b\x0c\r !-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")
#: words kept in one tokenizer's WordPiece cache before it is cleared
_CACHE_WORDS = 1 << 16

_SPECIAL_DEFAULTS = {
    "unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
    "cls_token": "[CLS]", "mask_token": "[MASK]",
}


#: the library's tables (``tokenization/tables.py``): what the BERT
#: normalizer drops, the ideographs it spaces, the non-spacing marks it
#: strips, the punctuation the pre-tokenizer isolates
_is_control = in_ranges(table("BERT_CONTROL"))
_is_cjk = in_ranges(table("BERT_CJK"))
_is_mark_nonspacing = in_ranges(table("BERT_MARK_NONSPACING"))
_is_punctuation = in_ranges(table("PUNCTUATION"))


def bert_normalize(text: str, *, clean_text: bool = True, handle_chinese_chars: bool = True,
                   strip_accents: Optional[bool] = None, lowercase: bool = True) -> str:
    """The BERT normalizer (``BertNormalizer``): NUL, U+FFFD and control
    characters dropped and whitespace to a space, CJK ideographs spaced,
    accents stripped (the library's NFD, its non-spacing marks dropped; by
    default when lowercasing), then lowercased, character by character."""
    if text.isascii():
        # no CJK, nothing to strip: the controls go, tab and line ends
        # become spaces
        text = text.translate(_ASCII_CLEAN) if clean_text else text
        return text.lower() if lowercase else text
    if clean_text or handle_chinese_chars:
        chars = []
        for char in text:
            if clean_text:
                if _is_control(char):
                    continue
                if char in WHITESPACE:
                    chars.append(" ")
                    continue
            if handle_chinese_chars and _is_cjk(char):
                chars.extend((" ", char, " "))
            else:
                chars.append(char)
        text = "".join(chars)
    if lowercase if strip_accents is None else strip_accents:
        text = "".join(c for c in normalize("NFD", text) if not _is_mark_nonspacing(c))
    return lowercase_text(text) if lowercase else text


def bert_words(text: str) -> list[str]:
    """The BERT pre-tokenizer (``BertPreTokenizer``): split on whitespace,
    which goes, and around every punctuation character (ASCII punctuation
    and Unicode ``P*``), which stays a word of its own."""
    if text.isascii():
        return _ASCII_SPLIT.findall(text)
    words: list[str] = []
    word: list[str] = []
    for char in text:
        if char in WHITESPACE or _is_punctuation(char):
            if word:
                words.append("".join(word))
                word = []
            if char not in WHITESPACE:
                words.append(char)
        else:
            word.append(char)
    if word:
        words.append("".join(word))
    return words


def wordpiece(word: str, vocab: dict, unk_id: int, *, prefix: str = "##",
              max_input_chars_per_word: int = 100) -> list[int]:
    """Greedy longest-match WordPiece: pieces after the first carry
    ``prefix``; a word over ``max_input_chars_per_word`` characters, or
    one with a remainder no piece matches, is the unknown token."""
    if len(word) > max_input_chars_per_word:
        return [unk_id]
    ids = []
    start = 0
    while start < len(word):
        end = len(word)
        while start < end:
            piece = word[start:end] if start == 0 else prefix + word[start:end]
            if piece in vocab:
                ids.append(vocab[piece])
                break
            end -= 1
        else:
            return [unk_id]
        start = end
    return ids


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class WordPieceTokenizer:
    """``vocab.txt`` WordPiece with the BERT basic tokenizer in front."""

    max_input_chars_per_word = 100

    def __init__(
        self,
        vocab: list[str],
        *,
        do_lower_case: bool = True,
        tokenize_chinese_chars: bool = True,
        strip_accents: Optional[bool] = None,
        special_tokens: Optional[dict] = None,
    ) -> None:
        self.vocab = {token: i for i, token in enumerate(vocab)}
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        special = {**_SPECIAL_DEFAULTS, **(special_tokens or {})}
        self.unk_token = special["unk_token"]
        self.cls_id = self.vocab[special["cls_token"]]
        self.sep_id = self.vocab[special["sep_token"]]
        self.unk_id = self.vocab[self.unk_token]
        self._cache: dict[str, list[int]] = {}
        specials = [t for t in special.values() if t]
        self._special = re.compile("|".join(
            re.escape(t) for t in sorted(specials, key=len, reverse=True)))

    @classmethod
    def from_dir(cls, path: str) -> "WordPieceTokenizer":
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as fh:
            vocab = [line.rstrip("\n") for line in fh]
        config: dict = {}
        config_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as fh:
                config = json.load(fh)
        special = {key: _token_content(config[key]) for key in _SPECIAL_DEFAULTS
                   if config.get(key) is not None}
        return cls(
            vocab,
            do_lower_case=config.get("do_lower_case", True),
            tokenize_chinese_chars=config.get("tokenize_chinese_chars", True),
            strip_accents=config.get("strip_accents"),
            special_tokens=special,
        )

    def _pieces(self, text: str) -> list[str]:
        """Normalized words of ``text`` (no special tokens in it)."""
        if text.isascii():
            text = text.translate(_ASCII_CLEAN)
            return _ASCII_WORDS.findall(text.lower() if self.do_lower_case else text)
        return bert_words(bert_normalize(
            text, handle_chinese_chars=self.tokenize_chinese_chars,
            strip_accents=self.strip_accents, lowercase=self.do_lower_case))

    def _wordpiece(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            if len(self._cache) >= _CACHE_WORDS:
                self._cache.clear()
            ids = self._cache[word] = self._wordpiece_uncached(word)
        return ids

    def _wordpiece_uncached(self, word: str) -> list[int]:
        return wordpiece(word, self.vocab, self.unk_id,
                         max_input_chars_per_word=self.max_input_chars_per_word)

    def encode(self, text: str, *, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        offset = 0
        for match in [*self._special.finditer(text), None]:
            stop = match.start() if match is not None else len(text)
            for word in self._pieces(text[offset:stop]):
                ids.extend(self._wordpiece(word))
            if match is not None:
                ids.append(self.vocab.get(match.group(), self.unk_id))
                offset = match.end()
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids
