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
   whitespace to a space, CJK ideographs spaced, accents stripped (NFD,
   non-spacing marks dropped) and then lowercased, character by character;
3. split on whitespace and around every punctuation character (ASCII
   punctuation and Unicode ``P*``);
4. greedy longest-match WordPiece with ``##`` continuation pieces; a word
   over 100 characters, or one with an unmatched remainder, is ``[UNK]``;
5. ``[CLS] ... [SEP]`` around the ids when ``add_special_tokens``.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Optional

__all__ = ["WordPieceTokenizer"]

#: ``char::is_whitespace`` (Unicode White_Space) plus tab, newline, CR —
#: the BERT normalizer maps these to a space (after dropping the controls)
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)

#: CJK ideograph blocks that get a space on either side
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)

#: the normalizer and the word split on ASCII text, where they reduce to
#: dropping the control characters, tabs and line ends to spaces, and
#: runs of letters and digits with each punctuation character alone
_ASCII_CLEAN = {**{i: None for i in (*range(9), 11, 12, *range(14, 32), 127)},
                9: " ", 10: " ", 13: " "}
_ASCII_WORDS = re.compile(r"[0-9A-Za-z]+|[!-/:-@\[-`{-~]")
#: words kept in one tokenizer's WordPiece cache before it is cleared
_CACHE_WORDS = 1 << 16

_SPECIAL_DEFAULTS = {
    "unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
    "cls_token": "[CLS]", "mask_token": "[MASK]",
}


def _is_control(char: str) -> bool:
    if char in "\t\n\r":
        return False
    return unicodedata.category(char).startswith("C")


def _is_cjk(char: str) -> bool:
    cp = ord(char)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punctuation(char: str) -> bool:
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


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

    def _normalize(self, text: str) -> str:
        chars = []
        for char in text:
            if char in "\x00\ufffd" or _is_control(char):
                continue
            if char in _WHITESPACE:
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(char):
                chars.extend((" ", char, " "))
            else:
                chars.append(char)
        text = "".join(chars)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = "".join(c.lower() for c in text)  # per character, no final sigma
        return text

    def _words(self, text: str) -> list[str]:
        words = []
        for chunk in text.split(" "):  # the normalizer left no other whitespace
            word: list[str] = []
            for char in chunk:
                if _is_punctuation(char):
                    if word:
                        words.append("".join(word))
                        word = []
                    words.append(char)
                else:
                    word.append(char)
            if word:
                words.append("".join(word))
        return words

    def _pieces(self, text: str) -> list[str]:
        """Normalized words of ``text`` (no special tokens in it)."""
        if text.isascii():
            text = text.translate(_ASCII_CLEAN)
            return _ASCII_WORDS.findall(text.lower() if self.do_lower_case else text)
        return self._words(self._normalize(text))

    def _wordpiece(self, word: str) -> list[int]:
        ids = self._cache.get(word)
        if ids is None:
            if len(self._cache) >= _CACHE_WORDS:
                self._cache.clear()
            ids = self._cache[word] = self._wordpiece_uncached(word)
        return ids

    def _wordpiece_uncached(self, word: str) -> list[int]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return ids

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
