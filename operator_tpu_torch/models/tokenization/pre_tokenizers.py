"""Pre-tokenizers: the normalized text into the pieces the model encodes.

Each maps pieces ``(text, starts the input)`` to finer pieces; the flag
is what ``Metaspace``'s ``prepend_scheme: first`` reads.
"""

from __future__ import annotations

import bisect
import functools
import re
from typing import Callable, Optional

from ..wordpiece import _is_punctuation, bert_words
from . import unicode_tables, unsupported
from .onig import Expression
from .text import (BEHAVIORS, WHITESPACE, byte_level, char_matches, class_text, in_ranges,
                   invert, literal_expression, regex_matches, split, string_matches, table,
                   translate_regex)

__all__ = ["build_pre_tokenizer"]

Pieces = "list[tuple[str, bool]]"
PreTokenizer = Callable[[Pieces], Pieces]

#: GPT-2's expression: ``ByteLevel`` with ``use_regex`` splits by it
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")


#: ``char::is_numeric`` (the ``N*`` categories of the library's Unicode)
_is_numeric = in_ranges(table("NUMERIC"))


def _splitting(find, behavior: str) -> PreTokenizer:
    """Each piece split by ``find(text) -> matches`` under ``behavior``."""
    if behavior not in BEHAVIORS:
        raise unsupported(f"split behavior {behavior!r}")

    def run(pieces):
        return [(part, first and start == 0) for text, first in pieces
                for part, start in split(text, find(text), behavior)]

    return run


@functools.lru_cache(maxsize=1)
def _whitespace_regex() -> Expression:
    """``Whitespace``'s ``\\w+|[^\\w\\s]+`` (the words and the runs of
    other non-space characters) as the ``regex`` crate reads it."""
    word, space = class_text(table("WORD")), class_text(table("SPACE"))
    return literal_expression(re.compile(f"[{word}]+|[^{word}{space}]+"))


_ANY = -1


@functools.lru_cache(maxsize=1)
def _script_table() -> "tuple[list[int], list[int], int]":
    """Run starts, each run's fixed script (an index of ``SCRIPT_NAMES``;
    Hiragana and Katakana as Han, what the table leaves out as ``Any``)
    and Han's index."""
    names = unicode_tables.SCRIPT_NAMES
    han = names.index("Hani")
    fixed = [han if name in ("Hira", "Kana") else _ANY if name == "Any" else i
             for i, name in enumerate(names)]
    runs = unicode_tables.SCRIPT_RUNS
    return [lo for lo, _ in runs], [fixed[i] for _, i in runs], han


@functools.lru_cache(maxsize=4096)
def fixed_script(char: str) -> int:
    """``UnicodeScripts``' ``fixed_script``: Hiragana, Katakana and U+30FC
    count as Han, a space as ``Any``."""
    if char == " ":
        return _ANY
    starts, scripts, han = _script_table()
    if char == "\u30fc":
        return han
    return scripts[bisect.bisect_right(starts, ord(char)) - 1]


def script_pieces(text: str) -> "list[tuple[str, int]]":
    """``UnicodeScripts`` on one piece: a cut wherever the script changes,
    ``Any`` joining what is before it (and dropped before the first
    script, as the library drops it)."""
    cuts, last = [], None
    for i, char in enumerate(text):
        script = fixed_script(char)
        if script != _ANY:
            if script != last:
                cuts.append(i)
            last = script
    cuts.append(len(text))
    return [(text[a:b], a) for a, b in zip(cuts, cuts[1:])]


def _unicode_scripts(pieces):
    return [(part, first and start == 0) for text, first in pieces
            for part, start in script_pieces(text)]


def _prepend_scheme(spec: dict) -> str:
    if "prepend_scheme" in spec:
        return spec["prepend_scheme"]
    return "always" if spec.get("add_prefix_space", True) else "never"


def _metaspace(spec: dict) -> PreTokenizer:
    replacement = spec.get("replacement", "▁")
    scheme, split_on = _prepend_scheme(spec), spec.get("split", True)

    def metaspace(pieces):
        out = []
        for text, first in pieces:
            if not text:
                continue
            text = text.replace(" ", replacement)
            if (scheme == "always" or (scheme == "first" and first)) and not text.startswith(replacement):
                text = replacement + text
            if split_on:
                out.extend((part, first and start == 0) for part, start in split(
                    text, string_matches(replacement, text), "MergedWithNext"))
            else:
                out.append((text, first))
        return out

    return metaspace


def _byte_level(spec: dict) -> PreTokenizer:
    prefix = bool(spec.get("add_prefix_space", True))
    regex = translate_regex(GPT2_PATTERN) if spec.get("use_regex", True) else None

    def run(pieces):
        out = []
        for text, first in pieces:
            if not text:
                continue
            if prefix and not text.startswith(" "):
                text = " " + text
            parts = (split(text, regex_matches(regex, text), "Isolated") if regex is not None
                     else [(text, 0)])
            out.extend((byte_level(part), first and start == 0) for part, start in parts)
        return out

    return run


def _fixed_length(length: int) -> PreTokenizer:
    if length <= 0:
        raise ValueError(f"FixedLength length {length}")

    def run(pieces):
        return [(text[i:i + length], first and i == 0) for text, first in pieces
                for i in range(0, len(text), length)]

    return run


def build_pre_tokenizer(spec: Optional[dict]) -> PreTokenizer:
    if spec is None:
        return lambda pieces: [p for p in pieces if p[0]]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def sequence(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces

        return sequence
    if kind == "Split":
        pattern = spec.get("pattern") or {}
        if "Regex" in pattern:
            regex = translate_regex(pattern["Regex"])
            find = lambda text: regex_matches(regex, text)  # noqa: E731
        elif "String" in pattern:
            literal = pattern["String"]
            find = lambda text: string_matches(literal, text)  # noqa: E731
        else:
            raise unsupported(f"Split with a {sorted(pattern)} pattern")
        if spec.get("invert"):
            plain = find
            find = lambda text: invert(plain(text))  # noqa: E731
        return _splitting(find, spec.get("behavior", "Isolated"))
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "WhitespaceSplit":
        return _splitting(lambda text: char_matches(WHITESPACE.__contains__, text), "Removed")
    if kind == "Whitespace":
        regex = _whitespace_regex()
        return _splitting(lambda text: invert(regex_matches(regex, text)), "Removed")
    if kind == "BertPreTokenizer":
        def bert(pieces):
            out = []
            for text, first in pieces:
                words, offset = bert_words(text), 0
                for word in words:
                    start = text.index(word, offset)
                    out.append((word, first and start == 0))
                    offset = start + len(word)
            return out

        return bert
    if kind == "Punctuation":
        return _splitting(lambda text: char_matches(_is_punctuation, text),
                          spec.get("behavior", "Isolated"))
    if kind == "Digits":
        behavior = "Isolated" if spec.get("individual_digits", False) else "Contiguous"
        return _splitting(lambda text: char_matches(_is_numeric, text), behavior)
    if kind == "CharDelimiterSplit":
        delimiter = spec["delimiter"]
        return _splitting(lambda text: char_matches(delimiter.__eq__, text), "Removed")
    if kind == "FixedLength":
        return _fixed_length(int(spec.get("length", 5)))
    if kind == "UnicodeScripts":
        return _unicode_scripts
    raise unsupported(f"pre_tokenizer {kind!r}")

