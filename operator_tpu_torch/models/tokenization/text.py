"""Expressions, classes and splitting as the ``tokenizers`` library runs them.

- :func:`translate_regex` reads an Oniguruma expression (the library's
  ``Regex`` patterns) into an :class:`~.onig.Expression` over Python's
  ``re`` or the port's own matcher (:mod:`.onig`, :mod:`.onig_match`);
- :func:`regex_matches` finds as Oniguruma's ``find_iter`` does (no empty
  match right after a match), :func:`char_matches` as the library's
  character predicates do (each matching character its own match);
- :func:`split` is ``NormalizedString::split``: one of the five
  delimiter behaviors over those matches, empty pieces dropped;
- :func:`escape_codepoints` gives the Rust ``regex`` crate's ``\\w`` and
  ``\\s``, which the ``Whitespace`` pre-tokenizer and ``single_word``
  added tokens read (not Oniguruma's).
"""

from __future__ import annotations

import bisect
import functools
import re
import sys
import unicodedata
from typing import Callable, Iterable, Iterator

from . import unsupported
from .onig import Expression, compile_expression

#: ``char::is_whitespace`` (Unicode White_Space), Oniguruma's ``\s`` too;
#: Python's ``str.isspace`` also counts U+001C..U+001F
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)

#: what a word character is to the ``regex`` crate beyond the letters,
#: marks, decimal and letter numbers and connectors: the Other_Alphabetic
#: symbols (circled and squared Latin letters)
_WORD_EXTRA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
#: the join controls, word characters to the ``regex`` crate
JOIN_CONTROLS = (0x200C, 0x200D)


def in_ranges(table: "tuple[tuple[int, int], ...]") -> Callable[[str], bool]:
    """Membership of a character in sorted code point ranges."""
    starts = [lo for lo, _ in table]

    def contains(char: str) -> bool:
        cp = ord(char)
        i = bisect.bisect_right(starts, cp) - 1
        return i >= 0 and cp <= table[i][1]

    return contains


@functools.lru_cache(maxsize=None)
def escape_codepoints(escape: str) -> "tuple[int, ...]":
    """The ``regex`` crate's ``\\s`` or ``\\w`` (without the join
    controls), from ``unicodedata``."""
    if escape == "s":
        return tuple(sorted(ord(c) for c in WHITESPACE))
    if escape == "w":
        word = {c for c in range(sys.maxunicode + 1)
                if unicodedata.category(chr(c))[0] in "LM"
                or unicodedata.category(chr(c)) in ("Nd", "Nl", "Pc")}
        for lo, hi in _WORD_EXTRA:
            word.update(range(lo, hi + 1))
        return tuple(sorted(word))
    raise ValueError(f"no class \\{escape}")


def ranges(points: Iterable[int]) -> str:
    """Code points as the body of an ``re`` character class."""
    out, start, prev = [], None, None
    for c in [*points, -2]:
        if start is not None and c == prev + 1:
            prev = c
            continue
        if start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(prev))
            out.append(lo if start == prev else f"{lo}-{hi}")
        start = prev = c
    return "".join(out)


def translate_regex(pattern: str) -> Expression:
    """The library's (Oniguruma) expression, read for Python's ``re`` or the
    port's matcher (its ``engine`` says which)."""
    return compile_expression(pattern)


def literal_expression(pattern: "re.Pattern") -> Expression:
    """A Python ``re`` that needs no translation, found the same way."""
    return Expression(pattern)


# ---------------------------------------------------------------------------
# finding and splitting
# ---------------------------------------------------------------------------

#: (start, stop, is a match) spans that cover a text, in order
Matches = "list[tuple[int, int, bool]]"


def find_iter(expression: Expression, text: str) -> Iterator["tuple[int, int]"]:
    """Oniguruma's ``find_iter``: leftmost matches, each search from where
    the last match ended, an empty match right there skipped (the search
    then starts a character later; Python's ``finditer`` keeps it)."""
    pos, last_end = 0, None
    while pos <= len(text):
        span = expression.search(text, pos)
        if span is None:
            return
        start, stop = span
        if start == stop and last_end == stop:
            pos += 1
            continue
        pos = last_end = stop
        yield start, stop


def regex_matches(expression: Expression, text: str) -> Matches:
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for start, stop in find_iter(expression, text):
        if prev != start:
            out.append((prev, start, False))
        out.append((start, stop, True))
        prev = stop
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def char_matches(pred: Callable[[str], bool], text: str) -> Matches:
    """A character predicate as a pattern: each matching character is a
    match of its own."""
    if not text:
        return [(0, 0, False)]
    out, last = [], 0
    for i, char in enumerate(text):
        if pred(char):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(text):
        out.append((last, len(text), False))
    return out


def string_matches(literal: str, text: str) -> Matches:
    """A literal string as a pattern (never an empty match)."""
    if not literal:
        return [(0, len(text), False)]
    return regex_matches(literal_expression(re.compile(re.escape(literal))), text)


def invert(matches: Matches) -> Matches:
    return [(start, stop, not hit) for start, stop, hit in matches]


BEHAVIORS = ("Removed", "Isolated", "MergedWithPrevious", "MergedWithNext", "Contiguous")


def split(text: str, matches: Matches, behavior: str) -> "list[tuple[str, int]]":
    """``NormalizedString::split``: ``(piece, start)`` for the pieces
    ``behavior`` makes of ``text`` and its matches, empty ones dropped."""
    if behavior == "Isolated":
        spans = [(a, b) for a, b, _ in matches]
    elif behavior == "Removed":
        spans = [(a, b) for a, b, hit in matches if not hit]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        spans, previous = [], False
        for a, b, hit in matches:
            merge = hit == previous if behavior == "Contiguous" else hit and not previous
            if merge and spans:
                spans[-1] = (spans[-1][0], b)
            else:
                spans.append((a, b))
            previous = hit
    elif behavior == "MergedWithNext":
        spans, previous = [], False
        for a, b, hit in reversed(matches):
            if hit and not previous and spans:
                spans[-1] = (a, spans[-1][1])
            else:
                spans.append((a, b))
            previous = hit
        spans.reverse()
    else:
        raise unsupported(f"split behavior {behavior!r}")
    return [(text[a:b], a) for a, b in spans if b > a]


# ---------------------------------------------------------------------------
# GPT-2's byte table
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> "dict[int, str]":
    """GPT-2's byte -> printable character table (``ByteLevel``)."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> "dict[str, int]":
    return {c: b for b, c in bytes_to_unicode().items()}


def byte_level(text: str) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in text.encode("utf-8"))
