"""Expressions, classes and splitting as the ``tokenizers`` library runs them.

- :func:`translate_regex` reads an Oniguruma expression (the library's
  ``Regex`` patterns) into an :class:`~.onig.Expression` over Python's
  ``re`` or the port's own matcher (:mod:`.onig`, :mod:`.onig_match`);
- :func:`regex_matches` finds as Oniguruma's ``find_iter`` does (no empty
  match right after a match), :func:`char_matches` as the library's
  character predicates do (each matching character its own match);
- :func:`split` is ``NormalizedString::split``: one of the five
  delimiter behaviors over those matches, empty pieces dropped;
- :func:`normalize` and :func:`lowercase` are the library's normalization
  forms and ``Lowercase`` (its tables, not Python's Unicode);
- ``WHITESPACE`` and :func:`is_word` are the Rust ``regex`` crate's ``\\s``
  and ``\\w``, which the ``Whitespace`` pre-tokenizer and ``single_word``
  added tokens read (not Oniguruma's).
"""

from __future__ import annotations

import bisect
import functools
import re
import unicodedata
from typing import Callable, Iterable, Iterator

from . import tables, unsupported
from .onig import Expression, compile_expression, decode


def table(name: str) -> "tuple[tuple[int, int], ...]":
    """One of :mod:`.tables`' sets as sorted code point ranges."""
    return tuple(decode(getattr(tables, name)))


def in_ranges(ranges: "tuple[tuple[int, int], ...]") -> Callable[[str], bool]:
    """Membership of a character in sorted code point ranges."""
    starts = [lo for lo, _ in ranges]

    def contains(char: str) -> bool:
        cp = ord(char)
        i = bisect.bisect_right(starts, cp) - 1
        return i >= 0 and cp <= ranges[i][1]

    return contains


def class_text(ranges: "Iterable[tuple[int, int]]") -> str:
    """Code point ranges as the body of an ``re`` character class."""
    return "".join(re.escape(chr(lo)) if lo == hi else f"{re.escape(chr(lo))}-{re.escape(chr(hi))}"
                   for lo, hi in ranges)


#: ``char::is_whitespace`` (Unicode White_Space), the ``regex`` crate's and
#: Oniguruma's ``\s`` too; Python's ``str.isspace`` also counts
#: U+001C..U+001F
WHITESPACE = frozenset(chr(c) for lo, hi in table("SPACE") for c in range(lo, hi + 1))
#: the ``regex`` crate's ``\w`` (``Whitespace``, ``single_word``)
is_word = in_ranges(table("WORD"))


# ---------------------------------------------------------------------------
# normalization and case, as the library's tables give them
# ---------------------------------------------------------------------------

#: where the library's normalization tables and ``unicodedata`` disagree:
#: each a starter the library does not map, so the text on either side of
#: one normalizes alone
_CUTS = re.compile(f"([{class_text(table('NORMALIZATION_CUTS'))}])")
#: the library's lowercase where ``str.lower`` of the character differs
_LOWER = str.maketrans({chr(c): lower for c, lower in tables.LOWERCASE.items()})


def normalize(form: str, text: str) -> str:
    """``NFC``, ``NFD``, ``NFKC`` or ``NFKD`` as the library's tables give
    it: ``unicodedata`` on each run between the code points they disagree
    on, which stay as they are."""
    if text.isascii():
        return text
    if _CUTS.search(text) is None:
        return unicodedata.normalize(form, text)
    return "".join(part if i % 2 else unicodedata.normalize(form, part)
                   for i, part in enumerate(_CUTS.split(text)))


def lowercase(text: str) -> str:
    """``Lowercase``: each character's lowercase (Rust's
    ``char::to_lowercase``, no final sigma), the library's where Python's
    Unicode lacks it."""
    if text.isascii():
        return text.lower()
    text = text.translate(_LOWER)
    if "Σ" in text:
        # str.lower reads a final sigma from its context, a character alone does not
        return "".join(c.lower() for c in text)
    return text.lower()


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
