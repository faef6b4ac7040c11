"""Expressions, classes and splitting as the ``tokenizers`` library runs them.

- :func:`translate_regex` turns an Oniguruma expression (the library's
  ``Regex`` patterns) into a Python ``re`` one: the classes Python reads
  differently or not at all (``\\p{..}``/``\\P{..}`` general categories,
  ``\\s``, ``\\w``, ``\\d``, ``\\h`` and their negations) become explicit
  code point ranges built from ``unicodedata``, and ``^``/``$`` match at
  line ends, as Oniguruma's do;
- :func:`regex_matches` finds as Oniguruma's ``find_iter`` does (no empty
  match right after a match), :func:`char_matches` as the library's
  character predicates do (each matching character its own match);
- :func:`split` is ``NormalizedString::split``: one of the five
  delimiter behaviors over those matches, empty pieces dropped.
"""

from __future__ import annotations

import bisect
import functools
import re
import sys
import unicodedata
from typing import Callable, Iterable, Iterator

from . import needs_scripts, unsupported

#: ``char::is_whitespace`` (Unicode White_Space), Oniguruma's ``\s`` too;
#: Python's ``str.isspace`` also counts U+001C..U+001F
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)

#: general-category names Oniguruma reads in ``\p{..}``: each short name
#: and the major classes' long names
_CATEGORY_ALIASES = {
    "Letter": "L", "Cased_Letter": "LC", "L&": "LC", "Uppercase_Letter": "Lu",
    "Lowercase_Letter": "Ll", "Titlecase_Letter": "Lt", "Modifier_Letter": "Lm",
    "Other_Letter": "Lo", "Mark": "M", "Combining_Mark": "M", "Nonspacing_Mark": "Mn",
    "Spacing_Mark": "Mc", "Enclosing_Mark": "Me", "Number": "N", "Decimal_Number": "Nd",
    "Letter_Number": "Nl", "Other_Number": "No", "Punctuation": "P",
    "Connector_Punctuation": "Pc", "Dash_Punctuation": "Pd", "Open_Punctuation": "Ps",
    "Close_Punctuation": "Pe", "Initial_Punctuation": "Pi", "Final_Punctuation": "Pf",
    "Other_Punctuation": "Po", "Symbol": "S", "Math_Symbol": "Sm", "Currency_Symbol": "Sc",
    "Modifier_Symbol": "Sk", "Other_Symbol": "So", "Separator": "Z", "Space_Separator": "Zs",
    "Line_Separator": "Zl", "Paragraph_Separator": "Zp", "Other": "C", "Control": "Cc",
    "Format": "Cf", "Surrogate": "Cs", "Private_Use": "Co", "Unassigned": "Cn",
}
_CATEGORIES = frozenset({
    "Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd", "Ps", "Pe",
    "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co", "Cn",
})

#: what a word character (``\w`` in a class) is beyond the letters,
#: marks, decimal and letter numbers and connectors: the Other_Alphabetic
#: symbols (circled and squared Latin letters)
_WORD_EXTRA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
#: what Oniguruma's ``\w`` outside a class also matches: Latin-1's
#: superscripts and fractions
_BARE_WORD_EXTRA = (0xB2, 0xB3, 0xB9, 0xBC, 0xBD, 0xBE)
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


@functools.lru_cache(maxsize=1)
def _category_table() -> "tuple[str, ...]":
    return tuple(unicodedata.category(chr(c)) for c in range(sys.maxunicode + 1))


@functools.lru_cache(maxsize=None)
def category_codepoints(categories: "frozenset[str]") -> "tuple[int, ...]":
    """Every code point whose general category is one of ``categories``
    (two-letter names; one letter takes the whole class)."""
    table = _category_table()
    return tuple(c for c, cat in enumerate(table) if cat in categories or cat[0] in categories)


def _category_set(name: str) -> "frozenset[str]":
    short = _CATEGORY_ALIASES.get(name, name)
    if short == "LC":
        return frozenset({"Lu", "Ll", "Lt"})
    if short in _CATEGORIES or short in {c[0] for c in _CATEGORIES}:
        return frozenset({short})
    if short == "Any":
        return frozenset(_CATEGORIES)
    if re.fullmatch(r"[A-Z][A-Za-z_]*", short):
        # a Script (Han, Latin, Greek, ...) or another property
        raise needs_scripts(f"expression class \\p{{{name}}}")
    raise unsupported(f"expression class \\p{{{name}}}")


@functools.lru_cache(maxsize=None)
def escape_codepoints(escape: str) -> "tuple[int, ...]":
    """The code points of a class escape, positive form: ``s``, ``w``
    (as in a class), ``d``, ``h`` or a ``p{..}`` property."""
    if escape == "s":
        return tuple(sorted(ord(c) for c in WHITESPACE))
    if escape == "d":
        return category_codepoints(frozenset({"Nd"}))
    if escape == "h":
        return tuple(sorted(ord(c) for c in "0123456789ABCDEFabcdef"))
    if escape == "w":
        word = set(category_codepoints(frozenset({"L", "M", "Nd", "Nl", "Pc"})))
        for lo, hi in _WORD_EXTRA:
            word.update(range(lo, hi + 1))
        return tuple(sorted(word))
    return category_codepoints(_category_set(escape[2:-1]))


@functools.lru_cache(maxsize=None)
def _complement(points: "tuple[int, ...]") -> "tuple[int, ...]":
    inside = set(points)
    return tuple(c for c in range(sys.maxunicode + 1) if c not in inside)


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


_ESCAPE = re.compile(r"\\(?:([sSwWdDhH])|([pP])\{(\^?)([^}]*)\})")


@functools.lru_cache(maxsize=None)
def translate_regex(pattern: str) -> "re.Pattern":
    """The library's (Oniguruma) expression as a Python ``re``."""
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            match = _ESCAPE.match(pattern, i)
            if match is None:
                nxt = pattern[i + 1]
                out.append("\\Z" if nxt == "z" else pattern[i:i + 2])
                i += 2
                continue
            letter, prop, caret, name = match.groups()
            if letter is not None:
                points = escape_codepoints(letter.lower())
                negated = letter.isupper()
                if letter in "wW" and not in_class:
                    points = tuple(sorted({*points, *_BARE_WORD_EXTRA}))
            else:
                points = escape_codepoints(f"p{{{name}}}")
                negated = (prop == "P") != bool(caret)
            if in_class:
                out.append(ranges(_complement(points) if negated else points))
            else:
                out.append(f"[{'^' if negated else ''}{ranges(points)}]")
            i = match.end()
            continue
        if in_class:
            if c == "]":
                in_class = False
            elif c == "[":
                raise unsupported(f"nested character class in expression {pattern!r}")
            out.append(c)
        elif c == "[":
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":  # a leading "]" is literal
                out.append("\\]")
                i += 1
        elif c in "^$":
            out.append(f"(?m:{c})")
        elif pattern.startswith("(?<", i) and pattern[i + 3:i + 4] not in ("=", "!"):
            out.append("(?P<")  # a named group
            i += 3
            continue
        else:
            out.append(c)
        i += 1
    return re.compile("".join(out))


# ---------------------------------------------------------------------------
# finding and splitting
# ---------------------------------------------------------------------------

#: (start, stop, is a match) spans that cover a text, in order
Matches = "list[tuple[int, int, bool]]"


def find_iter(regex: "re.Pattern", text: str) -> Iterator["tuple[int, int]"]:
    """Oniguruma's ``find_iter``: leftmost matches, an empty match right
    where the last match ended skipped (Python's ``finditer`` keeps it)."""
    pos, last_end = 0, None
    while pos <= len(text):
        match = regex.search(text, pos)
        if match is None:
            return
        start, stop = match.span()
        if start == stop and last_end == stop:
            pos = stop + 1
            continue
        pos = last_end = stop
        yield start, stop


def regex_matches(regex: "re.Pattern", text: str) -> Matches:
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for start, stop in find_iter(regex, text):
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
    return regex_matches(re.compile(re.escape(literal)), text)


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
