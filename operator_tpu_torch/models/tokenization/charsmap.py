"""The ``Precompiled`` normalizer: SentencePiece's compiled character map.

``precompiled_charsmap`` is base64 of a little-endian ``u32`` byte size,
that many bytes of a darts-clone double array over UTF-8 keys, then the
normalized strings, each ended by a NUL; a key's value is its string's
offset.  The library (``spm_precompiled``) cuts the text into extended
grapheme clusters (UAX #29) and replaces a cluster under 6 bytes whole
when a prefix of it is a key (the shortest such prefix's string stands
for the cluster); anything else goes character by character, each
replaced when it is a key.  Python has no grapheme segmentation: the
cluster rules are here, the Indic conjunct rule (GB9c) among them, over
the break classes probed from the library's ``Precompiled``
(``tables.GRAPHEMES``), not ``unicodedata``'s.
"""

from __future__ import annotations

import base64
import bisect
import functools
import re
import struct
from typing import Optional

from . import tables
from .onig import decode

__all__ = ["Precompiled", "graphemes"]


class Precompiled:
    """A charsmap, read from its bytes."""

    def __init__(self, blob: bytes) -> None:
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: too short")
        (trie_bytes,) = struct.unpack_from("<I", blob)
        if trie_bytes % 4 or 4 + trie_bytes > len(blob):
            raise ValueError(f"precompiled_charsmap: bad trie size {trie_bytes}")
        self._units = struct.unpack_from(f"<{trie_bytes // 4}I", blob, 4)
        self._normalized = bytes(blob[4 + trie_bytes:])
        self._normalized.decode("utf-8")  # the library requires UTF-8
        #: chunk -> its string (or None), for the chunks met so far
        self._seen: dict[str, Optional[str]] = {}

    @classmethod
    def from_base64(cls, text: str) -> "Precompiled":
        return cls(base64.b64decode(text))

    def _first_prefix_value(self, key: bytes) -> Optional[int]:
        """darts-clone's common-prefix search, first (shortest) hit."""
        units = self._units
        if not units:
            return None
        unit = units[0]
        pos = _offset(unit)
        for byte in key:
            if byte == 0:
                break
            pos ^= byte
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != byte:
                return None
            pos ^= _offset(unit)
            if (unit >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        if chunk in self._seen:
            return self._seen[chunk]
        value = self._first_prefix_value(chunk.encode("utf-8"))
        if value is None:
            norm = None
        else:
            end = self._normalized.find(b"\0", value)
            norm = self._normalized[value:end if end >= 0 else None].decode("utf-8")
        if len(self._seen) < _SEEN_CHUNKS:
            self._seen[chunk] = norm
        return norm

    def normalize(self, text: str) -> str:
        out: list[str] = []
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for char in cluster:
                norm = self.transform(char)
                out.append(char if norm is None else norm)
        return "".join(out)


#: chunks whose lookups one charsmap keeps
_SEEN_CHUNKS = 1 << 16


def _offset(unit: int) -> int:
    return (unit >> 10) << ((unit & (1 << 9)) >> 6)


# ---------------------------------------------------------------------------
# extended grapheme clusters (UAX #29)
# ---------------------------------------------------------------------------

_ASCII_CLUSTERS = re.compile(r"\r\n|[\x00-\x7f]")

#: the break classes, one per code point (the rest are Other), and the
#: Indic conjunct classes beside them
_BREAK_CLASSES = ("CR", "LF", "ZWJ", "Control", "Prepend", "Extend", "SpacingMark", "L", "V",
                  "T", "LV", "LVT", "RI", "ExtPict")
_CONJUNCT_CLASSES = ("Consonant", "Linker", "InCBExtend")


def _runs(names) -> "tuple[list[int], list[tuple[int, str]]]":
    """Run starts and (last code point, class) of the named classes."""
    runs = sorted((lo, hi, name) for name in names for lo, hi in decode(tables.GRAPHEMES[name]))
    return [lo for lo, _, _ in runs], [(hi, name) for _, hi, name in runs]


@functools.lru_cache(maxsize=1)
def _class_runs() -> tuple:
    return _runs(_BREAK_CLASSES), _runs(_CONJUNCT_CLASSES)


def _lookup(runs, cp: int, default: Optional[str]) -> Optional[str]:
    starts, ends = runs
    i = bisect.bisect_right(starts, cp) - 1
    if i >= 0 and cp <= ends[i][0]:
        return ends[i][1]
    return default


@functools.lru_cache(maxsize=4096)
def _break_property(char: str) -> "tuple[str, Optional[str]]":
    """The character's break class and its Indic conjunct class (or None)."""
    breaks, conjuncts = _class_runs()
    cp = ord(char)
    return _lookup(breaks, cp, "Other"), _lookup(conjuncts, cp, None)


def graphemes(text: str) -> "list[str]":
    """``text`` cut into extended grapheme clusters."""
    if not text:
        return []
    if text.isascii():
        # no extenders, prepends or joiners: only CR LF holds together
        return _ASCII_CLUSTERS.findall(text)
    out: list[str] = []
    start = 0
    props = [_break_property(c) for c in text]
    # GB11: inside an emoji sequence (Pictographic Extend* ZWJ) the next
    # Pictographic joins; GB12/13: regional indicators pair up; GB9c: a
    # consonant after consonant [Extend Linker]* Linker [Extend Linker]*
    pict_zwj = False
    in_pict = props[0][0] == "ExtPict"
    ri_run = 1 if props[0][0] == "RI" else 0
    conjunct = "consonant" if props[0][1] == "Consonant" else None
    for i in range(1, len(text)):
        prev, (cur, incb) = props[i - 1][0], props[i]
        if prev == "CR" and cur == "LF":
            keep = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
            keep = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            keep = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            keep = True
        elif prev in ("LVT", "T") and cur == "T":
            keep = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            keep = True
        elif incb == "Consonant" and conjunct == "linked":
            keep = True
        elif prev == "ZWJ" and cur == "ExtPict" and pict_zwj:
            keep = True
        elif prev == "RI" and cur == "RI":
            keep = ri_run % 2 == 1
        else:
            keep = False
        if not keep:
            out.append(text[start:i])
            start = i
        # the emoji-sequence state after character i
        if cur == "ExtPict":
            in_pict = True
        elif cur == "ZWJ":
            pict_zwj = in_pict
            in_pict = False
        elif cur != "Extend":
            in_pict = False
        if cur != "ZWJ":
            pict_zwj = False
        ri_run = ri_run + 1 if cur == "RI" else 0
        # the conjunct state after character i
        if incb == "Consonant":
            conjunct = "consonant"
        elif incb == "Linker" and conjunct:
            conjunct = "linked"
        elif incb != "InCBExtend":
            conjunct = None
    out.append(text[start:])
    return out
