"""The ``Precompiled`` normalizer: SentencePiece's compiled character map.

``precompiled_charsmap`` is base64 of a little-endian ``u32`` byte size,
that many bytes of a darts-clone double array over UTF-8 keys, then the
normalized strings, each ended by a NUL; a key's value is its string's
offset.  The library (``spm_precompiled``) cuts the text into extended
grapheme clusters (UAX #29) and replaces a cluster under 6 bytes whole
when a prefix of it is a key (the shortest such prefix's string stands
for the cluster); anything else goes character by character, each
replaced when it is a key.  Python has no grapheme segmentation: the
cluster rules are here, with the break properties built from
``unicodedata`` and the few lists it lacks (Prepend, the Grapheme_Extend
exceptions, Extended_Pictographic), as of Unicode 15.0, without 15.1's
Indic conjunct rule (GB9c) — a cluster it would join spans 6 bytes or
more, which goes character by character either way.
"""

from __future__ import annotations

import base64
import functools
import re
import struct
import unicodedata
from typing import Optional

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

_PREPEND = frozenset([*range(0x0600, 0x0606), 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E,
                      0x110BD, 0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A,
                      *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02])
#: Other_Grapheme_Extend (spacing marks and others that extend) and the
#: emoji modifiers, which are Extend since Unicode 11
_EXTEND_EXTRA = frozenset([
    0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E, 0x0D57,
    0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E, 0x302F, 0xFF9E, 0xFF9F, 0x1133E, 0x11357, 0x114B0,
    0x114BD, 0x115AF, 0x11930, 0x1D165, *range(0x1D16E, 0x1D173), *range(0xE0020, 0xE0080),
    *range(0x1F3FB, 0x1F400)])
#: Mc characters that are not SpacingMark
_NOT_SPACING = frozenset([0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, *range(0x1067, 0x106E),
                          0x1083, *range(0x1087, 0x108D), 0x108F, 0x109A, 0x109B, 0x109C,
                          0x1A61, 0x1A63, 0x1A64, 0xAA7B, 0xAA7D, 0x11720, 0x11721])
_PICTOGRAPHIC_RANGES = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
    (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
    (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), (0x2714, 0x2714),
    (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755),
    (0x2757, 0x2757), (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
    (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297), (0x3299, 0x3299),
    (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A),
    (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F),
    (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF),
    (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD),
)


_ASCII_CLUSTERS = re.compile(r"\r\n|[\x00-\x7f]")


@functools.lru_cache(maxsize=4096)
def _break_property(char: str) -> str:
    cp = ord(char)
    if char == "\r":
        return "CR"
    if char == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if cp in _EXTEND_EXTRA:
        return "Extend"
    if cp in _PREPEND:
        return "Prepend"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    category = unicodedata.category(char)
    if category in ("Mn", "Me"):
        return "Extend"
    if category == "Mc" or cp in (0x0E33, 0x0EB3):
        return "Other" if cp in _NOT_SPACING else "SpacingMark"
    if category in ("Cc", "Zl", "Zp", "Cs") or (category == "Cf" and cp not in (0x200C, 0x200D)):
        return "Control"
    if any(lo <= cp <= hi for lo, hi in _PICTOGRAPHIC_RANGES):
        return "Pictographic"
    return "Other"


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
    # Pictographic joins; GB12/13: regional indicators pair up
    pict_zwj = False
    in_pict = props[0] == "Pictographic"
    ri_run = 1 if props[0] == "RI" else 0
    for i in range(1, len(text)):
        prev, cur = props[i - 1], props[i]
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
        elif prev == "ZWJ" and cur == "Pictographic" and pict_zwj:
            keep = True
        elif prev == "RI" and cur == "RI":
            keep = ri_run % 2 == 1
        else:
            keep = False
        if not keep:
            out.append(text[start:i])
            start = i
        # the emoji-sequence state after character i
        if cur == "Pictographic":
            in_pict = True
        elif cur == "ZWJ":
            pict_zwj = in_pict
            in_pict = False
        elif cur != "Extend":
            in_pict = False
        if cur != "ZWJ":
            pict_zwj = False
        ri_run = ri_run + 1 if cur == "RI" else 0
    out.append(text[start:])
    return out
