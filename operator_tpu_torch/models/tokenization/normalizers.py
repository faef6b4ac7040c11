"""Normalizers: the text before the pre-tokenizer, a string to a string."""

from __future__ import annotations

from typing import Callable, Optional

from ..wordpiece import bert_normalize
from . import unsupported
from .charsmap import Precompiled
from .text import (WHITESPACE, byte_level, in_ranges, lowercase, normalize, regex_matches, table,
                   translate_regex)

__all__ = ["build_normalizer", "replace"]

Normalizer = Callable[[str], str]

#: ``StripAccents`` drops every combining mark of the library's table
_is_combining_mark = in_ranges(table("COMBINING_MARK"))

#: ``Nmt``: control characters it drops, and the characters it makes a space
_NMT_DROP = frozenset([*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F])
_NMT_SPACE = frozenset([0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029,
                        0x2581, 0xFEFF, 0xFFFD])


def replace(spec: dict, where: str) -> Callable[[str], str]:
    """``Replace``'s pattern (a literal ``String`` or a ``Regex``) and
    ``content``, as a function of the text (normalizer and decoder alike)."""
    pattern, content = spec.get("pattern") or {}, spec["content"]
    if "String" in pattern:
        literal = pattern["String"]
        return (lambda text: text.replace(literal, content)) if literal else (lambda text: text)
    if "Regex" in pattern:
        regex = translate_regex(pattern["Regex"])

        def run(text: str) -> str:
            return "".join(content if hit else text[a:b]
                           for a, b, hit in regex_matches(regex, text))

        return run
    raise unsupported(f"{where} with a {sorted(pattern)} pattern")


def _nmt(text: str) -> str:
    return "".join(" " if ord(c) in _NMT_SPACE else c for c in text if ord(c) not in _NMT_DROP)


def _strip(left: bool, right: bool) -> Normalizer:
    def strip(text: str) -> str:
        lo, hi = 0, len(text)
        while left and lo < hi and text[lo] in WHITESPACE:
            lo += 1
        while right and hi > lo and text[hi - 1] in WHITESPACE:
            hi -= 1
        return text[lo:hi]

    return strip


def build_normalizer(spec: Optional[dict]) -> Normalizer:
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_normalizer(s) for s in spec["normalizers"]]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text

        return run
    if kind == "Prepend":
        prepend = spec["prepend"]
        return lambda text: prepend + text if text else text
    if kind == "Replace":
        return replace(spec, "Replace normalizer")
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda text: normalize(kind, text)
    if kind == "Lowercase":
        return lowercase
    if kind == "StripAccents":
        return lambda text: "".join(c for c in text if not _is_combining_mark(c))
    if kind == "Strip":
        return _strip(bool(spec.get("strip_left", True)), bool(spec.get("strip_right", True)))
    if kind == "Nmt":
        return _nmt
    if kind == "ByteLevel":
        return byte_level
    if kind == "BertNormalizer":
        options = dict(clean_text=bool(spec.get("clean_text", True)),
                       handle_chinese_chars=bool(spec.get("handle_chinese_chars", True)),
                       strip_accents=spec.get("strip_accents"),
                       lowercase=bool(spec.get("lowercase", True)))
        return lambda text: bert_normalize(text, **options)
    if kind == "Precompiled":
        charsmap = spec.get("precompiled_charsmap")
        if not charsmap:
            raise ValueError("Precompiled normalizer without a precompiled_charsmap")
        return Precompiled.from_base64(charsmap).normalize
    raise unsupported(f"normalizer {kind!r}")
