"""Decoders: token strings back to text (``decode_chain``; the caller
joins what the chain returns)."""

from __future__ import annotations

import itertools
import re
from typing import Callable, Optional

from . import unsupported
from .normalizers import replace
from .pre_tokenizers import _prepend_scheme
from .text import unicode_to_bytes

__all__ = ["build_decoder", "cleanup"]

Decoder = Callable[["list[str]"], "list[str]"]

_BYTE_TOKEN = re.compile(r"\+?[0-9A-Fa-f]+")


def cleanup(text: str) -> str:
    """The ``WordPiece`` and ``CTC`` decoders' clean-up of spaces before
    punctuation and contractions."""
    for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                     (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(old, new)
    return text


def _byte_fallback(tokens: "list[str]") -> "list[str]":
    out: list[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for token in tokens:
        digits = token[3:-1]
        if (len(token.encode("utf-8")) == 6 and token.startswith("<0x") and token.endswith(">")
                and _BYTE_TOKEN.fullmatch(digits)):
            pending.append(int(digits, 16))
        else:
            flush()
            out.append(token)
    flush()
    return out


def _strip(spec: dict) -> Decoder:
    content, start, stop = spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0))

    def strip(tokens):
        out = []
        for token in tokens:
            lo = 0
            while lo < min(start, len(token)) and token[lo] == content:
                lo += 1
            hi, cut = len(token), 0
            while cut < stop and hi > lo and token[hi - 1] == content:
                hi -= 1
                cut += 1
            out.append(token[lo:hi])
        return out

    return strip


def _byte_level(tokens):
    table = unicode_to_bytes()
    data = bytearray()
    for token in tokens:
        # a token with a character outside the table (an added token's
        # own text) goes in as its UTF-8 bytes
        raw = [table.get(c) for c in token]
        data.extend(token.encode("utf-8") if None in raw else raw)
    return [data.decode("utf-8", errors="replace")]


def _wordpiece(prefix: str, clean: bool) -> Decoder:
    def run(tokens):
        out = []
        for i, token in enumerate(tokens):
            if i:
                token = token.replace(prefix, "", 1) if token.startswith(prefix) else " " + token
            out.append(cleanup(token) if clean else token)
        return out

    return run


def _ctc(pad: str, delimiter: str, clean: bool) -> Decoder:
    def run(tokens):
        out = []
        for token, _ in itertools.groupby(tokens):
            token = token.replace(pad, "") if pad else token
            if clean:
                token = cleanup(token).replace(delimiter, " ") if delimiter else cleanup(token)
            if token:
                out.append(token)
        return out

    return run


def build_decoder(spec: Optional[dict]) -> Decoder:
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_decoder(s) for s in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens

        return run
    if kind == "Replace":
        rewrite = replace(spec, "Replace decoder")
        return lambda tokens: [rewrite(t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec)
    if kind == "ByteLevel":
        return _byte_level
    if kind == "Metaspace":
        replacement = spec.get("replacement", "▁")
        drop_first = _prepend_scheme(spec) != "never"
        return lambda tokens: [
            "".join("" if c == replacement and i == 0 and drop_first
                    else " " if c == replacement else c for c in token)
            for i, token in enumerate(tokens)
        ]
    if kind == "WordPiece":
        return _wordpiece(spec.get("prefix", "##"), bool(spec.get("cleanup", True)))
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [t.replace(suffix, "" if i == len(tokens) - 1 else " ") if suffix else t
                               for i, t in enumerate(tokens)]
    if kind == "CTC":
        return _ctc(spec.get("pad_token", "<pad>"), spec.get("word_delimiter_token", "|"),
                    bool(spec.get("cleanup", True)))
    raise unsupported(f"decoder {kind!r}")
