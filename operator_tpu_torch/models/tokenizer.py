"""Tokenizers.

The port's copy of ``operator_tpu/models/tokenizer.py``: three
implementations behind one minimal interface (encode/decode/ids):

- :class:`HFTokenizer` reads a checkpoint directory's own
  ``tokenizer.json`` (and ``tokenizer_config.json``) itself — the JAX
  package goes through ``transformers.AutoTokenizer``; the port depends on
  PyTorch alone.  It covers the SentencePiece-style BPE of TinyLlama,
  Llama-2 and Mistral (the ``Prepend("▁")`` + ``Replace(" ", "▁")``
  normalizer or the ``Metaspace`` pre-tokenizer, ``<0xNN>`` byte fallback
  with ``fuse_unk``, the ``Replace``/``ByteFallback``/``Fuse``/``Strip``
  or ``Metaspace`` decoder chain) and the byte-level family of Llama-3 and
  Qwen2.5 (the ``NFC`` normalizer, the ``Split`` pre-tokenizer with their
  regular expressions, the ``ByteLevel`` pre-tokenizer and decoder over
  GPT-2's byte-to-unicode table, BPE with ``ignore_merges``): rank-ordered
  merges, added/special tokens split out before the model, each step as
  the ``tokenizers`` library runs it.  Python's ``re`` has no ``\\p{L}`` or
  ``\\p{N}``: those classes (and ``\\s``, Unicode White_Space as the
  library's Oniguruma reads it) are built once from ``unicodedata`` and
  written into the expression as ranges.  Anything else in a
  ``tokenizer.json`` — another model type, a ``Regex`` replace, the
  ``NFKC``/``Lowercase``/``Precompiled`` normalizers, ``single_word``
  added tokens, BPE dropout, a lone ``tokenizer.model`` — raises
  ``NotImplementedError`` naming ROADMAP Queue 1 item 4c;
- :class:`~.bpe.BPETokenizer`, the shipped log-trained byte-level BPE;
- :class:`ByteTokenizer`, the dependency-free byte-level fallback.
"""

from __future__ import annotations

import functools
import heapq
import json
import logging
import os
import re
import sys
import unicodedata
from typing import Any, Callable, Optional, Protocol, Sequence

log = logging.getLogger(__name__)

__all__ = ["ByteTokenizer", "HFTokenizer", "Tokenizer", "load_tokenizer"]

_ITEM_4C = "ROADMAP.md Queue 1 item 4c"

#: ``char::is_whitespace`` (Unicode White_Space), which the added-token
#: ``lstrip``/``rstrip`` rules use; Python's ``str.isspace`` also counts
#: U+001C..U+001F
_RUST_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)

#: the special-token attributes ``transformers`` reads from the config
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token")
#: ``LlamaTokenizerFast``'s defaults for a config that names none
_LLAMA_DEFAULTS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: Optional[int]
    eos_id: Optional[int]
    pad_id: int

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted by the special-token block."""

    SPECIALS = 3  # pad=0, bos=1, eos=2

    def __init__(self) -> None:
        self.pad_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.vocab_size = 256 + self.SPECIALS

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = [b + self.SPECIALS for b in text.encode("utf-8")]
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids beyond the byte range are skipped (a model vocab can exceed
        # the tokenizer's 259 ids; sampling may legally pick those)
        data = bytes(
            i - self.SPECIALS for i in ids if self.SPECIALS <= i < 256 + self.SPECIALS
        )
        return data.decode("utf-8", errors="replace")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tokenizer.json {what} is not read by operator_tpu_torch yet "
        f"({_ITEM_4C}: the other tokenizer.json features)"
    )


def _string_pattern(spec: dict, where: str) -> str:
    pattern = spec.get("pattern") or {}
    if "String" not in pattern:
        raise _unsupported(f"{where} with a {sorted(pattern)} pattern")
    return pattern["String"]


# ---------------------------------------------------------------------------
# Unicode classes for the byte-level pre-tokenizer's expressions
# ---------------------------------------------------------------------------


def _ranges(chars: "list[int]") -> str:
    """Code points as the body of an ``re`` character class."""
    out, start, prev = [], None, None
    for c in chars + [-2]:
        if start is not None and c == prev + 1:
            prev = c
            continue
        if start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(prev))
            out.append(lo if start == prev else f"{lo}-{hi}")
        start = prev = c
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _unicode_class(name: str) -> str:
    """``\\p{L}`` (letters), ``\\p{N}`` (numbers) or ``\\s`` (White_Space,
    which Oniguruma's ``\\s`` matches; Python's also takes U+001C..U+001F)
    as class ranges, built once from ``unicodedata``."""
    if name == "s":
        return _ranges(sorted(ord(c) for c in _RUST_WHITESPACE))
    return _ranges([c for c in range(sys.maxunicode + 1)
                    if unicodedata.category(chr(c))[0] == name])


def _translate_regex(pattern: str) -> "re.Pattern":
    """The ``tokenizers`` (Oniguruma) expression as a Python ``re``:
    ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` become explicit ranges,
    inside a class or standing alone; other escapes pass through."""
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt == "p":
                match = re.match(r"\\p\{(\w+)\}", pattern[i:])
                if match is None or match.group(1) not in ("L", "N"):
                    raise _unsupported(f"Split pattern class {pattern[i:i + 8]!r}")
                body = _unicode_class(match.group(1))
                out.append(body if in_class else f"[{body}]")
                i += match.end()
                continue
            if nxt in "sS":
                body = _unicode_class("s")
                if in_class:
                    if nxt == "S":
                        raise _unsupported("Split pattern with \\S inside a class")
                    out.append(body)
                else:
                    out.append(f"[{body}]" if nxt == "s" else f"[^{body}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return re.compile("".join(out))


@functools.lru_cache(maxsize=None)
def _bytes_to_unicode() -> "dict[int, str]":
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
def _unicode_to_bytes() -> "dict[str, int]":
    return {c: b for b, c in _bytes_to_unicode().items()}


#: GPT-2's expression: ``ByteLevel`` with ``use_regex`` splits by it
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                 r"|\s+(?!\S)|\s+")


# ---------------------------------------------------------------------------
# the BPE model
# ---------------------------------------------------------------------------


class _BPEModel:
    """``tokenizers``' BPE model: characters (or their ``<0xNN>`` bytes,
    or the unknown token) merged by rank, lowest first, leftmost among
    equals."""

    def __init__(self, spec: dict) -> None:
        if spec.get("type") != "BPE":
            raise _unsupported(f"model type {spec.get('type')!r}")
        for option in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(option):
                raise _unsupported(f"BPE {option}")
        #: a word that is in the vocab whole is taken whole (Llama-3)
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        #: (left id, right id) -> (rank, merged id); a repeated pair keeps
        #: its last rank, as the library's map does
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(spec.get("merges") or []):
            if isinstance(merge, str):
                parts = merge.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"bad BPE merge {merge!r}")
                left, right = parts
            else:
                left, right = merge
            try:
                pair = (self.vocab[left], self.vocab[right])
                self.merges[pair] = (rank, self.vocab[left + right])
            except KeyError as exc:
                raise ValueError(f"BPE merge {merge!r} names a token not in the vocab: {exc}") from None

    def _symbols(self, word: str) -> list[int]:
        ids: list[int] = []
        unk: Optional[int] = None  # a pending unknown token
        for char in word:
            token_id = self.vocab.get(char)
            if token_id is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(token_id)
                continue
            if self.byte_fallback:
                byte_ids = [self.vocab.get(f"<0x{b:02X}>") for b in char.encode("utf-8")]
                if None not in byte_ids:
                    # the library does not flush a pending unknown first
                    ids.extend(byte_ids)
                    continue
            if self.unk_token is not None:
                if self.unk_token not in self.vocab:
                    raise ValueError(f"unk_token {self.unk_token!r} is not in the vocab")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk_token]
        if unk is not None:
            ids.append(unk)
        return ids

    def encode_word(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        sym = self._symbols(word)
        n = len(sym)
        if n < 2:
            return sym
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = [
            (rank, i, new_id)
            for i in range(n - 1)
            for rank, new_id in [self.merges.get((sym[i], sym[i + 1]), (None, None))]
            if rank is not None
        ]
        heapq.heapify(heap)
        while heap:
            rank, i, new_id = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j == -1:
                continue
            merge = self.merges.get((sym[i], sym[j]))
            if merge is None or merge[1] != new_id:
                continue  # an expired entry
            sym[i] = new_id
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prev[nxt[j]] = i
            for left, right in ((prev[i], i), (i, nxt[i])):
                if left != -1 and right != -1:
                    merge = self.merges.get((sym[left], sym[right]))
                    if merge is not None:
                        heapq.heappush(heap, (merge[0], left, merge[1]))
        return [s for s, keep in zip(sym, alive) if keep]


# ---------------------------------------------------------------------------
# normalizers, pre-tokenizers, decoders
# ---------------------------------------------------------------------------


def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text

        return run
    if kind == "Prepend":
        prepend = spec["prepend"]
        return lambda text: prepend + text if text else text
    if kind == "Replace":
        pattern, content = _string_pattern(spec, "Replace normalizer"), spec["content"]
        return lambda text: text.replace(pattern, content)
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    raise _unsupported(f"normalizer {kind!r}")


def _prepend_scheme(spec: dict) -> str:
    if "prepend_scheme" in spec:
        return spec["prepend_scheme"]
    return "always" if spec.get("add_prefix_space", True) else "never"


def _split_isolated(regex: "re.Pattern", text: str) -> list[str]:
    """``Split`` with ``behavior: Isolated``: every match is a piece, and
    so is every stretch between matches."""
    out, offset = [], 0
    for match in regex.finditer(text):
        start, stop = match.span()
        if start == stop:
            continue
        if offset < start:
            out.append(text[offset:start])
        out.append(text[start:stop])
        offset = stop
    if offset < len(text):
        out.append(text[offset:])
    return out


def _pre_tokenizer(spec: Optional[dict]) -> Callable[[list[tuple[str, bool]]], list[tuple[str, bool]]]:
    """Maps pieces ``(text, starts the input)`` to finer pieces."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def sequence(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces

        return sequence
    if kind == "Split":
        pattern = spec.get("pattern") or {}
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise _unsupported(
                f"Split behavior {spec.get('behavior')!r} (invert={spec.get('invert')})")
        if "Regex" in pattern:
            regex = _translate_regex(pattern["Regex"])
        else:
            regex = re.compile(re.escape(_string_pattern(spec, "Split")))

        def split(pieces):
            return [(part, first and k == 0) for text, first in pieces
                    for k, part in enumerate(_split_isolated(regex, text))]

        return split
    if kind == "ByteLevel":
        table = _bytes_to_unicode()
        prefix = bool(spec.get("add_prefix_space", True))
        regex = _translate_regex(_GPT2_PATTERN) if spec.get("use_regex", True) else None

        def byte_level(pieces):
            out = []
            for text, first in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                parts = _split_isolated(regex, text) if regex is not None else [text]
                out.extend(("".join(table[b] for b in part.encode("utf-8")), first and k == 0)
                           for k, part in enumerate(parts))
            return out

        return byte_level
    if kind == "Metaspace":
        replacement = spec.get("replacement", "▁")
        scheme, split = _prepend_scheme(spec), spec.get("split", True)

        def metaspace(pieces):
            out = []
            for text, first in pieces:
                if not text:
                    continue
                text = text.replace(" ", replacement)
                if (scheme == "always" or (scheme == "first" and first)) and not text.startswith(replacement):
                    text = replacement + text
                if split:
                    # each replacement starts a new piece (merged with next)
                    out.extend((part, first and k == 0) for k, part in enumerate(
                        p for p in re.split(f"(?={re.escape(replacement)})", text) if p))
                else:
                    out.append((text, first))
            return out

        return metaspace
    raise _unsupported(f"pre_tokenizer {kind!r}")


def _byte_fallback(tokens: list[str]) -> list[str]:
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
                and re.fullmatch(r"\+?[0-9A-Fa-f]+", digits)):
            pending.append(int(digits, 16))
        else:
            flush()
            out.append(token)
    flush()
    return out


def _decoder(spec: Optional[dict]) -> Callable[[list[str]], list[str]]:
    """``decode_chain``: token strings -> strings, joined by the caller."""
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens

        return run
    if kind == "Replace":
        pattern, content = _string_pattern(spec, "Replace decoder"), spec["content"]
        return lambda tokens: [t.replace(pattern, content) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
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
    if kind == "ByteLevel":
        table = _unicode_to_bytes()

        def byte_level(tokens):
            data = bytearray()
            for token in tokens:
                # a token with a character outside the table (an added
                # token's own text) goes in as its UTF-8 bytes
                raw = [table.get(c) for c in token]
                data.extend(token.encode("utf-8") if None in raw else raw)
            return [data.decode("utf-8", errors="replace")]

        return byte_level
    if kind == "Metaspace":
        replacement = spec.get("replacement", "▁")
        drop_first = _prepend_scheme(spec) != "never"
        return lambda tokens: [
            "".join("" if c == replacement and i == 0 and drop_first
                    else " " if c == replacement else c for c in token)
            for i, token in enumerate(tokens)
        ]
    raise _unsupported(f"decoder {kind!r}")


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                     (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                     (" 're", "'re")):
        text = text.replace(old, new)
    return text


def _token_content(value: Any) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class HFTokenizer:
    """A checkpoint directory's ``tokenizer.json``, read without
    ``transformers``: ``encode`` is ``encode(add_special_tokens=False)``
    with BOS prepended when asked, ``decode`` is
    ``decode(skip_special_tokens=True)``, ``vocab_size`` counts the added
    tokens (``len(tokenizer)``), and a config without a pad token pads
    with EOS (or 0) — as the JAX package's ``HFTokenizer`` over
    ``AutoTokenizer``."""

    def __init__(self, path: str) -> None:
        spec_path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(spec_path):
            if os.path.exists(os.path.join(path, "tokenizer.model")):
                raise _unsupported(f"(absent in {path}; a SentencePiece tokenizer.model)")
            raise FileNotFoundError(f"no tokenizer.json under {path}")
        with open(spec_path, encoding="utf-8") as fh:
            spec = json.load(fh)
        config = _read_json(os.path.join(path, "tokenizer_config.json"))
        # special_tokens_map.json wins over the config, as in transformers
        config.update(_read_json(os.path.join(path, "special_tokens_map.json")))
        self._model = _BPEModel(spec["model"])
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode_chain = _decoder(spec.get("decoder"))
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))

        #: id -> added token spec; content -> id
        self._added: dict[int, dict] = {}
        for token in spec.get("added_tokens") or []:
            self._add_token(token)
        for key, token in sorted((config.get("added_tokens_decoder") or {}).items(),
                                 key=lambda kv: int(kv[0])):
            self._add_token({**token, "id": int(key)})
        llama = "Llama" in str(config.get("tokenizer_class") or "")
        special = {
            key: _token_content(config[key] if key in config else
                                _LLAMA_DEFAULTS.get(key) if llama else None)
            for key in _SPECIAL_KEYS
        }
        for content in special.values():
            if content is not None:
                self._add_token({"content": content, "special": True, "normalized": False})
        self._added_ids = {t["content"]: i for i, t in self._added.items()}
        self._special = {t["content"] for t in self._added.values() if t.get("special")}
        self._raw_split = self._splitter(normalized=False)
        self._normalized_split = self._splitter(normalized=True)

        self.vocab_size = len(set(self._model.vocab) | set(self._added_ids))
        ids = {key: self.token_to_id(content) if content is not None else None
               for key, content in special.items()}
        self.bos_id: Optional[int] = ids["bos_token"]
        self.eos_id: Optional[int] = ids["eos_token"]
        pad = ids["pad_token"]
        self.pad_id = int(pad if pad is not None else (self.eos_id or 0))

    def _add_token(self, token: dict) -> None:
        """Register an added token the way ``add_tokens`` does: its own id
        when it names one, else the vocab's id for its content, else the
        next free id."""
        content = token["content"]
        if any(t["content"] == content for t in self._added.values()):
            return
        if token.get("single_word"):
            raise _unsupported(f"single_word added token {content!r}")
        token_id = token.get("id")
        if token_id is None:
            token_id = self._model.vocab.get(content)
        if token_id is None:
            token_id = max([*self._model.vocab.values(), *self._added, -1]) + 1
        self._added[int(token_id)] = token

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self._added_ids:
            return self._added_ids[token]
        if token in self._model.vocab:
            return self._model.vocab[token]
        unk = self._model.unk_token
        return self.token_to_id(unk) if unk is not None and unk != token else None

    def _splitter(self, *, normalized: bool):
        """Leftmost-longest matcher over the added tokens whose
        ``normalized`` flag is ``normalized`` (special tokens default to
        unnormalized, others to normalized)."""
        tokens = {t["content"]: t for t in self._added.values()
                  if bool(t.get("normalized", not t.get("special"))) == normalized and t["content"]}
        if not tokens:
            return None
        pattern = re.compile("|".join(
            re.escape(c) for c in sorted(tokens, key=len, reverse=True)))
        return pattern, tokens

    def _split_added(self, text: str, splitter) -> list[tuple[Optional[int], str, int]]:
        """``(added id or None, text, start)`` pieces of ``text``; an
        ``lstrip``/``rstrip`` token takes the whitespace beside it."""
        if splitter is None or not text:
            return [(None, text, 0)]
        pattern, tokens = splitter
        out: list[tuple[Optional[int], str, int]] = []
        offset = 0
        for match in pattern.finditer(text):
            start, stop = match.span()
            token = tokens[match.group()]
            if token.get("lstrip"):
                while start > offset and text[start - 1] in _RUST_WHITESPACE:
                    start -= 1
            if token.get("rstrip"):
                while stop < len(text) and text[stop] in _RUST_WHITESPACE:
                    stop += 1
            if offset < start:
                out.append((None, text[offset:start], offset))
            out.append((self._added_ids[token["content"]], text[start:stop], start))
            offset = stop
        if offset < len(text):
            out.append((None, text[offset:], offset))
        return out

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids: list[int] = []
        for added, piece, start in self._split_added(text, self._raw_split):
            if added is not None:
                ids.append(added)
                continue
            normalized = self._normalize(piece)
            for added2, sub, sub_start in self._split_added(normalized, self._normalized_split):
                if added2 is not None:
                    ids.append(added2)
                    continue
                for word, _ in self._pre_tokenize([(sub, start == 0 and sub_start == 0)]):
                    ids.extend(self._model.encode_word(word))
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        tokens = []
        for i in ids:
            token = self._added[i]["content"] if i in self._added else self._model.id_to_token.get(i)
            if token is None or token in self._special:
                continue
            tokens.append(token)
        text = "".join(self._decode_chain(tokens))
        return _clean_up_tokenization(text) if self._clean_up else text


def load_tokenizer(path: Optional[str]) -> Tokenizer:
    """Resolve a tokenizer spec:

    - ``"builtin-bpe"`` — the shipped log-trained byte-level BPE
      (models/bpe.py, vocab 4096; no egress needed);
    - a directory path — its ``tokenizer.json`` (:class:`HFTokenizer`);
    - ``None``/``"byte"``/load failure — the byte fallback.

    A ``tokenizer.json`` the port cannot read yet raises
    ``NotImplementedError`` instead of falling back: a mounted checkpoint
    must not be served through the wrong vocabulary quietly.
    """
    if path == "byte":
        return ByteTokenizer()
    if path == "builtin-bpe":
        from .bpe import load_builtin_bpe

        bpe = load_builtin_bpe()
        if bpe is not None:
            return bpe
        log.warning("builtin BPE vocab missing; using byte fallback")
        return ByteTokenizer()
    if path:
        try:
            return HFTokenizer(path)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 - degrade to bytes, as the reference
            log.warning(
                "failed to load tokenizer from %s; using byte fallback", path, exc_info=True
            )
    return ByteTokenizer()
