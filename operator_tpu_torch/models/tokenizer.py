"""Tokenizers.

The port's copy of ``operator_tpu/models/tokenizer.py``: three
implementations behind one minimal interface (encode/decode/ids):

- :class:`HFTokenizer` reads a checkpoint directory's own
  ``tokenizer.json`` (and ``tokenizer_config.json``) itself — the JAX
  package goes through ``transformers.AutoTokenizer``; the port depends on
  PyTorch alone.  Every component of the ``tokenizers`` library is read
  (:mod:`.tokenization`: the BPE, WordPiece, WordLevel and Unigram models,
  the normalizers, pre-tokenizers, decoders and post-processors, the
  ``Precompiled`` charsmap), and around them what ``AutoTokenizer`` adds:
  added and special tokens split out before the model (``lstrip``,
  ``rstrip``, ``single_word``, ``normalized``), the special tokens the
  tokenizer class names by default (Llama, BERT, XLM-RoBERTa), BERT's
  normalizer rebuilt from ``do_lower_case``/``strip_accents``/
  ``tokenize_chinese_chars``, Llama's post-processor from
  ``add_bos_token``/``add_eos_token``, a top-level ``ByteLevel``
  pre-tokenizer's ``add_prefix_space`` taken from the config,
  ``clean_up_tokenization_spaces``.
  Expressions are read and run as the library's Oniguruma reads and runs
  them, its Unicode data (Script classes, ``UnicodeScripts``) included,
  every expression the library reads (Python's ``re`` or the port's own
  matcher, ``tokenization/onig_match.py``); an expression the library
  rejects raises a ``ValueError`` (so :func:`load_tokenizer` falls back
  to bytes, as the reference does); where the library gives up on a text
  (its retry limit) ``encode`` raises ``RetryLimitError``, which, like the
  library's panic, is no ``Exception``; a directory with
  a SentencePiece ``tokenizer.model`` and no ``tokenizer.json`` is not
  read, as the reference's ``transformers`` without ``sentencepiece``
  does not read it;
- :class:`~.bpe.BPETokenizer`, the shipped log-trained byte-level BPE;
- :class:`ByteTokenizer`, the dependency-free byte-level fallback.
"""

from __future__ import annotations

import json
import logging
import os
import random
import re
from typing import Any, Optional, Protocol, Sequence

from .tokenization import text as _text
from .tokenization.decoders import build_decoder
from .tokenization.models import build_model
from .tokenization.normalizers import build_normalizer
from .tokenization.pre_tokenizers import build_pre_tokenizer
from .tokenization.processors import build_post_processor

log = logging.getLogger(__name__)

__all__ = ["ByteTokenizer", "HFTokenizer", "Tokenizer", "load_tokenizer"]

#: the special-token attributes ``transformers`` reads from the config
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")
#: the special tokens a tokenizer class names when its config does not
_CLASS_DEFAULTS = {
    "llama": {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"},
    "bert": {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
             "cls_token": "[CLS]", "mask_token": "[MASK]"},
    "xlm-roberta": {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                    "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                    "mask_token": {"content": "<mask>", "lstrip": True, "normalized": True}},
}
#: ``tokenizer_class`` names (without ``Fast``) and ``config.json``
#: ``model_type``s of those families
_CLASS_FAMILIES = {"BertTokenizer": "bert", "XLMRobertaTokenizer": "xlm-roberta"}
_MODEL_TYPES = {"llama": "llama", "bert": "bert", "xlm-roberta": "xlm-roberta"}

#: pre-tokens kept in one tokenizer's cache of model ids before it is cleared
_CACHE_WORDS = 1 << 16



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


def _family(path: str, config: dict) -> Optional[str]:
    """The tokenizer class's family, as ``AutoTokenizer`` picks the class:
    ``tokenizer_config.json``'s ``tokenizer_class``, else ``config.json``'s
    ``model_type``."""
    name = config.get("tokenizer_class")
    if name:
        name = str(name)
        name = name[:-4] if name.endswith("Fast") else name
        if name in _CLASS_FAMILIES:
            return _CLASS_FAMILIES[name]
        return "llama" if "Llama" in name else None
    model_type = _read_json(os.path.join(path, "config.json")).get("model_type")
    return _MODEL_TYPES.get(model_type)


def _adjust_spec(spec: dict, config: dict, family: Optional[str]) -> None:
    """What the tokenizer classes change in the ``tokenizer.json`` they
    load: BERT rebuilds its normalizer from the config's options when one
    disagrees; every class sets a top-level ``ByteLevel`` pre-tokenizer's
    ``add_prefix_space`` to the config's (default off)."""
    normalizer = spec.get("normalizer")
    if family == "bert" and normalizer is None:
        # the class reads the normalizer's state, and fails without one
        raise ValueError("a BERT tokenizer.json without a normalizer")
    if family == "bert" and normalizer.get("type") == "BertNormalizer":
        want = {"lowercase": config.get("do_lower_case", True),
                "strip_accents": config.get("strip_accents"),
                "handle_chinese_chars": config.get("tokenize_chinese_chars", True)}
        if any(normalizer.get(key, value) != value for key, value in want.items()):
            spec["normalizer"] = {**normalizer, **want}
    pre = spec.get("pre_tokenizer")
    if pre and pre.get("type") == "ByteLevel":
        prefix = bool(config.get("add_prefix_space", False))
        if pre.get("add_prefix_space", prefix) != prefix:
            spec["pre_tokenizer"] = {**pre, "add_prefix_space": prefix}


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class HFTokenizer:
    """A checkpoint directory's ``tokenizer.json``, read without
    ``transformers``: ``encode`` is ``encode(add_special_tokens=False)``
    with BOS prepended when asked, :meth:`encode_with_special_tokens` is
    ``encode(add_special_tokens=True)`` (the post-processor's specials),
    ``decode`` is ``decode(skip_special_tokens=True)``, ``vocab_size``
    counts the added tokens (``len(tokenizer)``), and a config without a
    pad token pads with EOS (or 0) — as the JAX package's ``HFTokenizer``
    over ``AutoTokenizer``.  A BPE model with ``dropout`` draws from
    ``rng`` (a ``random.Random`` the caller may seed; a fresh one by
    default), never from the global generator."""

    def __init__(self, path: str, *, rng: Optional[random.Random] = None) -> None:
        spec_path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(spec_path):
            if os.path.exists(os.path.join(path, "tokenizer.model")):
                raise FileNotFoundError(
                    f"no tokenizer.json under {path}: a SentencePiece tokenizer.model alone is "
                    "not read (neither is it by the reference, whose transformers has no "
                    "sentencepiece)")
            raise FileNotFoundError(f"no tokenizer.json under {path}")
        with open(spec_path, encoding="utf-8") as fh:
            spec = json.load(fh)
        config = _read_json(os.path.join(path, "tokenizer_config.json"))
        # special_tokens_map.json wins over the config, as in transformers
        config.update(_read_json(os.path.join(path, "special_tokens_map.json")))
        family = _family(path, config)
        _adjust_spec(spec, config, family)
        self._model = build_model(spec["model"], rng)
        self._normalize = build_normalizer(spec.get("normalizer"))
        self._pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode_chain = build_decoder(spec.get("decoder"))
        self._post_process = build_post_processor(spec.get("post_processor"))
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self._cache: Optional[dict] = None if getattr(self._model, "dropout", 0.0) else {}

        #: id -> added token spec; content -> id
        self._added: dict[int, dict] = {}
        for token in spec.get("added_tokens") or []:
            self._add_token(token)
        for key, token in sorted((config.get("added_tokens_decoder") or {}).items(),
                                 key=lambda kv: int(kv[0])):
            self._add_token({**token, "id": int(key)})
        defaults = _CLASS_DEFAULTS.get(family, {})
        special = {key: config[key] if key in config else defaults.get(key)
                   for key in _SPECIAL_KEYS}
        for value in [*special.values(), *(config.get("additional_special_tokens") or [])]:
            if _token_content(value) is not None:
                extra = value if isinstance(value, dict) else {}
                self._add_token({"normalized": False, **{k: v for k, v in extra.items()
                                                         if k in ("lstrip", "rstrip", "normalized",
                                                                  "single_word")},
                                 "content": _token_content(value), "special": True})
        self._added_ids = {t["content"]: i for i, t in self._added.items()}
        self._special = {t["content"] for t in self._added.values() if t.get("special")}
        self._raw_split = self._splitter(normalized=False)
        self._normalized_split = self._splitter(normalized=True)

        self.vocab_size = len(set(self._model.vocab) | set(self._added_ids))
        ids = {key: self.token_to_id(_token_content(value)) if value is not None else None
               for key, value in special.items()}
        self.bos_id: Optional[int] = ids["bos_token"]
        self.eos_id: Optional[int] = ids["eos_token"]
        pad = ids["pad_token"]
        self.pad_id = int(pad if pad is not None else (self.eos_id or 0))
        if family == "llama":
            # LlamaTokenizerFast rebuilds its post-processor from
            # add_bos_token / add_eos_token
            before = [ids["bos_token"]] if config.get("add_bos_token", True) else []
            after = [ids["eos_token"]] if config.get("add_eos_token", False) else []
            if None in before + after:
                raise ValueError("add_bos_token/add_eos_token without the token")
            self._post_process = lambda seq: [*before, *seq, *after]

    def _add_token(self, token: dict) -> None:
        """Register an added token the way ``add_tokens`` does: its own id
        when it names one, else the vocab's id for its content, else the
        next free id."""
        content = token["content"]
        if any(t["content"] == content for t in self._added.values()):
            return
        token_id = token.get("id")
        if token_id is None:
            token_id = self._model.vocab.get(content)
        if token_id is None:
            token_id = max([*self._model.vocab.values(), *self._added, -1]) + 1
        self._added[int(token_id)] = token

    def _encode_word(self, word: str) -> list[int]:
        """The model's ids of a pre-token, cached (as the library caches
        its BPE words) unless BPE dropout draws anew each time."""
        if self._cache is None:
            return self._model.encode_word(word)
        ids = self._cache.get(word)
        if ids is None:
            if len(self._cache) >= _CACHE_WORDS:
                self._cache.clear()
            ids = self._cache[word] = self._model.encode_word(word)
        return ids

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
        unnormalized, others to normalized); a normalized token is matched
        by its normalized content."""
        tokens: dict[str, dict] = {}
        for t in self._added.values():
            if bool(t.get("normalized", not t.get("special"))) != normalized or not t["content"]:
                continue
            key = self._normalize(t["content"]) if normalized else t["content"]
            if key:
                tokens.setdefault(key, t)
        if not tokens:
            return None
        pattern = re.compile("|".join(
            re.escape(c) for c in sorted(tokens, key=len, reverse=True)))
        return pattern, tokens

    def _split_added(self, text: str, splitter) -> list[tuple[Optional[int], str, int]]:
        """``(added id or None, text, start)`` pieces of ``text``; an
        ``lstrip``/``rstrip`` token takes the whitespace beside it, a
        ``single_word`` one matches only between non-word characters."""
        if splitter is None or not text:
            return [(None, text, 0)]
        pattern, tokens = splitter
        out: list[tuple[Optional[int], str, int]] = []
        offset = 0
        for match in pattern.finditer(text):
            start, stop = match.span()
            token = tokens[match.group()]
            if token.get("single_word") and (
                    (start > 0 and _text.is_word(text[start - 1]))
                    or (stop < len(text) and _text.is_word(text[stop]))):
                continue
            if token.get("lstrip"):
                while start > offset and text[start - 1] in _text.WHITESPACE:
                    start -= 1
            if token.get("rstrip"):
                while stop < len(text) and text[stop] in _text.WHITESPACE:
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
                    ids.extend(self._encode_word(word))
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def encode_with_special_tokens(self, text: str) -> list[int]:
        """``encode(text, add_special_tokens=True)``: the post-processor's
        specials around the ids (the encoder's tokenization)."""
        return self._post_process(self.encode(text, add_bos=False))

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

    A ``tokenizer.json`` component the port does not read (an unknown
    component type) raises ``NotImplementedError`` instead of falling
    back: a mounted checkpoint must not be served through the wrong
    vocabulary quietly.  One the library rejects (an expression it does
    not read too) falls back to bytes, as the reference does.
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
