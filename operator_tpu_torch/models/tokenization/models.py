"""The four models of a ``tokenizer.json``: a pre-token to ids.

Each model has ``vocab`` (token -> id), ``id_to_token``, ``unk_token``
and ``encode_word(word) -> ids``.
"""

from __future__ import annotations

import heapq
import random
from typing import Optional

from ..wordpiece import wordpiece
from . import unsupported

__all__ = ["BPE", "Unigram", "WordLevel", "WordPiece", "build_model"]

#: the Unigram model scores an unknown character this far below its
#: lowest piece (``kUnkPenalty``)
UNK_PENALTY = 10.0


def _byte_tokens(text: str, vocab: dict) -> "Optional[list[int]]":
    """``<0xNN>`` ids of ``text``'s UTF-8 bytes, or None when one is missing."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in text.encode("utf-8")]
    return None if None in ids else ids


class BPE:
    """``tokenizers``' BPE model: characters (with the continuing-subword
    prefix after the first and the end-of-word suffix on the last), or
    their ``<0xNN>`` bytes, or the unknown token, merged by rank, lowest
    first, leftmost among equals.  With ``dropout`` a merge popped from
    the queue is skipped with that probability (drawn from ``rng``) and
    put back after the next merge made, and neither ``ignore_merges`` nor
    the cache applies — as the library does."""

    def __init__(self, spec: dict, rng: Optional[random.Random] = None) -> None:
        #: a word that is in the vocab whole is taken whole (Llama-3)
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.prefix: str = spec.get("continuing_subword_prefix") or ""
        self.suffix: str = spec.get("end_of_word_suffix") or ""
        dropout = spec.get("dropout")
        if dropout is not None and not 0.0 <= dropout <= 1.0:
            raise ValueError(f"BPE dropout {dropout} is not a probability")
        self.dropout: float = float(dropout or 0.0)
        self.rng = rng if rng is not None else random.Random()
        prefix_bytes = len(self.prefix.encode("utf-8"))
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
            merged = left + right.encode("utf-8")[prefix_bytes:].decode("utf-8", errors="replace")
            try:
                pair = (self.vocab[left], self.vocab[right])
                self.merges[pair] = (rank, self.vocab[merged])
            except KeyError as exc:
                raise ValueError(f"BPE merge {merge!r} names a token not in the vocab: {exc}") from None

    def _symbols(self, word: str) -> list[int]:
        ids: list[int] = []
        unk: Optional[int] = None  # a pending unknown token
        last = len(word) - 1
        for k, char in enumerate(word):
            piece = (self.prefix if k and self.prefix else "") + char + (
                self.suffix if k == last else "")
            token_id = self.vocab.get(piece)
            if token_id is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(token_id)
                continue
            if self.byte_fallback:
                byte_ids = _byte_tokens(piece, self.vocab)
                if byte_ids is not None:
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
        if not word:
            return []
        dropout = self.dropout > 0.0
        if self.ignore_merges and not dropout and word in self.vocab:
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
        skipped: list = []
        while heap:
            top = heapq.heappop(heap)
            if dropout and self.rng.random() < self.dropout:
                skipped.append(top)
                continue
            for entry in skipped:
                heapq.heappush(heap, entry)
            skipped.clear()
            rank, i, new_id = top
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


class WordPiece:
    """Greedy longest-match WordPiece (the BERT tokenizer's
    :func:`~operator_tpu_torch.models.wordpiece.wordpiece`)."""

    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.unk_token: str = spec.get("unk_token", "[UNK]")
        self.prefix: str = spec.get("continuing_subword_prefix", "##")
        self.max_input_chars_per_word = int(spec.get("max_input_chars_per_word", 100))

    def encode_word(self, word: str) -> list[int]:
        if not word:
            return []
        unk_id = self.vocab.get(self.unk_token)
        ids = wordpiece(word, self.vocab, -1, prefix=self.prefix,
                        max_input_chars_per_word=self.max_input_chars_per_word)
        if ids == [-1]:
            if unk_id is None:
                raise ValueError(f"WordPiece unk_token {self.unk_token!r} is not in the vocab")
            return [unk_id]
        return ids


class WordLevel:
    """A word is its id, or the unknown token's."""

    def __init__(self, spec: dict) -> None:
        self.vocab: dict[str, int] = dict(spec["vocab"])
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.unk_token: str = spec.get("unk_token", "<unk>")

    def encode_word(self, word: str) -> list[int]:
        if not word:
            return []
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk_token in self.vocab:
            return [self.vocab[self.unk_token]]
        raise ValueError(f"WordLevel unk_token {self.unk_token!r} is not in the vocab")


class Unigram:
    """SentencePiece's unigram model: the best-scoring segmentation of a
    pre-token into vocab pieces (Viterbi, forward over characters; a tie
    keeps the path found first, i.e. the longest last piece), where a
    character no piece starts with is the unknown piece scored
    ``UNK_PENALTY`` below the lowest piece; runs of unknowns are fused,
    then each either a piece (when the run spells one), its ``<0xNN>``
    bytes under ``byte_fallback``, or the unknown id."""

    def __init__(self, spec: dict) -> None:
        pieces = spec["vocab"]
        self.scores: list[float] = [float(score) for _, score in pieces]
        self.vocab: dict[str, int] = {}
        for i, (piece, _) in enumerate(pieces):
            self.vocab[piece] = i  # a repeated piece keeps its last id
        self.id_to_token = {i: piece for i, (piece, _) in enumerate(pieces)}
        unk_id = spec.get("unk_id")
        self.unk_id: Optional[int] = None if unk_id is None else int(unk_id)
        if self.unk_id is not None and not 0 <= self.unk_id < len(pieces):
            raise ValueError(f"Unigram unk_id {self.unk_id} is outside the vocab")
        self.unk_token: Optional[str] = None if self.unk_id is None else pieces[self.unk_id][0]
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.min_score = min(self.scores, default=0.0)
        self._max_len = max((len(p) for p, _ in pieces), default=0)

    def _pieces(self, word: str) -> list[str]:
        size = len(word)
        unk_score = self.min_score - UNK_PENALTY
        #: best path ending at each position: (score, start, id)
        best: list = [None] * (size + 1)
        best[0] = (0.0, None, 0)
        for start in range(size):
            till_here = best[start][0] if best[start] is not None else 0.0
            single = False
            for stop in range(start + 1, min(size, start + self._max_len) + 1):
                token_id = self.vocab.get(word[start:stop])
                if token_id is None:
                    continue
                score = self.scores[token_id] + till_here
                node = best[stop]
                if node is None or node[1] is None or score > node[0]:
                    best[stop] = (score, start, token_id)
                if stop == start + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: a character no piece covers and no unk_id")
                score = unk_score + till_here
                node = best[start + 1]
                if node is None or node[1] is None or score > node[0]:
                    best[start + 1] = (score, start, self.unk_id)
        out: list[str] = []
        unknown: list[str] = []
        stop = size
        while stop > 0:
            _, start, token_id = best[stop]
            if self.unk_id is not None and token_id == self.unk_id:
                unknown.append(word[start:stop])
            else:
                if unknown:
                    out.append("".join(reversed(unknown)))
                    unknown = []
                out.append(word[start:stop])
            stop = start
        if unknown:
            out.append("".join(reversed(unknown)))
        out.reverse()
        return out

    def encode_word(self, word: str) -> list[int]:
        if not word:
            return []
        ids: list[int] = []
        for piece in self._pieces(word):
            token_id = self.vocab.get(piece)
            if token_id is None:
                byte_ids = _byte_tokens(piece, self.vocab) if self.byte_fallback else None
                if byte_ids is not None:
                    ids.extend(byte_ids)
                    continue
                token_id = self.unk_id
            ids.append(token_id)
        return ids


def build_model(spec: dict, rng: Optional[random.Random] = None):
    kind = spec.get("type")
    if kind == "BPE":
        return BPE(spec, rng)
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "WordLevel":
        return WordLevel(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise unsupported(f"model type {kind!r}")
