"""Byte-level BPE: trainer + tokenizer, dependency-free and egress-free.

The port's copy of ``operator_tpu/models/bpe.py``, with its own copy of
the shipped vocab (``bpe_vocab/logbpe-4k.json``).

The serving/bench path needs a *real* subword tokenizer — byte-level token
counts inflate prompt lengths ~4x vs a production BPE vocab, which distorts
tok/s and context budgets (the reference's AI leg tokenizes server-side with
the provider's tokenizer; AIProviderConfig only carries maxTokens,
aiprovider-crd.yaml:47-50, so the operator never shipped one).  This module
trains a compact BPE on recorded failure logs + repo prose and ships the
result as a JSON vocab (``bpe_vocab/logbpe-4k.json``), so an air-gapped
environment still tokenizes like production.

Scheme (GPT-2 family, minus the regex zoo):

- ids ``0..2``: specials (pad/bos/eos); ids ``3..258``: raw bytes;
  id ``259+r``: the r-th merge.
- pre-tokenization splits on letter/digit/punct runs with the leading space
  attached (so ``" error"`` is one unit — the single most valuable property
  of GPT-style BPE on prose/logs).
- encoding greedily applies the lowest-rank merge within each pre-token;
  decoding concatenates byte strings (specials skipped).

The trainer keeps an inverted pair->words index so each merge touches only
the words containing it — a 4k vocab trains in seconds on a ~1 MB corpus.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter, defaultdict
from typing import Iterable, Optional, Sequence

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
NUM_SPECIALS = 3
FIRST_MERGE_ID = NUM_SPECIALS + 256

_PRETOKEN_RE = re.compile(
    rb" ?[A-Za-z]+| ?[0-9]+| ?[^ A-Za-z0-9]+| +"
)

BUILTIN_VOCAB = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bpe_vocab", "logbpe-4k.json"
)


def _pretokenize(data: bytes) -> list[bytes]:
    return _PRETOKEN_RE.findall(data)


def _word_ids(word: bytes) -> tuple[int, ...]:
    return tuple(b + NUM_SPECIALS for b in word)


def train_bpe(
    texts: Iterable[str], vocab_size: int, *, min_pair_count: int = 2
) -> list[tuple[int, int]]:
    """Learn merges until ``vocab_size`` ids exist (or pairs run dry).

    Returns the merge list: rank r merges id pair ``merges[r]`` into id
    ``FIRST_MERGE_ID + r``.
    """
    assert vocab_size > FIRST_MERGE_ID, "vocab must exceed the byte alphabet"
    words = Counter()
    for text in texts:
        for w in _pretokenize(text.encode("utf-8")):
            words[_word_ids(w)] += 1
    seqs: list[list[int]] = [list(w) for w in words]
    counts: list[int] = [words[w] for w in words]

    pair_counts: Counter = Counter()
    pair_words: defaultdict[tuple[int, int], set[int]] = defaultdict(set)
    for idx, seq in enumerate(seqs):
        c = counts[idx]
        for pair in zip(seq, seq[1:]):
            pair_counts[pair] += c
            pair_words[pair].add(idx)

    merges: list[tuple[int, int]] = []
    max_merges = vocab_size - FIRST_MERGE_ID
    while len(merges) < max_merges and pair_counts:
        pair, best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))
        if best < min_pair_count:
            break
        new_id = FIRST_MERGE_ID + len(merges)
        merges.append(pair)
        touched = pair_words.pop(pair, set())
        del pair_counts[pair]
        for idx in touched:
            seq, c = seqs[idx], counts[idx]
            # retract this word's contribution, merge, re-add
            for p in zip(seq, seq[1:]):
                if p != pair:
                    pair_counts[p] -= c
                    if pair_counts[p] <= 0:
                        del pair_counts[p]
                    pair_words[p].discard(idx)
            merged: list[int] = []
            i = 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
                    merged.append(new_id)
                    i += 2
                else:
                    merged.append(seq[i])
                    i += 1
            seqs[idx] = merged
            for p in zip(merged, merged[1:]):
                if p == pair:  # the pair can never recur post-merge
                    continue
                pair_counts[p] += c
                pair_words[p].add(idx)
    return merges


class BPETokenizer:
    """Greedy-merge byte-level BPE over a trained merge table."""

    def __init__(self, merges: Sequence[tuple[int, int]]) -> None:
        self.merges = [tuple(m) for m in merges]
        self.ranks = {pair: r for r, pair in enumerate(self.merges)}
        self.pad_id = PAD_ID
        self.bos_id = BOS_ID
        self.eos_id = EOS_ID
        self.vocab_size = FIRST_MERGE_ID + len(self.merges)
        # id -> bytes for decoding
        self._bytes: list[bytes] = [b""] * self.vocab_size
        for b in range(256):
            self._bytes[b + NUM_SPECIALS] = bytes([b])
        for r, (a, b) in enumerate(self.merges):
            self._bytes[FIRST_MERGE_ID + r] = self._bytes[a] + self._bytes[b]

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"format": "logbpe-v1", "merges": [list(m) for m in self.merges]},
                f, separators=(",", ":"),
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            data = json.load(f)
        assert data.get("format") == "logbpe-v1", f"unknown vocab format in {path}"
        return cls([tuple(m) for m in data["merges"]])

    @classmethod
    def load_builtin(cls) -> "BPETokenizer":
        return cls.load(BUILTIN_VOCAB)

    # -- encode/decode --------------------------------------------------
    def _encode_word(self, word: bytes) -> list[int]:
        seq = [b + NUM_SPECIALS for b in word]
        while len(seq) > 1:
            best_rank, best_i = None, -1
            for i in range(len(seq) - 1):
                rank = self.ranks.get((seq[i], seq[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            seq[best_i : best_i + 2] = [FIRST_MERGE_ID + best_rank]
        return seq

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos else []
        for word in _pretokenize(text.encode("utf-8")):
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(
            self._bytes[i] for i in ids if NUM_SPECIALS <= i < self.vocab_size
        )
        return data.decode("utf-8", errors="replace")


def load_builtin_bpe() -> Optional[BPETokenizer]:
    """The shipped log-trained vocab, or None when the file is absent."""
    try:
        return BPETokenizer.load_builtin()
    except (OSError, AssertionError, KeyError, ValueError):
        return None
