"""Tokenizers: the dependency-free byte-level fallback.

The port's copy of ``operator_tpu/models/tokenizer.py:ByteTokenizer``
(vocab 256 + three specials).  The builtin BPE and the local HF tokenizer
come with the checkpoint loader in a later slice.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["ByteTokenizer"]


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
