"""The components of a ``tokenizer.json``, read without ``tokenizers``.

One module per group, laid out as the ``tokenizers`` library lays them
out, each step run as the library runs it (its Rust sources are the
specification; the tests hold every component to the library on the CPU):

- :mod:`.models` — ``BPE`` (byte fallback, unknowns fused, merges by rank,
  ``ignore_merges``, ``continuing_subword_prefix``, ``end_of_word_suffix``
  and ``dropout`` drawn from a generator the caller seeds), ``WordPiece``,
  ``WordLevel`` and ``Unigram`` (Viterbi over the piece lattice, byte
  fallback);
- :mod:`.normalizers` — ``BertNormalizer``, ``ByteLevel``, ``Lowercase``,
  ``NFC``/``NFD``/``NFKC``/``NFKD``, ``Nmt``, ``Precompiled``,
  ``Prepend``, ``Replace`` (string or regex), ``Sequence``, ``Strip``,
  ``StripAccents``;
- :mod:`.pre_tokenizers` — ``BertPreTokenizer``, ``ByteLevel``,
  ``CharDelimiterSplit``, ``Digits``, ``FixedLength``, ``Metaspace``,
  ``Punctuation``, ``Sequence``, ``Split`` (every behavior, ``invert``),
  ``UnicodeScripts``, ``Whitespace``, ``WhitespaceSplit``;
- :mod:`.decoders` — ``BPEDecoder``, ``ByteFallback``, ``ByteLevel``,
  ``CTC``, ``Fuse``, ``Metaspace``, ``Replace``, ``Sequence``, ``Strip``,
  ``WordPiece``;
- :mod:`.processors` — ``BertProcessing``, ``ByteLevel``,
  ``RobertaProcessing``, ``Sequence``, ``TemplateProcessing``;
- :mod:`.charsmap` — the ``Precompiled`` normalizer's SentencePiece
  charsmap (a darts-clone double array and its strings) and the grapheme
  clusters it is applied to;
- :mod:`.onig` — Oniguruma's expressions, as the library reads them, in
  Python's ``re`` where it runs them as Oniguruma does;
- :mod:`.onig_match` — the port's own Oniguruma matcher for the rest
  (recursion, the absent operator, segment boundaries, callouts, ...), with
  the library's retry limit;
- :mod:`.text` — finding and splitting as the library does, GPT-2's byte
  table;
- :mod:`.tables` and :mod:`.unicode_tables` — the library's character
  tables and its Unicode data (property classes, case folding, grapheme
  cluster classes, ``UnicodeScripts``' scripts), generated from it.
"""

from __future__ import annotations


def unsupported(what: str) -> NotImplementedError:
    """A ``tokenizer.json`` feature the port does not read."""
    return NotImplementedError(f"tokenizer.json {what} is not read by operator_tpu_torch")
