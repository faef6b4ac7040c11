"""Write ``operator_tpu_torch/models/tokenization/tables.py``.

The text front end's normalizers and pre-tokenizers (``BertNormalizer``,
``StripAccents``, the normalization forms, ``Lowercase``, ``Digits``,
``Whitespace``, ``Precompiled`` and added tokens' ``single_word``) read
Unicode properties that the ``tokenizers`` library takes from its Rust
crates, each of its own Unicode version: none is Python's
``unicodedata``.  This script probes the installed library for each of
them, over every code point but the surrogates, and writes them down:

1. **The BERT normalizer**: what ``clean_text`` drops, the non-spacing
   marks its accent stripping drops (``is_mark_nonspacing``, an older
   table than ``StripAccents``'), the ideographs ``handle_chinese_chars``
   spaces; **StripAccents**' combining marks; **BertPreTokenizer**'s
   punctuation.
2. **Normalization forms**: the code points where the library's tables
   (older than Python's) and ``unicodedata`` disagree, alone or in a
   sequence (a canonical combining class, a decomposition, a
   composition).  Each is unassigned in the library's tables, a starter
   with no mapping there, so the port cuts a text at them and normalizes
   each side with ``unicodedata`` (checked here for every form).
3. **Lowercase** (Rust's ``char::to_lowercase``, also the BERT
   normalizer's): each code point whose lowercase ``str.lower`` gives
   otherwise, with the library's.
4. **Digits** (``char::is_numeric``), **Whitespace** (the ``regex``
   crate's ``\\w`` and ``\\s``) and added tokens' **single_word** (what
   counts as a word character on either side of the token).
5. **Precompiled's grapheme clusters** (the ``unicode-segmentation``
   crate): each code point's break class, read from which of two cluster
   readings the library's output takes in a set of contexts (a cluster
   under 6 bytes that starts with a key is replaced whole), the Indic
   conjunct classes (GB9c) too.  Regional indicators are four bytes, so
   no output of ``Precompiled`` tells them apart: they are Oniguruma's
   (``unicode_tables.CLUSTERS``).

Run it where ``tokenizers`` is installed (the port reads the written
module, never the library):

    python scripts/torch_text_tables.py [--check]

``--check`` rewrites nothing and exits 1 if the committed module differs.
It takes about half a minute.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import os
import struct
import sys
import unicodedata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "operator_tpu_torch", "models", "tokenization", "tables.py")
# the grapheme probe reads the port's Oniguruma tables
sys.path.insert(0, ROOT)

_spec = importlib.util.spec_from_file_location(
    "torch_unicode_tables", os.path.join(ROOT, "scripts", "torch_unicode_tables.py"))
unicode_generator = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(unicode_generator)

ALL = unicode_generator.ALL
encode, to_ranges = unicode_generator.encode, unicode_generator.to_ranges
FORMS = ("NFC", "NFD", "NFKC", "NFKD")
CHUNK = 8192


def _chunks(points=ALL):
    for lo in range(0, len(points), CHUNK):
        yield points[lo:lo + CHUNK]


def each_alone(normalize, separator: str, points=ALL) -> dict:
    """Code point -> what ``normalize`` makes of it alone (a chunk at a
    time, joined by ``separator``, which none of the probes changes)."""
    out = {}
    for chunk in _chunks([c for c in points if chr(c) != separator]):
        pieces = normalize(separator.join(map(chr, chunk))).split(separator)
        assert len(pieces) == len(chunk)
        out.update(zip(chunk, pieces))
    return out


def dropped(normalize) -> set:
    """The code points ``normalize`` removes (an ideograph between them)."""
    return {c for c, piece in each_alone(normalize, "一").items() if piece == ""}


# ---------------------------------------------------------------------------
# 1. the BERT normalizer, StripAccents, BertPreTokenizer
# ---------------------------------------------------------------------------


def bert_tables() -> dict:
    from tokenizers import normalizers, pre_tokenizers

    def bert(**options):
        spec = dict(clean_text=False, handle_chinese_chars=False, strip_accents=False,
                    lowercase=False)
        spec.update(options)
        return normalizers.BertNormalizer(**spec).normalize_str

    punctuation = pre_tokenizers.Punctuation(behavior="removed")

    def without_punctuation(text):
        return "".join(piece for piece, _ in punctuation.pre_tokenize_str(text))

    spaced = each_alone(bert(handle_chinese_chars=True), "\n")
    return {
        "BERT_CONTROL": dropped(bert(clean_text=True)),
        "BERT_MARK_NONSPACING": dropped(bert(strip_accents=True)),
        "BERT_CJK": {c for c, piece in spaced.items() if piece == f" {chr(c)} "},
        "COMBINING_MARK": dropped(normalizers.StripAccents().normalize_str),
        "PUNCTUATION": dropped(without_punctuation),
    }


# ---------------------------------------------------------------------------
# 2. normalization forms
# ---------------------------------------------------------------------------

def _class_marks(unknown: set) -> dict:
    """One mark of each canonical combining class, of those the library
    knows too."""
    marks: dict = {}
    for c in ALL:
        ccc = unicodedata.combining(chr(c))
        if ccc and c not in unknown and unicodedata.decomposition(chr(c)) == "":
            marks.setdefault(ccc, chr(c))
    return marks


def normalization_cuts() -> set:
    """The code points whose normalization differs between the library
    and ``unicodedata`` alone or in a sequence."""
    from tokenizers import normalizers

    library = {form: getattr(normalizers, form)().normalize_str for form in FORMS}
    cuts: set = set()
    for form in FORMS:
        alone = each_alone(library[form], "\0")
        cuts.update(c for c, piece in alone.items()
                    if piece != unicodedata.normalize(form, chr(c)))
    # canonical combining classes: every code point beside one mark of
    # each class, on either side, after a starter
    def reordered(contexts):
        for prefix, suffix, points in contexts:
            for chunk in _chunks([c for c in points if c]):
                texts = [f"{prefix}{chr(c)}{suffix}" for c in chunk]
                got = library["NFD"]("\0".join(texts)).split("\0")
                cuts.update(c for c, text, piece in zip(chunk, texts, got)
                            if piece != unicodedata.normalize("NFD", text))

    # a class the library does not know (every code point after a mark of
    # class 230 and before one of class 1), then each class against one
    # mark of each class both know
    reordered([("a\u0301", "", ALL), ("a", "\u0334", ALL)])
    marks = [m for m in _class_marks(cuts).values()]
    candidates = [c for c in ALL if unicodedata.combining(chr(c)) and c not in cuts]
    reordered([(f"a{m}", "", candidates) for m in marks] + [("a", m, candidates) for m in marks])
    # compositions: every pair Python composes
    pairs = []
    for c in ALL:
        parts = unicodedata.decomposition(chr(c)).split()
        if len(parts) == 2 and not parts[0].startswith("<"):
            pair = "".join(chr(int(p, 16)) for p in parts)
            if unicodedata.normalize("NFC", pair) == chr(c):
                pairs.append(pair)
    got = library["NFC"]("\0".join(pairs)).split("\0")
    for pair, piece in zip(pairs, got):
        if piece != unicodedata.normalize("NFC", pair):
            cuts.update(map(ord, pair))
            cuts.add(ord(unicodedata.normalize("NFC", pair)))
    # a cut must be a starter the library maps to itself in every form
    for form in FORMS:
        for c, piece in each_alone(library[form], "\0", sorted(cuts)).items():
            if piece != chr(c):
                raise SystemExit(f"normalization: U+{c:04X} is mapped by the library's {form}")
    got = library["NFD"]("\0".join(f"a\u0301{chr(c)}" for c in sorted(cuts))).split("\0")
    if any(piece != f"a\u0301{chr(c)}" for c, piece in zip(sorted(cuts), got)):
        raise SystemExit("normalization: a cut code point is not a starter in the library")
    return cuts


# ---------------------------------------------------------------------------
# 3. lowercase
# ---------------------------------------------------------------------------


def lowercase_table() -> dict:
    """Code point -> the library's lowercase, where ``str.lower`` of the
    code point alone differs."""
    from tokenizers import normalizers

    lower = each_alone(normalizers.Lowercase().normalize_str, "\0")
    bert = each_alone(normalizers.BertNormalizer(
        clean_text=False, handle_chinese_chars=False, strip_accents=False,
        lowercase=True).normalize_str, "\0")
    if lower != bert:
        raise SystemExit("lowercase: Lowercase and the BERT normalizer's lowercase differ")
    table = {c: piece for c, piece in lower.items() if piece != chr(c).lower()}
    for c, piece in table.items():
        # the port lowercases what the table gives: that must stay
        if piece.lower() != piece:
            raise SystemExit(f"lowercase: U+{c:04X}'s lowercase is not lowercase to Python")
    return table


# ---------------------------------------------------------------------------
# 4. Digits, Whitespace, single_word
# ---------------------------------------------------------------------------


def numeric_points() -> set:
    from tokenizers import pre_tokenizers

    digits = pre_tokenizers.Digits(individual_digits=True)
    out = set()
    for chunk in _chunks():
        # each code point after a letter: a number is a piece of its own
        pieces = digits.pre_tokenize_str("".join(f"a{chr(c)}" for c in chunk))
        out.update(chunk[start // 2] for piece, (start, stop) in pieces
                   if start % 2 == 1 and stop == start + 1)
    return out


@functools.lru_cache(maxsize=1)
def whitespace_classes() -> "tuple[set, set]":
    """The ``regex`` crate's ``\\w`` and ``\\s`` as ``Whitespace``
    (``\\w+|[^\\w\\s]+``) splits each code point after a letter."""
    from tokenizers import pre_tokenizers

    split = pre_tokenizers.Whitespace()
    word, space = set(), set()
    for chunk in _chunks():
        pieces = split.pre_tokenize_str("".join(f"a{chr(c)} " for c in chunk))
        covered = set()
        for _, (start, stop) in pieces:
            for i in range(start, stop):
                if i % 3 == 1:
                    covered.add(i // 3)
                    if start % 3 == 0:
                        word.add(chunk[i // 3])
        space.update(c for i, c in enumerate(chunk) if i not in covered)
    return word, space


def whitespace_split_points() -> set:
    """``char::is_whitespace``: what ``WhitespaceSplit`` removes, which
    must be what the BERT normalizer's ``clean_text`` makes a space where
    it does not drop it as a control."""
    from tokenizers import normalizers, pre_tokenizers

    split = pre_tokenizers.WhitespaceSplit()
    removed = dropped(lambda text: "".join(p for p, _ in split.pre_tokenize_str(text)))
    clean = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                                       strip_accents=False, lowercase=False).normalize_str
    cleaned = each_alone(clean, "一")
    spaced = {c for c, piece in cleaned.items() if piece == " "}
    controls = {c for c, piece in cleaned.items() if piece == ""}
    if spaced != removed - controls:
        raise SystemExit("whitespace: the BERT normalizer's is not WhitespaceSplit's")
    return removed


def single_word_points() -> set:
    """What ``single_word`` counts as a word character: an added token
    with it set is not found right before or right after one."""
    from tokenizers import AddedToken, Tokenizer, models

    tokenizer = Tokenizer(models.WordLevel({"[UNK]": 0}, unk_token="[UNK]"))
    tokenizer.add_tokens([AddedToken("tok", single_word=True)])
    before, after = set(), set()
    for chunk in _chunks([c for c in ALL if c != 0x20]):
        # " tok" c "tok": the first token ends before c, the second starts after it
        encoding = tokenizer.encode("".join(f" tok{chr(c)}tok" for c in chunk))
        found = [(start // 8, start % 8) for (start, _), i in zip(encoding.offsets, encoding.ids)
                 if i == 1]
        ends = {k for k, at in found if at == 1}
        starts = {k for k, at in found if at == 5}
        before.update(c for k, c in enumerate(chunk) if k not in ends)
        after.update(c for k, c in enumerate(chunk) if k not in starts)
    if before != after:
        raise SystemExit("single_word: the characters before and after a token differ")
    return before


# ---------------------------------------------------------------------------
# 5. Precompiled's grapheme clusters
# ---------------------------------------------------------------------------


def charsmap_blob(rules: "dict[bytes, str]") -> bytes:
    """SentencePiece's compiled charsmap over byte keys (see
    ``tokenization/charsmap.py``): a darts-clone double array, then the
    NUL-ended values."""
    strings = bytearray()
    offsets = {}
    for key in sorted(rules):
        offsets[key] = len(strings)
        strings += rules[key].encode("utf-8") + b"\0"
    root: dict = {}
    for key in rules:
        node = root
        for byte in key:
            node = node.setdefault(byte, {})
        node[None] = offsets[key]
    units, used, bases = [0], {0}, set()
    queue = [(root, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = sorted(k for k in node if k is not None)
        need = labels + ([0] if None in node else [])
        base = 1
        while base in bases or any(base ^ c in used for c in need):
            base += 1
        bases.add(base)
        units += [0] * (max(base ^ c for c in need) + 1 - len(units))
        units[pos] |= (pos ^ base) << 10 | (1 << 8 if None in node else 0)
        used.update(base ^ c for c in need)
        if None in node:
            units[base] = node[None] | 1 << 31
        for c in labels:
            units[base ^ c] |= c
            queue.append((node[c], base ^ c))
    units += [0] * (-len(units) % 256)
    trie = b"".join(struct.pack("<I", u) for u in units)
    return struct.pack("<I", len(trie)) + trie + bytes(strings)


#: every lead byte of a multi-byte character is a key, and ``a``: a
#: cluster under 6 bytes that starts with one is replaced whole
PROBE_RULES = {**{bytes([b]): "X" for b in range(0xC2, 0xF5)}, b"a": "A"}
#: a character of each UTF-8 length past ASCII
REPRESENTATIVE = {2: "\u0100", 3: "\u0800", 4: "\U00010000"}


def _render(clusters: "list[str]") -> str:
    """What ``PROBE_RULES``' charsmap makes of text cut into ``clusters``."""
    def value(chunk: str):
        head = chunk.encode("utf-8")[:1]
        return PROBE_RULES.get(head)

    out = []
    for cluster in clusters:
        if len(cluster.encode("utf-8")) < 6 and value(cluster) is not None:
            out.append(value(cluster))
        else:
            out.extend(value(c) or c for c in cluster)
    return "".join(out)


#: (name, before, after): whether c joins across the cut ``|`` in
#: ``before + c + after``, c on the side the bar is not
CLUSTER_CONTEXTS = (
    ("after_other", "a|", ""),                                  # Extend, ZWJ, SpacingMark
    ("before_other", "", "|a"),                                 # Prepend
    ("before_extend", "", "|\u0301\u0301"),                     # all but Control, CR, LF
    ("before_v", "", "|\u1161\u0301"),                          # L, V, LV
    ("before_t", "", "|\u11a8\u0301"),                          # V, T, LV, LVT
    ("after_v", "\u1161|", "\u0301"),                           # V, T
    ("before_l", "", "|\u1100\u0301"),                          # L
    ("after_zwj", "\xa9\u200d|", "\u0301"),                     # Extended_Pictographic
    ("in_emoji_zwj", "\xa9", "\u200d|\xa9\u0301"),              # Extend (not SpacingMark)
    ("after_linker", "\u0915\u094d|", "\u0301"),                # InCB Consonant
    ("linker", "\u0915", "|\u0937\u0301"),                      # InCB Linker
    ("in_conjunct", "\u0915", "\u094d|\u0937\u0301"),           # InCB Extend, Linker
)


_CLUSTER_POINTS = [c for c in ALL if chr(c) not in "\r\n"]


@functools.lru_cache(maxsize=1)
def _cluster_keys() -> list:
    return [chr(c) if c < 0x80 else 2 if c < 0x800 else 3 if c < 0x10000 else 4
            for c in _CLUSTER_POINTS]


def cluster_context(context: "tuple[str, str, str]") -> "tuple[str, frozenset]":
    """The code points that join across the context's cut, read from the
    library's output where the two readings differ."""
    from tokenizers import normalizers

    name, before, after = context
    library = normalizers.Precompiled(charsmap_blob(PROBE_RULES))
    joined = set()
    readings: dict = {}
    left, right = before.replace("|", ""), after.replace("|", "")
    for chunk, keys in zip(_chunks(_CLUSTER_POINTS), _chunks(_cluster_keys())):
        for key in set(keys) - readings.keys():
            # the output depends on c only by its length and whether it is
            # a key (every character but ASCII's, and "a")
            char = key if isinstance(key, str) else REPRESENTATIVE[key]
            if before.endswith("|"):
                text, cut = left + char + right, len(left)
            else:
                text, cut = left + char + right, len(left) + 1 + after.index("|")
            # the rest of each side one cluster with c (a control is
            # taken out afterwards)
            readings[key] = (_render([text]), _render([text[:cut], text[cut:]]))
        got = library.normalize_str("\n".join(f"{left}{chr(c)}{right}" for c in chunk))
        joined.update(c for c, key, piece in zip(chunk, keys, got.split("\n"))
                      if piece == readings[key][0] != readings[key][1])
    return name, frozenset(joined)


#: the break classes (one per code point; the rest are Other) and the
#: Indic conjunct classes beside them
BREAK_CLASSES = ("CR", "LF", "ZWJ", "Control", "Prepend", "Extend", "SpacingMark", "L", "V", "T",
                 "LV", "LVT", "RI", "ExtPict")


def cluster_tables() -> dict:
    from operator_tpu_torch.models.tokenization import onig

    probes = dict(map(cluster_context, CLUSTER_CONTEXTS))
    # a context read with c joined to the mark after it says nothing of a
    # control, which joins neither side
    for name in ("after_v", "after_zwj", "after_linker"):
        probes[name] = probes[name] & probes["before_extend"]
    extendlike = probes["after_other"] | {0x200D}
    prepend = probes["before_other"]
    everything = set(ALL)
    hangul = {name: probes[name] - extendlike - prepend
              for name in ("before_v", "before_t", "after_v", "before_l")}
    # a four-byte character joined to another makes a cluster of 6 bytes
    # or more, so after a vowel nothing tells V from LV, or T from LVT:
    # such a one is read as V or T
    four = {c for c in ALL if c > 0xFFFF}
    vowel_like = hangul["before_v"] - hangul["before_l"]
    trail_like = hangul["before_t"] - hangul["before_v"]
    after_vowel = hangul["after_v"] | four
    out = {
        "CR": {0x0D}, "LF": {0x0A}, "ZWJ": {0x200D},
        "Control": everything - probes["before_extend"] - {0x0D, 0x0A},
        "Prepend": set(prepend),
        "Extend": (extendlike & probes["in_emoji_zwj"]) - {0x200D},
        "L": hangul["before_l"],
        "V": vowel_like & after_vowel,
        "T": trail_like & after_vowel,
        "LV": vowel_like - after_vowel,
        "LVT": trail_like - after_vowel,
        # four bytes each: Precompiled's output never tells them apart
        "RI": {c for lo, hi in onig.cluster_ranges("RI") for c in range(lo, hi + 1)},
        "ExtPict": probes["after_zwj"] - extendlike,
        "Consonant": probes["after_linker"] - extendlike,
        "Linker": probes["linker"] & extendlike,
    }
    out["SpacingMark"] = extendlike - out["Extend"] - {0x200D}
    out["InCBExtend"] = (probes["in_conjunct"] & extendlike) - out["Linker"]
    seen: set = set()
    for name in BREAK_CLASSES:
        if seen & out[name]:
            raise SystemExit(f"graphemes: {name} overlaps another break class")
        seen |= out[name]
    for name, points in out.items():
        print(f"graphemes: {name} {len(points)}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

HEADER = '''"""Unicode data of the ``tokenizers`` library's text front end.

Generated by ``PYTHONPATH=. python scripts/torch_text_tables.py`` from
the installed library (tokenizers {tokenizers}); do not edit.  Each is
what the library takes from a Rust crate of its own Unicode version, so
Python's ``unicodedata`` cannot stand in for it:

- ``BERT_CONTROL``: what ``BertNormalizer``'s ``clean_text`` drops;
  ``BERT_MARK_NONSPACING``: the marks its accent stripping drops after
  NFD; ``BERT_CJK``: the ideographs ``handle_chinese_chars`` spaces;
- ``COMBINING_MARK``: what ``StripAccents`` drops;
- ``PUNCTUATION``: what ``BertPreTokenizer`` and ``Punctuation`` isolate;
- ``NORMALIZATION_CUTS``: where the library's normalization tables and
  ``unicodedata`` disagree (each a starter with no mapping to the
  library: a text is normalized on either side of one);
- ``LOWERCASE``: code point -> ``Lowercase``'s result, where it is not
  ``str.lower``'s;
- ``NUMERIC``: what ``Digits`` splits off; ``WORD`` and ``SPACE``:
  ``Whitespace``'s ``\\\\w`` and ``\\\\s`` (``WORD`` is also what an added
  token's ``single_word`` counts as a word character);
- ``GRAPHEMES``: ``Precompiled``'s grapheme cluster classes, the Indic
  conjunct ones (``Consonant``, ``Linker``, ``InCBExtend``) too.

A set is encoded as ``unicode_tables``' are.
"""

from __future__ import annotations

'''

SETS = ("BERT_CONTROL", "BERT_MARK_NONSPACING", "BERT_CJK", "COMBINING_MARK", "PUNCTUATION",
        "NORMALIZATION_CUTS", "NUMERIC", "WORD", "SPACE")


def _wrap_string(value: str, width: int = 92) -> "list[str]":
    return [f'    "{value[i:i + width]}"' for i in range(0, len(value), width)] or ['    ""']


def render(tables: dict) -> str:
    lines = [HEADER.format(tokenizers=tables["tokenizers"])]
    for name in SETS:
        lines.append(f"{name} = (")
        lines += _wrap_string(encode(to_ranges(tables[name])))
        lines += [")", ""]
    lines.append("LOWERCASE = {")
    for c, lower in sorted(tables["LOWERCASE"].items()):
        lines.append(f"    0x{c:X}: {lower!r},")
    lines += ["}", ""]
    lines.append("GRAPHEMES = {")
    for name, points in tables["GRAPHEMES"].items():
        lines.append(f"    {name!r}: {encode(to_ranges(points))!r},")
    lines += ["}", ""]
    return "\n".join(lines)


def probe() -> dict:
    import tokenizers

    word, space = whitespace_classes()
    if single_word_points() != word:
        raise SystemExit("single_word: its word characters are not Whitespace's \\w")
    if whitespace_split_points() != space:
        raise SystemExit("whitespace: WhitespaceSplit's is not Whitespace's \\s")
    return {"tokenizers": tokenizers.__version__, **bert_tables(),
            "NORMALIZATION_CUTS": normalization_cuts(), "LOWERCASE": lowercase_table(),
            "NUMERIC": numeric_points(), "WORD": word, "SPACE": space,
            "GRAPHEMES": cluster_tables()}


@functools.lru_cache(maxsize=1)
def probed() -> dict:
    return probe()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="exit 1 if the committed module is not what the library gives")
    args = parser.parse_args(argv)
    text = render(probed())
    if args.check:
        with open(OUT, encoding="utf-8") as fh:
            same = fh.read() == text
        print("tables.py is " + ("current" if same else "stale"))
        return 0 if same else 1
    with open(OUT, "w", encoding="utf-8") as fh:
        fh.write(text)
    print(f"wrote {OUT} ({len(text.encode())} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
