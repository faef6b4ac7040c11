"""Write ``operator_tpu_torch/models/tokenization/unicode_tables.py``.

The port reads a ``tokenizer.json``'s Oniguruma expressions and runs its
``UnicodeScripts`` pre-tokenizer without the ``tokenizers`` library.  What
the library does there rests on Unicode data that Python's
``unicodedata`` (an older Unicode, no Script property) cannot give, so
this script probes the installed library for it and writes it down:

1. **Property classes** (Oniguruma): every ``\\p{name}`` the library
   accepts, each probed over every code point but the surrogates inside a
   class (``[\\p{name}]``) and, below U+0100, alone (a bare ``\\p{name}``
   reads another table there for the POSIX names); the same for ``\\w``,
   ``\\s``, ``\\d`` and ``\\h``.  Candidate names come from the ``regex``
   package's property list (general categories, scripts, blocks as
   ``In_...``, binary properties, each with its aliases) and fontTools'
   script and block names.  Names whose code points are equal share one
   set.
2. **Case folding** (Oniguruma, ``(?i)``): the classes of characters one
   character matches, probed over every character that changes under a
   case mapping; and the characters that fold to two or three, as
   ``str.casefold`` gives them, each checked against the library.
3. **Grapheme cluster classes** (Oniguruma's ``\\X``): each code point's
   class, read from whether the library's ``\\X`` holds it together with
   a neighbour in a set of contexts (``a`` + c, c + ``a``, the Hangul
   jamo, an emoji and a zero-width joiner, an Indic virama).
4. **The UnicodeScripts pre-tokenizer's script** of every code point (the
   library's Rust table): the runs it cuts every code point in order into,
   each named by pairing one of its characters with a representative of a
   fontTools script.
5. **Word break classes** (Oniguruma's ``\\y``, ``\\Y`` and ``\\X``
   under ``(?y{w})``): the ``regex`` package's ``Word_Break`` values are
   the candidates; each code point's class is checked against whether the
   library's word segments hold it together with a neighbour in a set of
   contexts (``a`` + c, c + ``a``, a digit, Katakana, Hebrew, a space, an
   emoji, a regional indicator on either side), and where the two differ
   the library's behaviour decides the class (each such code point is
   printed).

Run it where ``tokenizers``, ``regex`` and fontTools are installed (the
port reads the written module, never these packages):

    PYTHONPATH=. python scripts/torch_unicode_tables.py [--workers N] [--check]

``--check`` rewrites nothing and exits 1 if the committed module differs.
It takes a few minutes on six workers.
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "operator_tpu_torch", "models", "tokenization", "unicode_tables.py")

#: every code point but the surrogates, which a UTF-8 text cannot hold
ALL = [c for c in range(sys.maxunicode + 1) if not 0xD800 <= c < 0xE000]
#: the POSIX bracket names (and ``Word``), which Oniguruma also reads as
#: ``\\p{..}`` and which its ASCII options restrict
POSIX = ("Alnum", "Alpha", "ASCII", "Blank", "Cntrl", "Digit", "Graph", "Lower", "Print",
         "Punct", "Space", "Upper", "XDigit", "Word")
#: the class escapes, positive forms
ESCAPES = ("w", "s", "d", "h")

# digits of the range encoding: a number is its base-32 digits, most
# significant first, the last one from FINAL and the others from MORE
FINAL = "abcdefghijklmnopqrstuvwxyz012345"
MORE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ6789+/"


def normalize(name: str) -> str:
    """A property name as Oniguruma compares it: case, spaces, ``_`` and
    ``-`` ignored."""
    return "".join(c for c in name.lower() if c not in " _-")


def encode_number(n: int) -> str:
    digits = [FINAL[n & 31]]
    n >>= 5
    while n:
        digits.append(MORE[n & 31])
        n >>= 5
    return "".join(reversed(digits))


def encode(ranges) -> str:
    """Sorted ``(lo, hi)`` ranges as the gap before each and its length."""
    out, prev = [], -1
    for lo, hi in ranges:
        out.append(encode_number(lo - prev - 1) + encode_number(hi - lo))
        prev = hi
    return "".join(out)


def to_ranges(points) -> list:
    """Sorted code points as ranges; the surrogates, which the library
    never sees, join a range whose both sides are in it."""
    out: list = []
    for c in sorted(points):
        if out and (c == out[-1][1] + 1 or (out[-1][1] == 0xD7FF and c == 0xE000)):
            out[-1][1] = c
        else:
            out.append([c, c])
    return [tuple(r) for r in out]


# ---------------------------------------------------------------------------
# probing the library
# ---------------------------------------------------------------------------

_TEXT = "".join(map(chr, ALL))


def _index_to_cp(i: int) -> int:
    return i if i < 0xD800 else i + 0x800


def _compiles(pattern: str) -> bool:
    import tokenizers

    try:
        tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "removed")
    except Exception:  # noqa: BLE001 - the library's own error for a pattern it rejects
        return False
    return True


def matched_spans(pattern: str, text: str) -> list:
    """``(start, stop)`` character spans of the library's matches of
    ``pattern`` in ``text`` (empty matches are not seen)."""
    import tokenizers

    split = tokenizers.pre_tokenizers.Split(tokenizers.Regex(pattern), "removed", invert=True)
    return [span for _, span in split.pre_tokenize_str(text)]


def class_points(pattern: str, text: str = _TEXT, index=_index_to_cp) -> set:
    """The code points of ``text`` that a one-character ``pattern``
    matches."""
    out: set = set()
    for start, stop in matched_spans(f"(?:{pattern})+", text):
        out.update(index(i) for i in range(start, stop))
    return out


def _latin1_points(pattern: str) -> set:
    return class_points(pattern, "".join(map(chr, range(256))), int)


def _probe_name(name: str) -> tuple:
    """(name, in-class code points, bare code points below U+0100)."""
    return name, frozenset(class_points(f"[\\p{{{name}}}]")), frozenset(
        _latin1_points(f"\\p{{{name}}}"))


def _probe_bracket(name: str) -> tuple:
    return name, frozenset(class_points(f"[[:{name.lower()}:]]"))


def _probe_escape(letter: str) -> tuple:
    return letter, frozenset(class_points(f"[\\{letter}]")), frozenset(
        _latin1_points(f"\\{letter}"))


def single_cluster(prefix: str, suffix: str) -> set:
    """The code points c for which the library's ``\\X`` reads
    ``prefix + c + suffix`` as one extended grapheme cluster."""
    step = len(prefix) + len(suffix) + 2
    text = "".join(f"{prefix}{chr(c)}{suffix}\n" for c in ALL)
    return {ALL[start // step] for start, stop in matched_spans(r"^\X$", text)
            if stop - start == step - 1}


def _probe_cluster(context: "tuple[str, str, str]") -> tuple:
    name, prefix, suffix = context
    return name, frozenset(single_cluster(prefix, suffix))


def single_word(prefix: str, suffix: str) -> set:
    """The code points c for which the library's ``\\X`` under
    ``(?y{w})`` reads ``prefix + c + suffix`` as one word segment."""
    step = len(prefix) + len(suffix) + 2
    text = "".join(f"{prefix}{chr(c)}{suffix}\n" for c in ALL)
    return {ALL[start // step] for start, stop in matched_spans(r"(?y{w})^\X$", text)
            if stop - start == step - 1 and start % step == 0}


def _probe_word(context: "tuple[str, str, str]") -> tuple:
    name, prefix, suffix = context
    return name, frozenset(single_word(prefix, suffix))


# ---------------------------------------------------------------------------
# 1. property names
# ---------------------------------------------------------------------------


def candidate_names() -> list:
    """Names to try in ``\\p{..}``, each once after normalizing."""
    import regex
    from fontTools.unicodedata import Blocks, Scripts

    props = regex._regex.get_properties()
    yes_no = props["ALPHABETIC"][1]
    names = [*POSIX, "Any", "Assigned"]
    names += [k for k, (_, values) in props.items() if values == yes_no]
    for prop in ("GENERALCATEGORY", "SCRIPT"):
        names += list(props[prop][1])
    names += ["In_" + block for block in props["BLOCK"][1]]
    names += [*Scripts.NAMES, *Scripts.NAMES.values()]
    names += ["In_" + block.replace(" ", "_") for block in Blocks.VALUES if block != "No_Block"]
    seen, out = set(), []
    for name in names:
        if normalize(name) not in seen:
            seen.add(normalize(name))
            out.append(name)
    return out


def property_tables(pool) -> tuple:
    """(name -> set index, sets, bare Latin-1 sets by name); the escapes
    under ``\\w``-style keys, the POSIX brackets under ``[:name:]``."""
    accepted = [n for n in candidate_names() if _compiles(f"\\p{{{n}}}")]
    print(f"properties: {len(accepted)} names accepted", file=sys.stderr)
    probed = pool.map(_probe_name, accepted, chunksize=1)
    escapes = pool.map(_probe_escape, ESCAPES)
    brackets = pool.map(_probe_bracket, POSIX)
    sets: list = []
    index: dict = {}
    names: dict = {}
    bare: dict = {}
    for name, points, latin1 in [*probed, *[("\\" + e, p, l) for e, p, l in escapes]]:
        if points not in index:
            index[points] = len(sets)
            sets.append(points)
        names[name if name.startswith("\\") else normalize(name)] = index[points]
        if latin1 != {c for c in points if c < 256}:
            bare[name if name.startswith("\\") else normalize(name)] = latin1
    for name, points in brackets:
        if points not in index:
            index[points] = len(sets)
            sets.append(points)
        names[f"[:{name.lower()}:]"] = index[points]
    return names, sets, bare


# ---------------------------------------------------------------------------
# 2. case folding
# ---------------------------------------------------------------------------


def case_tables(property_set) -> tuple:
    """(classes of characters equal under case folding, {cp: fold} for
    the characters that fold to more than one)."""
    cased = set(property_set("changeswhencasemapped", ())) | set(property_set("changeswhencasefolded", ()))
    cased |= {c for c in ALL if chr(c).lower() != chr(c) or chr(c).upper() != chr(c)
              or chr(c).casefold() != chr(c)}
    cased = sorted(cased)
    text = "\0".join(map(chr, cased))
    parent = {c: c for c in cased}

    def root(c):
        while parent[c] != c:
            parent[c] = parent[parent[c]]
            c = parent[c]
        return c

    for c in cased:
        for start, _ in matched_spans(f"(?i)\\x{{{c:X}}}", text):
            d = ord(text[start])
            parent[root(d)] = root(c)
    classes: dict = {}
    for c in cased:
        classes.setdefault(root(c), []).append(c)
    groups = sorted(tuple(sorted(g)) for g in classes.values() if len(g) > 1)
    multi = {}
    for c in cased:
        fold = chr(c).casefold()
        if len(fold) > 1:
            if matched_spans(rf"\A(?i:\x{{{c:X}}})\z", fold) != [(0, len(fold))]:
                raise SystemExit(f"case: U+{c:04X} does not match its casefold {fold!r}")
            multi[c] = fold
    print(f"case: {len(groups)} classes, {len(multi)} multi-character folds", file=sys.stderr)
    return groups, multi


# ---------------------------------------------------------------------------
# 3. grapheme cluster classes
# ---------------------------------------------------------------------------

#: (name, prefix, suffix): c is in the named set when prefix + c + suffix
#: is one cluster
CLUSTER_CONTEXTS = (
    ("after_other", "a", ""),            # Extend, ZWJ, SpacingMark
    ("before_other", "", "a"),           # Prepend
    ("before_extend", "", "\u0301"),     # all but Control, CR, LF
    ("before_l", "", "\u1100"),          # L
    ("before_v", "", "\u1161"),          # L, V, LV
    ("before_t", "", "\u11A8"),          # V, T, LV, LVT
    ("after_l", "\u1100", ""),           # L, V, LV, LVT
    ("after_v", "\u1161", ""),           # V, T
    ("after_ri", "\U0001F1E6", ""),      # RI
    ("after_zwj", "\U0001F600\u200D", ""),           # Extended_Pictographic
    ("in_emoji_zwj", "\U0001F600", "\u200D\U0001F600"),  # Extend
    ("conjunct", "\u0915\u094D", "\u0937"),          # none: the library has no GB9c
)


def cluster_tables(pool) -> dict:
    """Each grapheme cluster class \\X reads, as a set of code points."""
    probes = dict(pool.map(_probe_cluster, CLUSTER_CONTEXTS, chunksize=1))
    extendlike = probes["after_other"]
    everything = set(ALL)
    out = {
        "CR": {0x0D}, "LF": {0x0A}, "ZWJ": {0x200D},
        "Control": everything - probes["before_extend"] - {0x0D, 0x0A},
        "Prepend": set(probes["before_other"]),
        "Extend": extendlike & probes["in_emoji_zwj"],
        "L": probes["before_l"] - extendlike,
        "V": (probes["after_v"] & probes["before_v"]) - extendlike,
        "T": (probes["after_v"] - probes["before_v"]) - extendlike,
        "LV": (probes["before_v"] & probes["after_l"]) - probes["after_v"] - probes["before_l"]
        - extendlike,
        "LVT": (probes["after_l"] & probes["before_t"]) - probes["before_v"] - probes["after_v"]
        - extendlike,
        "RI": probes["after_ri"] - extendlike,
        "ExtPict": probes["after_zwj"] - extendlike,
    }
    if probes["conjunct"]:
        raise SystemExit("clusters: the library joins an Indic conjunct (GB9c); read InCB")
    out["SpacingMark"] = extendlike - out["Extend"] - {0x200D}
    if 0x200D not in extendlike or 0x200D in out["Extend"]:
        raise SystemExit("clusters: U+200D is not read as ZWJ")
    for name, points in out.items():
        print(f"clusters: {name} {len(points)}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# 5. word break classes
# ---------------------------------------------------------------------------

#: (name, prefix, suffix): whether prefix + c + suffix is one word segment
#: tells c's class apart (UAX #29's rules as Oniguruma implements them)
WORD_CONTEXTS = (
    ("after_letter", "a", ""),                 # letters, digits, _, Extend/Format/ZWJ
    ("before_letter", "", "a"),                # letters, digits, _
    ("after_digit", "1", ""),                  # letters, digits, _, Extend/Format/ZWJ
    ("after_katakana", "\u30A2", ""),          # Katakana, _, Extend/Format/ZWJ
    ("between_letters", "a", "a"),             # MidLetter, MidNumLet, Single_Quote
    ("between_digits", "1", "1"),              # MidNum, MidNumLet, Single_Quote
    ("after_hebrew", "\u05D0", ""),            # Single_Quote too
    ("between_hebrew", "\u05D0", "\u05D0"),    # Double_Quote too
    ("after_space", " ", ""),                  # WSegSpace, Extend/Format/ZWJ
    ("before_extend", "", "\u0301"),           # all but the line breaks
    ("before_pictograph", "", "\U0001F600"),   # ZWJ
    ("after_ri", "\U0001F1E6", ""),            # Regional_Indicator, Extend/Format/ZWJ
)
#: the ``regex`` package's Word_Break values the library's rules read
WORD_CLASSES = ("ALetter", "Hebrew_Letter", "Numeric", "Katakana", "ExtendNumLet", "MidLetter",
                "MidNum", "MidNumLet", "Single_Quote", "Double_Quote", "Extend", "Format", "ZWJ",
                "WSegSpace", "Regional_Indicator", "CR", "LF", "Newline")


def word_tables(pool) -> dict:
    """Each word break class, as a set of code points: ``regex``'s value
    where the library behaves as that value says, else the value whose
    behaviour the library shows (None where none does)."""
    import regex

    probes = dict(pool.map(_probe_word, WORD_CONTEXTS, chunksize=1))
    candidate: dict = {}
    for name in WORD_CLASSES:
        for m in regex.finditer(f"\\p{{Word_Break={name}}}+", _TEXT):
            for i in range(m.start(), m.end()):
                candidate[_index_to_cp(i)] = name

    def print_(c):
        return tuple(c in probes[name] for name, _, _ in WORD_CONTEXTS)

    seen: dict = {}
    for c in ALL:
        seen.setdefault(candidate.get(c), {}).setdefault(print_(c), 0)
        seen[candidate.get(c)][print_(c)] += 1
    # each class's behaviour: the fingerprint most of its code points show
    typical = {name: max(counts, key=counts.get) for name, counts in seen.items()}
    by_print: dict = {}
    for name, fingerprint in typical.items():
        by_print.setdefault(fingerprint, []).append(name)
    out: dict = {name: set() for name in WORD_CLASSES}
    differ = []
    for c in ALL:
        name, fingerprint = candidate.get(c), print_(c)
        if typical[name] != fingerprint:
            names = by_print.get(fingerprint, [None])
            differ.append((c, name, names[0]))
            name = names[0]
        if name is not None:
            out[name].add(c)
    print(f"words: {len(differ)} code points where regex's Word_Break and the library differ "
          "(the library's class kept)", file=sys.stderr)
    for c, was, now in differ:
        print(f"  U+{c:04X} {was} -> {now}", file=sys.stderr)
    for name, points in out.items():
        print(f"words: {name} {len(points)}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# 4. the UnicodeScripts pre-tokenizer's scripts
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _same_script(a: int, b: int) -> bool:
    """Whether the pre-tokenizer keeps ``a`` and ``b`` (neither of them
    Any) in one piece."""
    import tokenizers

    pieces = tokenizers.pre_tokenizers.UnicodeScripts().pre_tokenize_str(chr(a) + chr(b))
    return len(pieces) == 1


def any_points() -> set:
    """The code points the library's table leaves out (its ``Any``, which
    never starts a piece): those at which no piece starts when each code
    point is put between two markers of one script, for two scripts."""
    import tokenizers

    split = tokenizers.pre_tokenizers.UnicodeScripts()
    out = None
    for marker in ("\uA000", "\u10A0"):  # Yi, Georgian
        starts_none = set()
        for lo in range(0, len(ALL), 1 << 16):
            chunk = ALL[lo:lo + (1 << 16)]
            text = "".join(chr(c) + marker for c in chunk)
            starts = {start for _, (start, _) in split.pre_tokenize_str(text)}
            starts_none |= {c for i, c in enumerate(chunk) if 2 * i not in starts}
        out = starts_none if out is None else out & starts_none
    return out


def script_runs() -> tuple:
    """(script names, [(first code point, name index)]) for the library's
    UnicodeScripts table (``Any`` for a code point it leaves out), and the
    code points where it differs from fontTools'."""
    import tokenizers
    from fontTools.unicodedata import script as font_script

    anys = any_points() | {0x20}
    known = [c for c in ALL if c not in anys]
    pieces = tokenizers.pre_tokenizers.UnicodeScripts().pre_tokenize_str(
        "".join(map(chr, known)))
    starts = sorted({start for _, (start, _) in pieces} | {0})
    bounds = [*starts, len(known)]
    runs_known = [known[a:b] for a, b in zip(bounds, bounds[1:])]
    font = {c: font_script(chr(c)) for c in known}
    # a representative of each fontTools script: the middle of its longest
    # stretch inside one run
    stretches: dict = {}
    for run in runs_known:
        i = 0
        while i < len(run):
            j = i
            while j < len(run) and font[run[j]] == font[run[i]]:
                j += 1
            if j - i > len(stretches.get(font[run[i]], ())):
                stretches[font[run[i]]] = run[i:j]
            i = j
    reps = {name: points[len(points) // 2] for name, points in stretches.items()}
    label: dict = {}
    for run in runs_known:
        counts: dict = {}
        for c in run:
            counts[font[c]] = counts.get(font[c], 0) + 1
        candidates = sorted(counts, key=lambda n: -counts[n]) + sorted(reps)
        for name in candidates:
            if name in reps and _same_script(run[0], reps[name]):
                break
        else:
            raise SystemExit(f"scripts: no fontTools script pairs with U+{run[0]:04X}")
        for c in run:
            own = font[c]
            keep = own == name or (own in reps and _same_script(reps[name], reps[own]))
            label[c] = own if keep else name
    names = sorted(set(label.values())) + ["Any"]
    index_of = {name: i for i, name in enumerate(names)}
    runs: list = []
    for c in range(sys.maxunicode + 1):
        index = index_of[label.get(c, "Any")]
        if not runs or runs[-1][1] != index:
            runs.append((c, index))
    differ = [c for c in known if font[c] != label[c]]
    return names, runs, differ


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

HEADER = '''"""Unicode data of the ``tokenizers`` library, as the port reads it.

Generated by ``PYTHONPATH=. python scripts/torch_unicode_tables.py`` from
the installed library (tokenizers {tokenizers}: its Oniguruma expressions
and its ``UnicodeScripts`` pre-tokenizer), with the ``regex`` package's
property names and fontTools' script and block names as candidates; do
not edit.  ``tests/test_torch_oniguruma.py`` holds it to the library.

- ``PROPERTIES``: each ``\\\\p{{name}}`` the library accepts (its name
  lowercased without spaces, ``_`` and ``-``) -> its set in ``SETS``, as
  the name reads inside a class; ``ESCAPES`` the same for ``\\\\w``,
  ``\\\\s``, ``\\\\d`` and ``\\\\h``, ``BRACKETS`` for the POSIX
  brackets (``[:punct:]`` is wider than ``\\\\p{{Punct}}``).
- ``BARE_LATIN1``: where a name or escape outside a class matches other
  code points below U+0100 (Oniguruma reads a Latin-1 table there), those.
- ``CASE_CLASSES``: the characters ``(?i)`` holds equal, one class each;
  ``MULTI_FOLDS``: the characters that fold to two or three.
- ``CLUSTERS``: the grapheme cluster classes of ``\\\\X``.
- ``WORD_BREAKS``: the word break classes of ``\\\\y``, ``\\\\Y`` and
  ``\\\\X`` under ``(?y{{w}})``.
- ``SCRIPT_NAMES`` and ``SCRIPT_RUNS``: the ``UnicodeScripts``
  pre-tokenizer's script of every code point, as (first code point, name)
  runs.  Its Rust table and Oniguruma's Script classes are
  {scripts_agree}.

A set is its sorted ranges, each the gap since the last range's end and
its length less one; a number is written in base 32, its last digit from
``{final}`` and the others from
``{more}``.  The surrogates, which the library never sees, are in a
set when both of their neighbours are.
"""

from __future__ import annotations

'''


def _wrap(name: str, items: "list[str]", width: int = 99) -> "list[str]":
    lines = [f"{name} = ("]
    row = "   "
    for item in items:
        if len(row) + len(item) + 1 > width:
            lines.append(row)
            row = "   "
        row += " " + item
    lines += [row, ")"] if row.strip() else [")"]
    return lines


def _wrap_string(value: str, width: int = 92) -> "list[str]":
    return [f'    "{value[i:i + width]}"' for i in range(0, len(value), width)] or ['    ""']


def render(tables: dict) -> str:
    """The module's text from the probed tables."""
    lines = [HEADER.format(**tables["header"], final=FINAL, more=MORE)]
    lines.append("#: the encoded sets")
    lines.append("SETS = (")
    for points in tables["sets"]:
        lines += _wrap_string(encode(to_ranges(points)))
        lines[-1] += ","
    lines += [")", ""]
    lines.append("PROPERTIES = {")
    for name, i in sorted(tables["properties"].items()):
        lines.append(f"    {name!r}: {i},")
    lines += ["}", ""]
    lines.append("ESCAPES = {")
    for name, i in sorted(tables["escapes"].items()):
        lines.append(f"    {name!r}: {i},")
    lines += ["}", ""]
    lines.append("BRACKETS = {")
    for name, i in sorted(tables["brackets"].items()):
        lines.append(f"    {name!r}: {i},")
    lines += ["}", ""]
    lines.append("BARE_LATIN1 = {")
    for name, points in sorted(tables["bare"].items()):
        lines.append(f"    {name!r}: {encode(to_ranges(points))!r},")
    lines += ["}", ""]
    lines += _wrap("CASE_CLASSES", [
        "(" + ", ".join(f"0x{c:X}" for c in group) + ")," for group in tables["case_classes"]])
    lines.append("")
    lines.append("MULTI_FOLDS = {")
    for c, fold in sorted(tables["multi_folds"].items()):
        lines.append(f"    0x{c:X}: {fold!r},")
    lines += ["}", ""]
    lines.append("CLUSTERS = {")
    for name, points in tables["clusters"].items():
        lines.append(f"    {name!r}: {encode(to_ranges(points))!r},")
    lines += ["}", ""]
    lines.append("WORD_BREAKS = {")
    for name, points in tables["word_breaks"].items():
        lines.append(f"    {name!r}: {encode(to_ranges(points))!r},")
    lines += ["}", ""]
    lines += _wrap("SCRIPT_NAMES", [f"{n!r}," for n in tables["script_names"]])
    lines.append("")
    lines += _wrap("SCRIPT_RUNS", [f"(0x{lo:X}, {i})," for lo, i in tables["script_runs"]])
    lines.append("")
    return "\n".join(lines)


def probe(workers: int) -> dict:
    import tokenizers

    with multiprocessing.get_context("fork").Pool(workers) as pool:
        names, sets, bare = property_tables(pool)
        clusters = cluster_tables(pool)
        word_breaks = word_tables(pool)

    def property_set(name, default=None):
        return sets[names[name]] if name in names else default

    case_classes, multi_folds = case_tables(property_set)
    script_names, runs, differ = script_runs()
    print(f"scripts: {len(script_names)} scripts in {len(runs)} runs; {len(differ)} code points "
          f"differ from fontTools' (its Unicode 17.0 Scripts.py)",
          file=sys.stderr)
    for c in differ:
        print(f"  U+{c:04X}", file=sys.stderr)
    by_name: dict = {}
    bounds = [lo for lo, _ in runs] + [sys.maxunicode + 1]
    for (lo, i), hi in zip(runs, bounds[1:]):
        by_name.setdefault(script_names[i], set()).update(range(lo, hi))
    agree = all(
        {c for c in property_set(normalize(name)) if not 0xD800 <= c < 0xE000} - {0x20}
        == {c for c in points if not 0xD800 <= c < 0xE000} - {0x20}
        for name, points in by_name.items() if name != "Any")
    return {
        "header": {"tokenizers": tokenizers.__version__,
                   "scripts_agree": "equal on every code point" if agree else
                   "not equal, so both are kept"},
        "sets": sets,
        "properties": {k: v for k, v in names.items() if k[0] not in "\\["},
        "escapes": {k[1:]: v for k, v in names.items() if k.startswith("\\")},
        "brackets": {k[2:-2]: v for k, v in names.items() if k.startswith("[")},
        "bare": bare, "case_classes": case_classes, "multi_folds": multi_folds,
        "clusters": clusters, "word_breaks": word_breaks, "script_names": script_names,
        "script_runs": runs,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, default=min(6, os.cpu_count() or 1))
    parser.add_argument("--check", action="store_true",
                        help="exit 1 if the committed module is not what the library gives")
    args = parser.parse_args(argv)
    text = render(probe(args.workers))
    if args.check:
        with open(OUT, encoding="utf-8") as fh:
            same = fh.read() == text
        print("unicode_tables.py is " + ("current" if same else "stale"))
        return 0 if same else 1
    with open(OUT, "w", encoding="utf-8") as fh:
        fh.write(text)
    print(f"wrote {OUT} ({len(text.encode())} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
