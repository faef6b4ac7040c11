"""Oniguruma's expressions, as the ``tokenizers`` library reads and runs them.

The library compiles a ``Regex`` pattern with Oniguruma's own syntax
(``(?imxWDSPy-imx)`` options, ``m`` meaning dot-all, ``\\h`` a hex digit,
``{n,m}+`` a repeat of a repeat) and finds with its ``find_iter``.  This
module parses that syntax into a small tree and, where Python's ``re`` can
run it in the library's order without exponential backtracking, writes it
out for ``re``:

- every class is a code point set from :mod:`.unicode_tables` (Unicode as
  the library's Oniguruma has it): ``\\p{..}`` names as Oniguruma compares
  them (case, spaces, ``_`` and ``-`` ignored, ``^`` negating), ``\\w \\s
  \\d \\h``, POSIX brackets, nested classes, ``&&`` intersections and the
  ASCII options ``W D S P``;
- ``(?i)`` is written out, never left to ``re``: each literal becomes the
  characters Oniguruma's case folding holds equal, a character that folds
  to several (``ß``, ``ﬁ``, ``İ``) their spelling too, two or three
  literals that fold to one character that character too;
- ``^ $ \\A \\z \\Z \\b \\B`` are written as Oniguruma reads them, ``\\K``
  and ``\\G`` by :class:`Expression` around the compiled ``re``;
- ``\\R``, ``\\X``, ``\\O``, ``\\N``, ``\\x{..}``, ``\\o{..}``, ``\\uHHHH``,
  ``\\cX``/``\\C-X``/``\\M-X``, raw bytes (``\\xHH``, octal) read as UTF-8;
- capture groups, named groups, back references, conditionals, atomic
  groups, lookarounds (a look-behind of several widths as one look-behind
  per width), possessive and nested repeats (a repeat of a repeat reduced
  as Oniguruma reduces it), a ``\\g<..>`` call that is not recursive
  (written in place).

Every other expression the library reads goes to the port's own matcher
(:mod:`.onig_match`), which runs Oniguruma's semantics and its retry
limit: a recursive call, the absent operator ``(?~..)``, ``\\y``/``\\Y``,
callouts, back references under ``(?i)``, with a nest level or to a
shared name, look-behinds ``re`` cannot write, ``\\G`` and ``\\K`` anywhere,
a repeat of two or more rounds of what can match empty, and exponential
ambiguity (:func:`ambiguous`), where ``re`` backtracks without bound and
Oniguruma gives up.  An expression the library rejects raises
:class:`OnigurumaError` (a ``ValueError``, so a loader falls back as the
reference does).
"""

from __future__ import annotations

import bisect
import functools
import re
from typing import Optional

from . import unicode_tables as _tables

__all__ = ["Expression", "OnigurumaError", "compile_expression", "property_ranges"]

MAX_CODE = 0x10FFFF
#: a code point set: sorted, disjoint, non-adjacent ``(lo, hi)`` ranges
Ranges = "tuple[tuple[int, int], ...]"

ALL: "Ranges" = ((0, MAX_CODE),)
ASCII: "Ranges" = ((0, 0x7F),)
NEWLINE = 0x0A
#: the POSIX bracket names, which the ``P`` option restricts to ASCII
POSIX_NAMES = ("alnum", "alpha", "ascii", "blank", "cntrl", "digit", "graph", "lower", "print",
               "punct", "space", "upper", "xdigit", "word")
#: a repeat's largest count
MAX_REPEAT = 100000
#: a look-behind of several widths is split into at most this many
MAX_LOOKBEHIND_WIDTHS = 64
#: how far back ``\\X`` started inside a cluster reads (pairs of regional
#: indicators, extenders before an emoji's joiner)
CLUSTER_CONTEXT = 8


class OnigurumaError(ValueError):
    """An expression the ``tokenizers`` library rejects (its message)."""


class _CaptureInLookBehind(OnigurumaError):
    """A capture group in a negative look-behind."""


class _Unwritable(Exception):
    """What Python's ``re`` cannot express: the expression goes to the
    matcher (:mod:`.onig_match`)."""


# ---------------------------------------------------------------------------
# code point sets
# ---------------------------------------------------------------------------


def _normalize(ranges) -> "Ranges":
    out: list = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return tuple((lo, hi) for lo, hi in out)


def union(*sets) -> "Ranges":
    return _normalize([r for s in sets for r in s])


def intersect(a: "Ranges", b: "Ranges") -> "Ranges":
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tuple(out)


def complement(a: "Ranges") -> "Ranges":
    out, prev = [], 0
    for lo, hi in a:
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= MAX_CODE:
        out.append((prev, MAX_CODE))
    return tuple(out)


def contains(a: "Ranges", cp: int) -> bool:
    i = bisect.bisect_right(a, (cp, MAX_CODE + 1)) - 1
    return i >= 0 and a[i][0] <= cp <= a[i][1]


def points(*cps: int) -> "Ranges":
    return _normalize((c, c) for c in cps)


# ---------------------------------------------------------------------------
# the generated tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def decode(encoded: str) -> "Ranges":
    """A set as :mod:`.unicode_tables` writes it."""
    numbers, n = [], 0
    for ch in encoded:
        digit = _MORE.find(ch)
        if digit >= 0:
            n = n * 32 + digit
        else:
            numbers.append(n * 32 + _FINAL.index(ch))
            n = 0
    out, prev = [], -1
    for gap, length in zip(numbers[::2], numbers[1::2]):
        lo = prev + 1 + gap
        prev = lo + length
        out.append((lo, prev))
    return tuple(out)


_FINAL = "abcdefghijklmnopqrstuvwxyz012345"
_MORE = "ABCDEFGHIJKLMNOPQRSTUVWXYZ6789+/"


def normalize_name(name: str) -> str:
    """A property name as Oniguruma compares it."""
    return "".join(c for c in name.lower() if c not in " _-")


def _with_bare(ranges: "Ranges", key: str, bare: bool) -> "Ranges":
    """Outside a class a POSIX name reads Oniguruma's Latin-1 table below
    U+0100."""
    if not bare or key not in _tables.BARE_LATIN1:
        return ranges
    return union(intersect(ranges, ((0x100, MAX_CODE),)), decode(_tables.BARE_LATIN1[key]))


@functools.lru_cache(maxsize=None)
def property_ranges(name: str, bare: bool = False) -> "Ranges":
    """``\\p{name}``'s code points, as in a class or (``bare``) alone."""
    key = normalize_name(name)
    index = _tables.PROPERTIES.get(key)
    if index is None:
        raise OnigurumaError(f"invalid character property name {{{name}}}")
    return _with_bare(decode(_tables.SETS[index]), key, bare)


@functools.lru_cache(maxsize=None)
def escape_ranges(letter: str, bare: bool = False) -> "Ranges":
    """``\\w``, ``\\s``, ``\\d`` or ``\\h`` (positive), as in a class or alone."""
    return _with_bare(decode(_tables.SETS[_tables.ESCAPES[letter]]), "\\" + letter, bare)


@functools.lru_cache(maxsize=None)
def cluster_ranges(name: str) -> "Ranges":
    return decode(_tables.CLUSTERS[name])


@functools.lru_cache(maxsize=1)
def _case() -> tuple:
    """(cp -> its class, fold string -> the characters that fold to it)."""
    classes = {c: group for group in _tables.CASE_CLASSES for c in group}
    canon = {c: min(group) for c, group in classes.items()}
    multi: dict = {}
    for c, fold in _tables.MULTI_FOLDS.items():
        multi.setdefault(_fold_string(fold, canon), []).append(c)
    return classes, canon, multi


def _fold_string(text: str, canon: dict) -> str:
    return "".join(chr(canon.get(ord(c), ord(c))) for c in text)


def case_class(cp: int) -> "tuple[int, ...]":
    """The characters ``(?i)`` matches for ``cp`` one for one."""
    return _case()[0].get(cp, (cp,))


def fold(cp: int) -> str:
    """``cp`` case folded, as the characters of its classes' representatives."""
    classes, canon, _ = _case()
    if cp in _tables.MULTI_FOLDS:
        return _fold_string(_tables.MULTI_FOLDS[cp], canon)
    return chr(canon.get(cp, cp))


def case_closure(ranges: "Ranges") -> "Ranges":
    """``ranges`` and every character case folding holds equal to one."""
    extra = [c for group in _tables.CASE_CLASSES if any(contains(ranges, c) for c in group)
             for c in group]
    return union(ranges, points(*extra)) if extra else ranges


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


class Node:
    __slots__ = ()


class Chars(Node):
    """One character of a set; ``icase``: a positive class under ``(?i)``
    (its characters that fold to several match their spelling too)."""
    __slots__ = ("ranges", "icase")

    def __init__(self, ranges, icase=False):
        self.ranges, self.icase = ranges, icase


class Text(Node):
    """Literal characters (merged into runs); ``icase`` under ``(?i)``."""
    __slots__ = ("cps", "icase")

    def __init__(self, cps, icase):
        self.cps, self.icase = list(cps), icase


class Seq(Node):
    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items


class Alt(Node):
    __slots__ = ("branches",)

    def __init__(self, branches):
        self.branches = branches


class Group(Node):
    """``kind``: ``cap`` (``number``), ``nc`` (``(?:..)``, dissolved into
    the literals around it), ``sub`` (non-capturing, kept: an option group,
    a plain group when only named groups capture), ``atomic``, ``ahead``,
    ``nahead``, ``behind``, ``nbehind``."""
    __slots__ = ("kind", "body", "number")

    def __init__(self, kind, body, number=None):
        self.kind, self.body, self.number = kind, body, number


class Repeat(Node):
    """``mode``: ``greedy``, ``lazy`` or ``possessive``; ``hi`` None for
    no bound."""
    __slots__ = ("body", "lo", "hi", "mode")

    def __init__(self, body, lo, hi, mode):
        self.body, self.lo, self.hi, self.mode = body, lo, hi, mode


class Anchor(Node):
    """``kind``: ``bol eol bos eos eos_nl word nonword keep start``; the
    word anchors carry their word set."""
    __slots__ = ("kind", "word")

    def __init__(self, kind, word=None):
        self.kind, self.word = kind, word


class Backref(Node):
    """``\\k<..>``: ``numbers`` the groups of a name several groups share
    (None: ``number`` alone), ``level`` a nest level (``\\k<n+0>``)."""
    __slots__ = ("number", "icase", "level", "numbers")

    def __init__(self, number, icase=False, level=None, numbers=None):
        self.number, self.icase, self.level, self.numbers = number, icase, level, numbers


class Cond(Node):
    """``(?(n)yes|no)`` (``number``, ``numbers`` for a shared name) or
    ``(?(cond)yes|no)`` (``test``)."""
    __slots__ = ("number", "test", "yes", "no", "numbers")

    def __init__(self, number, test, yes, no, numbers=None):
        self.number, self.test, self.yes, self.no, self.numbers = number, test, yes, no, numbers


class Call(Node):
    """``\\g<..>``: ``target`` is a group number or name, ``number`` the
    group it names once the whole expression is read."""
    __slots__ = ("target", "number")

    def __init__(self, target):
        self.target, self.number = target, None


class Cluster(Node):
    """``\\X``: one grapheme cluster, or under ``(?y{w})`` one word segment."""
    __slots__ = ("word",)

    def __init__(self, word=False):
        self.word = word


class Absent(Node):
    """The absent operator: ``kind`` ``repeater`` (``(?~absent)``),
    ``expr`` (``(?~|absent|body)``), ``stopper`` (``(?~|absent)``) or
    ``clear`` (``(?~|)``)."""
    __slots__ = ("kind", "absent", "body")

    def __init__(self, kind, absent=None, body=None):
        self.kind, self.absent, self.body = kind, absent, body


class Callout(Node):
    """A builtin callout ``(*name[tag]{args})`` other than ``(*FAIL)``."""
    __slots__ = ("name", "args", "tag")

    def __init__(self, name, args, tag):
        self.name, self.args, self.tag = name, args, tag


class Raw(Node):
    """A piece of ``re`` written directly, of the widths given."""
    __slots__ = ("text", "lo", "hi")

    def __init__(self, text, lo, hi):
        self.text, self.lo, self.hi = text, lo, hi


FAIL = Raw("(?!)", 0, 0)
#: ``\\R``: a CRLF or one line break, atomically
NEWLINES = Raw("(?>\\r\\n|[\\n\\x0b\\x0c\\r\\x85\\u2028\\u2029])", 1, 2)


def width(node: Node) -> "tuple[int, Optional[int]]":
    """The fewest and most characters ``node`` matches (None: no bound)."""
    if isinstance(node, Chars):
        return _icase_chars_width(node) if node.icase else (1, 1)
    if isinstance(node, Text):
        if not node.icase:
            return len(node.cps), len(node.cps)
        return 1 if node.cps else 0, 3 * len(node.cps)
    if isinstance(node, Seq):
        lo, hi = 0, 0
        for item in node.items:
            a, b = width(item)
            lo += a
            hi = None if hi is None or b is None else hi + b
        return lo, hi
    if isinstance(node, Alt):
        ws = [width(b) for b in node.branches]
        return min(a for a, _ in ws), (None if any(b is None for _, b in ws)
                                       else max(b for _, b in ws))
    if isinstance(node, Group):
        return (0, 0) if node.kind in ("ahead", "nahead", "behind", "nbehind") else width(node.body)
    if isinstance(node, Repeat):
        a, b = width(node.body)
        return a * node.lo, (None if node.hi is None or b is None else b * node.hi)
    if isinstance(node, (Anchor, Callout)):
        return 0, 0
    if isinstance(node, (Backref, Call)):
        return 0, None
    if isinstance(node, Cluster):
        return 1, None
    if isinstance(node, Absent):
        if node.kind == "expr":
            return width(node.body)
        return (0, None) if node.kind == "repeater" else (0, 0)
    if isinstance(node, Cond):
        ws = [width(node.yes), width(node.no)]
        if node.test is not None:
            ws[0] = _add(width(node.test), ws[0])
        return min(a for a, _ in ws), (None if any(b is None for _, b in ws)
                                       else max(b for _, b in ws))
    if isinstance(node, Raw):
        return node.lo, node.hi
    raise TypeError(node)


def _add(a, b):
    return a[0] + b[0], (None if a[1] is None or b[1] is None else a[1] + b[1])


def _icase_chars_width(node: Chars) -> "tuple[int, Optional[int]]":
    _, _, multi = _case()
    longest = max((len(f) for f, cps in multi.items()
                   if any(contains(node.ranges, c) for c in cps)), default=1)
    return 1, longest


def _walk(node: Node):
    yield node
    children = []
    if isinstance(node, Seq):
        children = node.items
    elif isinstance(node, Alt):
        children = node.branches
    elif isinstance(node, (Group, Repeat)):
        children = [node.body]
    elif isinstance(node, Cond):
        children = [c for c in (node.test, node.yes, node.no) if c is not None]
    elif isinstance(node, Absent):
        children = [c for c in (node.absent, node.body) if c is not None]
    for child in children:
        yield from _walk(child)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


class _Flags:
    """The options in force: ``i``, ``m`` (dot-all), ``x`` and the ASCII
    restrictions ``W`` (word), ``D`` (digit), ``S`` (space), ``P``
    (POSIX brackets; it sets the other three too)."""
    __slots__ = ("i", "m", "x", "W", "D", "S", "P", "y")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k, False))

    def copy(self) -> "_Flags":
        return _Flags(**{k: getattr(self, k) for k in self.__slots__})


_SPACE_X = " \t\n\x0b\x0c\r"
_CONTROL_ESCAPES = {"t": 0x09, "n": 0x0A, "r": 0x0D, "f": 0x0C, "v": 0x0B, "a": 0x07, "e": 0x1B}
_HEX = "0123456789abcdefABCDEF"
_OCT = "01234567"
_NAME = re.compile(r"[^\W\d]\w*")
#: a byte escape that may continue a UTF-8 sequence (the digits: octal
#: unless a back reference)
_BYTE_ESCAPE = re.compile(r"\\(x(?!\{)|[0-7])([0-9]*)")
#: the builtin callouts the library reads: the fewest and most arguments
_CALLOUT_ARGS = {"FAIL": (0, 0), "MISMATCH": (0, 0), "SKIP": (0, 0), "ERROR": (0, 1),
                 "MAX": (1, 2), "COUNT": (0, 1), "TOTAL_COUNT": (0, 1), "CMP": (3, 3)}
_TAG = re.compile(r"[A-Za-z_]\w*")


class _Parser:
    def __init__(self, pattern: str, named_only: bool):
        self.p = pattern
        self.i = 0
        self.named_only = named_only
        self.groups = 0          # capture groups opened so far
        self.names: dict = {}    # name -> [group numbers]
        self.bodies: dict = {}   # number -> Group
        self.saw_name = False
        self.numbered_refs = False
        self.matcher_reason: Optional[str] = None   # what only the matcher runs
        self.tags: dict = {}     # callout tag -> its callout's name
        self.capture_error: "Optional[OnigurumaError]" = None

    # --- helpers ---

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.p[j] if j < len(self.p) else ""

    def eat(self, s: str) -> bool:
        if self.p.startswith(s, self.i):
            self.i += len(s)
            return True
        return False

    def skip_x(self, flags: _Flags) -> None:
        while flags.x and self.i < len(self.p):
            c = self.p[self.i]
            if c in _SPACE_X:
                self.i += 1
            elif c == "#":
                end = self.p.find("\n", self.i)
                self.i = len(self.p) if end < 0 else end + 1
            else:
                return

    # --- structure ---

    def parse(self) -> Node:
        flags = _Flags()
        node = self.alternation(flags)
        if self.i < len(self.p):
            raise OnigurumaError("unmatched close parenthesis")
        return node

    def alternation(self, flags: _Flags) -> Node:
        branches = [self.sequence(flags)]
        while self.eat("|"):
            branches.append(self.sequence(flags))
        return branches[0] if len(branches) == 1 else Alt(branches)

    def sequence(self, flags: _Flags) -> Node:
        items: list = []
        while True:
            self.skip_x(flags)
            c = self.peek()
            if c in ("", "|", ")"):
                break
            atom = self.atom(flags)
            if atom is None:
                continue
            if isinstance(atom, _Flags):
                # an isolated option holds to the end of the group, over
                # the alternatives after it: a(?i)b|c is a(?i:b|c)
                items.append(Group("sub", self.alternation(atom)))
                break
            items.append(self.quantified(atom, flags))
        return Seq(_merge(items))

    def quantified(self, atom: Node, flags: _Flags) -> Node:
        while True:
            self.skip_x(flags)
            quantifier = self.quantifier()
            if quantifier is None:
                return atom
            if _invalid_target(atom):
                raise OnigurumaError("target of repeat operator is invalid")
            lo, hi, mode = quantifier
            if lo > 1 and width(atom)[0] == 0:
                # Oniguruma ends a repeat at its first empty round; Python's
                # goes on to the minimum, and so backtracks in another order
                self.needs("a repeat of at least two of what can match empty")
            if mode == "optional":  # x{n}? is (?:x{n})?
                atom = Repeat(Repeat(atom, lo, hi, "greedy"), 0, 1, "greedy")
            else:
                atom = _nested_repeat(atom, lo, hi, mode)

    def quantifier(self):
        c = self.peek()
        if c in ("*", "+", "?"):
            self.i += 1
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
            if self.eat("?"):
                return lo, hi, "lazy"
            if self.eat("+"):
                return lo, hi, "possessive"
            return lo, hi, "greedy"
        if c == "{":
            interval = self.interval()
            if interval is None:
                return None
            lo, hi, possessive, fixed = interval
            if possessive:
                return lo, hi, "possessive"
            if self.eat("?"):
                return lo, hi, ("optional" if fixed else "lazy")
            return lo, hi, "greedy"
        return None

    def interval(self):
        """``{n}``, ``{n,}``, ``{,m}``, ``{n,m}`` at the cursor (consumed),
        or None (then ``{`` is a literal)."""
        m = re.compile(r"\{(\d*)(,?)(\d*)\}").match(self.p, self.i)
        if m is None or (not m.group(1) and not m.group(3)) or (m.group(3) and not m.group(2)):
            return None
        lo_s, comma, hi_s = m.groups()
        lo = int(lo_s) if lo_s else 0
        hi = (int(hi_s) if hi_s else None) if comma else lo
        if lo > MAX_REPEAT or (hi is not None and hi > MAX_REPEAT):
            raise OnigurumaError("too big number for repeat range")
        self.i = m.end()
        possessive = hi is not None and lo > hi
        if possessive:
            lo, hi = hi, lo
        return lo, hi, possessive, not comma

    def atom(self, flags: _Flags):
        c = self.peek()
        if c == "(":
            return self.group(flags)
        if c == "[":
            self.i += 1
            return self.char_class(flags)
        if c in ("*", "+", "?"):
            raise OnigurumaError("target of repeat operator is not specified")
        if c == "{" and self.interval_ahead():
            raise OnigurumaError("target of repeat operator is not specified")
        self.i += 1
        if c == ".":
            return Chars(ALL if flags.m else complement(points(NEWLINE)))
        if c == "^":
            return Anchor("bol")
        if c == "$":
            return Anchor("eol")
        if c == "\\":
            return self.escape(flags)
        return Text([ord(c)], flags.i)

    def interval_ahead(self) -> bool:
        saved = self.i
        try:
            return self.interval() is not None
        finally:
            self.i = saved

    # --- groups ---

    def group(self, flags: _Flags):
        self.i += 1
        if self.eat("?"):
            return self.extended_group(flags)
        if self.eat("*"):
            return self.callout()
        if self.named_only:
            return self.close(Group("sub", self.alternation(flags)))
        self.groups += 1
        node = Group("cap", None, self.groups)
        node.body = self.alternation(flags)
        return self.close(node)

    def close(self, node: Node) -> Node:
        if not self.eat(")"):
            raise OnigurumaError("end pattern with unmatched parenthesis")
        if isinstance(node, Group) and node.kind == "cap":
            self.bodies[node.number] = node
        return node

    def extended_group(self, flags: _Flags):
        c = self.peek()
        simple = {":": "nc", ">": "atomic", "=": "ahead", "!": "nahead"}
        if c in simple:
            self.i += 1
            return self.close(Group(simple[c], self.alternation(flags)))
        if self.eat("<=") or self.eat("<!"):
            kind = "behind" if self.p[self.i - 1] == "=" else "nbehind"
            body = self.alternation(flags)
            try:
                _check_lookbehind(body, kind == "nbehind")
            except _CaptureInLookBehind as err:
                # a plain group captures only while no group is named
                if self.named_only:
                    raise
                self.capture_error = self.capture_error or err
            return self.close(Group(kind, body))
        if c in ("<", "'"):
            self.i += 1
            name = self.group_name(">" if c == "<" else "'")
            self.saw_name = True
            self.groups += 1
            self.names.setdefault(name, []).append(self.groups)
            node = Group("cap", None, self.groups)
            node.body = self.alternation(flags)
            return self.close(node)
        if c == "#":
            end = self.p.find(")", self.i)
            if end < 0:
                raise OnigurumaError("end pattern in group")
            self.i = end + 1
            return None
        if c == "~":
            self.i += 1
            self.needs("the absent operator (?~...)")
            return self.absent(flags)
        if c == "(":
            return self.conditional(flags)
        if c == "{":
            self.code_callout()
            return None
        return self.options(flags)

    def absent(self, flags: _Flags) -> Node:
        """``(?~absent)``, ``(?~|absent|expr)``, ``(?~|absent)``, ``(?~|)``
        after the ``~``: the absent part of the two middle forms is one
        branch, the expression the alternatives after it."""
        if not self.eat("|"):
            return self.close(Absent("repeater", self.alternation(flags)))
        if self.peek() == ")":
            return self.close(Absent("clear"))
        absent = self.sequence(flags)
        if not self.eat("|"):
            return self.close(Absent("stopper", absent))
        return self.close(Absent("expr", absent, self.alternation(flags)))

    def code_callout(self) -> None:
        """``(?{contents}[tag]X)``: the contents end at as many ``}`` as
        opened them.  The library registers no function for it, so it
        does nothing."""
        opened = len(self.p) - len(self.p[self.i:].lstrip("{")) - self.i
        end = self.p.find("}" * opened, self.i + opened)
        if end < 0:
            raise OnigurumaError("invalid callout pattern")
        self.i = end + opened
        m = re.compile(r"(?:\[([^\]]*)\])?[<>X]?\)").match(self.p, self.i)
        if m is None:
            raise OnigurumaError("invalid callout pattern")
        self.i = m.end()
        if m.group(1) is not None:
            self.tag(m.group(1), "CODE")

    def group_name(self, close: str) -> str:
        end = self.p.find(close, self.i)
        if end < 0:
            raise OnigurumaError("invalid group name <>")
        name = self.p[self.i:end]
        self.i = end + 1
        if not name:
            raise OnigurumaError("group name is empty")
        if not _NAME.fullmatch(name):
            raise OnigurumaError(f"invalid group name <{name}>")
        return name

    def options(self, flags: _Flags):
        on, new = True, flags.copy()
        while True:
            c = self.peek()
            if c == "":
                raise OnigurumaError("end pattern in group")
            self.i += 1
            if c == "-":
                on = False
            elif c in "imxWDSP":
                setattr(new, c, on)
                if c == "P":
                    new.W = new.D = new.S = on
            elif c == "y" and on:
                for mode in ("{g}", "{w}"):
                    if self.eat(mode):
                        new.y = mode == "{w}"
                        break
                else:
                    raise OnigurumaError("undefined group option")
            elif c == ")":
                return new
            elif c == ":":
                return self.close(Group("sub", self.alternation(new)))
            else:
                raise OnigurumaError("undefined group option")

    def callout(self):
        """``(*name[tag]{args})`` after the ``(*``."""
        m = re.compile(r"([A-Za-z_]\w*)(?:\[([^\]]*)\])?(?:\{([^}]*)\})?\)").match(
            self.p, self.i)
        if m is None:
            raise OnigurumaError("invalid callout pattern")
        self.i = m.end()
        name, tag, text = m.groups()
        if name not in _CALLOUT_ARGS:
            raise OnigurumaError("undefined callout name")
        args = [] if text is None else text.split(",")
        fewest, most = _CALLOUT_ARGS[name]
        if not fewest <= len(args) <= most:
            raise OnigurumaError("invalid callout arg")
        if tag is not None:
            self.tag(tag, name)
        if name == "FAIL":
            return FAIL
        self.needs(f"the callout (*{name})")
        return Callout(name, self.callout_args(name, args), tag)

    def tag(self, tag: str, name: str) -> None:
        if not _TAG.fullmatch(tag):
            raise OnigurumaError("invalid callout tag name")
        if tag in self.tags:
            raise OnigurumaError(f"multiplex defined name <{tag}>")
        self.tags[tag] = name

    @staticmethod
    def callout_args(name: str, args: list) -> tuple:
        """Integers, tags (checked once every tag is read) and the count
        and comparison words, with the library's defaults."""
        def value(text: str):
            if re.fullmatch(r"[+-]?\d+", text):
                return int(text)
            if not _TAG.fullmatch(text):
                raise OnigurumaError("invalid callout tag name")
            return text

        if name == "ERROR":
            if not args:
                return (0,)
            if not re.fullmatch(r"[+-]?\d+", args[0]):
                raise OnigurumaError("invalid callout arg")
            return (int(args[0]),)
        if name in ("COUNT", "TOTAL_COUNT"):
            if args and len(args[0]) != 1:
                raise OnigurumaError("invalid callout arg")
            return (args[0] if args else ">",)
        if name == "MAX":
            if len(args) > 1 and len(args[1]) != 1:
                raise OnigurumaError("invalid callout arg")
            return value(args[0]), (args[1] if len(args) > 1 else "X")
        if name == "CMP":
            return value(args[0]), args[1], value(args[2])
        return ()

    def conditional(self, flags: _Flags):
        self.i += 1  # the "("
        ref = re.compile(r"(?:<([^>]*)>|'([^']*)'|([+-]?\d+))\)").match(self.p, self.i)
        number = test = shared = None
        if ref is not None:
            self.i = ref.end()
            name = ref.group(1) or ref.group(2) or ref.group(3)
            number = self.reference(name, "backref")
            names = self.names.get(name)
            shared = tuple(names) if names is not None and len(names) > 1 else None
        else:
            test = self.alternation(flags)
            if not self.eat(")"):
                raise OnigurumaError("end pattern with unmatched parenthesis")
        body = self.alternation(flags)
        branches = body.branches if isinstance(body, Alt) else [body]
        if len(branches) > 2:
            raise OnigurumaError("invalid conditional pattern")
        yes, no = branches[0], branches[1] if len(branches) == 2 else Seq([])
        return self.close(Cond(number, test, yes, no, shared if test is None else None))

    # --- references ---

    def reference(self, text: str, what: str) -> int:
        """A group number from ``<name>``, ``<n>``, ``<-n>`` or ``<+n>``."""
        if re.fullmatch(r"[+-]?\d+", text):
            self.numbered_refs = True
            if self.saw_name or self.named_only:
                raise OnigurumaError("numbered backref/call is not allowed. (use name)")
            n = int(text)
            if text[0] == "-":
                n = self.groups + 1 + n
            elif text[0] == "+":
                n = self.groups + n
            if n < 0 or (n == 0 and what == "backref"):
                raise OnigurumaError("invalid backref number/name")
            return n
        if not text:
            raise OnigurumaError("group name is empty")
        numbers = self.names.get(text)
        if numbers is None:
            raise OnigurumaError(f"undefined name <{text}> reference")
        if len(numbers) > 1:
            self.needs(f"a reference to the name <{text}> of several groups")
        return numbers[0]

    def backref(self, text: str, flags: _Flags) -> Backref:
        """``\\k<..>``: a name or number, a nest level after it."""
        level = None
        m = re.fullmatch(r"(.*?[^+-])([+-]\d+)", text)
        if m is not None and not re.fullmatch(r"[+-]?\d+", text):
            text, level = m.group(1), int(m.group(2))
            self.needs(f"a back reference with a nest level \\k<{m.group(0)}>")
        number = self.reference(text, "backref")
        numbers = self.names.get(text)
        shared = tuple(numbers) if numbers is not None and len(numbers) > 1 else None
        if flags.i:
            self.needs("a back reference under (?i)")
        return Backref(number, flags.i, level, shared)

    def needs(self, what: str) -> None:
        """A construct only the matcher runs (the first one is kept)."""
        if self.matcher_reason is None:
            self.matcher_reason = what

    def bracketed(self, what: str) -> str:
        """The text of ``<..>`` or ``'..'`` after ``\\k`` or ``\\g``."""
        close = ">" if self.peek() == "<" else "'"
        self.i += 1
        end = self.p.find(close, self.i)
        if end < 0:
            raise OnigurumaError("invalid backref number/name" if what == "backref"
                             else "invalid group name <>")
        text, self.i = self.p[self.i:end], end + 1
        return text

    def resolve_calls(self, tree: Node) -> None:
        """Each call's group, now that every group is read (a call may name
        a group after it)."""
        for node in _walk(tree):
            if not isinstance(node, Call):
                continue
            target = node.target
            if isinstance(target, int):
                node.number = target
                if target and target not in self.bodies:
                    raise OnigurumaError("undefined group reference")
                continue
            if not target:
                raise OnigurumaError("group name is empty")
            numbers = self.names.get(target)
            if numbers is None:
                raise OnigurumaError(f"undefined name <{target}> reference")
            if len(numbers) > 1:
                raise OnigurumaError(f"multiplex definition name <{target}> call")
            node.number = numbers[0]

    # --- escapes ---

    def escape(self, flags: _Flags):
        c = self.peek()
        if c == "":
            raise OnigurumaError("end pattern at escape")
        self.i += 1
        if c in "wWsSdDhH":
            return Chars(self.escape_class(c, flags, bare=True))
        if c in "pP" and self.peek() == "{":
            return Chars(self.property(c, flags, bare=True))
        if c == "b":
            return Anchor("word", self.word(flags))
        if c == "B":
            return Anchor("nonword", self.word(flags))
        if c == "A":
            return Anchor("bos")
        if c == "z":
            return Anchor("eos")
        if c == "Z":
            return Anchor("eos_nl")
        if c == "G":
            return Anchor("start")
        if c == "K":
            return Anchor("keep")
        if c in "yY":
            self.needs(f"the text segment boundary \\{c}")
            return Anchor("segment" if c == "y" else "nonsegment", flags.y)
        if c == "R":
            return NEWLINES
        if c == "X":
            if flags.y:
                self.needs("\\X under (?y{w})")
            return Cluster(flags.y)
        if c == "O":
            return Chars(ALL)
        if c == "N":
            return Chars(complement(points(NEWLINE)))
        if c == "k" and self.peek() in ("<", "'"):
            return self.backref(self.bracketed("backref"), flags)
        if c == "g" and self.peek() in ("<", "'"):
            text = self.bracketed("call")
            if text == "0":
                return Call(0)
            if re.fullmatch(r"[+-]?\d+", text):
                return Call(self.reference(text, "call"))
            return Call(text)
        if c in "123456789":
            j = self.i
            while self.peek() and self.peek() in "0123456789":
                self.i += 1
            n = int(self.p[j - 1:self.i])
            if n <= 1000 and (n <= self.groups or n <= 9):
                self.numbered_refs = True
                if self.saw_name or self.named_only:
                    raise OnigurumaError("numbered backref/call is not allowed. (use name)")
                if flags.i:
                    self.needs("a back reference under (?i)")
                return Backref(n, flags.i)
            self.i = j
            if c in "89":
                return Text([ord(c)], flags.i)
            return self.raw_bytes(flags, self.octal(c, 2))
        if c == "0":
            return self.raw_bytes(flags, self.octal("0", 2))
        if c == "x" and self.peek() != "{":
            return self.raw_bytes(flags, self.hex2())
        cp = self.code_escape(c)
        if cp is not None:
            return Text(cp, flags.i) if isinstance(cp, list) else Text([cp], flags.i)
        return Text([ord(c)], flags.i)

    def word(self, flags: _Flags) -> "Ranges":
        word = escape_ranges("w", bare=True)
        return intersect(word, ASCII) if flags.W else word

    def escape_class(self, letter: str, flags: _Flags, bare: bool) -> "Ranges":
        ranges = escape_ranges(letter.lower(), bare=bare)
        if (letter in "wW" and flags.W) or (letter in "dD" and flags.D) or (
                letter in "sS" and flags.S):
            ranges = intersect(ranges, ASCII)
        return complement(ranges) if letter.isupper() else ranges

    def property(self, letter: str, flags: _Flags, bare: bool) -> "Ranges":
        self.i += 1  # the "{"
        end = self.p.find("}", self.i)
        if end < 0:
            raise OnigurumaError("end pattern with unmatched parenthesis")
        name, self.i = self.p[self.i:end], end + 1
        negated = letter == "P"
        if name.startswith("^"):
            name, negated = name[1:], not negated
        ranges = property_ranges(name, bare)
        key = normalize_name(name)
        if key in POSIX_NAMES and (flags.P or (key == "word" and flags.W) or (
                key == "digit" and flags.D) or (key == "space" and flags.S)):
            ranges = intersect(ranges, ASCII)
        return complement(ranges) if negated else ranges

    def octal(self, first: str, more: int) -> int:
        digits = first
        while len(digits) < more + 1 and self.peek() and self.peek() in _OCT:
            digits += self.peek()
            self.i += 1
        return int(digits, 8) & 0xFF

    def hex2(self) -> int:
        digits = ""
        while len(digits) < 2 and self.peek() and self.peek() in _HEX:
            digits += self.peek()
            self.i += 1
        return int(digits or "0", 16)

    def code_escape(self, c: str):
        """A code point escape after its letter (``\\x{..}``, ``\\o{..}``,
        ``\\uHHHH``, controls, ``\\cX``, ``\\C-X``, ``\\M-X``); None when
        ``c`` is none of them."""
        if c in _CONTROL_ESCAPES:
            return _CONTROL_ESCAPES[c]
        if c in "xo" and self.peek() == "{":
            end = self.p.find("}", self.i)
            body = self.p[self.i + 1:end] if end >= 0 else ""
            digits = _HEX if c == "x" else _OCT
            if end < 0 or not body.strip() or any(ch not in digits + " " for ch in body):
                raise OnigurumaError("invalid code point value")
            self.i = end + 1
            cps = [int(part, 16 if c == "x" else 8) for part in body.split()]
            return [self._valid(cp) for cp in cps] if len(cps) > 1 else self._valid(cps[0])
        if c == "u":
            digits = self.p[self.i:self.i + 4]
            if len(digits) < 4 or any(ch not in _HEX for ch in digits):
                raise OnigurumaError("invalid code point value")
            self.i += 4
            return self._valid(int(digits, 16))
        if c == "c":
            if not self.peek():
                raise OnigurumaError("end pattern at control")
            return self._control(self.control_target())
        if c == "C":
            if not self.eat("-"):
                raise OnigurumaError("invalid control-code syntax")
            if not self.peek():
                raise OnigurumaError("end pattern at control")
            return self._control(self.control_target())
        if c == "M":
            if not self.eat("-"):
                raise OnigurumaError("invalid meta-code syntax")
            if not self.peek():
                raise OnigurumaError("end pattern at meta")
            return (self.control_target() & 0xFF) | 0x80
        return None

    def control_target(self) -> int:
        c = self.p[self.i]
        self.i += 1
        if c == "\\":
            nxt = self.peek()
            self.i += 1
            cp = self.code_escape(nxt)
            return cp if isinstance(cp, int) else ord(nxt)
        return ord(c)

    @staticmethod
    def _control(cp: int) -> int:
        return 0x7F if cp == ord("?") else cp & 0x9F

    @staticmethod
    def _valid(cp: int) -> int:
        # a code point past Unicode or a surrogate matches no character
        return -1 if cp > MAX_CODE or 0xD800 <= cp < 0xE000 else cp

    def raw_bytes(self, flags: _Flags, first: int):
        """A byte escape (``\\xHH``, octal) and the ones after it that its
        character needs, read as UTF-8."""
        return Text(_decode_utf8(bytes(self.more_bytes([first]))), flags.i)

    def more_bytes(self, data: list) -> list:
        while len(data) < _utf8_length(data[0]):
            m = _BYTE_ESCAPE.match(self.p, self.i)
            if m is None:
                break
            if m.group(1) == "x":
                self.i = m.end()
                data.append(self.hex2())
            elif m.group(1) == "0" or int(m.group(2)) > max(9, self.groups):
                self.i = m.start() + 2
                data.append(self.octal(m.group(1), 2))
            else:  # a back reference
                break
        return data

    # --- classes ---

    def char_class(self, flags: _Flags) -> Node:
        ranges, negated = self.class_body(flags)
        if flags.i:  # folding closes the class before its negation
            ranges = case_closure(ranges)
            return Chars(complement(ranges)) if negated else Chars(ranges, True)
        return Chars(complement(ranges) if negated else ranges)

    def class_body(self, flags: _Flags) -> "tuple[Ranges, bool]":
        """The set of a class after its ``[`` (consumed through ``]``), the
        negation apart."""
        negated = self.eat("^")
        if self.peek() == "]":
            if self.p.find("]", self.i + 1) < 0:
                raise OnigurumaError("empty char-class")
            # a leading "]" is a literal
        operands: list = []
        current: list = []
        prev = None          # the last single character, a range's start
        pending_range = False
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise OnigurumaError("premature end of char-class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if self.p.startswith("&&", self.i):
                if pending_range:
                    current.append(points(ord("-")))
                    pending_range = False
                self.i += 2
                operands.append(union(*current))
                current, prev = [], None
                continue
            item = self.class_item(flags)
            if isinstance(item, int):  # a character
                if pending_range:
                    lo = prev
                    if item < lo:
                        raise OnigurumaError("empty range in char class")
                    if lo >= 0 and item >= 0:
                        current.append(((lo, item),))
                    pending_range, prev = False, None
                    continue
                if self.peek() == "-" and self.peek(1) not in ("]", "") and not \
                        self.p.startswith("-&&", self.i):
                    self.i += 1
                    if self.peek() == "[":
                        raise OnigurumaError("char-class value at end of range")
                    pending_range, prev = True, item
                    continue
                if item >= 0:
                    current.append(points(item))
                prev = item
            else:  # a set: a class escape, a property, a POSIX bracket, a nested class
                if pending_range:
                    raise OnigurumaError("char-class value at end of range")
                if self.peek() == "-" and self.peek(1) not in ("]", ""):
                    raise OnigurumaError("unmatched range specifier in char-class")
                current.append(item)
                prev = None
        operands.append(union(*current))
        ranges = operands[0]
        for operand in operands[1:]:
            ranges = intersect(ranges, operand)
        return ranges, negated

    def class_item(self, flags: _Flags):
        """One item of a class: a code point (int, -1 for one no text
        holds) or a set (tuple)."""
        c = self.peek()
        self.i += 1
        if c == "[":
            if self.peek() == ":":
                end = self.p.find(":]", self.i + 1)
                body = self.p[self.i + 1:end] if end >= 0 else None
                if body is not None and re.fullmatch(r"\^?[A-Za-z]+", body):
                    negated = body.startswith("^")
                    name = body.lstrip("^").lower()
                    if name not in POSIX_NAMES:
                        raise OnigurumaError("invalid POSIX bracket type")
                    self.i = end + 2
                    ranges = decode(_tables.SETS[_tables.BRACKETS[name]])
                    if flags.P or (name == "word" and flags.W) or (
                            name == "digit" and flags.D) or (name == "space" and flags.S):
                        ranges = intersect(ranges, ASCII)
                    return complement(ranges) if negated else ranges
            ranges, negated = self.class_body(flags)
            return complement(ranges) if negated else ranges
        if c != "\\":
            return ord(c)
        e = self.peek()
        if e == "":
            raise OnigurumaError("end pattern at escape")
        self.i += 1
        if e in "wWsSdDhH":
            return self.escape_class(e, flags, bare=False)
        if e in "pP" and self.peek() == "{":
            return self.property(e, flags, bare=False)
        if e == "b":
            return 0x08
        if e in "01234567":
            return self._class_bytes([self.octal(e, 2)])
        if e == "x" and self.peek() != "{":
            return self._class_bytes([self.hex2()])
        if e == "x" and self.peek() == "{":
            # a code point list in a class is its characters
            end = self.p.find("}", self.i)
            body = self.p[self.i + 1:end] if end >= 0 else ""
            if end < 0 or not body.strip() or any(ch not in _HEX + " " for ch in body):
                raise OnigurumaError("invalid code point value")
            self.i = end + 1
            cps = [self._valid(int(part, 16)) for part in body.split()]
            if len(cps) == 1:
                return cps[0]
            return points(*[cp for cp in cps if cp >= 0])
        cp = self.code_escape(e)
        if isinstance(cp, list):
            return points(*[c for c in cp if c >= 0])
        return ord(e) if cp is None else cp

    def _class_bytes(self, data: list) -> int:
        while len(data) < _utf8_length(data[0]):
            m = _BYTE_ESCAPE.match(self.p, self.i)
            if m is None:
                break
            self.i = m.start() + 2
            data.append(self.hex2() if m.group(1) == "x" else self.octal(m.group(1), 2))
        cps = _decode_utf8(bytes(data))
        if len(cps) != 1:
            raise OnigurumaError("too short multibyte code string")
        return cps[0]


#: the repeats Oniguruma reduces when one repeats another directly
_REPEAT_KINDS = {(0, 1, "greedy"): 0, (0, None, "greedy"): 1, (1, None, "greedy"): 2,
                 (0, 1, "lazy"): 3, (0, None, "lazy"): 4, (1, None, "lazy"): 5}
#: Oniguruma's ``ReduceTypeTable``: row the inner repeat (``? * + ?? *?
#: +?``), column the outer
_REDUCE = (("del", "a", "a", "qq", "aq", "asis"),
           ("del", "del", "del", "p_qq", "p_qq", "del"),
           ("a", "a", "del", "asis", "p_qq", "del"),
           ("del", "aq", "aq", "del", "aq", "aq"),
           ("del", "del", "del", "del", "del", "del"),
           ("asis", "pq_q", "del", "aq", "aq", "del"))


def _nested_repeat(atom: Node, lo: int, hi: Optional[int], mode: str) -> Node:
    """``atom`` repeated, where a repeat of a repeat (``a**``, ``(?:a+)+``,
    not a capture group's) is reduced as Oniguruma reduces it."""
    inner = atom
    if isinstance(inner, Group) and inner.kind == "nc":
        inner = inner.body
    if isinstance(inner, Seq) and len(inner.items) == 1:
        inner = inner.items[0]
    if not isinstance(inner, Repeat):
        return Repeat(atom, lo, hi, mode)
    child = _REPEAT_KINDS.get((inner.lo, inner.hi, inner.mode))
    parent = _REPEAT_KINDS.get((lo, hi, mode))
    if child is None or parent is None:
        if child in (1, 2) and hi is not None and hi > 1 and mode == "greedy":
            hi = lo or 1  # (?:a*){n,m} is (?:a*){n}
        return Repeat(atom, lo, hi, mode)
    action, body = _REDUCE[child][parent], inner.body
    if action == "del":
        return inner
    if action == "a":
        return Repeat(body, 0, None, "greedy")
    if action == "aq":
        return Repeat(body, 0, None, "lazy")
    if action == "qq":
        return Repeat(body, 0, 1, "lazy")
    if action == "p_qq":
        return Repeat(Repeat(body, 1, None, "greedy"), 0, 1, "lazy")
    if action == "pq_q":
        return Repeat(Repeat(body, 1, None, "lazy"), 0, 1, "greedy")
    return Repeat(atom, lo, hi, mode)


def _invalid_target(node: Node) -> bool:
    """A repeat's target Oniguruma refuses: an anchor, look-around or
    callout, a ``(?:..)`` of one, an alternation with one as a branch."""
    if isinstance(node, (Anchor, Callout)) or node is FAIL:
        return True
    if isinstance(node, Group):
        if node.kind == "nc":
            return _invalid_target(node.body)
        return node.kind in ("ahead", "nahead", "behind", "nbehind")
    if isinstance(node, Seq):
        return len(node.items) == 1 and _invalid_target(node.items[0])
    if isinstance(node, Alt):
        return any(_invalid_target(b) for b in node.branches)
    return False


def _check_lookbehind(body: Node, negative: bool) -> None:
    """What Oniguruma refuses in a look-behind: a look-ahead, ``\\z`` or
    ``\\Z``; in a negative one a capture group; in a positive one a
    negative look-behind; an alternative of two or more optional
    characters or strings (``a?b?``: its "undefined error code")."""
    nodes = list(_walk(body))
    for n in nodes:
        if (isinstance(n, Group) and (n.kind in ("ahead", "nahead") or (
                n.kind == "nbehind" and not negative))) or (
                isinstance(n, Anchor) and n.kind in ("eos", "eos_nl")):
            raise OnigurumaError("invalid pattern in look-behind")
    if negative and any(isinstance(n, Group) and n.kind == "cap" for n in nodes):
        raise _CaptureInLookBehind("invalid pattern in look-behind")
    for branch in body.branches if isinstance(body, Alt) else [body]:
        items = branch.items if isinstance(branch, Seq) else [branch]
        if len(items) > 1 and all(isinstance(i, Repeat) and i.lo == 0 and i.mode != "possessive"
                                  and _plain(i.body) for i in items):
            raise OnigurumaError("undefined error code")


def _plain(node: Node) -> bool:
    """Characters or a string, bare, in a ``(?:..)`` or repeated a fixed
    number of times."""
    if isinstance(node, Repeat) and node.lo == node.hi and isinstance(node.body, Text):
        return _one_node(node.body)  # Oniguruma writes x{n} of a string out
    if isinstance(node, Group) and node.kind == "nc":
        node = node.body
    items = node.items if isinstance(node, Seq) else [node]
    return all(_one_node(i) for i in items)


def _one_node(node: Node) -> bool:
    """Characters or a string that ``(?i)`` does not turn into
    alternatives (a character folding to several, ``ss`` to ``ß``)."""
    if isinstance(node, Chars):
        return not node.icase or width(node)[1] == 1
    if isinstance(node, Text):
        return not node.icase or not any(isinstance(n, Alt) for n in icase_parts(node.cps))
    return False


def _utf8_length(lead: int) -> int:
    if lead < 0x80:
        return 1
    if lead < 0xC0:
        raise OnigurumaError("invalid code point value")
    if lead < 0xE0:
        return 2
    if lead < 0xF0:
        return 3
    if lead < 0xF8:
        return 4
    if lead < 0xFC:
        return 5
    if lead < 0xFE:
        return 6
    return 1


def _decode_utf8(data: bytes) -> "list[int]":
    """Raw bytes as characters (-1 for a sequence that is no character)."""
    out, i = [], 0
    while i < len(data):
        n = _utf8_length(data[i])
        chunk = data[i:i + n]
        if len(chunk) < n:
            raise OnigurumaError("too short multibyte code string")
        try:
            text = chunk.decode("utf-8")
            out.append(ord(text) if len(text) == 1 else -1)
        except UnicodeDecodeError:
            out.append(-1)
        i += n
    return out


def _merge(items: list) -> list:
    """Adjacent literals into runs; an unquantified ``(?:..)`` of one
    branch is dissolved into the run around it, as Oniguruma does."""
    flat: list = []
    for item in items:
        if isinstance(item, Group) and item.kind == "nc" and isinstance(item.body, Seq):
            flat.extend(item.body.items)
        else:
            flat.append(item)
    out: list = []
    for item in flat:
        if isinstance(item, Text) and out and isinstance(out[-1], Text) and \
                out[-1].icase == item.icase:
            out[-1] = Text(out[-1].cps + item.cps, item.icase)
        else:
            out.append(item)
    return out


# ---------------------------------------------------------------------------
# writing the tree out for ``re``
# ---------------------------------------------------------------------------


def _char(cp: int) -> str:
    if cp < 0x80 and (chr(cp).isalnum() or chr(cp) == "_"):
        return chr(cp)
    if cp < 0x100:
        return f"\\x{cp:02x}"
    if cp < 0x10000:
        return f"\\u{cp:04x}"
    return f"\\U{cp:08x}"


def class_text(ranges: "Ranges") -> str:
    """A set as one ``re`` class (or a never-matching piece)."""
    if not ranges:
        return "(?!)"
    outside = complement(ranges)
    negate = len(outside) < len(ranges)
    body = "".join(_char(lo) if lo == hi else f"{_char(lo)}-{_char(hi)}"
                   for lo, hi in (outside if negate else ranges))
    if negate and not body:
        return "[\\x00-\\U0010ffff]"
    return f"[{'^' if negate else ''}{body}]"


def _single(cp: int) -> str:
    """One character under ``(?i)``: the characters folding holds equal."""
    group = case_class(cp)
    return _char(cp) if len(group) == 1 else class_text(points(*group))


def _fold_class(cp: int) -> Node:
    return FAIL if cp < 0 else Chars(points(*case_class(cp)))


def icase_parts(cps: "list[int]", lookbehind: bool = False) -> "list[Node]":
    """A literal run under ``(?i)`` as Oniguruma's case fold expansion
    makes it: each character its fold class, a character that folds to
    several its spelling too, two or three characters folding to one
    character that character too (taken greedily).  In a look-behind
    Oniguruma keeps the fold classes alone."""
    if lookbehind:
        return [_fold_class(c) for c in cps]
    _, _, multi = _case()
    out, p = [], 0
    while p < len(cps):
        for k in (3, 2):
            span = cps[p:p + k]
            if len(span) == k and -1 not in span and all(
                    c not in _tables.MULTI_FOLDS for c in span):
                folded = "".join(fold(c) for c in span)
                if folded in multi:
                    out.append(Alt([Seq([_fold_class(c) for c in span]),
                                    Chars(points(*multi[folded]))]))
                    p += k
                    break
        else:
            c = cps[p]
            if c in _tables.MULTI_FOLDS:
                folded = fold(c)
                out.append(Alt([Chars(points(*multi[folded])),
                                Seq([_fold_class(ord(x)) for x in folded])]))
            else:
                out.append(_fold_class(c))
            p += 1
    return out


def icase_spellings(ranges: "Ranges") -> "list[Node]":
    """A class under ``(?i)`` (closed): the spellings of its characters
    that fold to several, each its fold classes in a row."""
    _, _, multi = _case()
    spelled = {}
    for folded, cps in multi.items():
        if any(contains(ranges, c) for c in cps):
            key = "".join(_single(ord(x)) for x in folded)
            spelled[key] = Seq([_fold_class(ord(x)) for x in folded])
    return [spelled[key] for key in sorted(spelled)]


@functools.lru_cache(maxsize=1)
def grapheme_cluster() -> str:
    """``\\X``: one extended grapheme cluster (UAX #29) over the library's
    cluster classes.  Oniguruma's ``\\X`` is ``(?>\\O(?:\\Y\\O)*)``: it
    runs to the next boundary as the whole text places it, so where it
    starts inside a cluster the text before counts too.  That matters
    only inside a run of regional indicators (read back over up to
    ``CLUSTER_CONTEXT`` pairs) and inside an emoji sequence (up to
    ``CLUSTER_CONTEXT`` extenders before a joiner)."""
    c = {name: cluster_ranges(name) for name in _tables.CLUSTERS}
    control = class_text(union(c["CR"], c["LF"], c["Control"]))
    not_control = class_text(complement(union(c["CR"], c["LF"], c["Control"])))
    post = class_text(union(c["Extend"], c["ZWJ"], c["SpacingMark"]))
    L, V, T = class_text(c["L"]), class_text(c["V"]), class_text(c["T"])
    hangul = (f"{L}*(?:{V}+|{class_text(c['LV'])}{V}*|{class_text(c['LVT'])}){T}*"
              f"|{L}+|{T}+")
    ri = class_text(c["RI"])
    pict, extend, zwj = class_text(c["ExtPict"]), class_text(c["Extend"]), class_text(c["ZWJ"])
    emoji = f"{pict}(?:{extend}*{zwj}{pict})*"
    # started after an odd run of indicators: the second of a pair
    odd_run = "|".join(f"(?<=(?<!{ri}){ri * (2 * n + 1)})" for n in range(CLUSTER_CONTEXT))
    # started on an extender or joiner after an emoji: the sequence goes on
    in_emoji = "|".join(f"(?<={pict}{extend * n})" for n in range(CLUSTER_CONTEXT + 1))
    middle = [f"(?:{odd_run}){ri}", f"(?:{in_emoji}){extend}*{zwj}{pict}(?:{extend}*{zwj}{pict})*"]
    # the library's Oniguruma has no Indic conjunct rule (GB9c)
    core = [f"{ri}{ri}", hangul, emoji, not_control]
    prepend = class_text(c["Prepend"])
    return (f"(?>\\r\\n|{control}|(?:{'|'.join(f'(?:{x})' for x in middle)}"
            f"|{prepend}*(?:{'|'.join(f'(?:{x})' for x in core)})){post}*)")


class _Writer:
    def __init__(self, parser: _Parser):
        self.parser = parser
        self.keeps: list = []
        self.calls: list = []   # groups being written for a call (recursion)

    def write(self, node: Node, start: Optional[bool] = None, in_look: bool = False) -> str:
        w = lambda n: self.write(n, start, in_look)  # noqa: E731
        if isinstance(node, Chars):
            spelled = icase_spellings(node.ranges) if node.icase else []
            if spelled:
                return "(?:" + "|".join([class_text(node.ranges), *map(w, spelled)]) + ")"
            return class_text(node.ranges)
        if isinstance(node, Text):
            if node.icase:
                return "".join(map(w, icase_parts(node.cps)))
            return "".join("(?!)" if c < 0 else _char(c) for c in node.cps)
        if isinstance(node, Seq):
            return "".join(w(item) for item in node.items)
        if isinstance(node, Alt):
            return "(?:" + "|".join(w(b) for b in node.branches) + ")"
        if isinstance(node, Group):
            if node.kind == "cap":
                body = w(node.body)
                if self.calls:
                    return f"(?:{body})"
                return f"(?P<_g{node.number}>{body})"
            if node.kind in ("behind", "nbehind"):
                return self.lookbehind(node, start)
            inner = self.write(node.body, start, in_look or node.kind in ("ahead", "nahead"))
            return {"nc": "(?:{})", "sub": "(?:{})", "atomic": "(?>{})", "ahead": "(?={})",
                    "nahead": "(?!{})"}[node.kind].format(inner)
        if isinstance(node, Repeat):
            body = w(node.body)
            if not _is_atom(node.body):
                body = f"(?:{body})"
            if (node.lo, node.hi) == (0, None):
                q = "*"
            elif (node.lo, node.hi) == (1, None):
                q = "+"
            elif (node.lo, node.hi) == (0, 1):
                q = "?"
            elif node.hi is None:
                q = f"{{{node.lo},}}"
            elif node.lo == node.hi:
                q = f"{{{node.lo}}}"
            else:
                q = f"{{{node.lo},{node.hi}}}"
            return body + q + {"greedy": "", "lazy": "?", "possessive": "+"}[node.mode]
        if isinstance(node, Anchor):
            return self.anchor(node, start, in_look)
        if isinstance(node, Backref):
            if node.number not in self.parser.bodies:
                raise OnigurumaError("invalid backref number/name")
            if self.calls:
                raise _Unwritable("back reference inside a called group")
            if node.icase or node.level is not None or node.numbers:
                raise _Unwritable("a back reference only the matcher runs")
            return f"(?P=_g{node.number})"
        if isinstance(node, Cond):
            yes, no = w(node.yes), w(node.no)
            if node.test is None:
                if node.number not in self.parser.bodies:
                    raise OnigurumaError("invalid backref number/name")
                if self.calls or node.numbers:
                    raise _Unwritable("conditional inside a called group")
                return f"(?(_g{node.number}){yes}|{no})"
            test = self.write(node.test, start, True)
            return f"(?:(?>{test}){yes}|(?!{test}){no})"
        if isinstance(node, Call):
            return self.call(node, start, in_look)
        if isinstance(node, Raw):
            return node.text
        if isinstance(node, Cluster) and not node.word:
            return grapheme_cluster()
        if isinstance(node, (Cluster, Absent, Callout)):
            raise _Unwritable(type(node).__name__)
        raise TypeError(node)

    def anchor(self, node: Anchor, start: Optional[bool], in_look: bool) -> str:
        kind = node.kind
        if kind == "bol":  # not after a newline that ends the text
            return "(?:\\A|(?<=\\n)(?!\\Z))"
        if kind == "eol":
            return "(?m:$)"
        if kind == "bos":
            return "\\A"
        if kind == "eos":
            return "\\Z"
        if kind == "eos_nl":
            return "(?=\\n?\\Z)"
        if kind in ("word", "nonword"):
            w = class_text(node.word)
            if kind == "word":
                return f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))"
            return f"(?:(?<={w})(?={w})|(?<!{w})(?!{w}))"
        if kind == "keep":
            if in_look:
                raise _Unwritable("\\K inside a look-around")
            self.keeps.append(f"_k{len(self.keeps)}")
            return f"(?P<{self.keeps[-1]}>)"
        if kind == "start":
            if start is None:
                raise _Unwritable("\\G other than at the start of an alternative")
            return "" if start else "(?!)"
        if kind in ("segment", "nonsegment"):
            raise _Unwritable("a text segment boundary")
        raise TypeError(kind)

    def call(self, node: Call, start, in_look) -> str:
        number = node.number
        target = self.parser.bodies[number]
        referenced = any((isinstance(n, Backref) and n.number == number) or (
            isinstance(n, Cond) and n.number == number) for n in _walk(self.parser.tree))
        if referenced:
            raise _Unwritable("a called group that is also referenced")
        self.calls.append(number)
        try:
            return "(?:" + self.write(target.body, start, in_look) + ")"
        finally:
            self.calls.pop()

    def lookbehind(self, node: Group, start) -> str:
        positive = node.kind == "behind"
        parts = [self.lookbehind_part(b, positive, start) for b in lookbehind_parts(node.body)]
        return parts[0] if len(parts) == 1 else (
            "(?:" + "|".join(parts) + ")" if positive else "".join(parts))

    def lookbehind_part(self, body: Node, positive: bool, start) -> str:
        lo, hi = width(body)
        if lo == hi and not _has_icase_text(body):
            inner = self.write(body, start, True)
            return f"(?<={inner})" if positive else f"(?<!{inner})"
        if any(isinstance(n, Group) and n.kind == "cap" for n in _walk(body)):
            raise _Unwritable("a capture group in a look-behind of several widths")
        if any(isinstance(n, Anchor) and n.kind in ("word", "nonword") for n in _walk(body)):
            # its body reads nothing past the position: a word boundary at
            # the text's start fails there (Oniguruma's DATA_ENSURE)
            raise _Unwritable("a word boundary in a look-behind of several widths")
        variants = [self.write(v, start, True) for v in _fixed_variants(body)]
        # Oniguruma's tail check: \R's is a CRLF before the position
        crlf = len(lookbehind_tail(body) or ()) == 2
        if positive:
            found = "|".join(f"(?<={v})" for v in variants)
            return f"(?:(?<=\\r\\n)(?:{found}))" if crlf else f"(?:{found})"
        missing = "".join(f"(?<!{v})" for v in variants)
        return f"(?:(?<!\\r\\n)|{missing})" if crlf else missing


def _has_icase_text(node: Node) -> bool:
    return any((isinstance(n, Text) and n.icase and any(
        c in _tables.MULTI_FOLDS or len(fold(c)) > 1 for c in n.cps)) or (
        isinstance(n, Chars) and n.icase and width(n)[1] > 1)
        for n in _walk(node))


def _is_atom(node: Node) -> bool:
    if isinstance(node, Chars):
        return not (node.icase and width(node)[1] > 1)
    if isinstance(node, Text):
        return len(node.cps) == 1 and not node.icase
    return isinstance(node, Group) and node.kind in ("cap", "nc", "sub", "atomic")


def _fixed_variants(node: Node, followed: bool = False) -> "list[Node]":
    """``node`` as alternatives of one width each (a look-behind);
    ``followed``: a character of the look-behind comes after it."""
    if isinstance(node, Seq):
        out = [Seq([])]
        for i, item in enumerate(node.items):
            after = followed or any(width(x)[0] > 0 for x in node.items[i + 1:])
            out = [Seq([*v.items, x]) for v in out for x in _fixed_variants(item, after)]
            if len(out) > MAX_LOOKBEHIND_WIDTHS:
                raise _Unwritable("a look-behind of too many widths")
        return out
    if isinstance(node, Alt):
        out = [v for b in node.branches for v in _fixed_variants(b, followed)]
        if len(out) > MAX_LOOKBEHIND_WIDTHS:
            raise _Unwritable("a look-behind of too many widths")
        return out
    if isinstance(node, Group) and node.kind in ("nc", "sub", "atomic"):
        return _fixed_variants(node.body, followed)
    if isinstance(node, Repeat):
        if node.hi is None:
            raise _Unwritable("an unbounded repeat in a look-behind")
        return [v for n in range(node.lo, node.hi + 1)
                for v in _fixed_variants(Seq([node.body] * n), followed)]
    if node is NEWLINES:
        # atomic: a CR with a LF after it inside the look-behind is a CRLF
        one = "(?:\\r(?!\\n)|[\\n\\x0b\\x0c\\x85\\u2028\\u2029])" if followed else \
            "[\\n\\x0b\\x0c\\r\\x85\\u2028\\u2029]"
        return [Raw("\\r\\n", 2, 2), Raw(one, 1, 1)]
    if isinstance(node, Raw) and node.lo != node.hi:
        raise _Unwritable("\\X in a look-behind")
    lo, hi = width(node)
    if lo != hi:
        raise _Unwritable("a look-behind of several widths")
    return [node]


def char_width(node: Node, lookbehind: bool) -> "tuple[int, Optional[int]]":
    """:func:`width`, where in a look-behind a literal under ``(?i)`` is
    one character each (no foldings to several), as Oniguruma measures a
    look-behind's body."""
    if lookbehind and isinstance(node, Text):
        return len(node.cps), len(node.cps)
    if lookbehind and isinstance(node, Chars):
        return 1, 1
    if isinstance(node, Seq):
        lo, hi = 0, 0
        for item in node.items:
            a, b = char_width(item, lookbehind)
            lo += a
            hi = None if hi is None or b is None else hi + b
        return lo, hi
    if isinstance(node, Alt):
        ws = [char_width(b, lookbehind) for b in node.branches]
        return min(a for a, _ in ws), (None if any(b is None for _, b in ws)
                                       else max(b for _, b in ws))
    if isinstance(node, Group):
        if node.kind in ("ahead", "nahead", "behind", "nbehind"):
            return 0, 0
        return char_width(node.body, lookbehind)
    if isinstance(node, Repeat):
        a, b = char_width(node.body, lookbehind)
        return a * node.lo, (None if node.hi is None or b is None else b * node.hi)
    return width(node)


def lookbehind_parts(body: Node) -> "list[Node]":
    """A look-behind's body as Oniguruma divides it, one look-behind per
    part: a top-level alternation is divided when the whole has several
    widths and every branch after the first has one (the first is not
    looked at: ``\\R|a`` is divided, ``a|\\R`` is not), and each part
    again."""
    top = body
    while (isinstance(top, Group) and top.kind == "nc") or (
            isinstance(top, Seq) and len(top.items) == 1):
        top = top.body if isinstance(top, Group) else top.items[0]
    if not isinstance(top, Alt):
        return [body]
    widths = [char_width(b, True) for b in top.branches]
    one_width = len(set(widths)) == 1 and widths[0][0] == widths[0][1]
    if one_width or any(a != b for a, b in widths[1:]):
        return [body]
    # each part is a look-behind of its own, divided again
    return [part for b in top.branches for part in lookbehind_parts(b)]


def lookbehind_tail(node: Node) -> "Optional[tuple[Ranges, ...]]":
    """The characters, last last, that a look-behind of several widths
    checks before its position ahead of running ``node`` (Oniguruma's tail
    literal: the last item, past zero-width ones), or None.  Each is one a
    match ends with, but for ``\\R``'s: its condition's CRLF, so such a
    look-behind matches only after a CRLF."""
    if isinstance(node, Seq):
        for item in reversed(node.items):
            if width(item) != (0, 0):
                return lookbehind_tail(item)
        return None
    if node is NEWLINES:
        return points(0x0D), points(0x0A)
    if isinstance(node, Chars):
        return (node.ranges,)
    if isinstance(node, Text):
        if not node.cps or node.cps[-1] < 0:
            return None
        return (points(*case_class(node.cps[-1])) if node.icase else points(node.cps[-1]),)
    if isinstance(node, Group) and node.kind in ("cap", "nc", "sub", "atomic"):
        return lookbehind_tail(node.body)
    if isinstance(node, Repeat) and node.lo > 0:
        return lookbehind_tail(node.body)
    if isinstance(node, Alt):
        tails = [lookbehind_tail(b) for b in node.branches]
        if all(t is not None and len(t) == 1 for t in tails):
            return (union(*(t[0] for t in tails)),)
    return None


# ---------------------------------------------------------------------------
# the compiled expression
# ---------------------------------------------------------------------------


class Expression:
    """An expression as the library's ``find_iter`` sees it: ``search``
    from a position, ``\\G`` at that position, ``\\K`` moving the start,
    only at the positions Oniguruma's search tries (:func:`search_starts`)."""

    __slots__ = ("regex", "_at_start", "_keeps", "_starts")
    engine = "re"

    def __init__(self, regex: "re.Pattern", at_start: "Optional[re.Pattern]" = None,
                 keeps: "tuple[str, ...]" = (), starts: Optional[str] = None):
        self.regex, self._at_start, self._keeps = regex, at_start, keeps
        self._starts = starts

    def search(self, text: str, pos: int = 0) -> "Optional[tuple[int, int]]":
        """The leftmost match from ``pos`` as ``(start, stop)``."""
        if self._starts is not None:
            for at in start_positions(self._starts, text, pos):
                regex = self._at_start if self._at_start is not None and at == pos else self.regex
                match = regex.match(text, at)
                if match is not None:
                    return self._span(match)
            return None
        if self._at_start is not None:
            match = self._at_start.match(text, pos)
            if match is None and pos < len(text):
                match = self.regex.search(text, pos + 1)
        else:
            match = self.regex.search(text, pos)
        return None if match is None else self._span(match)

    def _span(self, match: "re.Match") -> "tuple[int, int]":
        start = match.start()
        for name in self._keeps:
            kept = match.start(name)
            if kept > start:
                start = kept
        return start, match.end()


def _tops(tree: Node) -> list:
    """The top-level alternatives' first items (where ``\\G`` may stand)."""
    branches = tree.branches if isinstance(tree, Alt) else [tree]
    out = []
    for b in branches:
        if isinstance(b, Seq) and b.items:
            out.append(b.items[0])
        elif not isinstance(b, Seq):
            out.append(b)
    return out


def read_expression(pattern: str) -> "tuple[_Parser, Node]":
    """The library's expression ``pattern`` as its tree (and the parser
    that read it), or the library's error."""
    parser = _Parser(pattern, named_only=False)
    tree = parser.parse()
    if parser.capture_error is not None and not parser.saw_name:
        raise parser.capture_error
    if parser.saw_name:
        if parser.numbered_refs:
            raise OnigurumaError("numbered backref/call is not allowed. (use name)")
        parser = _Parser(pattern, named_only=True)
        tree = parser.parse()
    parser.tree = tree
    parser.resolve_calls(tree)
    _check_recursion(parser, tree)
    for node in _walk(tree):
        if isinstance(node, Callout):
            values = {"MAX": node.args[:1], "CMP": node.args[::2]}.get(node.name, ())
            tags = [a for a in values if isinstance(a, str)]
            if any(t not in parser.tags for t in tags):
                raise OnigurumaError("invalid callout tag name")
    return parser, tree


@functools.lru_cache(maxsize=None)
def compile_expression(pattern: str):
    """The library's expression ``pattern``, searched as its ``find_iter``
    searches: an :class:`Expression` over Python's ``re`` where ``re``
    runs it in the library's order and without exponential backtracking,
    else the port's own matcher (:class:`.onig_match.Matcher`).  Either
    says which it is in ``engine``."""
    parser, tree = read_expression(pattern)
    if parser.matcher_reason is None and not ambiguous(tree):
        expression = _write(parser, tree)
        if expression is not None:
            return expression
    from .onig_match import Matcher

    return Matcher(parser, tree)


def _write(parser: _Parser, tree: Node) -> Optional[Expression]:
    """``tree`` for Python's ``re``, or None where ``re`` cannot express it."""
    starts = [n for n in _walk(tree) if isinstance(n, Anchor) and n.kind == "start"]
    tops = _tops(tree)
    if any(not any(n is t for t in tops) for n in starts):
        return None
    try:
        if starts:
            w = _Writer(parser)
            at_start = re.compile(w.write(tree, True))
            regex = re.compile(_Writer(parser).write(tree, False))
            return Expression(regex, at_start, tuple(w.keeps), search_starts(tree))
        w = _Writer(parser)
        text = w.write(tree)
        return Expression(re.compile(text), None, tuple(w.keeps), search_starts(tree))
    except (_Unwritable, re.error, RecursionError):
        return None


# ---------------------------------------------------------------------------
# where Oniguruma's search tries a match
# ---------------------------------------------------------------------------

#: ``.`` without the dot-all option and ``\\N``: any character but a line feed
NOT_NEWLINE = complement(points(NEWLINE))
_OPEN_GROUPS = ("cap", "nc", "sub", "atomic")


def _any_repeat(node: Node) -> Optional[Ranges]:
    """What an unbounded greedy (or possessive) repeat of one any-character
    class repeats (``\\O``'s every character or ``.``'s all but a line
    feed), else None."""
    if not isinstance(node, Repeat) or node.hi is not None or node.mode == "lazy":
        return None
    body = node.body
    while (isinstance(body, Group) and body.kind == "nc") or (
            isinstance(body, Seq) and len(body.items) == 1):
        body = body.body if isinstance(body, Group) else body.items[0]
    if isinstance(body, Chars) and not body.icase and body.ranges in (ALL, NOT_NEWLINE):
        return body.ranges
    return None


def _informs(node: Node) -> bool:
    """Whether ``node`` gives Oniguruma's optimizer something to search for
    (an exact string, or a map of first bytes: a class of ASCII
    characters only)."""
    if isinstance(node, Text):
        return bool(node.cps) and min(node.cps) >= 0
    if isinstance(node, Chars):
        if not node.ranges or node.ranges[-1][1] >= 0x80:
            return False
        return not node.icase or all(f < 0x80 for lo, hi in node.ranges
                                     for c in range(lo, hi + 1) for f in case_class(c))
    if isinstance(node, Seq):
        return any(_informs(item) for item in node.items)
    if isinstance(node, Group) and node.kind in _OPEN_GROUPS:
        return _informs(node.body)
    if isinstance(node, Repeat) and node.lo > 0:
        return _informs(node.body)
    if isinstance(node, Alt):
        return all(_informs(b) for b in node.branches)
    return False


_NOTHING = {"dot_all": False, "dot": False, "behind": False, "not_ahead_left": False,
            "not_ahead_right": False, "end": False, "found_first": False}


def _optimizer_reading(node: Node) -> "dict[str, bool]":
    """What Oniguruma's optimizer reads off ``node`` for its search: the
    repeat of an any-character class its first character-reading item is,
    the assertions before that (positive look-behinds, negative
    look-aheads, look-aheads that give it something to find) and after
    its last such item (``\\z``, ``\\Z``, negative look-aheads); an
    alternation's are what all of its branches have."""
    if isinstance(node, Alt):
        readings = [_optimizer_reading(b) for b in node.branches]
        return {key: all(r[key] for r in readings) for key in _NOTHING}
    if isinstance(node, Group) and node.kind in _OPEN_GROUPS:
        return _optimizer_reading(node.body)
    if not isinstance(node, Seq):
        repeated = _any_repeat(node)
        return {**_NOTHING, "dot_all": repeated == ALL, "dot": repeated == NOT_NEWLINE}
    reading = dict(_NOTHING)
    consuming = [i for i, item in enumerate(node.items) if width(item) != (0, 0)]
    first = consuming[0] if consuming else len(node.items)
    last = consuming[-1] if consuming else -1
    if consuming:
        head = _optimizer_reading(node.items[first])
        reading.update(dot_all=head["dot_all"], dot=head["dot"], behind=head["behind"],
                       not_ahead_left=head["not_ahead_left"], found_first=head["found_first"])
        tail = head if first == last else _optimizer_reading(node.items[last])
        reading.update(end=tail["end"], not_ahead_right=tail["not_ahead_right"])
    for item in node.items[:first]:
        kind = item.kind if isinstance(item, Group) else None
        reading["behind"] |= kind == "behind"
        reading["not_ahead_left"] |= kind == "nahead"
        reading["found_first"] |= kind == "ahead" and _informs(item.body)
    for item in node.items[last + 1:]:
        reading["not_ahead_right"] |= isinstance(item, Group) and item.kind == "nahead"
        reading["end"] |= isinstance(item, Anchor) and item.kind in ("eos", "eos_nl")
    return reading


def search_starts(tree: Node) -> Optional[str]:
    """Where Oniguruma's search tries a match from its start, when its
    optimizer anchors it (None: at every position).  An expression whose
    first character-reading item is an unbounded repeat of ``\\O`` (the
    dot-all ``.``) can match only where the search starts, so the search
    tries ``"first"`` (when a look-ahead before it gives the optimizer a
    string or class to find) or ``"first_two"`` positions (its loop runs
    once more at the range's end); the zero-width assertions before it are
    not read, so ``\\b\\O+`` finds nothing where the first two positions
    are not word boundaries.  A positive look-behind before it, or a
    ``\\z``/``\\Z`` at its end, keeps every position.  An unbounded
    repeat of ``.`` with something to find after it tries the start and
    each position after a line feed (``"lines"``), unless a look-behind
    before it or a negative look-ahead before it or at its end is there."""
    r = _optimizer_reading(tree)
    if r["dot_all"] and not r["behind"] and not r["end"]:
        return "first" if r["found_first"] else "first_two"
    if r["dot"] and _informs(tree) and not (r["found_first"] or r["behind"] or
                                             r["not_ahead_left"] or r["not_ahead_right"]):
        return "lines"
    return None


def start_positions(starts: Optional[str], text: str, pos: int):
    """The positions, from ``pos``, where a search of :func:`search_starts`'
    kind ``starts`` (not None) tries a match."""
    if starts == "first":
        return (pos,)
    if starts == "first_two":
        return (pos, pos + 1) if pos < len(text) else (pos,)
    return [pos] + [i + 1 for i in range(pos, len(text) - 1) if text[i] == "\n"]


def first_chars(node: Node) -> "Optional[Ranges]":
    """The characters ``node``'s matches start with; None where that is
    not known or ``node`` may match empty."""
    if isinstance(node, Chars):
        return ALL if node.icase else node.ranges
    if isinstance(node, Text):
        if not node.cps or node.icase or node.cps[0] < 0:
            return None
        return points(node.cps[0])
    if isinstance(node, Seq):
        for item in node.items:
            if isinstance(item, Anchor) or (isinstance(item, Group) and item.kind in (
                    "ahead", "nahead", "behind", "nbehind")):
                continue
            return first_chars(item)
        return None
    if isinstance(node, Alt):
        sets = [first_chars(b) for b in node.branches]
        return None if any(s is None for s in sets) else union(*sets)
    if isinstance(node, Group) and node.kind in ("cap", "nc", "sub", "atomic"):
        return first_chars(node.body)
    if isinstance(node, Repeat) and node.lo > 0:
        return first_chars(node.body)
    if isinstance(node, Cluster):
        return ALL
    return None


def _unatomic(node: Node):
    """``node`` and what it holds outside atomic groups and possessive
    repeats."""
    yield node
    if isinstance(node, Group) and node.kind == "atomic":
        return
    if isinstance(node, Repeat) and node.mode == "possessive":
        return
    for child in _children(node):
        yield from _unatomic(child)


def _children(node: Node) -> list:
    if isinstance(node, Seq):
        return node.items
    if isinstance(node, Alt):
        return node.branches
    if isinstance(node, (Group, Repeat)):
        return [node.body]
    if isinstance(node, Cond):
        return [c for c in (node.test, node.yes, node.no) if c is not None]
    if isinstance(node, Absent):
        return [c for c in (node.absent, node.body) if c is not None]
    return []


def ambiguous(tree: Node) -> bool:
    """Exponential ambiguity: a repeat of more than one round, not
    possessive, whose body can match one text in two ways (it holds an
    unbounded repeat, or alternatives that may start alike, outside an
    atomic group).  Python's ``re`` backtracks over such an expression
    without bound where Oniguruma gives up, so the matcher takes it."""
    for node in _walk(tree):
        if not isinstance(node, Repeat) or node.mode == "possessive":
            continue
        if node.hi is not None and node.hi <= 1:
            continue
        for inner in _unatomic(node.body):
            if isinstance(inner, Repeat) and inner.mode != "possessive" and inner.hi is None:
                return True
            if isinstance(inner, Alt):
                sets = [first_chars(b) for b in inner.branches]
                if any(s is None for s in sets):
                    return True
                for i, a in enumerate(sets):
                    if any(intersect(a, b) for b in sets[i + 1:]):
                        return True
    return False


def _check_recursion(parser: _Parser, tree: Node) -> None:
    """A call that can reach itself before reading a character never ends
    (the library's error); any other recursive call is the matcher's."""
    def visit(number: int, stack: tuple) -> None:
        body = tree if number == 0 else parser.bodies[number].body
        for n in _walk(body):
            if isinstance(n, Call):
                if n.number in stack:
                    if _left_recursive(parser, n.number, tree):
                        raise OnigurumaError("never ending recursion")
                    parser.needs("a recursive call")
                    continue
                visit(n.number, stack + (n.number,))

    visit(0, (0,))


def _left_recursive(parser: _Parser, number: int, tree: Node) -> bool:
    body = tree if number == 0 else parser.bodies[number].body

    def reaches(node: Node) -> "Optional[bool]":
        """True: the call is reached before a character; False: a
        character comes first; None: neither (node may be empty)."""
        if isinstance(node, Call):
            return node.number == number or None
        if isinstance(node, Seq):
            for item in node.items:
                r = reaches(item)
                if r is not None:
                    return r
                if width(item)[0] > 0:
                    return False
            return None
        if isinstance(node, Alt):
            results = [reaches(b) for b in node.branches]
            return True if True in results else (None if None in results else False)
        if isinstance(node, (Group, Repeat)):
            return reaches(node.body)
        return False if width(node)[0] > 0 else None

    return reaches(body) is True
