"""Oniguruma's own matching, over the tree :mod:`.onig` reads.

Python's ``re`` runs most of the expressions a ``tokenizer.json`` holds.
What it cannot run, and what it would run without bound, is matched here
as the library's Oniguruma matches it: a backtracking machine over a
program compiled from the tree, its choice points and states on explicit
stacks (a recursive call or a long text never reaches Python's recursion
limit), trying choices in Oniguruma's order:

- alternatives left to right, greedy and lazy and possessive repeats, a
  ``{n,m}`` written out where Oniguruma writes it out and counted where it
  counts, a repeat of what can match empty ended at its first empty round;
- atomic groups and look-arounds (atomic, as Oniguruma's are), a
  look-behind of any width tried from the nearest start to the farthest,
  without the case foldings to several characters there;
- capture groups as Oniguruma sets them (unset from the group's start to
  its end, inside calls too), calls and recursion (``\\g<..>``), back
  references (last group of a shared name first; the folded characters
  under ``(?i)``; a nest level, ``\\k<n+0>``, read off the history of
  calls and captures as Oniguruma walks its stack);
- the absent operator in its four forms, ``\\y``/``\\Y`` and ``\\X`` in
  both segment modes (``(?y{g})``, ``(?y{w})``), ``\\G`` anywhere (the
  search's start), ``\\K`` anywhere (a start past the end is the end);
- the builtin callouts ``(*FAIL)``, ``(*MISMATCH)``, ``(*ERROR)``,
  ``(*SKIP)``, ``(*MAX)``, ``(*COUNT)``, ``(*TOTAL_COUNT)`` and
  ``(*CMP)``; a code callout ``(?{..})`` does nothing, as in the library,
  which registers no function for it.

Each match attempt at a start position counts its retries (a pop of a
choice point) as Oniguruma's ``retry-limit-in-match`` does and gives up
past :data:`RETRY_LIMIT` with :class:`RetryLimitError`, where the
library's search panics.
"""

from __future__ import annotations

import bisect
import functools
from typing import Optional

from . import onig
from . import unicode_tables as _tables

__all__ = ["Matcher", "MatchError", "RETRY_LIMIT", "RetryLimitError", "compile_matcher"]

#: Oniguruma's default ``retry-limit-in-match``: retries of one match
#: attempt at one start position
RETRY_LIMIT = 10_000_000
#: a ``{n,m}`` whose body times its count is at most this many operations
#: is written out, as Oniguruma's ``QUANTIFIER_EXPAND_LIMIT_SIZE``
EXPAND_LIMIT = 10


class MatchError(BaseException):
    """The library's search error (a panic of the ``tokenizers`` library,
    which is not an ``Exception`` either): a callout's error, or the retry
    limit."""


class RetryLimitError(MatchError):
    """A match attempt passed :data:`RETRY_LIMIT` retries
    (``retry-limit-in-match over``)."""


# ---------------------------------------------------------------------------
# segment boundaries (\\y, \\Y, \\X)
# ---------------------------------------------------------------------------


class _Classes:
    """Code point -> class name, over named range tables, memoized."""

    def __init__(self, tables: dict):
        ranges = sorted((lo, hi, name) for name, encoded in tables.items()
                        for lo, hi in onig.decode(encoded))
        self.starts = [lo for lo, _, _ in ranges]
        self.ranges = ranges
        self.memo: dict = {}

    def __call__(self, ch: str) -> Optional[str]:
        got = self.memo.get(ch, False)
        if got is False:
            cp = ord(ch)
            i = bisect.bisect_right(self.starts, cp) - 1
            got = self.ranges[i][2] if i >= 0 and cp <= self.ranges[i][1] else None
            self.memo[ch] = got
        return got


@functools.lru_cache(maxsize=1)
def _grapheme_classes() -> _Classes:
    return _Classes({k: v for k, v in _tables.CLUSTERS.items() if k != "ExtPict"})


@functools.lru_cache(maxsize=1)
def _word_classes() -> _Classes:
    return _Classes(_tables.WORD_BREAKS)


@functools.lru_cache(maxsize=1)
def _pictographic() -> "_Set":
    return _Set(onig.cluster_ranges("ExtPict"))


_HANGUL = frozenset(("L", "V", "T", "LV", "LVT"))
_CONTROLS = frozenset(("CR", "LF", "Control"))


def grapheme_boundary(text: str, p: int) -> bool:
    """Oniguruma's ``onigenc_egcb_is_break_position`` (UAX #29 without
    GB9c) at ``p``."""
    if p == 0 or p >= len(text):
        return True
    kind = _grapheme_classes()
    a, b = kind(text[p - 1]), kind(text[p])
    if a is None and b is None:
        return True
    if a == "CR" and b == "LF":
        return False
    if a in _CONTROLS or b in _CONTROLS:
        return True
    if a in _HANGUL and b in _HANGUL:
        return not ((a == "L" and b != "T") or (a in ("LV", "V") and b in ("V", "T"))
                    or (b == "T" and a in ("LVT", "T")))
    if b in ("Extend", "ZWJ", "SpacingMark") or a == "Prepend":
        return False
    if a == "ZWJ":
        if not _pictographic().has(text[p]):
            return True
        q = p - 2
        while q >= 0:
            if _pictographic().has(text[q]):
                return False
            if kind(text[q]) != "Extend":
                return True
            q -= 1
        return True
    if a == "RI" and b == "RI":
        q, n = p - 2, 0
        while q >= 0 and kind(text[q]) == "RI":
            n += 1
            q -= 1
        return n % 2 == 1
    return True


_WB_IGNORE = frozenset(("Extend", "Format", "ZWJ"))
_WB_LETTER = frozenset(("ALetter", "Hebrew_Letter"))
_WB_MIDLETTER = frozenset(("MidLetter", "MidNumLet", "Single_Quote"))
_WB_MIDNUM = frozenset(("MidNum", "MidNumLet", "Single_Quote"))
_WB_NEWLINE = frozenset(("Newline", "CR", "LF"))


def _wb_before(text: str, q: int, kind) -> "tuple[Optional[str], int]":
    """The class of the character before ``q`` past Extend/Format/ZWJ (the
    last one read if all are), and its index."""
    t = None
    while q > 0:
        q -= 1
        t = kind(text[q])
        if t not in _WB_IGNORE:
            break
    return t, q


def _wb_after(text: str, p: int, kind) -> Optional[str]:
    """The class of the first character after ``p`` past Extend/Format/ZWJ
    (None at the end)."""
    q = p + 1
    while q < len(text):
        t = kind(text[q])
        if t not in _WB_IGNORE:
            return t
        q += 1
    return None


def word_boundary(text: str, p: int) -> bool:
    """Oniguruma's ``onigenc_wb_is_break_position`` (UAX #29 word
    boundaries) at ``p``."""
    if p == 0 or p >= len(text):
        return True
    kind = _word_classes()
    a, b = kind(text[p - 1]), kind(text[p])
    if a is None and b is None:
        return True
    if a == "CR" and b == "LF":
        return False
    if a in _WB_NEWLINE or b in _WB_NEWLINE:
        return True
    if a == "ZWJ" and _pictographic().has(text[p]):
        return False
    if a == "WSegSpace" and b == "WSegSpace":
        return False
    if b in _WB_IGNORE:
        return False
    q = p - 1
    if a in _WB_IGNORE:
        a, q = _wb_before(text, p - 1, kind)
    if a in _WB_LETTER:
        if b in _WB_LETTER:
            return False
        if b in _WB_MIDLETTER and _wb_after(text, p, kind) in _WB_LETTER:
            return False
    if a in _WB_MIDLETTER and b in _WB_LETTER and _wb_before(text, q, kind)[0] in _WB_LETTER:
        return False
    if a == "Hebrew_Letter":
        if b == "Single_Quote":
            return False
        if b == "Double_Quote" and _wb_after(text, p, kind) == "Hebrew_Letter":
            return False
    if b == "Hebrew_Letter" and a == "Double_Quote" and \
            _wb_before(text, q, kind)[0] == "Hebrew_Letter":
        return False
    if b == "Numeric":
        if a == "Numeric" or a in _WB_LETTER:
            return False
        if a in _WB_MIDNUM and _wb_before(text, q, kind)[0] == "Numeric":
            return False
    if a == "Numeric":
        if b in _WB_LETTER:
            return False
        if b in _WB_MIDNUM and _wb_after(text, p, kind) == "Numeric":
            return False
    if a == "Katakana" and b == "Katakana":
        return False
    if b == "ExtendNumLet" and (a in _WB_LETTER or a in ("Numeric", "ExtendNumLet", "Katakana")):
        return False
    if a == "ExtendNumLet" and (b in _WB_LETTER or b in ("Numeric", "Katakana")):
        return False
    if a == "Regional_Indicator" and b == "Regional_Indicator":
        n = 0
        while q > 0 and kind(text[q - 1]) == "Regional_Indicator":
            n += 1
            q -= 1
        return n % 2 == 1
    return True


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


class _Set:
    """A code point set's membership, memoized per character."""
    __slots__ = ("ranges", "memo")

    def __init__(self, ranges):
        self.ranges, self.memo = ranges, {}

    def has(self, ch: str) -> bool:
        got = self.memo.get(ch)
        if got is None:
            got = self.memo[ch] = onig.contains(self.ranges, ord(ch))
        return got


(CHARS, STR, STAR, PUSH, JUMP, MATCH, FAIL, OPEN, CLOSE, CALL, RETURN, KEEP, ANCHOR,
 ATOMIC, CUT, LOOK, LOOK_END, NLOOK, NLOOK_END, BEHIND, BEHIND_TRY, BEHIND_END, NBEHIND,
 NBEHIND_END, CHECK, CHECK_END, REP, REP_TEST, REP_INC, REP_END, BACKREF, COND, CLUSTER,
 ABSENT, ABSENT_END, STOPPER, CLEAR, CALLOUT, PUSH_EXACT, PUSH_PEEK) = range(40)

# the state besides pc and position, one tuple (ctx): its fields
CAPS, OPENS, KEEP_AT, RETS, MARKS, LIMIT, REPS, CHECKS, HIST = range(9)

# stack entries: (kind, pc, position, ctx[, more]): a choice point, a
# repeat's shorter runs down to a position, or at listed positions, a
# callout's retraction, a look-behind's next start (no retry: a failing
# look-behind of several widths costs the library's count what one of one
# width does)
ALT_ENTRY, STAR_ENTRY, PLACES_ENTRY, RETRACT_ENTRY, BEHIND_ENTRY = range(5)


@functools.lru_cache(maxsize=None)
def _lead(ch: str) -> int:
    """The first UTF-8 byte of ``ch`` (what Oniguruma's peeks compare)."""
    return ch.encode("utf-8", "surrogatepass")[0]


def _head(node, exact: bool):
    """Oniguruma's ``get_tree_head_literal``: the literal (``exact``) or
    literal or class a match of ``node`` starts with, or None."""
    if isinstance(node, onig.Chars):
        if exact or node.ranges in (onig.ALL, onig.NOT_NEWLINE):
            return None
        return node
    if isinstance(node, onig.Text):
        if not node.cps or node.cps[0] < 0 or (exact and node.icase):
            return None
        return node
    if isinstance(node, onig.Seq):
        return _head(node.items[0], exact) if node.items else None
    if isinstance(node, onig.Repeat):
        return _head(node.body, exact) if node.lo > 0 else None
    if isinstance(node, onig.Group) and node.kind in ("cap", "nc", "sub", "atomic", "ahead"):
        return _head(node.body, exact)
    return None


def _strict(node) -> bool:
    """One character or class, or a literal (Oniguruma's
    ``is_strict_real_node``)."""
    if isinstance(node, onig.Seq) and len(node.items) == 1:
        node = node.items[0]
    return isinstance(node, onig.Chars) or (isinstance(node, onig.Text) and bool(node.cps))


def _exclusive(x, y) -> bool:
    """No text starts with both ``x`` and ``y`` (both literals or classes;
    under ``(?i)`` never said)."""
    if x is None or y is None or x.icase or y.icase:
        return False
    if isinstance(x, onig.Text) and isinstance(y, onig.Text):
        return x.cps[0] != y.cps[0]
    if isinstance(x, onig.Text):
        x, y = y, x
    if isinstance(y, onig.Text):
        return y.cps[0] < 0 or not onig.contains(x.ranges, y.cps[0])
    return not onig.intersect(x.ranges, y.ranges)


def _single_char(body, lookbehind: bool):
    """``body`` as one character's set where it reads one character."""
    if isinstance(body, onig.Chars):
        if body.icase and not lookbehind and onig.icase_spellings(body.ranges):
            return None
        return body
    if isinstance(body, onig.Text) and not body.icase and len(body.cps) == 1 and body.cps[0] >= 0:
        return onig.Chars(onig.points(body.cps[0]))
    return None


def _with(ctx: tuple, field: int, value) -> tuple:
    return ctx[:field] + (value,) + ctx[field + 1:]


class _Callout:
    __slots__ = ("name", "args", "tag", "per_attempt")

    def __init__(self, name, args, tag):
        self.name, self.args, self.tag = name, args, tag
        self.per_attempt = name in ("MAX", "COUNT")


class Matcher:
    """A compiled expression: :meth:`search` as :class:`onig.Expression`'s."""

    engine = "matcher"

    def __init__(self, parser, tree):
        self.parser = parser
        self.ops: list = []
        self.called = sorted({n.number for n in onig._walk(tree) if isinstance(n, onig.Call)})
        self.subs: dict = {}
        self.patches: list = []
        self.callouts: list = []
        self.tags: dict = {}
        self.callout_index: dict = {}
        self.history = any(isinstance(n, onig.Backref) and n.level is not None
                           for n in onig._walk(tree))
        self.absents: list = []
        self.groups = parser.groups
        self.tree = tree
        # a capture only a back reference or a conditional reads: the others
        # change no match, so they are not kept
        self.read = {g for n in onig._walk(tree) if isinstance(n, (onig.Backref, onig.Cond))
                     for g in (n.numbers or (n.number,)) if g is not None}
        self._lookbehind = 0
        self._emit_program(tree)
        self.ops = [tuple(op) for op in self.ops]
        self.first = _first_set(tree)
        self.required = _required_text(tree)
        #: the positions Oniguruma's search tries (``onig.search_starts``)
        self.starts = onig.search_starts(tree)
        self.empty_caps = (None,) * (self.groups + 1)

    # --- compiling ---

    def emit(self, *op) -> int:
        self.ops.append(list(op))
        return len(self.ops) - 1

    def here(self) -> int:
        return len(self.ops)

    def _emit_program(self, tree) -> None:
        self.compile(tree)
        self.emit(MATCH)
        for number in self.called:  # each called group once, as a subroutine
            self.subs[number] = self.here()
            if number == 0:
                self.compile(tree)
            elif number in self.read:
                self.emit(OPEN, number)
                self.compile(self.parser.bodies[number].body)
                self.emit(CLOSE, number)
            else:
                self.compile(self.parser.bodies[number].body)
            self.emit(RETURN)
        for index in self.patches:
            self.ops[index][1] = self.subs[self.ops[index][1]]
        for index, body in self.absents:
            start = self.here()
            self.compile(body)
            self.emit(MATCH)
            self.ops[index][1] = start

    def compile(self, node, next_node=None) -> None:
        """``node``; ``next_node`` what follows it in its sequence (a repeat
        peeks at its first character, as Oniguruma's ``tune_next``)."""
        lookbehind = self._lookbehind > 0
        if isinstance(node, onig.Chars):
            if node.icase and not lookbehind:
                spelled = onig.icase_spellings(node.ranges)
                if spelled:
                    self.compile(onig.Alt([onig.Chars(node.ranges), *spelled]))
                    return
            self.emit(CHARS, _Set(node.ranges))
        elif isinstance(node, onig.Text):
            self.compile_text(node, lookbehind)
        elif isinstance(node, onig.Seq):
            items = node.items
            if len(items) == 1:
                self.compile(items[0], next_node)
            for i, item in enumerate(items if len(items) > 1 else ()):
                self.compile(item, items[i + 1] if i + 1 < len(items) else None)
        elif isinstance(node, onig.Alt):
            self.compile_alt(node.branches)
        elif isinstance(node, onig.Group):
            self.compile_group(node, next_node)
        elif isinstance(node, onig.Repeat):
            self.compile_repeat(node, next_node)
        elif isinstance(node, onig.Anchor):
            self.compile_anchor(node)
        elif isinstance(node, onig.Backref):
            numbers = node.numbers or (node.number,)
            for number in numbers:
                if number not in self.parser.bodies:
                    raise onig.OnigurumaError("invalid backref number/name")
            self.emit(BACKREF, tuple(reversed(numbers)), node.icase, node.level)
        elif isinstance(node, onig.Cond):
            self.compile_cond(node)
        elif isinstance(node, onig.Call):
            self.patches.append(self.emit(CALL, node.number))
        elif isinstance(node, onig.Cluster):
            self.emit(CLUSTER, node.word)
        elif isinstance(node, onig.Absent):
            self.compile_absent(node)
        elif isinstance(node, onig.Callout):
            self.compile_callout(node)
        elif node is onig.FAIL:
            self.emit(FAIL)
        elif node is onig.NEWLINES:
            self.compile(onig.Group("atomic", onig.Alt([
                onig.Text([0x0D, 0x0A], False),
                onig.Chars(onig.points(0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029))])))
        else:
            raise TypeError(node)

    def compile_text(self, node, lookbehind: bool) -> None:
        if not node.icase:
            if any(c < 0 for c in node.cps):
                self.emit(FAIL)
            elif node.cps:
                self.emit(STR, "".join(map(chr, node.cps)))
            return
        for part in onig.icase_parts(node.cps, lookbehind):
            self.compile(part)

    def compile_alt(self, branches) -> None:
        ends = []
        for i, branch in enumerate(branches):
            if i == len(branches) - 1:
                self.compile(branch)
                break
            push = self.emit(PUSH, None)
            self.compile(branch)
            ends.append(self.emit(JUMP, None))
            self.ops[push][1] = self.here()
        for index in ends:
            self.ops[index][1] = self.here()

    def compile_group(self, node, next_node=None) -> None:
        kind = node.kind
        if kind == "cap":
            if node.number in self.called:
                self.patches.append(self.emit(CALL, node.number))
            elif node.number in self.read:
                self.emit(OPEN, node.number)
                self.compile(node.body, next_node)
                self.emit(CLOSE, node.number)
            else:
                self.compile(node.body, next_node)
        elif kind in ("nc", "sub"):
            self.compile(node.body)
        elif kind == "atomic":
            self.emit(ATOMIC)
            self.compile(node.body)
            self.emit(CUT)
        elif kind == "ahead":
            self.emit(LOOK)
            self.compile(node.body)
            self.emit(LOOK_END)
        elif kind == "nahead":
            start = self.emit(NLOOK, None)
            self.compile(node.body)
            self.emit(NLOOK_END)
            self.ops[start][1] = self.here()
        else:
            branches = onig.lookbehind_parts(node.body)
            if len(branches) > 1:
                # Oniguruma divides the look-behind, one per branch, in
                # branch order
                parts = [onig.Group(kind, b) for b in branches]
                self.compile(onig.Alt(parts) if kind == "behind" else onig.Seq(parts))
                return
            widths = [onig.char_width(b, True) for b in (
                node.body.branches if isinstance(node.body, onig.Alt) else [node.body])]
            lo, hi = onig.char_width(node.body, True)
            tail = onig.lookbehind_tail(node.body)
            tail = None if tail is None else tuple(map(_Set, tail))
            # a look-behind of several widths reads nothing past where it
            # stands: Oniguruma moves its right range there
            bounded = any(a != b for a, b in widths)
            if kind == "behind":
                self.emit(BEHIND, lo, None, tail, bounded)
            else:
                start = self.emit(NBEHIND, lo, None, tail, bounded)
            self.emit(BEHIND_TRY, hi)
            self._lookbehind += 1
            self.compile(node.body)
            self._lookbehind -= 1
            if kind == "behind":
                self.emit(BEHIND_END)
            else:
                self.emit(NBEHIND_END)
                self.ops[start][2] = self.here()

    def compile_repeat(self, node, next_node=None) -> None:
        body, lo, hi, mode = node.body, node.lo, node.hi, node.mode
        if mode == "possessive":
            self.emit(ATOMIC)
            self.compile(onig.Repeat(body, lo, hi, "greedy"))
            self.emit(CUT)
            return
        if hi == 0:
            return
        empty = onig.char_width(body, self._lookbehind > 0)[0] == 0
        greedy_loop = mode == "greedy" and hi is None
        # Oniguruma's count-only shortcuts of a greedy loop: no choice point
        # where the body's first literal or the next one cannot follow
        # (PUSH_OR_JUMP_EXACT1, PUSH_IF_PEEK_NEXT), and a*b as (?>a*)b
        # where a and b cannot be the same character
        head = _head(body, True) if greedy_loop and not empty else None
        peek = _head(next_node, True) if greedy_loop and next_node is not None else None
        atomic = greedy_loop and lo <= 1 and _strict(body) and _exclusive(
            _head(body, False), _head(next_node, False))
        if atomic:
            self.emit(ATOMIC)
        single = _single_char(body, self._lookbehind > 0)
        if mode == "greedy" and single is not None:
            anychar = hi is None and single.ranges in (onig.ALL, onig.NOT_NEWLINE)
            exact = hi is None and isinstance(body, onig.Text)
            self.emit(STAR, _Set(single.ranges), lo, hi, atomic, exact, anychar,
                      None if exact or peek is None else _lead(chr(peek.cps[0])))
            if atomic:
                self.emit(CUT)
            return
        size = self._size(body)
        if hi is None and (lo <= 1 or size * lo <= EXPAND_LIMIT):
            for _ in range(lo):
                self.compile(body)
            self._star(body, mode == "greedy", empty, head, peek)
        elif hi is not None and mode == "greedy" and (
                hi == 1 or (size + 1) * hi <= EXPAND_LIMIT):
            for _ in range(lo):
                self.compile(body)
            pushes = []
            for _ in range(hi - lo):
                pushes.append(self.emit(PUSH, None))
                self.compile(body)
            for index in pushes:
                self.ops[index][1] = self.here()
        elif hi == 1 and lo == 0 and mode == "lazy":
            push = self.emit(PUSH, None)
            skip = self.emit(JUMP, None)
            self.ops[push][1] = self.here()
            self.compile(body)
            self.ops[skip][1] = self.here()
        else:
            self._counted(body, lo, hi, mode == "greedy", empty)
        if atomic:
            self.emit(CUT)

    def _size(self, node) -> int:
        """The operations ``node`` compiles to (Oniguruma's body length,
        roughly)."""
        saved = len(self.ops), list(self.patches), list(self.absents)
        self.compile(node)
        size = len(self.ops) - saved[0]
        del self.ops[saved[0]:]
        self.patches, self.absents = saved[1], saved[2]
        return max(size, 1)

    def _memst(self, body, empty: bool) -> tuple:
        """The groups of a body that can match empty which a back reference
        reads: their captures decide an empty round (Oniguruma's
        ``EMPTY_CHECK_END_MEMST``); none, and an empty round ends the
        repeat."""
        if not empty:
            return ()
        referenced = {g for n in onig._walk(self.tree) if isinstance(n, onig.Backref)
                      for g in (n.numbers or (n.number,))}
        return tuple(sorted(n.number for n in onig._walk(body) if isinstance(n, onig.Group)
                            and n.kind == "cap" and n.number in referenced))

    def _star(self, body, greedy: bool, empty: bool, head=None, peek=None) -> None:
        memst = self._memst(body, empty)
        if greedy:
            if head is not None:
                loop = self.emit(PUSH_EXACT, None, _lead(chr(head.cps[0])))
            elif peek is not None:
                loop = self.emit(PUSH_PEEK, None, _lead(chr(peek.cps[0])))
            else:
                loop = self.emit(PUSH, None)
            check = self.emit(CHECK, memst) if empty else None
            self.compile(body)
            end = self.emit(CHECK_END, None) if empty else None
            self.emit(JUMP, loop)
            self.ops[loop][1] = self.here()
            if empty:
                self.ops[end][1] = self.here()
            return
        skip = self.emit(JUMP, None)
        top = self.here()
        if empty:
            self.emit(CHECK, memst)
        self.compile(body)
        end = self.emit(CHECK_END, None) if empty else None
        self.ops[skip][1] = self.here()
        self.emit(PUSH, top)
        if empty:
            self.ops[end][1] = self.here()

    def _counted(self, body, lo: int, hi: Optional[int], greedy: bool, empty: bool) -> None:
        memst = self._memst(body, empty)
        self.emit(REP)
        test = self.emit(REP_TEST, lo, hi, greedy, None)
        if empty:
            self.emit(CHECK, memst)
        self.compile(body)
        end = self.emit(CHECK_END, None) if empty else None
        self.emit(REP_INC, test)
        exit_ = self.emit(REP_END)
        self.ops[test][4] = exit_
        if empty:
            self.ops[end][1] = exit_

    def compile_anchor(self, node) -> None:
        if node.kind == "keep":
            self.emit(KEEP)
        elif node.kind in ("word", "nonword"):
            self.emit(ANCHOR, node.kind, _Set(node.word))
        else:
            self.emit(ANCHOR, node.kind, node.word)

    def compile_cond(self, node) -> None:
        if node.test is not None:
            self.compile(onig.Alt([
                onig.Seq([onig.Group("atomic", node.test), node.yes]),
                onig.Seq([onig.Group("nahead", node.test), node.no])]))
            return
        numbers = node.numbers or (node.number,)
        for number in numbers:
            if number not in self.parser.bodies:
                raise onig.OnigurumaError("invalid backref number/name")
        test = self.emit(COND, numbers, None)
        self.compile(node.yes)
        skip = self.emit(JUMP, None)
        self.ops[test][2] = self.here()
        self.compile(node.no)
        self.ops[skip][1] = self.here()

    def compile_absent(self, node) -> None:
        if node.kind == "clear":
            self.emit(CLEAR)
            return
        index = self.emit(STOPPER if node.kind == "stopper" else ABSENT, None)
        self.absents.append((index, node.absent))
        if node.kind == "stopper":
            return
        self.compile(node.body if node.kind == "expr" else onig.Repeat(
            onig.Chars(onig.ALL), 0, None, "greedy"))
        self.emit(ABSENT_END)

    def compile_callout(self, node) -> None:
        """One callout's data however often its node is written out (a
        repeat's body twice, as Oniguruma writes ``X+`` as ``X X*``)."""
        index = self.callout_index.get(id(node))
        if index is None:
            index = self.callout_index[id(node)] = len(self.callouts)
            self.callouts.append(_Callout(node.name, node.args, node.tag))
            if node.tag is not None:
                self.tags[node.tag] = index
        self.emit(CALLOUT, index)

    # --- matching ---

    def search(self, text: str, pos: int = 0) -> "Optional[tuple[int, int]]":
        """The leftmost match from ``pos`` as ``(start, stop)``: each start
        from ``pos`` on is one match attempt, as Oniguruma's search."""
        n = len(text)
        last = n
        for literal in self.required:
            at = text.rfind(literal, pos)
            if at < 0:
                return None
            last = min(last, at)
        first = self.first
        data: dict = {}
        if self.starts is not None:
            # Oniguruma's search tries these positions only
            skip = pos
            for start in onig.start_positions(self.starts, text, pos):
                if start < skip or start > last:
                    continue
                result = _Attempt(self, text, pos, data).run(start)
                if isinstance(result, tuple):
                    return result
                if result is not None:
                    skip = result
            return None
        start = pos
        while start <= n and start <= last:
            if first is not None:
                while start < n and start <= last and not first.has(text[start]):
                    start += 1
                if start >= n or start > last:
                    break
            result = _Attempt(self, text, pos, data).run(start)
            if isinstance(result, tuple):
                return result
            start = max(start + 1, result) if result is not None else start + 1
        return None

    def __repr__(self) -> str:
        return f"Matcher({len(self.ops)} operations)"


class _Attempt:
    """One match attempt's machine: ``run(start)`` is the match as
    ``(start, stop)``, or where the search goes on from (``(*SKIP)``), or
    None."""

    __slots__ = ("m", "text", "search_start", "data", "retries", "skip")

    def __init__(self, m: Matcher, text: str, search_start: int, data: dict):
        self.m, self.text, self.search_start = m, text, search_start
        self.data, self.retries, self.skip = data, 0, None

    def run(self, start: int):
        m = self.m
        for index, callout in enumerate(m.callouts):
            if callout.per_attempt:
                self.data.pop(index, None)
        ctx = (m.empty_caps, None, None, None, None, len(self.text), None, None, None)
        end = self.execute(0, start, ctx)
        if end is None:
            return self.skip
        if end is _MISMATCH:
            return None
        stop, keep = end
        begin = start if keep is None else min(keep, stop)
        return begin, stop

    def absent_at(self, pc: int, s: int, limit: int) -> int:
        """The first position from ``s`` at which the absent expression
        matches (``limit`` when none does)."""
        m = self.m
        ctx = (m.empty_caps, None, None, None, None, len(self.text), None, None, None)
        for p in range(s, limit + 1):
            found = self.execute(pc, p, ctx)
            if found is _MISMATCH:
                continue
            if found is not None:
                return p
        return limit

    def execute(self, pc: int, s: int, ctx: tuple):
        """Run from ``pc`` at ``s`` to MATCH: ``(stop, keep)``, None (no
        match), or ``_MISMATCH``."""
        m, text = self.m, self.text
        ops = m.ops
        n = len(text)
        stack: list = []
        push = stack.append
        # the commonest names as locals (a global is slower to read)
        chars_, str_, push_, jump_, star_, anchor_ = CHARS, STR, PUSH, JUMP, STAR, ANCHOR
        alt_entry, star_entry, limit_at, retry_limit = ALT_ENTRY, STAR_ENTRY, LIMIT, RETRY_LIMIT
        while True:
            op = ops[pc]
            code = op[0]
            if code == chars_:
                if s < ctx[limit_at]:
                    charset = op[1]
                    hit = charset.memo.get(text[s])
                    if hit is None:
                        hit = charset.has(text[s])
                    if hit:
                        s += 1
                        pc += 1
                        continue
            elif code == str_:
                lit = op[1]
                if s + len(lit) <= ctx[limit_at] and text.startswith(lit, s):
                    s += len(lit)
                    pc += 1
                    continue
            elif code == push_:
                push((alt_entry, op[1], s, ctx))
                pc += 1
                continue
            elif code == jump_:
                pc = op[1]
                continue
            elif code == anchor_:
                if self.anchor(op[1], op[2], s, ctx[limit_at]):
                    pc += 1
                    continue
            elif code == star_:
                # a greedy repeat of one character: the longest run, and a
                # choice point for each shorter one, as Oniguruma's loop
                # leaves them (with its retry where the run ends on a
                # character it does not take)
                _, charset, lo, hi, atomic, exact, anychar, peek = op
                limit = ctx[limit_at]
                stop = limit if hi is None or s + hi > limit else s + hi
                memo, has = charset.memo, charset.has
                e = s
                while e < stop:
                    hit = memo.get(text[e])
                    if hit is None:
                        hit = has(text[e])
                    if not hit:
                        break
                    e += 1
                if e - s >= lo:
                    low = s + lo
                    ended = (hi is not None and e - s == hi) or exact or (anychar and e == limit)
                    if peek is None:
                        # the run's end, then the choice points low .. e - 1
                        if not ended:
                            self.retries += 1
                            if self.retries > RETRY_LIMIT:
                                self._count()
                        if e > low and not atomic:
                            push((star_entry, pc + 1, e - 1, ctx, low))
                        s = e
                        pc += 1
                        continue
                    # a choice point only where the next literal can follow
                    places = [p for p in range(low, e if ended else e + 1)
                              if p < limit and _lead(text[p]) == peek]
                    end = e if ended else (places.pop() if places else None)
                    if end is not None:
                        if not ended:
                            self.retries += 1
                            if self.retries > RETRY_LIMIT:
                                self._count()
                        if places and not atomic:
                            push((PLACES_ENTRY, pc + 1, len(places) - 1, ctx, places))
                        s = end
                        pc += 1
                        continue
            elif code == PUSH_EXACT:
                if s < ctx[limit_at] and _lead(text[s]) == op[2]:
                    push((ALT_ENTRY, op[1], s, ctx))
                    pc += 1
                else:
                    pc = op[1]
                continue
            elif code == PUSH_PEEK:
                if s < ctx[limit_at] and _lead(text[s]) == op[2]:
                    push((ALT_ENTRY, op[1], s, ctx))
                pc += 1
                continue
            elif code == OPEN:
                g = op[1]
                caps = ctx[CAPS]
                ctx = (caps[:g] + (None,) + caps[g + 1:], ((g, s), ctx[OPENS])) + ctx[2:]
                if m.history:
                    ctx = _with(ctx, HIST, (("start", g, s), ctx[HIST]))
                pc += 1
                continue
            elif code == CLOSE:
                g = op[1]
                begin, opens = _close(ctx[OPENS], g)
                caps = ctx[CAPS]
                ctx = (caps[:g] + ((begin, s),) + caps[g + 1:], opens) + ctx[2:]
                if m.history:
                    ctx = _with(ctx, HIST, (("end", g, s), ctx[HIST]))
                pc += 1
                continue
            elif code == MATCH:
                return s, ctx[KEEP_AT]
            elif code == FAIL:
                pass
            elif code == CALL:
                ctx = _with(ctx, RETS, (pc + 1, ctx[RETS]))
                if m.history:
                    ctx = _with(ctx, HIST, (("call",), ctx[HIST]))
                pc = op[1]
                continue
            elif code == RETURN:
                rets = ctx[RETS]
                pc = rets[0]
                ctx = _with(ctx, RETS, rets[1])
                if m.history:
                    ctx = _with(ctx, HIST, (("return",), ctx[HIST]))
                continue
            elif code == KEEP:
                ctx = _with(ctx, KEEP_AT, s)
                pc += 1
                continue
            elif code == ATOMIC:
                ctx = _with(ctx, MARKS, ((len(stack), s), ctx[MARKS]))
                pc += 1
                continue
            elif code == CUT:
                marks = ctx[MARKS]
                del stack[marks[0][0]:]
                ctx = _with(ctx, MARKS, marks[1])
                pc += 1
                continue
            elif code == LOOK:
                ctx = _with(ctx, MARKS, ((len(stack), s), ctx[MARKS]))
                pc += 1
                continue
            elif code == LOOK_END:
                marks = ctx[MARKS]
                height, s = marks[0]
                del stack[height:]
                ctx = _with(ctx, MARKS, marks[1])
                pc += 1
                continue
            elif code == NLOOK:
                push((ALT_ENTRY, op[1], s, ctx))
                ctx = _with(ctx, MARKS, ((len(stack) - 1, s), ctx[MARKS]))
                pc += 1
                continue
            elif code == NLOOK_END:
                del stack[ctx[MARKS][0][0]:]
            elif code == BEHIND or code == NBEHIND:
                tail = op[3]
                if tail is not None and (s < len(tail) or not all(
                        t.has(text[s - len(tail) + i]) for i, t in enumerate(tail))):
                    # the characters before are not the body's tail: the
                    # body fails at once, at the one retry Oniguruma counts
                    if code == NBEHIND:
                        self.retries += 1
                        pc = op[2]
                        continue
                else:
                    if code == NBEHIND:
                        push((ALT_ENTRY, op[2], s, ctx))
                    marks = ((len(stack) - (code == NBEHIND), s, ctx[limit_at]), ctx[MARKS])
                    ctx = ctx[:MARKS] + (marks, s if op[4] else ctx[limit_at]) + ctx[LIMIT + 1:]
                    if s - op[1] >= 0:
                        s -= op[1]
                        pc += 1
                        continue
            elif code == BEHIND_TRY:
                origin = ctx[MARKS][0][1]
                if s > 0 and (op[1] is None or origin - s < op[1]):
                    push((BEHIND_ENTRY, pc, s - 1, ctx))
                pc += 1
                continue
            elif code == BEHIND_END:
                marks = ctx[MARKS]
                height, origin, limit = marks[0]
                if s == origin:
                    del stack[height:]
                    ctx = ctx[:MARKS] + (marks[1], limit) + ctx[LIMIT + 1:]
                    pc += 1
                    continue
            elif code == NBEHIND_END:
                height, origin, _ = ctx[MARKS][0]
                if s == origin:
                    del stack[height:]
            elif code == CHECK:
                ctx = _with(ctx, CHECKS, ((s, ctx[CAPS], op[1]), ctx[CHECKS]))
                pc += 1
                continue
            elif code == CHECK_END:
                checks = ctx[CHECKS]
                begin, caps, groups = checks[0]
                ctx = _with(ctx, CHECKS, checks[1])
                empty = s == begin and _empty_round(groups, caps, ctx[CAPS], s)
                if empty is not None:  # None: the round fails
                    pc = op[1] if empty else pc + 1  # an empty round ends the repeat
                    continue
            elif code == REP:
                ctx = _with(ctx, REPS, (0, ctx[REPS]))
                pc += 1
                continue
            elif code == REP_TEST:
                count = ctx[REPS][0]
                lo, hi, greedy, exit_ = op[1], op[2], op[3], op[4]
                if count < lo:
                    pc += 1
                elif hi is not None and count >= hi:
                    pc = exit_
                elif greedy:
                    push((ALT_ENTRY, exit_, s, ctx))
                    pc += 1
                else:
                    push((ALT_ENTRY, pc + 1, s, ctx))
                    pc = exit_
                continue
            elif code == REP_INC:
                reps = ctx[REPS]
                ctx = _with(ctx, REPS, (reps[0] + 1, reps[1]))
                pc = op[1]
                continue
            elif code == REP_END:
                ctx = _with(ctx, REPS, ctx[REPS][1])
                pc += 1
                continue
            elif code == BACKREF:
                end = self.backref(op, s, ctx)
                if end is not None:
                    s = end
                    pc += 1
                    continue
            elif code == COND:
                caps = ctx[CAPS]
                pc = pc + 1 if any(caps[g] is not None for g in op[1]) else op[2]
                continue
            elif code == CLUSTER:
                if s < ctx[limit_at]:
                    boundary = word_boundary if op[1] else grapheme_boundary
                    limit = ctx[limit_at]
                    s += 1
                    while s < limit and not boundary(text, s):
                        s += 1
                    pc += 1
                    continue
            elif code == ABSENT:
                cut = self.absent_at(op[1], s, ctx[limit_at])
                ctx = (ctx[:MARKS] + (((ctx[limit_at],), ctx[MARKS]), cut) + ctx[LIMIT + 1:])
                pc += 1
                continue
            elif code == ABSENT_END:
                marks = ctx[MARKS]
                ctx = ctx[:MARKS] + (marks[1], marks[0][0]) + ctx[LIMIT + 1:]
                pc += 1
                continue
            elif code == STOPPER:
                ctx = _with(ctx, LIMIT, self.absent_at(op[1], s, ctx[limit_at]))
                pc += 1
                continue
            elif code == CLEAR:
                ctx = _with(ctx, LIMIT, n)
                pc += 1
                continue
            elif code == CALLOUT:
                verdict = self.callout(op[1], s)
                if verdict is _MISMATCH:
                    return _MISMATCH
                if verdict:
                    if m.callouts[op[1]].name in ("MAX", "COUNT", "TOTAL_COUNT"):
                        push((RETRACT_ENTRY, op[1], s, ctx))
                    pc += 1
                    continue
            else:
                raise AssertionError(code)
            # fail: back to the last choice point
            while True:
                retries = self.retries = self.retries + 1
                if retries > retry_limit:
                    self._count()
                if not stack:
                    return None
                entry = stack.pop()
                kind = entry[0]
                if kind == alt_entry:
                    _, pc, s, ctx = entry
                    break
                if kind == BEHIND_ENTRY:
                    _, pc, s, ctx = entry
                    self.retries -= 1
                    break
                if kind == star_entry:
                    _, pc, s, ctx, low = entry
                    if s > low:
                        push((star_entry, pc, s - 1, ctx, low))
                    break
                if kind == PLACES_ENTRY:
                    _, pc, i, ctx, places = entry
                    s = places[i]
                    if i > 0:
                        push((PLACES_ENTRY, pc, i - 1, ctx, places))
                    break
                self.retract(entry[1])
                self.retries -= 1  # a retraction is not a retry

    def _count(self) -> None:
        self.retries += 1
        if self.retries > RETRY_LIMIT:
            raise RetryLimitError("Onig: Regex search error: retry-limit-in-match over")

    # --- operations that read more than one character ---

    def anchor(self, kind: str, arg, s: int, limit: int) -> bool:
        text = self.text
        n = len(text)
        if kind == "bol":
            return s == 0 or (text[s - 1] == "\n" and s < n)
        if kind == "eol":
            return s == n or text[s] == "\n"
        if kind == "bos":
            return s == 0
        if kind == "eos":
            return s == n
        if kind == "eos_nl":
            return s == n or (s == n - 1 and text[s] == "\n")
        if kind in ("word", "nonword"):
            # at the text's start Oniguruma reads the character after only
            # inside its right range
            before = s > 0 and arg.has(text[s - 1])
            after = s < n and (s > 0 or s < limit) and arg.has(text[s])
            return (before != after) == (kind == "word")
        if kind == "start":
            return s == self.search_start
        if kind in ("segment", "nonsegment"):
            boundary = word_boundary(text, s) if arg else grapheme_boundary(text, s)
            return boundary == (kind == "segment")
        raise AssertionError(kind)

    def backref(self, op, s: int, ctx: tuple) -> Optional[int]:
        numbers, icase, level = op[1], op[2], op[3]
        text, limit = self.text, ctx[LIMIT]
        if level is not None:
            span = _at_level(ctx[HIST], numbers, level)
            spans = [span] if span is not None else []
        else:
            caps = ctx[CAPS]
            spans = [caps[g] for g in numbers if caps[g] is not None]
        for begin, end in spans:
            got = _compare(text, begin, end, s, limit, icase)
            if got is not None:
                return got
            if level is not None:
                return None
        return None

    # --- callouts ---

    def _value(self, arg) -> int:
        if isinstance(arg, int):
            return arg
        return self.data.get(self.m.tags[arg], [0])[0]

    def callout(self, index: int, s: int):
        """Progress: True to go on, False to fail, ``_MISMATCH``."""
        c = self.m.callouts[index]
        name, args = c.name, c.args
        if name == "FAIL":
            return False
        if name == "MISMATCH":
            return _MISMATCH
        if name == "ERROR":
            if args[0] == -1:
                return _MISMATCH
            raise MatchError(f"Onig: Regex search error: callout error {args[0]}")
        if name == "SKIP":
            self.skip = s if self.skip is None else max(self.skip, s)
            return True
        if name == "CMP":
            a, op, b = self._value(args[0]), args[1], self._value(args[2])
            if op not in _COMPARISONS:
                raise MatchError("Onig: Regex search error: invalid callout arg")
            return _COMPARISONS[op](a, b)
        if name == "MAX":
            limit = self._value(args[0])
            mode = args[1]
            if mode not in ("X", "<", ">"):
                raise MatchError("Onig: Regex search error: invalid callout arg")
            slot = self.data.setdefault(index, [0])
            if mode != "<":
                if slot[0] >= limit:
                    return False
                slot[0] += 1
            return True
        if name in ("COUNT", "TOTAL_COUNT"):
            mode = args[0]
            if mode not in ("X", "<", ">"):
                raise MatchError("Onig: Regex search error: invalid callout arg")
            slot = self.data.setdefault(index, [0])
            if mode != "<":
                slot[0] += 1
            return True
        return True  # a code callout: no function is registered for it

    def retract(self, index: int) -> None:
        c = self.m.callouts[index]
        slot = self.data.setdefault(index, [0])
        mode = c.args[1] if c.name == "MAX" else c.args[0]
        if c.name == "MAX" and mode == "<":
            if slot[0] < self._value(c.args[0]):
                slot[0] += 1
        elif mode == "<":
            slot[0] += 1
        elif mode == "X":
            slot[0] -= 1


_MISMATCH = object()
_COMPARISONS = {"==": int.__eq__, "!=": int.__ne__, "<": int.__lt__, ">": int.__gt__,
                "<=": int.__le__, ">=": int.__ge__}


def _empty_round(groups: tuple, before: tuple, after: tuple, s: int) -> Optional[bool]:
    """Oniguruma's ``STACK_EMPTY_CHECK_MEM`` for a round that read nothing:
    True (the repeat ends), False (a group's capture was unset or not
    empty before: the repeat goes on) or None (it was empty elsewhere:
    the round fails)."""
    verdict: Optional[bool] = True
    for g in groups:
        if after[g] == before[g]:
            continue
        prev = before[g]
        if prev is None or prev[0] != prev[1]:
            return False
        if prev[1] != s:
            verdict = None
    return verdict


def _close(opens, g: int):
    """The start of the innermost open group ``g`` and the open groups
    without it."""
    head = []
    while opens is not None:
        (number, begin), rest = opens
        if number == g:
            for entry in reversed(head):
                rest = (entry, rest)
            return begin, rest
        head.append((number, begin))
        opens = rest
    raise AssertionError(g)


def _at_level(hist, numbers, level: int):
    """Oniguruma's ``backref_match_at_nested_level``: walking the history
    back, the last capture of one of ``numbers`` made ``level`` calls away
    (its end, then its start)."""
    depth, end = 0, None
    while hist is not None:
        event, hist = hist
        kind = event[0]
        if kind == "call":
            depth -= 1
        elif kind == "return":
            depth += 1
        elif depth == level:
            if kind == "end" and event[1] in numbers:
                end = event[2]
            elif kind == "start" and event[1] in numbers and end is not None:
                return event[2], end
    return None


@functools.lru_cache(maxsize=None)
def _utf8(ch: str) -> int:
    return len(ch.encode("utf-8", "surrogatepass"))


def _compare(text: str, begin: int, end: int, s: int, limit: int, icase: bool) -> Optional[int]:
    """The end of ``text[begin:end]`` read again at ``s``, or None; under
    ``(?i)`` Oniguruma's ``string_cmp_ic``: character by character,
    folded, over the same number of UTF-8 bytes."""
    if not icase:
        length = end - begin
        if s + length <= limit and text.startswith(text[begin:end], s):
            return s + length
        return None
    total = sum(_utf8(c) for c in text[begin:end])
    if sum(_utf8(c) for c in text[s:min(limit, s + total)]) < total:
        return None
    done1 = done2 = 0
    i, j = begin, s
    while i < end:
        if j >= limit or onig.fold(ord(text[i])) != onig.fold(ord(text[j])):
            return None
        done1 += _utf8(text[i])
        done2 += _utf8(text[j])
        i += 1
        j += 1
        if done2 >= total:
            return j if done1 >= total else None
    return j


# ---------------------------------------------------------------------------
# what a match must hold (the search skips what cannot start one)
# ---------------------------------------------------------------------------


def _first_set(tree) -> Optional[_Set]:
    """The characters a match can start with, or None (any, or empty)."""
    ranges = onig.first_chars(tree)
    return None if ranges is None else _Set(ranges)


def _required_text(tree) -> "tuple[str, ...]":
    """Literal runs every match holds (a text without one has no match)."""
    items = tree.items if isinstance(tree, onig.Seq) else [tree]
    out = []
    for item in items:
        if isinstance(item, onig.Group) and item.kind in ("cap", "nc", "sub", "atomic"):
            out.extend(_required_text(item.body))
        elif isinstance(item, onig.Text) and not item.icase and item.cps and min(item.cps) >= 0:
            out.append("".join(map(chr, item.cps)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def compile_matcher(pattern: str) -> Matcher:
    """``pattern`` for the matcher whatever ``onig.compile_expression``
    would route it to (the tests hold the matcher to the library on
    every construct this way)."""
    return Matcher(*onig.read_expression(pattern))
