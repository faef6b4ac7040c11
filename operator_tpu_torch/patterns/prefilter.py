"""Literal prefilter: one scan decides which (pattern, line) pairs
deserve a real regex check.

Copy of ``operator_tpu/patterns/prefilter.py``.  The port's scanner
(``operator_tpu_torch/native``) builds the checkout's
``native/logscan.cpp`` (Aho-Corasick) with ``g++`` on first use, as the
JAX package does, and falls back to the pure-Python sweep without a
compiler; which one ran changes speed only, never results.

The matcher's hot loop is O(patterns × lines) Python regex calls
(matcher.py _primary_hits) — the analysis-latency bearing stage between
kube watch and the TPU programs.  Most library patterns anchor on a
distinctive literal ("OutOfMemoryError", "CrashLoopBackOff", "exit code"):
scanning the whole log ONCE for all such literals (native/logscan.cpp
Aho-Corasick via operator_tpu_torch.native) yields candidate lines per pattern,
and only those lines see the full regex.  Patterns whose regex has no
required literal (alternations, classes, quantifiers) are conservatively
left on the full scan path — the prefilter NEVER changes results, only
skips work (guaranteed by test_prefilter.py's equivalence tests).
"""

from __future__ import annotations

import logging
from bisect import bisect_left
from typing import Optional

from ..native import MultiPatternScanner
from ..schema.patterns import Pattern

log = logging.getLogger(__name__)

MIN_LITERAL_LEN = 4

#: zero-width / class escapes — not literal characters
_NONLITERAL_ESCAPES = set("dDwWsSbBAZ")
#: single-char escapes that decode to a real in-line character
_CHAR_ESCAPES = {"t": "\t", "f": "\f", "v": "\v", "a": "\a"}
#: escapes for characters that never occur inside a splitlines() line —
#: a per-line match can't contain them, so they just close the run
_LINEBREAK_ESCAPES = set("nr")
#: numeric / named escapes (\xHH, \uHHHH, \UHHHHHHHH, \N{...}) — bail
#: rather than guess the decoded character
_OPAQUE_ESCAPES = set("xuUN")
_QUANTIFIER_START = set("*+?{")


def _skip_group(regex: str, i: int) -> Optional[int]:
    """i points at '('; returns index past the matching ')' or None."""
    depth = 0
    while i < len(regex):
        ch = regex[i]
        if ch == "\\":
            i += 2
            continue
        if ch == "[":
            end = _skip_class(regex, i)
            if end is None:
                return None
            i = end
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return i + 1
        i += 1
    return None


def _skip_class(regex: str, i: int) -> Optional[int]:
    """i points at '['; returns index past the matching ']' or None."""
    i += 1
    if i < len(regex) and regex[i] == "^":
        i += 1
    if i < len(regex) and regex[i] == "]":  # leading ] is literal
        i += 1
    while i < len(regex):
        if regex[i] == "\\":
            i += 2
            continue
        if regex[i] == "]":
            return i + 1
        i += 1
    return None


def _skip_quantifier(regex: str, i: int) -> Optional[int]:
    """Skip a quantifier at i (if any); None on an unterminated '{'."""
    if i < len(regex) and regex[i] in "*+?":
        i += 1
    elif i < len(regex) and regex[i] == "{":
        end = regex.find("}", i)
        if end < 0:
            return None
        i = end + 1
    else:
        return i
    if i < len(regex) and regex[i] == "?":  # non-greedy marker
        i += 1
    return i


def _split_alternation(regex: str) -> Optional[list[str]]:
    """Split on top-level '|' (respecting groups/classes/escapes)."""
    branches: list[str] = []
    start = 0
    i = 0
    while i < len(regex):
        ch = regex[i]
        if ch == "\\":
            i += 2
            continue
        if ch == "(":
            end = _skip_group(regex, i)
            if end is None:
                return None
            i = end
            continue
        if ch == "[":
            end = _skip_class(regex, i)
            if end is None:
                return None
            i = end
            continue
        if ch == "|":
            branches.append(regex[start:i])
            start = i + 1
        i += 1
    branches.append(regex[start:])
    return branches


def _branch_runs(branch: str) -> Optional[list[str]]:
    """Maximal literal runs every match of ``branch`` must contain.

    A quantified element is dropped from its run (may repeat/vanish);
    groups and classes close the current run but what's OUTSIDE them stays
    required.  None -> unanalyzable (lookarounds, backrefs, bad syntax)."""
    runs: list[str] = []
    current: list[str] = []

    def close() -> None:
        if current:
            runs.append("".join(current))
            current.clear()

    i = 0
    while i < len(branch):
        ch = branch[i]
        if ch == "\\":
            if i + 1 >= len(branch):
                return None
            escaped = branch[i + 1]
            if escaped.isdigit():  # backreference / octal
                return None
            if escaped in _OPAQUE_ESCAPES:  # \xHH, \uHHHH, \N{...}: don't guess
                return None
            after = i + 2
            if escaped in _NONLITERAL_ESCAPES or escaped in _LINEBREAK_ESCAPES:
                close()
                end = _skip_quantifier(branch, after)
                if end is None:
                    return None
                i = end
                continue
            literal_char = _CHAR_ESCAPES.get(escaped)
            if literal_char is None:
                if escaped.isalnum():  # unrecognized alphanumeric escape
                    return None
                literal_char = escaped  # escaped punctuation: \. \( \\ ...
            end = _skip_quantifier(branch, after)
            if end is None:
                return None
            if end != after:  # quantified literal: can't require it
                close()
            else:
                current.append(literal_char)
            i = end
            continue
        if ch == "(":
            if branch.startswith("(?", i) and not branch.startswith("(?:", i):
                return None  # lookaround / inline flag mid-pattern
            end = _skip_group(branch, i)
            if end is None:
                return None
            close()
            end = _skip_quantifier(branch, end)
            if end is None:
                return None
            i = end
            continue
        if ch == "[":
            end = _skip_class(branch, i)
            if end is None:
                return None
            close()
            end = _skip_quantifier(branch, end)
            if end is None:
                return None
            i = end
            continue
        if ch == ".":
            close()
            end = _skip_quantifier(branch, i + 1)
            if end is None:
                return None
            i = end
            continue
        if ch in "^$":
            close()
            i += 1
            continue
        if ch in _QUANTIFIER_START:
            # quantifier applying to the previous literal char: that char
            # may repeat or vanish — drop it and close the run
            if current:
                current.pop()
            close()
            end = _skip_quantifier(branch, i)
            if end is None or end == i:
                return None
            i = end
            continue
        if ch == "|":  # should have been split already
            return None
        # literal char — but only required if not quantified
        nxt = i + 1
        if nxt < len(branch) and branch[nxt] in _QUANTIFIER_START:
            end = _skip_quantifier(branch, nxt)
            if end is None:
                return None
            close()
            i = end
            continue
        current.append(ch)
        i += 1
    close()
    return runs


def _unwrap(regex: str) -> str:
    """Strip a group that wraps the entire pattern: ``(a|b)`` -> ``a|b``."""
    while regex.startswith("(") and not (
        regex.startswith("(?") and not regex.startswith("(?:")
    ):
        end = _skip_group(regex, 0)
        if end != len(regex):
            return regex
        regex = regex[3:-1] if regex.startswith("(?:") else regex[1:-1]
    return regex


def required_literals(regex: str) -> Optional[tuple[list[str], bool]]:
    """(literals, case_insensitive) such that every match of ``regex``
    contains at least ONE of the literals; None if no such set is provable.

    ``(?i)(OOMKilled|Out of memory|oom-kill)`` -> those three, ci;
    ``java\\.lang\\.OutOfMemoryError(: .*)?`` -> the class name, cs."""
    case_insensitive = False
    if regex.startswith("(?i)"):
        case_insensitive = True
        regex = regex[4:]
    branches = _split_alternation(_unwrap(regex))
    if branches is None:
        return None
    literals: list[str] = []
    for branch in branches:
        runs = _branch_runs(branch)
        if runs is None:
            return None
        best = max((r for r in runs if len(r) >= MIN_LITERAL_LEN), key=len, default=None)
        if best is None:
            return None  # a match could ride this branch with no literal
        literals.append(best.lower() if case_insensitive else best)
    return literals, case_insensitive


def literals_for_pattern(pattern: Pattern) -> Optional[tuple[list[str], bool]]:
    """(literals, case_insensitive) guaranteeing: the pattern can only fire
    on a line containing >=1 of the literals.  None -> full scan."""
    primary = pattern.primary_pattern
    if primary is None:
        return None
    if primary.regex:
        return required_literals(primary.regex)
    if primary.keywords:
        # every keyword must appear; anchor on the longest (rarest) one
        longest = max(primary.keywords, key=len)
        if len(longest) >= MIN_LITERAL_LEN:
            return [longest.lower()], True
        return None
    return None


class LiteralPrefilter:
    """Built per pattern-set (engine reload); applied per failure log."""

    def __init__(self, patterns: list[Pattern]) -> None:
        self.full_scan_ids: set[str] = set()
        cs_literals: list[bytes] = []
        ci_literals: list[bytes] = []
        self._cs_owner: list[str] = []  # literal idx -> pattern id
        self._ci_owner: list[str] = []
        for pattern in patterns:
            anchored = literals_for_pattern(pattern)
            if anchored is None:
                self.full_scan_ids.add(pattern.id)
                continue
            literals, case_insensitive = anchored
            if case_insensitive and not all(lit.isascii() for lit in literals):
                # the ci scan lowercases BYTES (ASCII-only) but literals are
                # lowercased as str (full Unicode); for non-ASCII letters the
                # two disagree and the literal may silently never be found —
                # conservative: full scan for the whole pattern
                self.full_scan_ids.add(pattern.id)
                continue
            for literal in literals:
                if case_insensitive:
                    ci_literals.append(literal.encode("utf-8", "surrogateescape"))
                    self._ci_owner.append(pattern.id)
                else:
                    cs_literals.append(literal.encode("utf-8", "surrogateescape"))
                    self._cs_owner.append(pattern.id)
        self._cs = MultiPatternScanner(cs_literals) if cs_literals else None
        self._ci = MultiPatternScanner(ci_literals) if ci_literals else None
        self.native = bool(
            (self._cs and self._cs.native) or (self._ci and self._ci.native)
        )
        self.num_anchored = len(patterns) - len(self.full_scan_ids)

    def candidate_lines(self, lines: list[str]) -> dict[str, set[int]]:
        """pattern id -> line numbers that may match.  Patterns in
        ``full_scan_ids`` are absent — callers scan those fully."""
        import numpy as np

        text = "\n".join(lines).encode("utf-8", "surrogateescape")
        # vectorised byte-offset -> line-number mapping
        newline_at = np.flatnonzero(np.frombuffer(text, np.uint8) == 0x0A)
        starts = np.concatenate([[0], newline_at + 1])

        candidates: dict[str, set[int]] = {}

        def collect(scanner, owners, buf: bytes) -> None:
            ids, end_offsets = scanner.scan_arrays(buf)
            if len(ids) == 0:
                return
            line_numbers = np.searchsorted(starts, end_offsets, side="right") - 1
            for literal_id, line_number in zip(ids.tolist(), line_numbers.tolist()):
                candidates.setdefault(owners[literal_id], set()).add(line_number)

        if self._cs is not None:
            collect(self._cs, self._cs_owner, text)
        if self._ci is not None:
            collect(self._ci, self._ci_owner, text.lower())
        return candidates
