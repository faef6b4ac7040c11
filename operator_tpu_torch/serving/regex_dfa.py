"""Byte-level regex -> DFA -> token transition table (guided_regex).

Port of ``operator_tpu/serving/regex_dfa.py`` (numpy only, copied as it
is; ``token_byte_table`` reads the port's tokenizers).  A small, self-contained regex compiler for constrained decoding:
Thompson NFA construction over BYTES, subset construction to a DFA, then
a vectorized closure over the tokenizer vocabulary so each DFA state
carries a token-level transition row (serving/guided.py table format —
the same stacked tables the decode block consumes for guided_choice).

Supported syntax (full-match semantics, byte alphabet):

- literals (non-ASCII via their UTF-8 bytes), ``\\`` escapes
- ``.`` (any byte except ``\\n``), classes ``[a-z]``/``[^...]`` with
  ranges, and the usual shorthands ``\\d \\D \\w \\W \\s \\S``
- grouping ``(...)``, alternation ``|``
- quantifiers ``* + ?`` and bounded ``{m}``/``{m,}``/``{m,n}`` (n <= 64)

Deliberately NOT supported (rejected with ValueError): backreferences,
lookaround, lazy/stacked quantifiers (constrained decoding is a language
filter; greedy/lazy is meaningless), alphanumeric escapes outside the
supported shorthands (word-boundary/hex/unicode escapes would silently
change meaning),
and interior anchors — a single leading ``^`` / trailing ``$`` is
accepted and ignored (patterns are implicitly anchored).

Dead-end elimination: DFA states from which no TOKEN sequence can reach
acceptance are pruned, so the sampler can never be steered into a state
whose row is all -inf (a pattern the tokenizer cannot realise raises).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MAX_REPEAT = 64


# --------------------------------------------------------------------------
# parsing -> NFA (Thompson construction)
# --------------------------------------------------------------------------


@dataclass
class _NfaState:
    #: byte-class edges: (256-bool mask, target state id)
    edges: list = field(default_factory=list)
    eps: list = field(default_factory=list)


class _Nfa:
    def __init__(self) -> None:
        self.states: list[_NfaState] = []

    def new_state(self) -> int:
        self.states.append(_NfaState())
        return len(self.states) - 1


def _class_mask(chars: str) -> np.ndarray:
    mask = np.zeros(256, bool)
    for ch in chars:
        mask[ord(ch)] = True
    return mask


_DIGIT = _class_mask("0123456789")
_WORD = _class_mask(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_SPACE = _class_mask(" \t\n\r\f\v")
_ANY = np.ones(256, bool)
_ANY[ord("\n")] = False

_ESCAPES = {
    "d": _DIGIT, "D": ~_DIGIT,
    "w": _WORD, "W": ~_WORD,
    "s": _SPACE, "S": ~_SPACE,
    "n": _class_mask("\n"), "t": _class_mask("\t"), "r": _class_mask("\r"),
}


class _Parser:
    """Recursive-descent: alt -> concat -> repeat -> atom."""

    def __init__(self, pattern: str) -> None:
        # full-match semantics: tolerate the habitual outer anchors
        if pattern.startswith("^"):
            pattern = pattern[1:]
        if pattern.endswith("$") and not pattern.endswith("\\$"):
            pattern = pattern[:-1]
        self.src = pattern
        self.pos = 0
        self.nfa = _Nfa()

    def fail(self, message: str) -> Exception:
        return ValueError(
            f"guided_regex: {message} at position {self.pos} in {self.src!r}"
        )

    def peek(self) -> Optional[str]:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def take(self) -> str:
        ch = self.src[self.pos]
        self.pos += 1
        return ch

    # fragments are (start, accept) state-id pairs
    def parse(self) -> tuple:
        fragment = self.alt()
        if self.pos != len(self.src):
            raise self.fail(f"unexpected {self.peek()!r}")
        return fragment

    def alt(self) -> tuple:
        branches = [self.concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.concat())
        if len(branches) == 1:
            return branches[0]
        start, accept = self.nfa.new_state(), self.nfa.new_state()
        for b_start, b_accept in branches:
            self.nfa.states[start].eps.append(b_start)
            self.nfa.states[b_accept].eps.append(accept)
        return start, accept

    def concat(self) -> tuple:
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.repeat())
        if not parts:  # empty branch: epsilon
            state = self.nfa.new_state()
            return state, state
        start, accept = parts[0]
        for nxt_start, nxt_accept in parts[1:]:
            self.nfa.states[accept].eps.append(nxt_start)
            accept = nxt_accept
        return start, accept

    def repeat(self) -> tuple:
        fragment = self.atom()
        ch = self.peek()
        if ch == "*":
            self.take()
            fragment = self._star(fragment)
        elif ch == "+":
            self.take()
            fragment = self._concat_pair(fragment, self._star(self._copy(fragment)))
        elif ch == "?":
            self.take()
            fragment = self._optional(fragment)
        elif ch == "{":
            fragment = self._bounded(fragment)
        else:
            return fragment
        if self.peek() in ("*", "+", "?", "{"):
            raise self.fail(
                "lazy/stacked quantifiers are not supported (group the "
                "inner quantifier explicitly if you mean it)"
            )
        return fragment

    def _bounded(self, fragment: tuple) -> tuple:
        self.take()  # '{'
        digits = ""
        while self.peek() and self.peek().isdigit():
            digits += self.take()
        if not digits:
            raise self.fail("malformed {m,n}")
        low = int(digits)
        high = low
        if self.peek() == ",":
            self.take()
            digits = ""
            while self.peek() and self.peek().isdigit():
                digits += self.take()
            high = int(digits) if digits else None
        if self.peek() != "}":
            raise self.fail("unterminated {m,n}")
        self.take()
        if high is not None and (high < low or high > MAX_REPEAT):
            raise self.fail(f"repeat bound must be <= {MAX_REPEAT} and >= the minimum")
        if low > MAX_REPEAT:
            raise self.fail(f"repeat bound must be <= {MAX_REPEAT}")
        parts = [self._copy(fragment) for _ in range(low)]
        if high is None:
            parts.append(self._star(self._copy(fragment)))
        else:
            parts.extend(
                self._optional(self._copy(fragment)) for _ in range(high - low)
            )
        if not parts:  # {0} / {0,0}
            state = self.nfa.new_state()
            return state, state
        out = parts[0]
        for part in parts[1:]:
            out = self._concat_pair(out, part)
        return out

    def _concat_pair(self, a: tuple, b: tuple) -> tuple:
        self.nfa.states[a[1]].eps.append(b[0])
        return a[0], b[1]

    def _star(self, fragment: tuple) -> tuple:
        start, accept = self.nfa.new_state(), self.nfa.new_state()
        f_start, f_accept = fragment
        self.nfa.states[start].eps += [f_start, accept]
        self.nfa.states[f_accept].eps += [f_start, accept]
        return start, accept

    def _optional(self, fragment: tuple) -> tuple:
        start, accept = self.nfa.new_state(), self.nfa.new_state()
        f_start, f_accept = fragment
        self.nfa.states[start].eps += [f_start, accept]
        self.nfa.states[f_accept].eps.append(accept)
        return start, accept

    def _copy(self, fragment: tuple) -> tuple:
        """Deep-copy a fragment's subgraph (for counted repeats / ``+``)."""
        start, accept = fragment
        reachable = set()
        stack = [start]
        while stack:
            state = stack.pop()
            if state in reachable:
                continue
            reachable.add(state)
            node = self.nfa.states[state]
            stack += [t for _, t in node.edges] + list(node.eps)
        mapping = {old: self.nfa.new_state() for old in reachable}
        for old in reachable:
            node = self.nfa.states[old]
            clone = self.nfa.states[mapping[old]]
            clone.edges = [(mask, mapping[t]) for mask, t in node.edges if t in mapping]
            clone.eps = [mapping[t] for t in node.eps if t in mapping]
        return mapping[start], mapping[accept]

    def atom(self) -> tuple:
        ch = self.peek()
        if ch is None:
            raise self.fail("unexpected end of pattern")
        if ch == "(":
            self.take()
            if self.peek() == "?":
                raise self.fail("(?...) groups are not supported")
            fragment = self.alt()
            if self.peek() != ")":
                raise self.fail("unbalanced parenthesis")
            self.take()
            return fragment
        if ch == "[":
            return self._fragment_for(self._char_class())
        if ch == ".":
            self.take()
            return self._fragment_for(_ANY.copy())
        if ch == "\\":
            self.take()
            return self._fragment_for(self._escape())
        if ch in "*+?{":
            raise self.fail(f"quantifier {ch!r} with nothing to repeat")
        if ch in ")|":
            raise self.fail(f"unexpected {ch!r}")
        if ch in "^$":
            raise self.fail(
                "interior anchors are not supported (patterns are "
                "implicitly anchored; escape a literal with \\)"
            )
        self.take()
        return self._bytes_fragment(ch.encode("utf-8"))

    def _escape(self) -> np.ndarray:
        if self.peek() is None:
            raise self.fail("dangling escape")
        ch = self.take()
        if ch in _ESCAPES:
            return _ESCAPES[ch].copy()
        if ch.isalnum():
            raise self.fail(
                f"unsupported escape \\{ch} (supported: "
                f"{' '.join(sorted(_ESCAPES))}; punctuation escapes literal)"
            )
        return _class_mask(ch)  # \. \[ \\ etc: the literal byte

    def _char_class(self) -> np.ndarray:
        self.take()  # '['
        negate = self.peek() == "^"
        if negate:
            self.take()
        mask = np.zeros(256, bool)
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise self.fail("unterminated character class")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                self.take()
                mask |= self._escape()
                continue
            self.take()
            lo = ch.encode("utf-8")
            if len(lo) != 1:
                raise self.fail("non-ASCII in character class")
            if self.peek() == "-" and self.pos + 1 < len(self.src) \
                    and self.src[self.pos + 1] != "]":
                self.take()
                hi = self.take().encode("utf-8")
                if len(hi) != 1 or hi[0] < lo[0]:
                    raise self.fail("bad character range")
                mask[lo[0]: hi[0] + 1] = True
            else:
                mask[lo[0]] = True
        return ~mask if negate else mask

    def _fragment_for(self, mask: np.ndarray) -> tuple:
        start, accept = self.nfa.new_state(), self.nfa.new_state()
        self.nfa.states[start].edges.append((mask, accept))
        return start, accept

    def _bytes_fragment(self, data: bytes) -> tuple:
        start = self.nfa.new_state()
        current = start
        for byte in data:
            nxt = self.nfa.new_state()
            mask = np.zeros(256, bool)
            mask[byte] = True
            self.nfa.states[current].edges.append((mask, nxt))
            current = nxt
        return start, current


# --------------------------------------------------------------------------
# NFA -> DFA (subset construction) over bytes
# --------------------------------------------------------------------------


def _compile_byte_dfa(pattern: str, max_states: int) -> tuple:
    """Returns (byte_transition [S, 256] int32 with -1, accepting [S] bool)."""
    parser = _Parser(pattern)
    start, accept = parser.parse()
    nfa = parser.nfa

    def closure(states: frozenset) -> frozenset:
        seen = set(states)
        stack = list(states)
        while stack:
            for target in nfa.states[stack.pop()].eps:
                if target not in seen:
                    seen.add(target)
                    stack.append(target)
        return frozenset(seen)

    start_set = closure(frozenset({start}))
    index = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    position = 0
    while position < len(order):
        current = order[position]
        position += 1
        # move table for all 256 bytes at once
        targets: list[set] = [set() for _ in range(256)]
        for state in current:
            for mask, target in nfa.states[state].edges:
                for byte in np.nonzero(mask)[0]:
                    targets[int(byte)].add(target)
        row = np.full(256, -1, np.int32)
        for byte, target_set in enumerate(targets):
            if not target_set:
                continue
            closed = closure(frozenset(target_set))
            if closed not in index:
                if len(order) >= max_states:
                    raise ValueError(
                        f"guided_regex pattern needs more than {max_states} "
                        f"DFA states; simplify the pattern"
                    )
                index[closed] = len(order)
                order.append(closed)
            row[byte] = index[closed]
        rows.append(row)
    byte_transition = np.stack(rows)
    accepting = np.array([accept in s for s in order], bool)
    return byte_transition, accepting


# --------------------------------------------------------------------------
# token closure
# --------------------------------------------------------------------------


def token_byte_table(tokenizer, vocab_size: int) -> "list[Optional[bytes]]":
    """bytes of each token id, or None for ids that must never be emitted
    (specials, out-of-tokenizer ids).  Supported for the in-tree
    tokenizers (``ByteTokenizer``, ``BPETokenizer``); ``HFTokenizer`` raises,
    as the JAX package's transformers-backed tokenizer does (its byte
    mapping is model-specific)."""
    table: list[Optional[bytes]] = [None] * vocab_size
    inner = getattr(tokenizer, "_bytes", None)
    if inner is not None:  # models/bpe.py BPETokenizer
        from ..models.bpe import NUM_SPECIALS

        for token in range(min(vocab_size, len(inner))):
            if token >= NUM_SPECIALS and inner[token]:
                table[token] = inner[token]
        return table
    specials = getattr(tokenizer, "SPECIALS", None)
    if specials is not None:  # models/tokenizer.py ByteTokenizer
        for token in range(specials, min(vocab_size, 256 + specials)):
            table[token] = bytes([token - specials])
        return table
    raise ValueError(
        "guided_regex needs a tokenizer with a known byte mapping "
        "(byte or builtin-bpe); guided_choice works with any tokenizer"
    )


def compile_regex_automaton(
    pattern: str, tokenizer, vocab_size: int, *, max_states: int
):
    """Token-level ``ChoiceAutomaton``-compatible table for ``pattern``.

    Vectorized closure: all (state, token) pairs advance byte-position by
    byte-position; tokens whose bytes dead-end map to -1.  Accepting
    states allow EOS (self-loop); states from which acceptance is
    UNREACHABLE via tokens are pruned so the sampler never faces an
    all-forbidden row.
    """
    from .guided import ChoiceAutomaton

    eos = tokenizer.eos_id
    if eos is None or not 0 <= int(eos) < vocab_size:
        raise ValueError("guided decoding needs a tokenizer with an eos id")
    byte_transition, accepting = _compile_byte_dfa(pattern, max_states)
    table = token_byte_table(tokenizer, vocab_size)
    num_states = byte_transition.shape[0]
    # the closure materialises [num_states, vocab] int32 grids; bound the
    # allocation so one pathological pattern can't eat gigabytes inside the
    # API's validation call
    if num_states * vocab_size > 16_000_000:
        raise ValueError(
            f"guided_regex pattern needs {num_states} DFA states x "
            f"{vocab_size} vocab — too large; simplify the pattern"
        )

    max_len = max((len(b) for b in table if b), default=0)
    if max_len == 0:
        raise ValueError("tokenizer exposes no usable tokens")
    token_bytes = np.zeros((vocab_size, max_len), np.int32)
    token_lengths = np.zeros(vocab_size, np.int32)
    for token, data in enumerate(table):
        if data:
            token_bytes[token, : len(data)] = np.frombuffer(data, np.uint8)
            token_lengths[token] = len(data)

    # advance every (state, token) pair through the byte DFA, vectorized
    # over the full [S, V] grid one byte position at a time
    current = np.broadcast_to(
        np.arange(num_states, dtype=np.int32)[:, None], (num_states, vocab_size)
    ).copy()
    for position in range(max_len):
        live = (token_lengths > position)[None, :] & (current >= 0)
        stepped = byte_transition[
            np.clip(current, 0, None), token_bytes[:, position][None, :]
        ]
        current = np.where(live, stepped, current)
    transition = np.where(token_lengths[None, :] > 0, current, -1).astype(np.int32)

    # EOS in accepting states (self-loop), forbidden elsewhere
    transition[:, eos] = np.where(accepting, np.arange(num_states, dtype=np.int32), -1)

    # prune states that cannot reach acceptance through TOKEN edges: a
    # token-level dead end would leave the sampler an all--inf row
    alive = accepting.copy()
    changed = True
    while changed:
        reaches = (transition >= 0) & alive[np.clip(transition, 0, None)]
        new_alive = alive | reaches.any(axis=1)
        changed = bool((new_alive != alive).any())
        alive = new_alive
    if not alive[0]:
        raise ValueError(
            f"guided_regex pattern {pattern!r} cannot be realised by this "
            f"tokenizer's vocabulary"
        )
    dead_target = (transition >= 0) & ~alive[np.clip(transition, 0, None)]
    transition[dead_target] = -1

    return ChoiceAutomaton(
        transition=transition, num_states=num_states, choices=("regex", pattern)
    )


__all__ = ["compile_regex_automaton", "token_byte_table", "MAX_REPEAT"]
