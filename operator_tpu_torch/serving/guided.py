"""Guided (constrained) decoding: choice automata as device state.

Port of ``operator_tpu/serving/guided.py`` (numpy only, copied as it
is).  ``SamplingParams(guided_choice=(...))`` restricts a request's
output to one of the given strings.  The constraint is a token-trie
automaton whose transition table rides the wave engine's decode block
as DEVICE state: logits are masked and the automaton steps on the
device inside the block (``serving/programs.py``), so the block still
reads back once.

Mechanics:

- each choice is tokenized (its canonical encoding; no BOS) and inserted
  into a trie; ``transition[state, token]`` is the child state or -1
  (forbidden).  Completing a choice lands in a state where only EOS is
  allowed, so generation ends exactly at the choice boundary.
- automaton 0 is the IDENTITY (every token allowed, state stays 0):
  unconstrained slots ride the same program with zero effect.
- per-slot ``(automaton, state)`` vectors live on the device; the
  sampler masks ``logits`` with the gathered transition row and the
  sampled token indexes the next state.  The automata and state axes
  are padded to buckets, as in the JAX package.

``guided_regex`` rides the same machinery with a DFA in place of the
trie (serving/regex_dfa.py).  The engine enforces ``eos_id`` support at
SUBMIT time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.tokenizer import Tokenizer


@dataclass(frozen=True)
class ChoiceAutomaton:
    """Token-trie over a tuple of choice strings."""

    transition: np.ndarray  # [num_states, vocab] int32; -1 = forbidden
    num_states: int
    choices: tuple


def build_choice_automaton(
    choices: tuple, tokenizer: Tokenizer, vocab_size: int
) -> ChoiceAutomaton:
    """Trie over each choice's canonical token sequence.

    State 0 is the start.  After a full choice only EOS is allowed
    (self-looping, so pipelined junk steps past EOS stay trapped).
    """
    if not choices:
        raise ValueError("guided_choice needs at least one choice")
    eos = tokenizer.eos_id
    if eos is None or not 0 <= int(eos) < vocab_size:
        raise ValueError("guided decoding needs a tokenizer with an eos id")
    paths = []
    for choice in choices:
        ids = tokenizer.encode(choice, add_bos=False)
        if not ids:
            raise ValueError(f"choice {choice!r} tokenizes to nothing")
        if any(not 0 <= t < vocab_size for t in ids):
            raise ValueError(f"choice {choice!r} has out-of-vocab tokens")
        paths.append(ids)

    # trie construction over dicts, then flattened to the table
    nodes: list[dict] = [{}]  # state -> {token: child_state}
    accept: list[bool] = [False]
    for ids in paths:
        state = 0
        for token in ids:
            child = nodes[state].get(token)
            if child is None:
                nodes.append({})
                accept.append(False)
                child = len(nodes) - 1
                nodes[state][token] = child
            state = child
        accept[state] = True

    num_states = len(nodes)
    # same product cap as the regex path (regex_dfa.py): the table is
    # [num_states, vocab] int32 and gets padded/stacked again by the
    # engine — an unbounded choice set against a 150k vocab would
    # allocate gigabytes on the host and upload them to device
    if num_states * vocab_size > 16_000_000:
        raise ValueError(
            f"guided_choice automaton table would be {num_states} states x "
            f"{vocab_size} vocab = {num_states * vocab_size} entries, above "
            f"the 16M cap — use fewer or shorter choices"
        )
    transition = np.full((num_states, vocab_size), -1, np.int32)
    for state, edges in enumerate(nodes):
        for token, child in edges.items():
            transition[state, token] = child
        if accept[state]:
            transition[state, eos] = state  # EOS-only, self-looping
    return ChoiceAutomaton(
        transition=transition, num_states=num_states, choices=tuple(choices)
    )


def identity_automaton(vocab_size: int) -> ChoiceAutomaton:
    """Automaton 0: everything allowed, state stays 0 (unconstrained)."""
    return ChoiceAutomaton(
        transition=np.zeros((1, vocab_size), np.int32),
        num_states=1,
        choices=(),
    )


def stack_automata(
    automata: list, vocab_size: int, *, state_pad: int
) -> np.ndarray:
    """[n_automata, state_pad, vocab] with -1 padding rows (unreachable)."""
    out = np.full((len(automata), state_pad, vocab_size), -1, np.int32)
    for i, automaton in enumerate(automata):
        out[i, : automaton.num_states] = automaton.transition
    return out


__all__ = [
    "ChoiceAutomaton",
    "build_choice_automaton",
    "identity_automaton",
    "stack_automata",
]
