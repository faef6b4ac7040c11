"""Scheduler data types: row state and the per-step ragged wave plan.

The port's own copies of ``operator_tpu/serving/sched/types.py``
(``SchedConfig``, ``_Row``, ``RowWork``, ``StepPlan``, ``StepOutcome``),
less the prefix-cache fields: the block-hash prefix cache is not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..types import SamplingParams


@dataclass(frozen=True)
class SchedConfig:
    """Continuous-scheduler knobs.

    ``chunk`` bounds the prefill tokens ONE row may contribute to a step
    (Sarathi-style chunking).  ``token_budget`` is the flat token axis of
    the mixed step — decode rows take one token each off the top, prefill
    chunks fill the remainder; it must be >= ``max_slots`` so a full
    decode batch can never be starved (enforced at construction)."""

    chunk: int = 64
    token_budget: int = 0  # 0 = auto: max(chunk, max_slots)
    #: bounded in-flight dispatch queue (decode-ahead pipelining); 1 =
    #: synchronous commit
    pipeline_depth: int = 1
    #: prompt-lookup self-speculation (sched/draft.py)
    spec_decode: bool = False
    spec_lookup_k: int = 4


@dataclass
class _Row:
    """One live row of the running wave: a request at an arbitrary
    prefill-chunk or decode position."""

    req_id: int
    slot: int
    tokens: list[int]  # full (truncated) prompt token ids
    params: SamplingParams
    pages: list[int]
    pos: int = 0  # prompt tokens already written to the KV pages
    generated: list[int] = field(default_factory=list)
    submitted: float = 0.0  # perf_counter at submit
    started: float = 0.0  # perf_counter when the prompt completed
    prefill_ms: float = 0.0  # accumulated chunk compute share
    chunked: bool = False  # took more than one step of prefill
    queue_wait_ms: float = 0.0  # measured submit -> admission wall
    # --- decode-ahead pipelining: uncommitted in-flight deltas.  The
    # authoritative fields above advance only at commit; planning reads
    # the PREDICTED state (authoritative + pending). ---
    #: prompt tokens dispatched but not yet committed (prefill chunks)
    pend_pos: int = 0
    #: tokens sampled on device but not yet committed (chained decodes
    #: + a finishing chunk's first sample)
    pend_gen: int = 0
    #: a speculation verify round is in flight: the row must not be
    #: re-planned until its commit lands
    pend_spec: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def decoding(self) -> bool:
        return self.pos >= self.prompt_len

    @property
    def kv_len(self) -> int:
        """Tokens currently valid in this row's pages."""
        if not self.decoding:
            return self.pos
        # the freshest sampled token has not been written yet; every
        # earlier one has (prompt + generated[:-1])
        return self.prompt_len + max(0, len(self.generated) - 1)

    # -- predicted state (authoritative + in-flight deltas) ------------

    @property
    def pred_pos(self) -> int:
        return self.pos + self.pend_pos

    @property
    def pred_decoding(self) -> bool:
        return self.pred_pos >= self.prompt_len

    @property
    def pred_gen(self) -> int:
        return len(self.generated) + self.pend_gen

    @property
    def pred_kv(self) -> int:
        """Pages' valid length once every in-flight dispatch lands."""
        if not self.pred_decoding:
            return self.pred_pos
        return self.prompt_len + max(0, self.pred_gen - 1)


@dataclass
class RowWork:
    """One row's share of a step: ``count`` tokens starting at flat
    offset ``start``.  Positions are FROZEN at plan time (``pos0``)."""

    slot: int
    req_id: int
    start: int  # flat offset of the row's first token this step
    count: int
    kind: str  # "prefill" | "finish" | "decode" | "verify"
    #: absolute position of the row's first token this step
    pos0: int = 0
    #: draft tokens riding a verify row (count == 1 + spec_len)
    spec_len: int = 0
    drafts: tuple = ()
    #: the row's input token is the previous dispatch's on-device sample
    from_prev: bool = False


@dataclass
class StepPlan:
    """The ragged wave one dispatch serves; ``trace()`` is the stable
    serialisation the determinism tests compare."""

    work: list[RowWork] = field(default_factory=list)
    tokens_planned: int = 0
    decode_rows: int = 0
    prefill_rows: int = 0
    deferred_decode: int = 0  # decode-ready rows left out (stall signal)
    admitted: list[int] = field(default_factory=list)  # req ids admitted NOW

    def trace(self) -> tuple:
        return tuple(
            (w.slot, w.req_id, w.start, w.count, w.kind, w.pos0,
             w.spec_len, w.drafts, w.from_prev)
            for w in self.work
        )


@dataclass
class StepOutcome:
    """One finished request: the result (or the admission-time error)
    the engine resolves its future with."""

    req_id: int
    result: Optional[Any] = None  # GenerationResult
    error: Optional[BaseException] = None
