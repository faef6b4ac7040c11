"""Serving data types shared by the engine, the scheduler and the server.

The port's own copies of ``operator_tpu/serving/types.py``:
``SamplingParams``, ``GenerationResult``, ``PageAllocator``, the two
admission formulas and the wave engine's bucket rule ``_bucket``.
``SamplingParams`` carries the reference's fields; ``adapter``,
``guided_choice`` and ``guided_regex`` are served by the wave engine and
refused by the continuous scheduler, as in the reference.
``DeadlineExceeded`` and
``ShedLowValue`` are the deadline policy's and the overload ladder's
terminal errors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "DeadlineExceeded",
    "GenerationResult",
    "OversizedRequest",
    "PageAllocator",
    "SamplingParams",
    "ShedLowValue",
    "pages_needed",
    "prompt_budget",
]


@dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 256
    temperature: float = 0.3  # reference default, aiprovider-crd.yaml:56-58
    top_p: float = 0.95
    stop_on_eos: bool = True
    #: multi-LoRA: a registered adapter name (None = base model)
    adapter: Optional[str] = None
    #: guided decoding: one of these strings, or a full match of the regex
    guided_choice: Optional[tuple] = None
    guided_regex: Optional[str] = None
    #: absolute ``time.monotonic()`` deadline (``utils/deadline.py``).
    #: Admission rejects a request whose decode estimate cannot fit the
    #: residue, or clamps ``max_tokens`` to what does fit
    #: (``admission.deadline_policy``); an entry that expires while queued
    #: fails with :class:`DeadlineExceeded`.  None = no budget.
    deadline: Optional[float] = None
    #: set by admission when max_tokens was clamped to fit the deadline —
    #: the finish reason then reads "deadline" instead of "length"
    deadline_clamped: bool = False
    #: set when the overload ladder truncated ``max_tokens`` under
    #: pressure: the finish reason then reads "degraded"
    degraded: bool = False
    #: recall-hit probability; rides into the request's overload value
    #: (``router/value.py``)
    recall_p: float = 0.0
    #: trace id of the request's analysis (None = untraced); the overload
    #: ladder's decision log keys on it
    trace_tag: Optional[str] = None
    #: SLO class the overload ladder values the request under (None =
    #: the default class)
    slo_class: Optional[str] = None


@dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "deadline" (budget-clamped) | "degraded" (overload-truncated)
    prefill_ms: float = 0.0
    #: decode wall derived from the step clock (``obs/steptrace.py``): the
    #: cumulative wall of the decode-bearing steps this request lived
    #: through
    decode_ms: float = 0.0
    #: submit -> admission wall
    queue_wait_ms: float = 0.0

    @property
    def total_ms(self) -> float:
        return self.prefill_ms + self.decode_ms


@dataclass
class _Slot:
    active: bool = False
    prompt_len: int = 0
    params: SamplingParams = field(default_factory=SamplingParams)
    pages: list[int] = field(default_factory=list)
    # the wave engine's per-slot generation state (the continuous
    # scheduler keeps its own on ``sched.types._Row``)
    generated: list[int] = field(default_factory=list)
    started: float = 0.0
    prefill_ms: float = 0.0
    #: step-clock decode cumulative when the slot went live
    decode_cum0: float = 0.0


@dataclass
class _PrefillJob:
    """An in-progress chunked prefill (``Generator.prefill_chunk``).

    The device state (the bucket's mini cache and the running last-token
    logits) is the generator's buffer pair for the job's ``(n_pad,
    t_pad)``, written in place chunk by chunk; the host arrays describe
    the admitted wave as the one-shot path's do."""

    key: tuple  # (n_pad, t_pad)
    ids: Any  # [n_pad, t_pad] device tokens (each chunk is a view)
    offsets: Any  # [n_chunks] device chunk starts (each chunk's offset)
    lengths_np: Any
    lengths: Any  # device
    temp: Any
    top_p: Any
    slot_ids_np: Any  # padded rows duplicate row 0
    taken: list
    params_list: list
    page_grants: list
    adapter_idx: Any  # device or None
    mini: Any  # KVCache carry
    last_logits: Any  # [n_pad, vocab] carry
    written: int
    chunk_ms: float = 0.0  # accumulated chunk time (not the interleaved wall)


def _bucket(n: int, floor: int, cap: int) -> int:
    """Smallest power-of-two >= n, clamped to [floor, cap]."""
    size = floor
    while size < n and size < cap:
        size *= 2
    return min(size, cap)


class OversizedRequest(ValueError):
    """A single request needs more KV pages than the whole cache holds."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget cannot fit even one decoded token
    (rejected at submit), or expired while the request was queued."""


class ShedLowValue(RuntimeError):
    """The overload ladder shed this request: under storm its value score
    (router/value.py) fell below the rising cutoff and its SLO class was
    not protected — shed-lowest-value-first, after degradation already
    fired."""


def prompt_budget(max_seq: int, max_tokens: int) -> int:
    """Prompt-token budget for truncation: leave room for at least one
    generated token, and never let the generation reservation eat more
    than half the sequence."""
    return max_seq - max(1, min(max_tokens, max_seq // 2))


def pages_needed(
    prompt_tokens: int, max_tokens: int, max_seq: int, page_size: int
) -> int:
    """Worst-case KV pages a request needs (prompt + full generation,
    clamped to the sequence cap) — granted up front so the page table
    stays static for the row's lifetime."""
    total = min(prompt_tokens + max_tokens, max_seq)
    return -(-total // page_size)


class PageAllocator:
    """Host-side free list for the paged KV cache (ops/paged_attention.py).

    Page 0 is reserved as the trash page: padding tokens and released
    slots write there, so a page handed to a live sequence is never
    touched by anyone else.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least one real page beyond the trash page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields low ids first

    @property
    def available(self) -> int:
        return len(self._free)

    def allocate(self, count: int) -> list[int]:
        if count > len(self._free):
            raise MemoryError(f"KV pages exhausted: want {count}, have {len(self._free)}")
        return [self._free.pop() for _ in range(count)]

    def release(self, pages: list[int]) -> None:
        self._free.extend(pages)
