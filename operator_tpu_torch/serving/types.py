"""Serving data types shared by the engine, the scheduler and the server.

The port's own copies of ``operator_tpu/serving/types.py``:
``SamplingParams``, ``GenerationResult``, ``PageAllocator``, the two
admission formulas and the wave engine's bucket rule ``_bucket``.
``SamplingParams`` carries only the fields the continuous and wave paths
serve; LoRA adapters, guided decoding, deadlines, SLO
classes and trace tags come with the slices that port them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "GenerationResult",
    "OversizedRequest",
    "PageAllocator",
    "SamplingParams",
    "pages_needed",
    "prompt_budget",
]


@dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 256
    temperature: float = 0.3  # reference default, aiprovider-crd.yaml:56-58
    top_p: float = 0.95
    stop_on_eos: bool = True


@dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length"
    prefill_ms: float = 0.0
    #: host wall from the prompt's completion to the request's finish
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


def _bucket(n: int, floor: int, cap: int) -> int:
    """Smallest power-of-two >= n, clamped to [floor, cap]."""
    size = floor
    while size < n and size < cap:
        size *= 2
    return min(size, cap)


class OversizedRequest(ValueError):
    """A single request needs more KV pages than the whole cache holds."""


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
