"""The port's serving engine: a paged generator and its worker thread.

``Generator`` is the counterpart of the paged, continuous-mode part of
``operator_tpu/serving/engine.py:BatchedGenerator``: it holds the
parameters, the ``PagedKVCache`` (worst-case sizing by default,
``max_slots * pages_per_seq + 1`` pages with page 0 the trash page), the
page allocator, the slot table and the sampling ``torch.Generator`` —
everything the continuous scheduler (``sched/scheduler.py``) reads.

``ServingEngine`` runs that scheduler on ONE worker thread: callers on
any thread ``submit(prompt, params)`` and get a
``concurrent.futures.Future``; the worker admits queued submissions at
every step boundary (token-level admission), steps the scheduler and
resolves futures as rows finish.  All device work happens on the worker.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
from typing import Any, Optional, Sequence, Union

import torch

from ..models.configs import ModelConfig
from ..ops.paged_attention import PagedKVCache
from ..utils.device import resolve_device
from .sampling import SAMPLE_TOP_K
from .types import GenerationResult, PageAllocator, SamplingParams, _Slot

log = logging.getLogger(__name__)

__all__ = ["Generator", "ServingEngine"]


class Generator:
    """Slot-based paged generation state over one shared KV cache.

    Not thread-safe by design: the :class:`ServingEngine` serialises all
    calls on its one worker thread.  ``params`` must already live on
    ``device``."""

    def __init__(
        self,
        params: Any,
        config: ModelConfig,
        tokenizer: Any,
        *,
        max_slots: int = 8,
        max_seq: Optional[int] = None,
        page_size: int = 64,
        kv_pages: Optional[int] = None,
        cache_dtype: Optional[torch.dtype] = None,
        sample_top_k: Optional[int] = None,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq = min(max_seq or config.max_seq_len, config.max_seq_len)
        self.page_size = page_size
        self.pages_per_seq = -(-self.max_seq // page_size)
        self.sample_top_k = sample_top_k or SAMPLE_TOP_K
        self.cache_dtype = cache_dtype or torch.bfloat16
        num_pages = kv_pages or (max_slots * self.pages_per_seq + 1)
        self.allocator = PageAllocator(num_pages)
        self.paged_cache = PagedKVCache.create(
            config.num_layers, num_pages, page_size, config.num_kv_heads,
            config.head_dim, max_slots, self.pages_per_seq,
            dtype=self.cache_dtype, device=self.device,
        )
        self.slots: list[_Slot] = [_Slot() for _ in range(max_slots)]
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)

    def free_slots(self) -> list[int]:
        return [i for i, slot in enumerate(self.slots) if not slot.active]

    @property
    def num_active(self) -> int:
        return sum(1 for slot in self.slots if slot.active)

    def _truncate_prompt(self, ids: list, budget: int) -> list:
        """Fit ``ids`` into ``budget`` tokens, keeping the TAIL (failure
        evidence concentrates there).  The JAX generator keeps a registered
        shared prefix as the head; the port registers none yet."""
        if len(ids) <= budget:
            return ids
        return ids[-budget:]


class ServingEngine:
    """Thread front: submissions -> the scheduler's loop -> futures."""

    def __init__(self, generator: Generator, scheduler: Any) -> None:
        self.generator = generator
        self.scheduler = scheduler
        self._submissions: "queue.Queue[tuple]" = queue.Queue()
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------

    def warmup(self) -> None:
        """Run one empty wave (builds the kernels, warms the step) before
        serving; call before the first submit."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("warmup must run before the engine starts")
            self.scheduler.precompile()

    def start(self) -> None:
        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("serving engine is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="torch-decode", daemon=True
                )
                self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker and fail every request still outstanding."""
        self._closed.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                log.warning("serving worker did not stop within %.0fs", timeout)
        self._fail_outstanding(RuntimeError("serving engine closed"))

    # -- submit side ---------------------------------------------------

    def submit(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> "concurrent.futures.Future[GenerationResult]":
        if self._closed.is_set():
            raise RuntimeError("serving engine is closed")
        if self._error is not None:
            raise RuntimeError("serving engine loop died") from self._error
        future: concurrent.futures.Future = concurrent.futures.Future()
        self._submissions.put(
            (prompt, params or SamplingParams(), time.perf_counter(), future)
        )
        if self._error is not None:
            # the worker died between the check above and the put: its
            # drain may have missed this submission
            self._fail_outstanding(RuntimeError("serving engine loop died"))
            return future
        self.start()
        return future

    def generate(
        self, prompts: Sequence[str], params: Optional[SamplingParams] = None
    ) -> list[GenerationResult]:
        """Submit every prompt (they co-batch) and wait for all results."""
        futures = [self.submit(prompt, params) for prompt in prompts]
        return [future.result() for future in futures]

    def load_report(self) -> dict:
        """Queue depth and in-flight rows for ``/healthz`` (the JAX
        server's ``load`` field names)."""
        sched = self.scheduler
        return {
            "queueDepth": self._submissions.qsize() + sched.queue_depth,
            "inflight": sched.num_active,
            "gaveUp": self._error is not None,
            "steps": sched.steps,
            "occupancy": (
                round(sched.occupancy_sum / sched.steps, 6) if sched.steps else None
            ),
        }

    # -- the worker ----------------------------------------------------

    def _admit_submissions(self, block: bool) -> None:
        try:
            item = self._submissions.get(timeout=0.05) if block else (
                self._submissions.get_nowait()
            )
        except queue.Empty:
            return
        while True:
            prompt, params, submitted, future = item
            if future.set_running_or_notify_cancel():
                try:
                    req_id = self.scheduler.enqueue(prompt, params, submitted=submitted)
                except (ValueError, MemoryError) as exc:  # per-request verdict
                    future.set_exception(exc)
                else:
                    self._pending[req_id] = future
            try:
                item = self._submissions.get_nowait()
            except queue.Empty:
                return

    def _run(self) -> None:
        sched = self.scheduler
        try:
            while not self._closed.is_set():
                self._admit_submissions(block=sched.total_work == 0)
                if not sched.total_work:
                    continue
                for outcome in sched.step():
                    future = self._pending.pop(outcome.req_id, None)
                    if future is None:
                        continue
                    if outcome.error is not None:
                        future.set_exception(outcome.error)
                    else:
                        future.set_result(outcome.result)
        except Exception as exc:  # noqa: BLE001 - the loop's boundary: fail loudly
            log.exception("serving engine loop died")
            self._error = exc
            self._fail_outstanding(exc)

    def _fail_outstanding(self, exc: BaseException) -> None:
        for future in self._pending.values():
            if not future.done():
                future.set_exception(exc)
        self._pending.clear()
        while True:
            try:
                *_, future = self._submissions.get_nowait()
            except queue.Empty:
                break
            if future.set_running_or_notify_cancel():
                future.set_exception(exc)
