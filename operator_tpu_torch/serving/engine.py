"""The port's serving engine: a paged generator and its worker thread.

``Generator`` is the counterpart of the paged part of
``operator_tpu/serving/engine.py:BatchedGenerator``: it holds the
parameters, the ``PagedKVCache`` (worst-case sizing by default,
``max_slots * pages_per_seq + 1`` pages with page 0 the trash page), the
page allocator, the slot table and the sampling ``torch.Generator`` —
everything the continuous scheduler (``sched/scheduler.py``) reads — and
runs the phase-separated WAVE engine itself: batched admission with one
prefill per wave (``admission.py``), then decode in blocks of
``decode_block`` chained steps (``programs.py``) with up to
``pipeline_depth - 1`` blocks in flight while the host processes older
tokens.  Per-slot epochs keep a block dispatched before a slot was
recycled from crediting its tokens to the new sequence.

Both loops record each step into the generator's step clock
(``serving/perf.py:StepClock``; ``step_clock.summary()`` is the stall
attribution and the measured MFU against the H100's peak) and its
``metrics`` registry (``utils/timing.py``), and share the deadline policy
(``admission.py:deadline_policy`` on the injectable ``_clock``).

``ServingEngine`` runs one of the two loops on ONE worker thread: callers
on any thread ``submit(prompt, params, priority=...)`` and get a
``concurrent.futures.Future``; on an event loop, ``await
engine.generate(prompt, params, on_partial=..., priority=...,
resume_tokens=...)`` (the reference's coroutine, which the provider and
the HTTP server await: ``on_partial`` receives each step's
generated-so-far ids on the caller's loop, cancelling the coroutine
releases the request's slot and pages at the next step, and
``resume_tokens`` re-prefills a failed-over stream's tokens);
``generate_batch(prompts)`` submits a list and waits.  ``priority``
orders admission only (higher first, FIFO within a class).
``load_report()`` is the reference's ``ReplicaLoad`` that ``/healthz``
serves and the router reads.  With a scheduler the worker admits queued
submissions at every step boundary (token-level admission) and steps the
scheduler; without one it runs the wave loop (``operator_tpu/serving/
engine.py:_serve``): admit what fits into free slots and pages, requeue
the rest, then ``generator.step()``.  All device work happens on the
worker.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import itertools
import logging
import queue
import threading
import time
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.quant import is_quantized
from ..obs import span as obs_span
from ..obs.sloledger import SLOBoard
from ..ops.paged_attention import PagedKVCache
from ..router.health import ReplicaLoad
from ..utils.device import resolve_device
from ..utils.timing import MetricsRegistry
from .admission import AdmissionMixin
from .perf import StepClock, flops_per_token, peak_tflops
from .programs import ProgramBuilderMixin
from .sampling import SAMPLE_TOP_K
from .types import (
    DeadlineExceeded,
    GenerationResult,
    OversizedRequest,
    PageAllocator,
    SamplingParams,
    ShedLowValue,
    _Slot,
)

log = logging.getLogger(__name__)

__all__ = ["Generator", "ServingEngine"]

_NOT_PORTED_GUIDED = (
    "guided decoding and LoRA adapters are not ported to operator_tpu_torch "
    "yet (ROADMAP.md Queue 1 item 9)"
)


def _params_dtype_name(params: Any) -> str:
    """The serving dtype's name for the step clock's peak: ``int8`` for
    quantized weights, else the embedding's dtype."""
    if is_quantized(params):
        return "int8"
    return str(params["embed"].dtype).replace("torch.", "")


class Generator(AdmissionMixin, ProgramBuilderMixin):
    """Slot-based paged generation state over one shared KV cache, and
    the wave engine over it (``admit`` + ``step``).

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
        decode_block: int = 1,
        pipeline_depth: int = 1,
        seed: int = 0,
        device: Union[str, torch.device, None] = None,
        metrics: Optional[MetricsRegistry] = None,
        roofline_token_s: Optional[float] = None,
        step_ring_capacity: Optional[int] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq = min(max_seq or config.max_seq_len, config.max_seq_len)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # the step clock: a bounded ring of per-step host-gap/device/
        # sample-transfer records with the analytic flops per token, so
        # every decode-bearing step carries its MFU (STEP_RING_CAPACITY)
        serving_dtype = _params_dtype_name(params)
        self.step_clock = StepClock(
            capacity=step_ring_capacity,
            flops_per_token=flops_per_token(config, serving_dtype),
            peak_tflops=peak_tflops(serving_dtype),
            max_slots=max_slots,
            metrics=self.metrics,
        )
        # deadline budgets (admission.deadline_policy): per-token decode
        # estimate before any step has been measured; the clock is an
        # attribute so tests can inject a fake one
        self.roofline_token_s = roofline_token_s
        self._clock = time.monotonic
        #: value-aware overload ladder (router/value.py OverloadPolicy):
        #: when a caller wires one, deadline_policy degrades/sheds by value
        #: under pressure; None = no overload control
        self.overload_policy = None
        #: opt-in chaos seam (utils/faultinject.py): consulted per step()
        #: round, on the wave loop and the continuous scheduler alike —
        #: stalls (a sleep action; the worker thread, never the event
        #: loop) and simulated device errors
        self.fault_plan = None
        self.page_size = page_size
        self.pages_per_seq = -(-self.max_seq // page_size)
        self.sample_top_k = sample_top_k or SAMPLE_TOP_K
        self.cache_dtype = cache_dtype or torch.bfloat16
        num_pages = kv_pages or (max_slots * self.pages_per_seq + 1)
        self.allocator = PageAllocator(num_pages)
        # wave decode: blocks of K chained steps per host round trip, with
        # up to pipeline_depth - 1 blocks in flight; a finished slot may
        # decode that many junk blocks into its own pages before the host
        # stops it, so the max_seq guard keeps that margin free
        if decode_block < 1 or pipeline_depth < 1:
            raise ValueError(
                f"decode_block={decode_block} and pipeline_depth={pipeline_depth} "
                f"must be >= 1"
            )
        if pipeline_depth * decode_block * 2 > self.max_seq:
            raise ValueError(
                f"pipeline_depth*decode_block={pipeline_depth * decode_block} "
                f"reserves more than half of max_seq={self.max_seq} as the "
                f"stop margin — generations would truncate immediately"
            )
        self.decode_block = decode_block
        self.pipeline_depth = pipeline_depth
        #: optional ``hook(slot_id, token_ids_so_far)`` called after each
        #: processed block for slots that are still generating — the
        #: streaming feed (ServingEngine marshals it onto the caller's
        #: event loop).  Called from the worker thread; must not block.
        self.partial_hook: Optional[Any] = None
        self._alloc_decode_state()
        self.slots: list[_Slot] = [_Slot() for _ in range(max_slots)]
        # per-slot generation counter: an in-flight block carries the epoch
        # it was dispatched under, so tokens of a block dispatched before a
        # slot was recycled are never credited to the new sequence
        self._slot_epoch = [0] * max_slots
        # host shadow of per-slot token counts: the decode loop never reads
        # lengths back from the device
        self._host_offsets = np.zeros((max_slots,), np.int64)
        #: dispatched, unprocessed blocks: (host tokens [K, B], snapshot,
        #: begin event, end event)
        self._inflight_blocks: list[tuple] = []
        # per-slot sampling tensors change only at admit/finish
        self._sampling_cache: Optional[tuple] = None
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)
        #: wave counters: prefill waves, decode blocks dispatched, held
        #: slots / capacity summed over blocks, and the stream milliseconds
        #: of each processed block (CUDA events around it; CUDA only)
        self.prefill_waves = 0
        self.blocks_dispatched = 0
        self.occupancy_sum = 0.0
        self.block_ms: list[float] = []

    def _alloc_decode_state(self) -> None:
        """Fresh zeroed decode state: the page pool and the per-slot last
        sampled tokens."""
        config = self.config
        self.paged_cache = PagedKVCache.create(
            config.num_layers, self.allocator.num_pages, self.page_size,
            config.num_kv_heads, config.head_dim, self.max_slots,
            self.pages_per_seq, dtype=self.cache_dtype, device=self.device,
        )
        self.last_tokens = torch.zeros(
            (self.max_slots, 1), dtype=torch.int32, device=self.device
        )

    def free_slots(self) -> list[int]:
        return [i for i, slot in enumerate(self.slots) if not slot.active]

    @property
    def prefix_held_pages(self) -> int:
        """KV pages held by registered shared prefixes: none, the wave
        engine's shared prefix is not ported (ROADMAP Queue 1 item 6)."""
        return 0

    @property
    def num_active(self) -> int:
        return sum(1 for slot in self.slots if slot.active)

    # -- the wave engine ------------------------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _activate_slots(
        self, first_np: np.ndarray, lengths: np.ndarray, taken: list[int],
        params_list: Sequence[SamplingParams], page_grants: list[list[int]],
        prefill_ms: float,
    ) -> list[int]:
        """Prompt KV is in the pages and first tokens are sampled: flip the
        slots live."""
        self.metrics.record("prefill", prefill_ms)
        self.metrics.record("prefill_batch", float(len(taken)))
        # the wave's prefill is one phase-separated step; its time is all
        # "device" (no per-component split is measurable after the fact)
        self.step_clock.observe(
            kind="prefill",
            tokens=int(sum(int(n) for n in lengths[: len(taken)])),
            slots=len(taken),
            host_gap_ms=0.0,
            device_ms=float(prefill_ms),
            sample_xfer_ms=0.0,
        )
        started = time.perf_counter()
        for row, slot_id in enumerate(taken):
            self._slot_epoch[slot_id] += 1  # new generation begins
            self.slots[slot_id] = _Slot(
                active=True, prompt_len=int(lengths[row]),
                params=params_list[row], pages=page_grants[row],
                generated=[int(first_np[row])], started=started,
                prefill_ms=prefill_ms,
                decode_cum0=self.step_clock.decode_cum_ms,
            )
            self._host_offsets[slot_id] = int(lengths[row])
        rows = self._to_device(np.asarray(taken, np.int64))
        self.last_tokens[rows, 0] = self._to_device(
            first_np[: len(taken)].astype(np.int32)
        )
        self._sampling_cache = None  # slot set changed
        return list(taken)

    def _sampling_tensors(self) -> tuple:
        """(active_np, temp_dev, top_p_dev, active_dev), rebuilt only when
        the slot set changes (admit/finish) — not every decode step."""
        if self._sampling_cache is None:
            active = np.array([s.active for s in self.slots])
            temp = np.array(
                [s.params.temperature if s.active else 0.0 for s in self.slots],
                np.float32,
            )
            top_p = np.array(
                [s.params.top_p if s.active else 1.0 for s in self.slots], np.float32
            )
            self._sampling_cache = (
                active, self._to_device(temp), self._to_device(top_p),
                self._to_device(active),
            )
        return self._sampling_cache

    def step(self) -> list[tuple[int, GenerationResult]]:
        """One decode round: dispatch a block, then process the oldest
        blocks' tokens; returns finished (slot, result) pairs.

        With ``pipeline_depth=1`` the block just dispatched is processed at
        once.  With depth D > 1 up to D - 1 blocks stay IN FLIGHT while the
        host processes older tokens, so the host's work overlaps the next
        block's device time.  Once nothing is active the leftovers are
        flushed (their tokens belong to finished epochs)."""
        if self.num_active == 0 and not self._inflight_blocks:
            return []
        if self.fault_plan is not None:
            # chaos seam: a raise action fails this step as a device error
            # would, and the worker's boundary fails what is outstanding
            self.fault_plan.apply("engine.step", active=self.num_active)
        started = time.perf_counter()
        if self.num_active:
            # held slots over capacity, as the continuous scheduler's
            # occupancy is defined
            self.metrics.record(
                "batch_occupancy", 100.0 * self.num_active / self.max_slots
            )
            with torch.profiler.record_function("podmortem.decode"):
                self._dispatch_block()
        finished: list[tuple[int, GenerationResult]] = []
        processed = 0
        while self._inflight_blocks and (
            len(self._inflight_blocks) >= self.pipeline_depth
            or self.num_active == 0
        ):
            finished.extend(self._process_block(*self._inflight_blocks.pop(0)))
            processed += 1
        if processed:
            # seconds per token for the deadline policy's estimate
            elapsed_ms = (time.perf_counter() - started) * 1e3
            self.metrics.record("decode_step", elapsed_ms / (processed * self.decode_block))
            if self.decode_block > 1:
                self.metrics.record("decode_block", elapsed_ms / processed)
        return finished

    def _dispatch_block(self) -> None:
        """Enqueue one decode block; its tokens stay on the device (and
        travel to pinned host memory on the stream) until processed."""
        active, temp_dev, top_p_dev, active_dev = self._sampling_tensors()
        begin = end = None
        cuda = self.device.type == "cuda"
        if cuda:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
        self.paged_cache, toks, self.last_tokens = self._decode_block_paged(
            self.params, self.paged_cache, self.last_tokens,
            temp_dev, top_p_dev, active_dev,
        )
        if cuda:
            toks = toks.to("cpu", non_blocking=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        # which generation of each slot this block belongs to and how many
        # tokens it held before the block, BEFORE advancing the shadow
        snapshot = {
            i: (self._slot_epoch[i], int(self._host_offsets[i]))
            for i, slot in enumerate(self.slots)
            if slot.active
        }
        self._host_offsets[active] += self.decode_block
        self.blocks_dispatched += 1
        self.occupancy_sum += self.num_active / self.max_slots
        # step-clock stamps travel WITH the block: with pipeline_depth > 1
        # it is processed (and its record written) a later round
        t_dispatch = time.perf_counter()
        timing = (t_dispatch, self.step_clock.host_gap_ms(t_dispatch), len(snapshot))
        self._inflight_blocks.append((toks, snapshot, begin, end, timing))

    def _process_block(
        self, toks: torch.Tensor, snapshot: dict, begin: Any, end: Any,
        timing: tuple,
    ) -> list[tuple[int, GenerationResult]]:
        if end is not None:
            end.synchronize()  # the block's ONE host sync
            self.block_ms.append(begin.elapsed_time(end))
        t_ready = time.perf_counter()
        toks_np = toks.numpy()  # [K, B]
        block = self.decode_block
        t_dispatch, host_gap_ms, live = timing
        t_fetch = time.perf_counter()
        self.step_clock.observe(
            kind="decode",
            tokens=block * live,
            slots=live,
            host_gap_ms=host_gap_ms,
            device_ms=max(0.0, (t_ready - t_dispatch) * 1e3),
            sample_xfer_ms=max(0.0, (t_fetch - t_ready) * 1e3),
            commit_t=t_fetch,
        )
        finished: list[tuple[int, GenerationResult]] = []
        eos = self.tokenizer.eos_id
        for i, (epoch, before) in snapshot.items():
            slot = self.slots[i]
            # the slot moved on (finished, possibly re-admitted) after this
            # block was dispatched: its lanes hold junk for the new epoch
            if not slot.active or self._slot_epoch[i] != epoch:
                continue
            generated_before = len(slot.generated)
            for k in range(block):
                token = int(toks_np[k, i])
                previous = slot.generated[-1] if slot.generated else None
                # the PREVIOUS sampled token ended generation?
                if slot.params.stop_on_eos and eos is not None and previous == eos:
                    finished.append((i, self._finish(i, reason="stop")))
                    break
                if len(slot.generated) >= slot.params.max_tokens:
                    # budget already consumed (the prefill-sampled token
                    # counts); discard this token so max_tokens is exact
                    finished.append((i, self._finish(i, reason="length")))
                    break
                slot.generated.append(token)
                total = before + k + 1
                # stop pipeline_depth BLOCKS short of max_seq: the device
                # decodes that many further blocks before the host can stop
                # it, and those writes must stay inside the slot's pages
                if (
                    len(slot.generated) >= slot.params.max_tokens
                    or total >= self.max_seq - self.pipeline_depth * block
                ):
                    finished.append((i, self._finish(i, reason="length")))
                    break
            if (
                self.partial_hook is not None
                # identity: _finish() swaps in a fresh _Slot, so a slot that
                # finished inside this block is skipped (its result carries
                # the tail)
                and self.slots[i] is slot
                and len(slot.generated) > generated_before
            ):
                # list COPY: the hook crosses into the event-loop thread
                # while this worker keeps appending
                self.partial_hook(i, list(slot.generated))
        return finished

    def cancel(self, slot_id: int) -> bool:
        """Abort a decoding sequence and reclaim its slot and pages now
        (a client that went away must not decode to ``max_tokens``).  The
        epoch bump in :meth:`_finish` orphans the in-flight decode-ahead
        blocks that still carry the slot.  Returns True if a slot was
        freed."""
        if 0 <= slot_id < self.max_slots and self.slots[slot_id].active:
            self._finish(slot_id, reason="cancelled")
            return True
        return False

    def _finish(self, slot_id: int, *, reason: str) -> GenerationResult:
        slot = self.slots[slot_id]
        if slot.pages:
            # point the slot's table row at the trash page BEFORE releasing
            # the grant: the freed pages may go to a new sequence while this
            # slot row still takes part in batched decode (the write is
            # ordered on the stream after every block already dispatched)
            self.paged_cache.page_table[slot_id] = 0
            self.paged_cache.lengths[slot_id] = 0
            self.allocator.release(slot.pages)
        self._slot_epoch[slot_id] += 1  # stale in-flight tokens now orphaned
        self._host_offsets[slot_id] = 0
        self._sampling_cache = None  # slot set changed
        eos = self.tokenizer.eos_id
        ids = [t for t in slot.generated if t != eos]
        if reason == "length" and slot.params.deadline_clamped:
            # the length cap was the deadline budget's clamp, not the
            # caller's max_tokens — surface the difference
            reason = "deadline"
        result = GenerationResult(
            text=self.tokenizer.decode(ids),
            token_ids=ids,
            prompt_tokens=slot.prompt_len,
            completion_tokens=len(ids),
            finish_reason=reason,
            prefill_ms=slot.prefill_ms,
            # the decode-bearing wall the step clock accrued while the
            # slot was live
            decode_ms=max(0.0, self.step_clock.decode_cum_ms - slot.decode_cum0),
        )
        self.slots[slot_id] = _Slot()
        return result

    def generate(
        self, prompt: str, params: Optional[SamplingParams] = None
    ) -> GenerationResult:
        """Synchronous single-prompt generation (drains the whole batch)."""
        [slot_id] = self.admit([prompt], [params or SamplingParams()])
        while True:
            for finished_id, result in self.step():
                if finished_id == slot_id:
                    return result


@dataclasses.dataclass
class _Submission:
    """One request on its way from a caller to the worker."""

    prompt: str
    params: SamplingParams
    submitted: float
    priority: int
    future: "concurrent.futures.Future[GenerationResult]"
    #: token-level failover: generated ids re-prefilled after the prompt
    resume_tokens: Optional[list] = None
    #: streaming: where each step's generated-so-far ids go
    partial: Optional["_PartialFeed"] = None


@dataclasses.dataclass
class _PartialFeed:
    """One streaming request's feed: the caller's loop and callback, its
    future (a cancelled one hears nothing more) and how many tokens the
    callback has seen (the order guard)."""

    loop: asyncio.AbstractEventLoop
    callback: Any
    future: Optional[concurrent.futures.Future] = None
    sent: int = 0


def _settle(
    future: concurrent.futures.Future, *, result: Any = None,
    exc: Optional[BaseException] = None,
) -> None:
    """Resolve a request's future unless its caller cancelled it first
    (the caller's cancel and the worker's answer race across threads)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


class ServingEngine:
    """Thread front: submissions -> the scheduler's loop, or the wave
    loop when there is no scheduler -> futures.

    A request's future stays pending until the worker answers it, so a
    caller that goes away (``await engine.generate(...)`` cancelled, a
    streaming client's disconnect) cancels it; the worker reaps the
    cancelled request at its next step boundary — ``Scheduler.cancel`` or
    ``Generator.cancel`` — and its slot and pages return at once, as the
    reference's serve loops do."""

    def __init__(
        self,
        generator: Generator,
        scheduler: Any = None,
        *,
        admission_wait_s: float = 0.004,
    ) -> None:
        self.generator = generator
        self.scheduler = scheduler
        #: wave mode: a short window that lets concurrent arrivals share
        #: one prefill
        self.admission_wait_s = admission_wait_s
        self._submissions: "queue.Queue[_Submission]" = queue.Queue()
        #: futures in flight, keyed by scheduler req id (continuous) or
        #: slot id (wave)
        self._pending: dict[int, concurrent.futures.Future] = {}
        #: wave mode: submissions taken from the queue, not yet admitted
        #: (page backpressure keeps them here), and each admitted slot's
        #: submit -> admission wall
        self._waiting: collections.deque = collections.deque()
        self._queue_wait_ms: dict[int, float] = {}
        self._stalled_avail: Optional[int] = None
        # streaming: key (req id or slot id) -> feed; the worker's hooks
        # marshal each snapshot onto the caller's loop
        self._partial_cbs: dict[int, _PartialFeed] = {}
        generator.partial_hook = self._on_partial_from_worker
        if scheduler is not None:
            scheduler.partial_hook = self._on_partial_from_worker
        #: per-class SLO aggregates (obs/sloledger.py SLOBoard) carried on
        #: load_report() and /healthz; the operator-side ledger owns the
        #: podmortem_slo_* counters
        self._slo_board = SLOBoard()
        #: prefill/decode disaggregation role advertised on /healthz
        self.replica_role: str = "mixed"
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------

    def warmup(self) -> None:
        """Before serving, run one empty continuous step or, in wave mode,
        one short wave (builds the kernels and warms both programs); call
        before the first submit."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("warmup must run before the engine starts")
            if self.scheduler is not None:
                self.scheduler.precompile()
                return
            g = self.generator
            g.admit(["warm up"], [SamplingParams(
                max_tokens=g.decode_block + 1, temperature=0.0, stop_on_eos=False,
            )])
            while g.num_active or g._inflight_blocks:
                g.step()

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
        """Stop the worker and fail every request still outstanding with
        ``asyncio.CancelledError("serving engine closed")``, as the
        reference does (the HTTP server answers "server shutting down")."""
        self._closed.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                log.warning("serving worker did not stop within %.0fs", timeout)
        self._fail_outstanding(asyncio.CancelledError("serving engine closed"))

    # -- submit side ---------------------------------------------------

    def submit(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        *,
        priority: int = 0,
        resume_tokens: Optional[list] = None,
        on_partial: Optional[tuple] = None,
    ) -> "concurrent.futures.Future[GenerationResult]":
        """Queue one request; raises ``ValueError`` for a guided or LoRA
        request (not ported) or ``resume_tokens`` without the scheduler,
        and :class:`DeadlineExceeded` when its budget cannot fit one
        decoded token — all to this caller, before the request takes a
        queue place.  ``priority`` orders admission (higher first, FIFO
        within a class).  ``on_partial`` is ``(loop, callback)``: each
        step's generated-so-far ids reach ``callback`` on ``loop``."""
        feed = None
        if on_partial is not None:
            feed = _PartialFeed(*on_partial)
        if self._closed.is_set():
            raise RuntimeError("serving engine is closed")
        if self._error is not None:
            raise RuntimeError("serving engine loop died") from self._error
        if params is not None and (
            params.guided_choice is not None
            or params.guided_regex is not None
            or params.adapter is not None
        ):
            raise ValueError(_NOT_PORTED_GUIDED)
        if resume_tokens and self.scheduler is None:
            raise ValueError(
                "token-level streaming resume requires the continuous "
                "scheduler (sched_mode=continuous)"
            )
        if params is not None and params.deadline is not None:
            # fail fast: admission re-runs the policy with the residue
            # left after the queue wait and owns the clamp
            g = self.generator
            _, outcome = g.deadline_policy(params)
            if outcome == "rejected":
                g.metrics.incr("admission_deadline_rejected")
                raise DeadlineExceeded(
                    "deadline budget cannot fit any decoded output "
                    f"(remaining {max(0.0, params.deadline - g._clock()):.3f}s)"
                )
        future: concurrent.futures.Future = concurrent.futures.Future()
        if feed is not None:
            feed.future = future
        self._submissions.put(_Submission(
            prompt, params or SamplingParams(), time.perf_counter(), priority, future,
            resume_tokens=list(resume_tokens) if resume_tokens else None,
            partial=feed,
        ))
        if self._error is not None:
            # the worker died between the check above and the put: its
            # drain may have missed this submission
            self._fail_outstanding(RuntimeError("serving engine loop died"))
            return future
        self.start()
        return future

    async def generate(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        *,
        on_partial: Optional[Any] = None,
        priority: int = 0,
        resume_tokens: Optional[list] = None,
    ) -> GenerationResult:
        """Generate on the caller's event loop (the reference's coroutine):
        the submission's verdicts (``ValueError``,
        :class:`DeadlineExceeded`) raise here, the result or the engine's
        error when the request finishes.

        ``on_partial(token_ids_so_far)`` fires on this loop after each
        committed step or decode block while the request generates — the
        streaming feed of the HTTP server.  Cancelling this coroutine
        (the client went away) releases the request's slot and pages at
        the worker's next step.  ``priority`` orders admission; the
        pipeline's explanations use 10 so external API callers sharing the
        engine never starve them.  ``resume_tokens`` resumes a failed-over
        stream: the ids are re-prefilled after the prompt and the result
        carries only the continuation (continuous mode only)."""
        loop = asyncio.get_running_loop()
        future = self.submit(
            prompt, params, priority=priority, resume_tokens=resume_tokens,
            on_partial=(loop, on_partial) if on_partial is not None else None,
        )
        # per-class SLO accounting: every submit settles exactly once — a
        # cancelled or failed request is a miss
        slo_cls = (params.slo_class if params is not None else None) or "default"
        self._slo_board.submitted(slo_cls)
        settled = False
        try:
            with obs_span("engine.generate", priority=priority) as span_:
                result = await asyncio.wrap_future(future)
                metrics = self.generator.metrics
                metrics.observe("queue_wait_milliseconds", result.queue_wait_ms)
                metrics.observe(
                    "ttft_milliseconds", result.queue_wait_ms + result.prefill_ms
                )
                if result.completion_tokens > 0:
                    metrics.observe(
                        "token_latency_milliseconds",
                        result.decode_ms / result.completion_tokens,
                    )
                # attained = finished with output inside its own deadline;
                # deadline-free requests attain by completing at all
                attained = result.finish_reason != "deadline" and (
                    params is None or params.deadline is None
                    or self.generator._clock() <= params.deadline
                )
                self._slo_board.finished(
                    slo_cls, attained=attained, tokens=result.completion_tokens,
                )
                settled = True
                span_.set(
                    queue_wait_ms=round(result.queue_wait_ms, 3),
                    prefill_ms=round(result.prefill_ms, 3),
                    decode_ms=round(result.decode_ms, 3),
                    prompt_tokens=result.prompt_tokens,
                    completion_tokens=result.completion_tokens,
                    finish_reason=result.finish_reason,
                )
                return result
        finally:
            if not settled:
                self._slo_board.finished(slo_cls, attained=False, tokens=0)

    def generate_batch(
        self, prompts: Sequence[str], params: Optional[SamplingParams] = None
    ) -> list[GenerationResult]:
        """Submit every prompt (they co-batch) and wait for all results."""
        futures = [self.submit(prompt, params) for prompt in prompts]
        return [future.result() for future in futures]

    def load_report(self) -> ReplicaLoad:
        """This replica's load in the shape the router's shed decision
        reads (``router/health.py:ReplicaLoad``), built as the reference
        builds it: queue pressure, the admission roofline's own per-token
        estimate, the step clock's summary, the SLO board, the KV economy
        and the overload ladder's totals.  Cheap reads from any thread;
        approximate under concurrent decode, which the router treats as
        feedback, not truth.  Served on ``GET /healthz``."""
        g = self.generator
        sched = self.scheduler
        if sched is not None:
            queue_depth = self._submissions.qsize() + sched.queue_depth
            inflight = sched.num_active
        else:
            # wave: the waiting line is popped but not yet admitted
            queue_depth = self._submissions.qsize()
            inflight = len(self._waiting) + len(self._pending)
        summary = g.step_clock.summary()
        fractions = summary.get("fractions") or {}
        kvstore = getattr(sched, "_kvstore", None)
        return ReplicaLoad(
            queue_depth=queue_depth,
            inflight=inflight,
            decode_token_s=g.decode_token_estimate_s(),
            # the supervisor is not ported (ROADMAP.md Queue 1 item 10):
            # only a dead loop gives up
            gave_up=self._error is not None,
            decode_mfu=summary.get("decode_mfu"),
            host_gap_frac=fractions.get("host_gap"),
            occupancy=summary.get("occupancy_avg"),
            steps=summary.get("steps") or 0,
            slo_attainment=self._slo_board.attainment(),
            goodput_tokens_s=self._slo_board.goodput_tokens_s(),
            slo_completed=self._slo_board.completed,
            slo_classes=self._slo_board.per_class(),
            kv_pages_free=g.allocator.available,
            kv_pages_total=g.allocator.num_pages - 1,
            prefix_hit_rate=kvstore.hit_rate() if kvstore is not None else None,
            prefix_lookups=kvstore.lookups if kvstore is not None else 0,
            kv_blocks=kvstore.inventory() if kvstore is not None else None,
            role=self.replica_role,
            shed=g.metrics.labeled_total("shed"),
            degraded=g.metrics.labeled_total("degraded"),
        )

    # -- streaming -----------------------------------------------------

    def _register_partial(self, key: int, item: _Submission) -> None:
        if item.partial is not None:
            self._partial_cbs[key] = item.partial

    def _forget(self, key: int) -> None:
        self._partial_cbs.pop(key, None)

    def _on_partial_from_worker(self, key: int, token_ids: list) -> None:
        """Scheduler/generator hook (worker thread) -> the caller's loop.
        Snapshots are queued in commit order ahead of the request's
        result, so a stream hears every step before its end."""
        feed = self._partial_cbs.get(key)
        if feed is None or feed.future.cancelled():  # the client went away
            return
        try:
            feed.loop.call_soon_threadsafe(self._deliver_partial, feed, token_ids)
        except RuntimeError:  # the caller's loop is closed
            pass

    @staticmethod
    def _deliver_partial(feed: _PartialFeed, token_ids: list) -> None:
        """Loop-side delivery with a per-request order guard: a snapshot
        is delivered only when it is longer than the last one sent, so a
        stream never rewinds, however commits and cancellations
        interleave."""
        if feed.future.cancelled() or len(token_ids) <= feed.sent:
            return
        feed.sent = len(token_ids)
        feed.callback(token_ids)

    # -- the worker ----------------------------------------------------

    def _admit_submissions(self, block: bool) -> None:
        try:
            item = self._submissions.get(timeout=0.05) if block else (
                self._submissions.get_nowait()
            )
        except queue.Empty:
            return
        while True:
            if not item.future.cancelled():
                try:
                    req_id = self.scheduler.enqueue(
                        item.prompt, item.params, submitted=item.submitted,
                        priority=item.priority, resume_tokens=item.resume_tokens,
                    )
                except (ValueError, MemoryError, ShedLowValue) as exc:  # per-request verdict
                    _settle(item.future, exc=exc)
                else:
                    self._pending[req_id] = item.future
                    self._register_partial(req_id, item)
            try:
                item = self._submissions.get_nowait()
            except queue.Empty:
                return

    def _run(self) -> None:
        try:
            if self.scheduler is not None:
                self._run_sched()
            else:
                self._run_wave()
        except Exception as exc:  # noqa: BLE001 - the loop's boundary: fail loudly
            log.exception("serving engine loop died")
            self._error = exc
            if self.scheduler is not None:
                # drop rows, queue and the gathered offload buffers: the
                # device state they point into is no longer trusted
                self.scheduler.reset()
            self._fail_outstanding(exc)

    def _cancelled(self) -> list[int]:
        """Keys of in-flight requests whose callers went away."""
        return [key for key, future in self._pending.items() if future.cancelled()]

    def _run_sched(self) -> None:
        sched = self.scheduler
        while not self._closed.is_set():
            self._admit_submissions(block=sched.total_work == 0)
            if not sched.total_work:
                continue
            # reclaim rows whose callers are gone (disconnects): the slot
            # and pages return before this step is planned
            for req_id in self._cancelled():
                sched.cancel(req_id)
                self._pending.pop(req_id, None)
                self._forget(req_id)
            if not sched.total_work:
                continue
            for outcome in sched.step():
                self._forget(outcome.req_id)
                future = self._pending.pop(outcome.req_id, None)
                if future is None:
                    continue
                if outcome.error is not None:
                    _settle(future, exc=outcome.error)
                else:
                    _settle(future, result=outcome.result)

    # -- the wave loop -------------------------------------------------

    def _take_submissions(self, block: bool) -> bool:
        """Move queued submissions into the waiting line (blocking briefly
        when ``block``); returns whether any arrived."""
        arrived = False
        timeout = 0.05 if block else None
        while True:
            try:
                item = (
                    self._submissions.get(timeout=timeout) if timeout
                    else self._submissions.get_nowait()
                )
            except queue.Empty:
                return arrived
            timeout = None
            if not item.future.cancelled():
                # higher priority first, FIFO within a class
                at = len(self._waiting)
                while at and self._waiting[at - 1].priority < item.priority:
                    at -= 1
                self._waiting.insert(at, item)
                arrived = True

    def _page_stalled(self) -> bool:
        """True while a backpressured line has no new pages to retry with:
        skipping the retry avoids re-tokenising every waiting prompt each
        round while decode slowly frees pages."""
        if self._stalled_avail is None:
            return False
        if self.generator.allocator.available > self._stalled_avail:
            self._stalled_avail = None
            return False
        return True

    def _sweep_waiting(self) -> None:
        """Drop waiting requests whose callers went away, and fail every
        one whose deadline expired while it queued (the reference's
        ``_sweep_batch``): neither should take card time."""
        now = self.generator._clock()
        live = collections.deque()
        for item in self._waiting:
            deadline = item.params.deadline
            if item.future.cancelled():
                continue
            if deadline is not None and deadline <= now:
                self.generator.metrics.incr("admission_deadline_rejected")
                _settle(item.future, exc=DeadlineExceeded(
                    "deadline expired while queued for admission"
                ))
            else:
                live.append(item)
        self._waiting = live

    def _admit_waiting(self, arrived: bool) -> None:
        """Admit the head of the waiting line into free slots and pages;
        what does not fit stays in line (backpressure)."""
        g = self.generator
        free = len(g.free_slots())
        if not free or self._page_stalled():
            return
        if arrived and len(self._waiting) < free and self.admission_wait_s > 0:
            # a short window lets concurrent arrivals share one prefill
            time.sleep(self.admission_wait_s)
            self._take_submissions(block=False)
        batch = list(itertools.islice(self._waiting, free))
        admitted_t = time.perf_counter()
        try:
            slots = g.admit([b.prompt for b in batch], [b.params for b in batch])
        except OversizedRequest as exc:
            # only the head is impossible: fail it alone, the rest retry
            _settle(self._waiting.popleft().future, exc=exc)
            return
        for slot_id, item in zip(slots, batch):
            self._waiting.popleft()
            self._pending[slot_id] = item.future
            self._register_partial(slot_id, item)
            self._queue_wait_ms[slot_id] = max(0.0, (admitted_t - item.submitted) * 1e3)
        # a stall is recorded only while active sequences hold pages: their
        # release is the retry trigger
        self._stalled_avail = (
            g.allocator.available
            if len(slots) < len(batch) and g.num_active > 0 else None
        )

    def _run_wave(self) -> None:
        g = self.generator
        while not self._closed.is_set():
            busy = bool(self._waiting) or g.num_active > 0 or bool(g._inflight_blocks)
            arrived = self._take_submissions(block=not busy)
            if self._waiting:
                self._sweep_waiting()
            if self._waiting:
                self._admit_waiting(arrived)
            if g.num_active:
                # reclaim slots whose callers are gone: an abandoned
                # request must not decode to max_tokens holding its pages
                for slot_id in self._cancelled():
                    g.cancel(slot_id)
                    self._pending.pop(slot_id, None)
                    self._queue_wait_ms.pop(slot_id, None)
                    self._forget(slot_id)
            if not (g.num_active or g._inflight_blocks):
                continue
            for slot_id, result in g.step():
                self._forget(slot_id)
                future = self._pending.pop(slot_id, None)
                result.queue_wait_ms = self._queue_wait_ms.pop(slot_id, 0.0)
                if future is not None:
                    _settle(future, result=result)

    def _fail_outstanding(self, exc: BaseException) -> None:
        self._partial_cbs.clear()
        for future in list(self._pending.values()):
            _settle(future, exc=exc)
        self._pending.clear()
        while self._waiting:
            _settle(self._waiting.popleft().future, exc=exc)
        while True:
            try:
                item = self._submissions.get_nowait()
            except queue.Empty:
                break
            _settle(item.future, exc=exc)
