"""The port's serving engine: the generator and its worker thread.

``Generator`` is the counterpart of
``operator_tpu/serving/engine.py:BatchedGenerator``: it
holds the parameters, the KV cache, the slot table and the sampling
``torch.Generator``.  Paged (``paged=True``, the port's default): a
``PagedKVCache`` (worst-case sizing by default, ``max_slots *
pages_per_seq + 1`` pages with page 0 the trash page) and its page
allocator — everything the continuous scheduler (``sched/scheduler.py``)
reads.  Contiguous (``paged=False``, JAX's default and
``KV_CACHE_MODE=contiguous``): a ``KVCache`` of ``max_slots x max_seq``
reserved up front, with each slot's offset in a device vector, no
allocator and no shared prefixes.  It runs the phase-separated WAVE
engine itself: batched admission with one
prefill per wave (``admission.py``), then decode in blocks of
``decode_block`` chained steps (``programs.py``) with up to
``pipeline_depth - 1`` blocks in flight while the host processes older
tokens.  Registered shared prefixes (``add_shared_prefix``: a prompt
template's static preamble prefilled once into generator-owned pages)
let a wave whose every prompt starts with one forward only its suffix;
with ``prefill_chunk`` a long wave is prefilled one chunk per ``step()``
into its reserved slots while the live slots' decode blocks go on.
Per-slot epochs keep a block dispatched before a slot was recycled from
crediting its tokens to the new sequence.  The wave engine
also serves guided decoding (the reference's automaton registry: an LRU
of built automata, the stacked ``[A, S, vocab]`` tables and each slot's
automaton and DFA state on the device) and multi-LoRA (the adapters
stacked with the all-zeros adapter at index 0, each slot's index riding
into the projections); the continuous scheduler refuses both.

Every serving program — the continuous scheduler's mixed step, the wave
engine's plain and guided decode blocks and its prefill buckets — runs
as a ``serving/graphs.py`` program: a CUDA graph on the card, captured at
its key's first use or by the warmup grid (``ServingEngine.precompile``,
``WARMUP_GRID``) and replayed after, eager on the CPU; with an AOT cache
(``aot_cache``, ``serving/aotcache.py``) each capture is recorded.
``reset`` zeroes the page pool in place, so a restart captures nothing
again, unless a stalled worker is still wedged (then the graphs and the
pool are made anew).

With ``mesh`` (a ``DeviceMesh`` of the process group's ranks) it is one
rank of a sharded generator: the JAX generator's validation and
messages, its params cut to this rank's shards, its cache at this
rank's KV heads (and, contiguous, its data rank's rows), the programs'
mesh paths (``programs.py``), dp-rounded buckets (``admission.py``) and
a ``torch.Generator`` of its data rank.  Ranks keep in lockstep through
``serving/meshserve.py``: rank 0 sends each state-changing call to the
others before making it.  A mesh whose collectives no graph can capture
(gloo) runs its programs eagerly, by ``GraphSet``'s stated mode.

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

The fleet KV fabric (``fabric/``, continuous mode): with ``fabric`` set,
``generate`` first pulls the prompt's missing prefix blocks from peers'
host pools into this replica's (``FabricFetcher.prefetch``; its store
probe and adoption run on the worker between steps through
``store_executor``), ``kv_block_bytes`` serves this replica's pooled
blocks to peers in the PMKV1 wire format, and ``fabric_poller`` feeds
the fetcher's index from peers' ``/healthz``.

Supervision (the reference's ``SupervisorPolicy``): with a policy, a
watchdog thread sees a step (or a wave's batched prefill) older than
``stall_timeout_s`` and abandons the worker behind an epoch — the
orphan, when its step returns, touches nothing and waits — or is woken
by a loop death; it then collects the outstanding requests, waits
``join_grace_s`` for a stalled orphan, resets the generator and the
scheduler (``Generator.reset``: the page pool zeroed in place, or the
graphs and the pool made anew under an orphan still wedged, every slot
emptied, the weights kept), audits slots and pages, requeues each
survivor once at priority ``max(p, 1)`` with its absolute deadline and
restarts the loop — on the orphan when it came back, else on a fresh thread —
leaving a black-box record (``engine-stall`` or ``engine-error``).  Without a policy a loop death fails what is
outstanding, and the next ``submit`` resets the engine first (lazy
recovery); both paths allow ``MAX_RESETS_PER_WINDOW`` resets per
``RESET_WINDOW_S``.  A reset that fails (a CUDA context killed by a
sticky error) gives up loudly.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import functools
import itertools
import logging
import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.llama import KVCache
from ..models.quant import is_quantized
from ..obs import span as obs_span
from ..obs.sloledger import SLOBoard
from ..ops.paged_attention import PagedKVCache
from ..router.health import ReplicaLoad
from ..utils.device import resolve_device
from ..utils.timing import MetricsRegistry
from .admission import AdmissionMixin
from .graphs import GraphProgram, GraphSet
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
    _bucket,
    _PrefillJob,
    _Slot,
)

log = logging.getLogger(__name__)

__all__ = ["EngineStalled", "Generator", "ServingEngine", "SupervisorPolicy"]



class EngineStalled(RuntimeError):
    """The serving loop made no step progress within the supervisor's
    stall budget: the device (or its runtime) is wedged, not merely
    slow."""


@dataclasses.dataclass
class SupervisorPolicy:
    """Watchdog policy for the serving engine, with the reference's
    defaults.  With a policy, a step exceeding ``stall_timeout_s`` or a
    loop death triggers a supervised restart that requeues each
    in-flight request up to ``max_requeues`` times with its residual
    deadline; without one, a loop death fails what is outstanding and
    recovery is lazy (the next ``submit``)."""

    #: a step may hide a first kernel build: only a wedged device should
    #: trip this (``OperatorConfig.supervisor_stall_s``)
    stall_timeout_s: float = 120.0
    #: how long to wait for an abandoned (stalled) worker to return
    #: before resetting the device state under it anyway
    join_grace_s: float = 10.0
    #: each request is re-admitted at most this many times
    max_requeues: int = 1


class _Orphaned(Exception):
    """Raised in a worker the supervisor abandoned, as it comes back from
    its device call: it exits touching nothing."""


def _params_dtype_name(params: Any) -> str:
    """The serving dtype's name for the step clock's peak: ``int8`` for
    quantized weights, else the embedding's dtype."""
    if is_quantized(params):
        return "int8"
    return str(params["embed"].dtype).replace("torch.", "")


class Generator(AdmissionMixin, ProgramBuilderMixin):
    """Slot-based generation state over one shared KV cache (paged, or
    contiguous with ``paged=False``), and the wave engine over it
    (``admit`` + ``step``).

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
        lora_adapters: Optional[dict[str, Any]] = None,
        lora_alpha: float = 16.0,
        aot_cache: Any = None,
        prefill_chunk: Optional[int] = None,
        paged: bool = True,
        mesh: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        # ---- sharded serving: a DeviceMesh (parallel/mesh.py:make_mesh) of
        # the process group's ranks, each running this generator on its
        # shard — tp on heads and MLP columns, slots over the data axes;
        # the programs run the collectives (ServingShard) that XLA inserts
        # for JAX.  ``params`` may be whole (each rank cuts its shard) or
        # already this rank's shards (the sharded load)
        self.mesh = mesh
        self.shard = None
        if mesh is not None:
            from ..parallel.mesh import ServingShard, validate_serving_mesh

            validate_serving_mesh(mesh, config, max_slots)
            self.shard = ServingShard(mesh)
            params = self.shard.local_params(params, config, quantized=is_quantized(params))
        #: the KV layout: pages (the scheduler's too) or one contiguous row
        #: per slot.  JAX's ``BatchedGenerator`` defaults to contiguous; the
        #: port defaults to paged, and the provider passes it explicitly
        self.paged = paged
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
        #: True on a worker the serving engine's supervisor abandoned (set
        #: by ``ServingEngine``): checked after the chaos seam, so a worker
        #: woken from an injected stall dispatches nothing into the state
        #: the restarted loop owns
        self.abandoned: Callable[[], bool] = lambda: False
        self.page_size = page_size
        self.pages_per_seq = -(-self.max_seq // page_size)
        self.sample_top_k = sample_top_k or SAMPLE_TOP_K
        self.cache_dtype = cache_dtype or torch.bfloat16
        num_pages = kv_pages or (max_slots * self.pages_per_seq + 1)
        #: contiguous mode has no pages, as JAX's has no allocator
        self.allocator: Optional[PageAllocator] = PageAllocator(num_pages) if paged else None
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
        # chunked prefill: a wave whose bucket is longer than the chunk is
        # prefilled ``prefill_chunk`` tokens per step() round instead of in
        # one pass, so the decode blocks of live slots interleave with it
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        self.prefill_chunk = prefill_chunk
        self._prefill_job: Optional[_PrefillJob] = None
        #: a pending job's slots: neither free nor decoding, but active
        self._reserved: set[int] = set()
        #: the job's (mini cache, last logits) buffers per (n_pad, t_pad):
        #: allocated once, written in place by the chunk programs
        self._job_buffers: dict[tuple, tuple] = {}
        #: registered shared prefixes: text, tokens and generator-owned
        #: pages each (see add_shared_prefix)
        self._prefixes: list[dict] = []
        #: rank 0's ``serving/meshserve.py:MeshDriver`` on a serving mesh
        #: of several ranks, else None
        self.mirror = None
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
        # a data rank draws for its own rows: its own stream (tp ranks of
        # one data rank draw alike, so they sample the same tokens)
        self._rng.manual_seed(seed if self.shard is None
                              else seed * self.shard.data + self.shard.data_rank)
        #: wave counters: prefill waves, decode blocks dispatched, held
        #: slots / capacity summed over blocks, and the stream milliseconds
        #: of each processed block (CUDA events around it; CUDA only)
        self.prefill_waves = 0
        self.blocks_dispatched = 0
        self.occupancy_sum = 0.0
        self.block_ms: list[float] = []

        # ---- guided decoding (serving/guided.py): automaton tables stacked
        # [A_pad, S_pad, vocab] on the device, per-slot (automaton, state)
        # vectors carried through the decode block.  None = no guided slot
        # active; the unguided block runs untouched.
        self._guided_cache: dict[tuple, Any] = {}  # spec -> ChoiceAutomaton (LRU)
        # submit-time validation builds automata on the caller's thread
        # while the worker refreshes the stacked tables; the lock guards
        # the bookkeeping only (builds run unlocked), and _guided_protect
        # shields an in-flight refresh from submit-thread eviction
        self._guided_lock = threading.Lock()
        self._guided_protect: frozenset = frozenset()
        self._guided_tables: Optional[torch.Tensor] = None
        self._guided_index: dict[tuple, int] = {}  # spec -> stacked index
        self._guided_aut_np = np.zeros((max_slots,), np.int64)
        self.guided_aut: Optional[torch.Tensor] = None  # [B] automaton ids
        self.guided_state: Optional[torch.Tensor] = None  # [B] DFA states

        # ---- multi-LoRA serving: adapters stacked [L, n_adapters + 1, ...]
        # with the all-zeros base at index 0; every row picks its adapter
        # inside the one pass (models/llama.py _lora_path)
        self.lora_alpha = lora_alpha
        self.lora: Optional[dict] = None
        self._adapter_ids: dict[Optional[str], int] = {None: 0}
        if lora_adapters:
            from ..parallel.lora import stack_adapters, zero_lora

            names = sorted(lora_adapters)
            first = lora_adapters[names[0]]
            first_a = first[next(iter(first))]["a"]
            zero = zero_lora(
                config, rank=first_a.shape[-1], targets=tuple(first),
                dtype=first_a.dtype, device=self.device,
            )
            self.lora = stack_adapters(
                [zero] + [
                    {t: {k: v.to(self.device) for k, v in f.items()}
                     for t, f in lora_adapters[n].items()}
                    for n in names
                ]
            )
            self._adapter_ids.update({n: i + 1 for i, n in enumerate(names)})
            if self.shard is not None:
                # replicated factors, each rank keeping its projections' part
                self.lora = self.shard.local_lora(self.lora)
        #: the guided tables' device buffers, one per padded shape: a
        #: restack of the same shape is copied into the buffer the decode
        #: graphs were captured with
        self._guided_buffers: dict[tuple, torch.Tensor] = {}

        # ---- the serving programs (serving/graphs.py): CUDA graphs on the
        # card, captured at each key's first use or by the warmup grid
        # (precompile_grid) and replayed after; eager on the CPU.  With an
        # AOT cache (serving/aotcache.py: a path, or a provider-built
        # AotCache) every capture is recorded for the next boot.
        self._aot = None
        if aot_cache is not None:
            from .aotcache import AotCache, generator_fingerprint

            if isinstance(aot_cache, AotCache):
                self._aot = aot_cache
                self._aot.metrics = self.metrics
            else:
                try:
                    self._aot = AotCache(str(aot_cache), generator_fingerprint(
                        config=config,
                        weight_dtype=serving_dtype,
                        max_slots=max_slots,
                        max_seq=max_seq,
                        cache_dtype=cache_dtype,
                        paged=paged,
                        page_size=page_size,
                        kv_pages=kv_pages,
                        decode_block=decode_block,
                        sample_top_k=sample_top_k,
                        pipeline_depth=pipeline_depth,
                        prefill_chunk=prefill_chunk,
                        lora_names=[n for n in self._adapter_ids if n],
                        mesh=mesh,
                    ), metrics=self.metrics)
                except Exception:  # noqa: BLE001 - the cache is an optimisation only
                    log.warning(
                        "AOT cache disabled: fingerprint construction failed",
                        exc_info=True,
                    )
        eager = None
        if self.shard is not None and self.device.type == "cuda" and not self.shard.capturable:
            eager = (f"the mesh's {self.shard.backend} collectives cannot be captured in a "
                     f"CUDA graph")
        self.graphs = GraphSet(self.device, eager=eager)
        # fixed by address: params, the adapter stack, the guided tables,
        # the cache's KV (and in contiguous mode the offsets vector, which
        # the decode block advances in place)
        if paged:
            held = dict(fixed_fields=("k_pages", "v_pages"), generators=(self._rng,))
            decode_fn, decode_fixed = self._decode_block_paged, (0, 6, 8)
        else:
            held = dict(fixed_fields=("k", "v"), generators=(self._rng,))
            decode_fn, decode_fixed = self._decode_block, (0, 3, 7, 9)
        self._decode_program = self._aot_wrap(
            "_decode_block", decode_fn, fixed_args=decode_fixed, **held
        )
        self._decode_guided_program = self._aot_wrap(
            "_decode_block_guided", decode_fn, fixed_args=decode_fixed, **held
        )
        self._prefill_program = self._aot_wrap(
            "prefill_fn", self._prefill, fixed_args=(0, 7, 9), **held
        )
        # one program per key, named as the JAX generator names its
        # executables: the prefixed prefill buckets (n_pad, t_sfx, shared,
        # guided), the chunk programs (n_pad, t_pad, chunk), the finish
        # programs (n_pad, t_pad, guided) and the prefix builds (n_keep)
        self._prefix_fns: dict[tuple, GraphProgram] = {}
        self._chunk_fns: dict[tuple, GraphProgram] = {}
        self._finish_fns: dict[tuple, GraphProgram] = {}
        self._prefix_build_fns: dict[int, GraphProgram] = {}

    def _aot_wrap(self, name: str, fn: Any, **kwargs: Any) -> GraphProgram:
        """One serving program (``serving/graphs.py``), its captures
        recorded in the AOT cache when there is one."""
        cached = None
        if self._aot is not None:
            from .aotcache import CachedProgram

            cached = CachedProgram(self._aot, name)
        return self.graphs.program(name, fn, cached=cached, **kwargs)

    @property
    def _prefill_fns(self) -> set:
        """The prefill buckets ``(n_pad, t_pad, guided)`` captured so far
        (the JAX generator's ``_prefill_fns`` keys)."""
        return self._prefill_program.keys()

    @property
    def adapter_names(self) -> list[str]:
        """Registered LoRA adapter names (multi-LoRA serving)."""
        return sorted(name for name in self._adapter_ids if name is not None)

    def _alloc_decode_state(self) -> None:
        """Fresh zeroed decode state: the page pool, or the contiguous
        cache and the per-slot offsets (JAX ``engine.py:897-905``), and
        the per-slot last sampled tokens."""
        config = self.config
        self.paged_cache: Optional[PagedKVCache] = None
        self.cache: Optional[KVCache] = None
        self.offsets: Optional[torch.Tensor] = None
        # on a mesh: this rank's KV heads; the whole pool (the tables and
        # lengths are whole on every rank), or its data rank's cache rows
        if self.paged:
            self.paged_cache = PagedKVCache.create(
                config.num_layers, self.allocator.num_pages, self.page_size,
                self._kv_heads, config.head_dim, self.max_slots,
                self.pages_per_seq, dtype=self.cache_dtype, device=self.device,
            )
        else:
            rows = self.max_slots // (1 if self.shard is None else self.shard.data)
            self.cache = KVCache.create(
                config, rows, self.max_seq, dtype=self.cache_dtype,
                device=self.device, kv_heads=self._kv_heads,
            )
            self.offsets = torch.zeros((self.max_slots,), dtype=torch.int32, device=self.device)
        self.last_tokens = torch.zeros(
            (self.max_slots, 1), dtype=torch.int32, device=self.device
        )

    def reset(self, *, fresh: bool = False) -> None:
        """Drop every sequence and zero the decode state: the engine's
        recovery path after a device error or a stall.  The allocator is
        rebuilt, every slot is emptied and its epoch bumped (tokens of
        blocks still in flight are orphaned), a pending chunked job is
        dropped, the step clock restarts, and every registered shared
        prefix is primed again into the fresh pool; the weights are
        kept.  The page pool (or the contiguous cache and its offsets)
        and the per-slot tokens are zeroed IN PLACE, so the captured
        graphs, which read them by address, stay valid and nothing is
        captured again.

        ``fresh`` is for a stalled worker that did not come back: it may
        still copy into the graphs' static inputs and replay them.  Then
        the graphs are dropped and the pool is allocated anew (the old one
        dropped first), so the orphan's late writes land only in what it
        holds; each program is captured again at its next use, counted in
        ``graphs.captures``.  On the card a sticky error (an illegal
        address kills the context) makes this raise: no in-process reset
        revives it."""
        self._inflight_blocks.clear()
        self._prefill_job = None
        self._reserved.clear()
        # the step timeline died with the decode state (the black-box
        # dump captured its tail first)
        self.step_clock.reset()
        prefix_texts = [entry["text"] for entry in self._prefixes]
        self._prefixes = []
        if fresh:
            self.graphs.drop()
            self.paged_cache = self.cache = self.offsets = None
            self.last_tokens = None
            # an orphan may still replay a chunk graph into these
            self._job_buffers.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.paged:
            self.allocator = PageAllocator(self.allocator.num_pages)
        if fresh:
            self._alloc_decode_state()
        else:
            if self.paged:
                paged = self.paged_cache
                state = (paged.k_pages, paged.v_pages, paged.page_table, paged.lengths)
            else:
                state = (self.cache.k, self.cache.v, self.offsets)
            for tensor in (*state, self.last_tokens):
                tensor.zero_()
        for i in range(self.max_slots):
            self._slot_epoch[i] += 1
            self.slots[i] = _Slot()
        self._host_offsets[:] = 0
        self._sampling_cache = None
        self._guided_aut_np[:] = 0
        self._drop_guided_tables()
        # the pool was zeroed or rebuilt: re-prime every registered prefix
        # so admissions after the recovery keep their fast path.  A failed
        # re-prime must not fail the recovery: serving without the
        # optimisation beats staying down
        for text in prefix_texts:
            try:
                self.add_shared_prefix(text)
            except Exception:  # noqa: BLE001 - the prefix is an optimisation only
                log.warning(
                    "shared-prefix re-prime failed after reset; serving without it",
                    exc_info=True,
                )

    def free_slots(self) -> list[int]:
        return [
            i for i, slot in enumerate(self.slots)
            if not slot.active and i not in self._reserved
        ]

    @property
    def num_active(self) -> int:
        # a pending chunked job's slots count: they hold capacity and need
        # step() calls to progress before they decode
        return sum(1 for slot in self.slots if slot.active) + len(self._reserved)

    @property
    def num_decoding(self) -> int:
        return sum(1 for slot in self.slots if slot.active)

    # -- shared-prefix KV (the registered prompt preambles) ---------------

    #: registered-prefix cap: each entry holds up to max_seq / page_size
    #: pages for the engine's lifetime, so a runaway set of templates must
    #: not eat the pool
    MAX_SHARED_PREFIXES = 8

    @property
    def _prefix_tokens(self) -> list:
        """The first-registered prefix's tokens (single-prefix view)."""
        return self._prefixes[0]["tokens"] if self._prefixes else []

    @property
    def _prefix_pages(self) -> list:
        return self._prefixes[0]["pages"] if self._prefixes else []

    @property
    def prefix_held_pages(self) -> int:
        """KV pages owned by every registered prefix: held for the
        engine's lifetime, never in any slot's grant (the page audits
        subtract them)."""
        return sum(len(entry["pages"]) for entry in self._prefixes)

    def _prefix_keep_len(self, tokens: list) -> int:
        """Page-floored cacheable length of a prefix's tokens: at least
        one page of room for every suffix and its generation, and at
        least one suffix token, so the first sampled token has a logit
        row."""
        max_keep = self.max_seq - max(self.page_size, 64)
        return (min(len(tokens) - 1, max_keep) // self.page_size) * self.page_size

    def set_shared_prefix(self, text: str) -> int:
        """Replace every registered prefix with this one (an idle engine
        is required: live slots' tables may reference the released
        pages).  A text too short to cache leaves the registry as it is.
        See :meth:`add_shared_prefix`.  A contiguous engine caches
        nothing: JAX's warning, and 0."""
        if not self.paged:
            log.warning("set_shared_prefix needs paged KV; ignoring")
            return 0
        if self.num_active:
            raise RuntimeError(
                "set_shared_prefix requires an idle engine "
                f"({self.num_active} sequences active)"
            )
        if self._prefix_keep_len(self.tokenizer.encode(text)) < self.page_size:
            log.warning("shared prefix shorter than one page; not caching")
            return 0
        self.clear_shared_prefixes()
        return self.add_shared_prefix(text)

    def clear_shared_prefixes(self) -> None:
        """Release every registered prefix's pages (idle engine only).
        The prefixed programs stay: they are keyed by shape and shared
        length and take the prefix's pages as an input, so a later prefix
        of the same length replays them (the JAX generator drops its
        executables here)."""
        if self.num_active:
            raise RuntimeError(
                "clear_shared_prefixes requires an idle engine "
                f"({self.num_active} sequences active)"
            )
        for entry in self._prefixes:
            self.allocator.release(entry["pages"])
        self._prefixes = []

    def add_shared_prefix(self, text: str) -> int:
        """Prefill ``text``'s KV once into generator-owned pages; later
        waves whose every prompt starts with it forward only their
        suffix.

        Every explanation request shares one prompt template, so each
        template's static preamble is prefilled once.  Prefix pages are
        owned by the generator (never in a slot's grant, so a sequence's
        teardown cannot free them).  Sharing is decided per wave by token
        comparison against every registered prefix: the longest one that
        every row fully matches wins (``admission.py:_wave_prefix_match``);
        a wave matching none takes the plain prefill.  Over-budget
        prompts keep the prefix's head (``_truncate_prompt``).

        Safe while serving, on the worker between steps: registration
        only allocates pages and writes them (the release paths, set and
        clear, need an idle engine).  Idempotent by cached tokens, capped
        at :attr:`MAX_SHARED_PREFIXES`, and refused when it would leave
        less than one full sequence's pages grantable.  The build is one
        program per ``n_keep`` (flash prefill when enabled); its pages are
        released if it fails.  Returns the number of prefix tokens cached
        (0: nothing cached, as in a contiguous engine, which logs JAX's
        warning)."""
        if not self.paged:
            log.warning("add_shared_prefix needs paged KV; ignoring")
            return 0
        tokens = self.tokenizer.encode(text)
        n_keep = self._prefix_keep_len(tokens)
        if n_keep < self.page_size:
            log.warning("shared prefix shorter than one page; not caching")
            return 0
        for entry in self._prefixes:
            if entry["tokens"] == tokens[:n_keep]:
                return n_keep  # idempotent: already cached
        if len(self._prefixes) >= self.MAX_SHARED_PREFIXES:
            log.warning(
                "shared-prefix registry full (%d); %r not cached",
                self.MAX_SHARED_PREFIXES, text[:60],
            )
            return 0
        need = n_keep // self.page_size
        if self.allocator.available - need < self.pages_per_seq:
            # a refused prefix costs a full prefill, never a request
            log.warning(
                "shared prefix %r needs %d pages but only %d are free "
                "(one-sequence reserve %d); not cached",
                text[:60], need, self.allocator.available, self.pages_per_seq,
            )
            return 0
        pages = self.allocator.allocate(need)
        program = self._prefix_build_fns.get(n_keep)
        if program is None:
            program = self._prefix_build_fns[n_keep] = self._aot_wrap(
                f"prefix_build_k{n_keep}", self._prefix_build, fixed_args=(0,),
                fixed_fields=("k_pages", "v_pages"),
            )
        from ..ops.flash_prefill import flash_prefill_enabled

        try:
            # writes the pages in place; the engine's tables are untouched
            program(
                self.params, self.paged_cache,
                self._to_device(np.asarray([tokens[:n_keep]], np.int32)),
                self._to_device(np.asarray([pages], np.int32)),
                key=(n_keep,), variant=flash_prefill_enabled(),
            )
        except BaseException:
            self.allocator.release(pages)
            raise
        self._prefixes.append({"text": text, "tokens": tokens[:n_keep], "pages": pages})
        log.info("shared prefix cached: %d tokens in %d pages (%d registered)",
                 n_keep, len(pages), len(self._prefixes))
        return n_keep

    # -- the wave engine ------------------------------------------------

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _activate_slots(
        self, first_np: np.ndarray, lengths: np.ndarray, taken: list[int],
        params_list: Sequence[SamplingParams], page_grants: list[list[int]],
        prefill_ms: float,
    ) -> list[int]:
        """Prompt KV is in the cache and first tokens are sampled: flip the
        slots live.  In contiguous mode each slot's device offset is set to
        its prompt length, in place (the decode graphs read the vector by
        address); the host shadow stays the truth, so nothing is read
        back, where JAX reads the offsets to the host here."""
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
                params=params_list[row], pages=page_grants[row] if self.paged else [],
                generated=[int(first_np[row])], started=started,
                prefill_ms=prefill_ms,
                decode_cum0=self.step_clock.decode_cum_ms,
            )
            self._host_offsets[slot_id] = int(lengths[row])
        rows = self._to_device(np.asarray(taken, np.int64))
        self.last_tokens[rows, 0] = self._to_device(
            first_np[: len(taken)].astype(np.int32)
        )
        if not self.paged:
            self.offsets[rows] = self._to_device(
                np.asarray(lengths[: len(taken)], np.int32)
            )
        self._sampling_cache = None  # slot set changed
        return list(taken)

    def _sampling_tensors(self) -> tuple:
        """(active_np, temp_dev, top_p_dev, active_dev, adapter_idx_dev),
        rebuilt only when the slot set changes (admit/finish) — not every
        decode step."""
        if self._sampling_cache is None:
            active = np.array([s.active for s in self.slots])
            temp = np.array(
                [s.params.temperature if s.active else 0.0 for s in self.slots],
                np.float32,
            )
            top_p = np.array(
                [s.params.top_p if s.active else 1.0 for s in self.slots], np.float32
            )
            adapter_idx = np.array(
                [self._adapter_ids[s.params.adapter] if s.active else 0
                 for s in self.slots],
                np.int64,
            )
            self._sampling_cache = (
                active, self._to_device(temp), self._to_device(top_p),
                self._to_device(active), self._to_device(adapter_idx),
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
            if self.abandoned():
                raise RuntimeError("worker abandoned during its step")
        # on a serving mesh, the part every rank makes (serving/meshserve.py)
        return self._step()

    def _step(self) -> list[tuple[int, GenerationResult]]:
        """:meth:`step` past its chaos seam."""
        if self._prefill_job is not None:
            # one chunk per round: live slots' next block waits for at
            # most one chunk
            self._advance_prefill()
        started = time.perf_counter()
        if self.num_decoding:
            # held slots (decoding and reserved) over capacity, as the
            # continuous scheduler's occupancy is defined
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
        active, temp_dev, top_p_dev, active_dev, idx_dev = self._sampling_tensors()
        lora_idx = idx_dev if self.lora is not None else None
        begin = end = None
        cuda = self.device.type == "cuda"
        if cuda:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
        program = (
            self._decode_program if self._guided_tables is None
            else self._decode_guided_program
        )
        rest = (temp_dev, top_p_dev, active_dev, self.lora, lora_idx,
                self._guided_tables, self.guided_aut, self.guided_state)
        if self.paged:
            self.paged_cache, toks, self.last_tokens, state = program(
                self.params, self.paged_cache, self.last_tokens, *rest,
                key=self._decode_key(),
            )
        else:
            # the offsets advance in place, inside the program
            self.cache, toks, self.last_tokens, state = program(
                self.params, self.cache, self.last_tokens, self.offsets, *rest,
                key=self._decode_key(),
            )
        self.guided_state = state  # None while no guided slot is active
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

    def _decode_key(self) -> tuple:
        """The decode block's program key: its shape, whether the adapter
        stack rides along, and the guided tables' padded shape."""
        tables = self._guided_tables
        return (
            self.max_slots, self.decode_block, self.lora is not None,
            None if tables is None else tuple(tables.shape[:2]),
        )

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the pending job, or its finish program.

        The last chunk is partial where ``t_pad`` is not a multiple of the
        chunk (buckets clamp to ``max_seq``).  The chunks write only the
        job's own buffers; the page tables are staged at the finish, from
        the engine's tables as they are then, and committed from the
        finish program's return, so a failure at any chunk leaves the
        device state untouched and an interleaved block's commit is never
        overwritten.  A contiguous finish scatters into the slots' rows,
        which no live slot reads."""
        job = self._prefill_job
        n_pad, t_pad = job.key
        t0 = time.perf_counter()
        if job.written < t_pad:
            step_chunk = min(self.prefill_chunk, t_pad - job.written)
            fn_key = (n_pad, t_pad, step_chunk)
            program = self._chunk_fns.get(fn_key)
            if program is None:
                log.info("capturing prefill chunk n=%d t=%d chunk=%d", n_pad, t_pad, step_chunk)
                # params, the mini cache, the last logits and the adapter
                # stack are read in place, by address
                program = self._chunk_fns[fn_key] = self._aot_wrap(
                    f"chunk_n{n_pad}_t{t_pad}_c{step_chunk}", self._prefill_chunk,
                    fixed_args=(0, 1, 5, 6),
                )
            with torch.profiler.record_function("podmortem.prefill_chunk"):
                program(
                    self.params, job.mini, job.ids[:, job.written: job.written + step_chunk],
                    job.lengths, job.offsets[job.written // self.prefill_chunk],
                    job.last_logits, self.lora, job.adapter_idx, key=fn_key,
                )
            job.written += step_chunk
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            job.chunk_ms += elapsed_ms
            self.metrics.record("prefill_chunk", elapsed_ms)
            if job.written < t_pad:
                return
            t0 = time.perf_counter()  # the finish is timed on its own
        # every chunk written: scatter and sample, then activate.  Guided
        # rows mask the first token here; their automaton ids are resolved
        # NOW (waves admitted between the chunks may have restacked)
        job_specs = [self._guided_spec(p) for p in job.params_list]
        if any(job_specs) or self._guided_tables is not None:
            self._refresh_guided_tables(job_specs)
        # whenever tables are live every activated slot gets its binding
        # (the identity for unguided rows): a recycled slot may hold a
        # stale state whose padding row would mask every logit
        guided = self._guided_tables is not None
        row_aut = self._guided_row_aut(job_specs, n_pad) if guided else None
        fn_key = (n_pad, t_pad, guided)
        program = self._finish_fns.get(fn_key)
        if program is None:
            program = self._finish_fns[fn_key] = self._aot_wrap(
                f"finish_n{n_pad}_t{t_pad}_g{int(guided)}", self._prefill_finish,
                fixed_args=(1, 4, 7),
                fixed_fields=("k_pages", "v_pages") if self.paged else ("k", "v"),
                generators=(self._rng,),
            )
        if self.paged:
            cache, rows = self._stage_page_tables(
                len(job.taken), n_pad, job.slot_ids_np, job.page_grants, job.lengths_np,
            )
        else:
            # JAX's contiguous finish: the slots' rows, by slot id
            cache, rows = self.cache, job.slot_ids_np.astype(np.int64)
        with torch.profiler.record_function("podmortem.prefill_finish"):
            cache, first_tokens, first_state = program(
                cache, job.mini, job.lengths, self._to_device(rows),
                job.last_logits, job.temp, job.top_p, self._guided_tables,
                self._to_device(row_aut) if guided else None, key=fn_key,
            )
            first_np = first_tokens.cpu().numpy()  # the job's ONE host sync
        if self.paged:  # the contiguous cache was written in place
            self.paged_cache = cache
        self._prefill_job = None
        self._reserved.difference_update(job.taken)
        finish_ms = (time.perf_counter() - t0) * 1e3
        self._activate_slots(
            first_np, job.lengths_np, job.taken, job.params_list, job.page_grants,
            job.chunk_ms + finish_ms,
        )
        if guided:
            self._apply_guided_activation(row_aut, job.taken, first_state)

    def _job_buffers_for(self, n_pad: int, t_pad: int) -> tuple:
        """The (mini cache, last logits) pair of a ``(n_pad, t_pad)`` job,
        allocated at its first job: the chunk graphs read and write them
        in place, so a chunk copies neither (at 16 x 2,048 tinyllama's
        mini cache is 738 MB).  Their contents need no reset between
        jobs: every cache slot a chunk attends to was written by an
        earlier chunk of the same job, and every row's last logits land
        in exactly one chunk."""
        buffers = self._job_buffers.get((n_pad, t_pad))
        if buffers is None:
            rows = n_pad // (1 if self.shard is None else self.shard.data)  # this rank's
            buffers = self._job_buffers[(n_pad, t_pad)] = (
                self._mini_cache(rows, t_pad, self.cache_dtype, self.device),
                torch.zeros(
                    (rows, self.config.vocab_size), dtype=torch.float32, device=self.device
                ),
            )
        return buffers

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
        if self._guided_tables is not None:
            if self._guided_aut_np[slot_id]:
                self._guided_aut_np[slot_id] = 0
                self.guided_aut = self._to_device(self._guided_aut_np)
                # the identity automaton has one state: a stale state would
                # index a padding row (all -1), and the sampler would face
                # an all -inf row (an error for torch.multinomial, where the
                # JAX sampler draws junk into the freed slot)
                self.guided_state[slot_id] = 0
            if not self._guided_aut_np.any() and not any(
                s.active and self._guided_spec(s.params)
                for i, s in enumerate(self.slots)
                if i != slot_id  # this slot is finishing right now
            ):
                self._drop_guided_tables()  # back to the unguided block
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

    # -- guided decoding registry (serving/guided.py) --------------------

    #: automaton-state cap: bounds the [A_pad, S_pad, vocab] int32 table the
    #: guided block carries; matches _refresh_guided_tables' s_pad clamp so
    #: an oversized request is refused at SUBMIT time, never at admission
    MAX_GUIDED_STATES = 1 << 14

    @staticmethod
    def _guided_spec(params: Optional[SamplingParams]) -> Optional[tuple]:
        """The hashable automaton key of a request: ("choice", names) or
        ("regex", pattern); None = unconstrained."""
        if params is None:
            return None
        if params.guided_choice is not None:
            return ("choice", tuple(params.guided_choice))
        if params.guided_regex is not None:
            return ("regex", str(params.guided_regex))
        return None

    def _automaton_cached(self, spec: tuple) -> bool:
        """Lock-guarded cache probe (with the LRU touch), so submit paths
        skip the build for specs already built."""
        with self._guided_lock:
            if spec in self._guided_cache:
                self._guided_cache[spec] = self._guided_cache.pop(spec)
                return True
        return False

    def _ensure_automaton(self, spec: tuple) -> None:
        """Build (and cache) the automaton of a guided spec; raises
        ``ValueError`` for anything unservable — called at SUBMIT time, so
        a bad request never fails a co-batched wave.

        The cache is an LRU of 32 that never evicts a spec bound to an
        active slot, indexed in the current stacked tables, or in the
        refresh pass in flight (``_guided_protect``): the worker indexes
        the cache directly for those.  The bookkeeping holds
        ``_guided_lock``; the build (seconds for a novel regex) runs
        outside it, so it never stalls the worker or the event loop."""
        if self._automaton_cached(spec):
            return
        kind, payload = spec
        if kind == "choice":
            from .guided import build_choice_automaton

            automaton = build_choice_automaton(
                payload, self.tokenizer, self.config.vocab_size
            )
        else:
            from .regex_dfa import compile_regex_automaton

            automaton = compile_regex_automaton(
                payload, self.tokenizer, self.config.vocab_size,
                max_states=self.MAX_GUIDED_STATES,
            )
        if automaton.num_states > self.MAX_GUIDED_STATES:
            raise ValueError(
                f"guided automaton needs {automaton.num_states} states, "
                f"above the {self.MAX_GUIDED_STATES} cap — simplify the "
                f"choices/pattern"
            )
        with self._guided_lock:
            if spec in self._guided_cache:  # raced another builder: theirs won
                self._guided_cache[spec] = self._guided_cache.pop(spec)
                return
            live = {
                self._guided_spec(slot.params) for slot in self.slots if slot.active
            }
            live.update(self._guided_index)
            live.update(self._guided_protect)
            live.discard(None)
            evictable = [k for k in self._guided_cache if k not in live]
            while len(self._guided_cache) >= 32 and evictable:
                self._guided_cache.pop(evictable.pop(0))
            self._guided_cache[spec] = automaton

    def _refresh_guided_tables(self, wave_specs: "list[Optional[tuple]]") -> None:
        """(Re)stack the automata the active and newly admitted guided slots
        need; None when no guided slot remains (the unguided block)."""
        from .guided import identity_automaton, stack_automata

        specs = {
            self._guided_spec(slot.params)
            for slot in self.slots
            if slot.active and self._guided_spec(slot.params)
        }
        specs.update(spec for spec in wave_specs if spec)
        if not specs:
            self._drop_guided_tables()
            return
        # advertise the wave to submit-thread evictions BEFORE ensuring
        with self._guided_lock:
            self._guided_protect = frozenset(specs)
        try:
            for spec in specs:
                self._ensure_automaton(spec)
            with self._guided_lock:
                ordered = sorted(specs)
                new_index = {spec: i + 1 for i, spec in enumerate(ordered)}
                if self._guided_tables is not None and new_index == self._guided_index:
                    return  # the same stack: no rebuild, no upload
                automata = [identity_automaton(self.config.vocab_size)]
                automata += [self._guided_cache[spec] for spec in ordered]
                self._guided_index = new_index
        finally:
            with self._guided_lock:
                self._guided_protect = frozenset()
        a_pad = _bucket(len(automata), 2, 64)
        s_pad = _bucket(max(a.num_states for a in automata), 8, self.MAX_GUIDED_STATES)
        while len(automata) < a_pad:
            automata.append(identity_automaton(self.config.vocab_size))
        stacked = torch.from_numpy(
            stack_automata(automata, self.config.vocab_size, state_pad=s_pad)
        )
        buffer = self._guided_buffers.get(tuple(stacked.shape))
        if buffer is None:
            buffer = stacked.to(self.device)
            self._guided_buffers[tuple(stacked.shape)] = buffer
        else:
            # in stream order: blocks already dispatched read the old stack
            buffer.copy_(stacked)
        self._guided_tables = buffer
        # remap every ACTIVE slot's automaton id under the new ordering
        for i, slot in enumerate(self.slots):
            spec = self._guided_spec(slot.params) if slot.active else None
            self._guided_aut_np[i] = self._guided_index[spec] if spec else 0
        self.guided_aut = self._to_device(self._guided_aut_np)
        if self.guided_state is None:
            self.guided_state = torch.zeros(
                (self.max_slots,), dtype=torch.int64, device=self.device
            )

    def _drop_guided_tables(self) -> None:
        """No guided slot is active: the unguided block runs again."""
        self._guided_tables = None
        self._guided_index = {}
        self.guided_aut = None
        self.guided_state = None

    def _guided_row_aut(self, specs: list, n_pad: int) -> np.ndarray:
        """[n_pad] automaton ids of a wave's rows (padding rows duplicate
        row 0); id 0 = identity for unguided rows."""
        row_aut = np.zeros((n_pad,), np.int64)
        for row, spec in enumerate(specs):
            row_aut[row] = self._guided_index.get(spec, 0)
        row_aut[len(specs):] = row_aut[0]
        return row_aut

    def _apply_guided_activation(
        self, row_aut: np.ndarray, taken: list[int], first_state: torch.Tensor
    ) -> None:
        """Bind each admitted slot's automaton id (0, the identity, for
        unguided slots — this RESET matters: a recycled slot may carry a
        stale accept state from a previous guided occupant) and scatter
        the first DFA states, on the device."""
        for row, slot_id in enumerate(taken):
            self._guided_aut_np[slot_id] = row_aut[row]
        self.guided_aut = self._to_device(self._guided_aut_np)
        rows = self._to_device(np.asarray(taken, np.int64))
        self.guided_state[rows] = first_state[: len(taken)].to(torch.int64)

    def close(self) -> None:
        """End a serving mesh's followers (rank 0, once the worker has
        stopped); nothing to do on one rank."""
        if self.mirror is not None:
            self.mirror.close()

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
    #: supervised restarts this request has been requeued through
    requeues: int = 0


class _HostTask:
    """Store work for the worker's next step boundary (the fabric
    prefetch's probe and adoption)."""

    def __init__(self, fn: Any) -> None:
        self.fn = fn
        self.future: concurrent.futures.Future = concurrent.futures.Future()


class _WorkerExecutor(concurrent.futures.Executor):
    """``loop.run_in_executor`` onto the engine's worker: each call runs
    on the worker thread between steps, holding the worker lock, so it
    is serialized with everything the scheduler does to its store (the
    port's counterpart of the reference's single-thread decode
    executor)."""

    def __init__(self, engine: "ServingEngine") -> None:
        self._engine = engine

    def submit(self, fn, /, *args, **kwargs) -> concurrent.futures.Future:
        return self._engine._submit_host_task(functools.partial(fn, *args, **kwargs))


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
    reference's serve loops do.

    ``supervisor`` (a :class:`SupervisorPolicy`) turns on the watchdog;
    ``recorder`` (an ``obs.FlightRecorder``, default the process-wide
    one) takes its black-box records."""

    #: recovery budget: at most this many resets per window, so a
    #: persistent device fault surfaces instead of thrashing
    MAX_RESETS_PER_WINDOW = 3
    RESET_WINDOW_S = 600.0

    def __init__(
        self,
        generator: Generator,
        scheduler: Any = None,
        *,
        admission_wait_s: float = 0.004,
        supervisor: Optional[SupervisorPolicy] = None,
        recorder: Optional[Any] = None,
    ) -> None:
        self.generator = generator
        self.scheduler = scheduler
        #: wave mode: a short window that lets concurrent arrivals share
        #: one prefill
        self.admission_wait_s = admission_wait_s
        self._submissions: "queue.Queue[_Submission]" = queue.Queue()
        #: requests in flight, keyed by scheduler req id (continuous) or
        #: slot id (wave), kept whole so a restart can requeue them
        self._pending: dict[int, _Submission] = {}
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
        #: fleet KV fabric (``fabric/``): a ``FabricFetcher`` wired after
        #: construction when KV_FABRIC=1; admission-time prefix misses then
        #: consult the fleet index and pull pages from a holder's host pool
        #: instead of recomputing.  None = local only (the default)
        self.fabric: Optional[Any] = None
        #: ``fabric/peers.py:PeerPoller`` feeding the fetcher's index from
        #: peer /healthz inventories (KV_FABRIC_PEERS); runs on the event
        #: loop of the first ``generate`` or server start, cancelled by close
        self.fabric_poller: Optional[Any] = None
        self._fabric_poll_task: Optional[asyncio.Task] = None
        #: runs host work on the worker at a step boundary, holding the
        #: worker lock: the fabric prefetch's store probe and adoption,
        #: and the profiler's start and stop (``/profile``), which must
        #: not race a graph replay
        self.store_executor = _WorkerExecutor(self)
        self._host_tasks: "queue.SimpleQueue[_HostTask]" = queue.SimpleQueue()
        #: set with every submission or store task: wakes an idle worker
        self._kick = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._error: Optional[BaseException] = None
        #: watchdog policy; None = loop death fails in-flight requests and
        #: recovery is lazy
        self._supervisor = supervisor
        self.recorder = recorder
        #: held by the worker except inside its device calls: whoever
        #: holds it may read and change the request state
        self._work_lock = threading.Lock()
        #: the current worker's generation: a worker whose epoch is stale
        #: was abandoned and touches nothing more
        self._epoch = 0
        self._local = threading.local()
        generator.abandoned = self._abandoned
        #: (epoch, monotonic start, what) of the device call in progress
        self._busy: Optional[tuple[int, float, str]] = None
        self._wake = threading.Event()
        #: a stalled worker that came back from its device call parks and
        #: is handed the next epoch (a fresh thread takes over only when
        #: it stays wedged past the grace): no thread exits and starts
        #: around a restart
        self._orphan_back = threading.Event()
        self._returned: Optional[threading.Thread] = None  # the orphan that came back
        self._handoff = threading.Event()
        self._handoff_to: Optional[tuple[threading.Thread, int]] = None
        self._supervise_thread: Optional[threading.Thread] = None
        self._stalled = False  # the last loop death was a stall
        self._gave_up = False  # the reset budget ran out, or a reset failed
        # survivors of a restart in progress: close() still fails them
        self._restarting: list[_Submission] = []
        self._reset_times: list[float] = []
        self._reset_lock = threading.Lock()
        #: single-flight guided automaton builds (ensure_guided), per spec
        self._guided_builds: dict[tuple, asyncio.Future] = {}

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

    def _precompile(self, level: str) -> dict:
        """The warmup grid (see :meth:`precompile`), on the caller's
        thread, before the worker starts."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("precompile must run before the engine starts")
            if level not in ("off", "serving", "full"):
                raise ValueError(
                    f"warmup grid level {level!r}: expected off/serving/full"
                )
            g = self.generator
            if level != "off" and g.device.type == "cuda":
                # every kernel built (in parallel) before readiness; found
                # built in the build directory on a warm boot
                from ..ops import _build

                _build.build_all()
            if self.scheduler is None:
                return g.precompile_grid(level)
            # continuous: ONE mixed program, whatever the workload
            if level == "off":
                return {"level": level, "programs": 0, "seconds": 0.0}
            started = time.perf_counter()
            self.scheduler.precompile()
            out = {
                "level": level, "programs": 1,
                "seconds": round(time.perf_counter() - started, 2),
            }
            if g._aot is not None:
                out["aot"] = g._aot.stats()
            return out

    async def precompile(self, level: str = "serving") -> dict:
        """Capture the serving programs before serving traffic, off the
        event loop: the wave engine's grid (``precompile_grid``) or the
        continuous scheduler's ONE mixed program.  Readiness gates on it
        (``operator/app.py``).  Returns the JAX engine's dict: ``level``,
        ``programs``, ``seconds`` (the grid adds ``skipped_waves``) and,
        with an AOT cache, ``aot``.  Must run before the first submit."""
        return await asyncio.to_thread(self._precompile, level)

    def start(self) -> None:
        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("serving engine is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, args=(self._epoch,), name="torch-decode",
                    daemon=True,
                )
                self._thread.start()
            if self._supervisor is not None and self._supervise_thread is None:
                self._supervise_thread = threading.Thread(
                    target=self._supervise, name="torch-supervisor", daemon=True
                )
                self._supervise_thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker and fail every request still outstanding with
        ``asyncio.CancelledError("serving engine closed")``, as the
        reference does (the HTTP server answers "server shutting down").
        A restart in progress is waited for (bounded), not interrupted."""
        self._closed.set()
        self._wake.set()
        self._handoff.set()  # a parked orphan exits
        poll, self._fabric_poll_task = self._fabric_poll_task, None
        if poll is not None and not poll.done():
            # the peer poller is index plumbing on its loop: nothing waits on it
            try:
                poll.get_loop().call_soon_threadsafe(poll.cancel)
            except RuntimeError:  # its loop is already closed
                pass
        supervise = self._supervise_thread
        if supervise is not None:
            supervise.join(5.0 + self._supervisor.join_grace_s)
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                log.warning("serving worker did not stop within %.0fs", timeout)
        self._fail_outstanding(asyncio.CancelledError("serving engine closed"))
        # a serving mesh's followers stop with the engine
        close = getattr(self.generator, "close", None)
        if close is not None:
            close()

    # -- submit side ---------------------------------------------------

    def _recover_if_needed(self) -> None:
        """The reference's checks at the head of ``generate``: a given-up
        engine revives once its reset window has room; an unsupervised
        engine whose loop died resets now (lazy recovery).  Raises when
        the engine stays down."""
        if self._gave_up:
            # the reset budget is a rate limit, not a death sentence
            now = time.monotonic()
            in_window = [t for t in self._reset_times if now - t < self.RESET_WINDOW_S]
            if len(in_window) < self.MAX_RESETS_PER_WINDOW and not self._closed.is_set():
                if self._error is not None:
                    self._try_recover()
                if self._gave_up and self._error is None:
                    self._gave_up = False
            if self._gave_up:
                raise RuntimeError(
                    "serving engine is down (supervisor reset budget exhausted)"
                ) from self._error
        if self._supervisor is None:
            # supervised engines restart on their own: a death seen here
            # is mid-restart, and the queue survives it
            if self._error is not None:
                self._try_recover()
            if self._error is not None:
                raise RuntimeError("serving engine loop died") from self._error

    def _check_submission(
        self, params: Optional[SamplingParams], resume_tokens: Optional[list]
    ) -> None:
        """The verdicts a request gets before it takes a queue place (or,
        with the fabric, prefetches): a closed or down engine, an unknown
        LoRA adapter (so a bad name fails its own request, never the
        co-batched wave), both guided fields at once, a guided or LoRA
        request on the continuous scheduler, ``resume_tokens`` without
        the scheduler, a deadline that cannot fit one decoded token."""
        if self._closed.is_set():
            raise RuntimeError("serving engine is closed")
        self._recover_if_needed()
        adapter = params.adapter if params is not None else None
        if adapter is not None and adapter not in self.generator._adapter_ids:
            raise ValueError(
                f"unknown LoRA adapter {adapter!r}; registered: "
                f"{self.generator.adapter_names}"
            )
        if params is not None and params.guided_choice is not None \
                and params.guided_regex is not None:
            raise ValueError("guided_choice and guided_regex are mutually exclusive")
        if self.scheduler is not None and params is not None and (
            params.guided_choice is not None
            or params.guided_regex is not None
            or params.adapter is not None
        ):
            # the mixed step has no guided/LoRA path: refuse at submit, to
            # this caller, rather than inside the serve loop
            raise ValueError(
                "guided decoding and LoRA adapters are not supported in "
                "continuous scheduler mode (sched_mode=continuous)"
            )
        if resume_tokens and self.scheduler is None:
            raise ValueError(
                "token-level streaming resume requires the continuous "
                "scheduler (sched_mode=continuous)"
            )
        self._check_deadline(params)

    def _check_deadline(self, params: Optional[SamplingParams]) -> None:
        """Fail fast when the request's deadline cannot fit one decoded
        token."""
        if params is not None and params.deadline is not None:
            # admission re-runs the policy with the residue left after the
            # queue wait and owns the clamp
            g = self.generator
            _, outcome = g.deadline_policy(params)
            if outcome == "rejected":
                g.metrics.incr("admission_deadline_rejected")
                raise DeadlineExceeded(
                    "deadline budget cannot fit any decoded output "
                    f"(remaining {max(0.0, params.deadline - g._clock()):.3f}s)"
                )

    def submit(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        *,
        priority: int = 0,
        resume_tokens: Optional[list] = None,
        on_partial: Optional[tuple] = None,
        _checked: bool = False,
    ) -> "concurrent.futures.Future[GenerationResult]":
        """Queue one request; raises ``ValueError`` for an unknown adapter,
        an unservable guided spec (its automaton is built here, on this
        thread, when not cached), a guided or LoRA request on the
        continuous scheduler or ``resume_tokens`` without it, and
        :class:`DeadlineExceeded` when its budget cannot fit one decoded
        token — all to this caller, before the request takes a queue
        place.  ``priority`` orders admission (higher first, FIFO
        within a class).  ``on_partial`` is ``(loop, callback)``: each
        step's generated-so-far ids reach ``callback`` on ``loop``.
        ``_checked``: ``generate`` ran the verdicts (and the guided build)
        before its awaits; only the closed engine and the deadline, which
        those waits may have used up, are checked again."""
        feed = None
        if on_partial is not None:
            feed = _PartialFeed(*on_partial)
        if not _checked:
            self._check_submission(params, resume_tokens)
            spec = self.generator._guided_spec(params)
            if spec is not None:
                self.generator._ensure_automaton(spec)
        elif self._closed.is_set():
            raise RuntimeError("serving engine is closed")
        else:
            self._check_deadline(params)
        future: concurrent.futures.Future = concurrent.futures.Future()
        if feed is not None:
            feed.future = future
        self._submissions.put(_Submission(
            prompt, params or SamplingParams(), time.perf_counter(), priority, future,
            resume_tokens=list(resume_tokens) if resume_tokens else None,
            partial=feed,
        ))
        self._kick.set()
        if self._supervisor is None and self._error is not None:
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
        carries only the continuation (continuous mode only).  A lazy
        recovery's reset runs off this loop."""
        loop = asyncio.get_running_loop()
        if self._error is not None or self._gave_up:
            await asyncio.to_thread(self._recover_if_needed)
        self.start_fabric_poll()
        fabric = self.fabric is not None and self.scheduler is not None
        guided_spec = self.generator._guided_spec(params)
        checked = fabric or guided_spec is not None
        if checked:
            self._check_submission(params, resume_tokens)
        if guided_spec is not None:
            # builds and caches the automaton off this loop; raises
            # ValueError here, to THIS caller, for an unservable spec
            await self.ensure_guided(guided_spec)
        if fabric:
            # fleet KV fabric: once the request passed its verdicts, pull
            # the prompt's missing prefix blocks from a peer's host pool
            # BEFORE admission so the scheduler's prefix match restores
            # them instead of recomputing.  Best effort, residual-budget
            # clamped: a failed fetch degrades to the ordinary recompute,
            # never an error to this caller
            await self._fabric_prefetch(prompt, params, resume_tokens)
        future = self.submit(
            prompt, params, priority=priority, resume_tokens=resume_tokens,
            on_partial=(loop, on_partial) if on_partial is not None else None,
            _checked=checked,
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

    async def ensure_guided(self, spec: tuple) -> None:
        """Build (and cache) the automaton of a guided spec; raises
        ``ValueError`` for a bad spec.

        The build (a regex's NFA and subset construction take seconds for
        a novel spec) runs on the loop's default executor: not inline (it
        would stall every connection on the loop) and not on the worker
        (it would delay the decode steps behind it).  A cached spec
        returns without the executor hop; concurrent callers with the
        same novel spec share one build (shielded, so a cancelled waiter
        never kills the build for the others).  The one entry point for
        ``generate`` and the HTTP server's validation."""
        if self.generator._automaton_cached(spec):
            return
        build = self._guided_builds.get(spec)
        if build is None:
            build = asyncio.get_running_loop().run_in_executor(
                None, self.generator._ensure_automaton, spec
            )
            self._guided_builds[spec] = build

            def _done(fut: "asyncio.Future") -> None:
                self._guided_builds.pop(spec, None)
                if not fut.cancelled():
                    fut.exception()  # retrieved even with no waiter left

            build.add_done_callback(_done)
        await asyncio.shield(build)

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
        estimate, whether the supervisor gave up, the step clock's
        summary, the SLO board, the KV economy and the overload ladder's
        totals.  Cheap reads from any thread; approximate under
        concurrent decode, which the router treats as feedback, not
        truth.  Served on ``GET /healthz``."""
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
        # a contiguous replica has no pages: 0 and 0, as the JAX server says
        allocator = g.allocator
        return ReplicaLoad(
            queue_depth=queue_depth,
            inflight=inflight,
            decode_token_s=g.decode_token_estimate_s(),
            gave_up=self._gave_up,
            decode_mfu=summary.get("decode_mfu"),
            host_gap_frac=fractions.get("host_gap"),
            occupancy=summary.get("occupancy_avg"),
            steps=summary.get("steps") or 0,
            slo_attainment=self._slo_board.attainment(),
            goodput_tokens_s=self._slo_board.goodput_tokens_s(),
            slo_completed=self._slo_board.completed,
            slo_classes=self._slo_board.per_class(),
            kv_pages_free=allocator.available if allocator is not None else 0,
            kv_pages_total=allocator.num_pages - 1 if allocator is not None else 0,
            prefix_hit_rate=kvstore.hit_rate() if kvstore is not None else None,
            prefix_lookups=kvstore.lookups if kvstore is not None else 0,
            kv_blocks=kvstore.inventory() if kvstore is not None else None,
            role=self.replica_role,
            shed=g.metrics.labeled_total("shed"),
            degraded=g.metrics.labeled_total("degraded"),
        )

    # -- the fleet KV fabric ---------------------------------------------

    def start_fabric_poll(self) -> None:
        """Run the peer poller (``fabric_poller``) on the running event
        loop, unless it already runs; the reference's ``start`` does so.
        ``generate`` and ``CompletionServer.start`` call it."""
        task = self._fabric_poll_task
        if self.fabric_poller is None or (task is not None and not task.done()):
            return
        if self._closed.is_set():
            return
        self._fabric_poll_task = asyncio.get_running_loop().create_task(
            self.fabric_poller.run(), name="fabric-peer-poll"
        )

    async def _fabric_prefetch(
        self,
        prompt: str,
        params: Optional[SamplingParams],
        resume_tokens: Optional[list],
    ) -> None:
        """Admission-time fabric prefetch (``fabric/fetch.py``).

        Tokenizes exactly as the scheduler's enqueue will (same
        truncation budget, same resume suffix) so the probed block hashes
        line up with the prefix match that follows.  The cheap gates run
        first: no host pool to land pages in, or an index with no holders
        at all, costs the request nothing (not even the tokenize, which
        runs off the event loop).  The store probe and the adoption run
        on the worker at a step boundary, holding its lock
        (``store_executor``): the scheduler mutates the store from inside
        its step, which runs without that lock, so only the worker's own
        thread is serialized with it.  The fetches' budget is the
        request's residual deadline.  Never raises: every failure falls
        through to the recompute the request was going to do anyway."""
        from .types import prompt_budget

        store = getattr(self.scheduler, "_kvstore", None)
        if store is None:
            return
        pool = getattr(store, "host_pool", None)
        if pool is None or getattr(pool, "capacity_bytes", 0) <= 0:
            return  # nowhere to land a fetched page
        try:
            if self.fabric.index.empty():
                return  # no holders anywhere: nothing to fetch
            g = self.generator
            p = params or SamplingParams()

            def tokenize() -> Optional[list]:
                ids = g.tokenizer.encode(prompt)
                budget = prompt_budget(g.max_seq, p.max_tokens)
                if resume_tokens:
                    if len(resume_tokens) >= budget:
                        return None  # enqueue will reject it
                    return g._truncate_prompt(
                        ids, budget - len(resume_tokens)
                    ) + list(resume_tokens)
                return g._truncate_prompt(ids, budget)

            tokens = await asyncio.to_thread(tokenize)
            if tokens is None:
                return
            residual = None
            if p.deadline is not None:
                residual = p.deadline - g._clock()
            await self.fabric.prefetch(
                tokens, store=store, budget_s=residual,
                executor=self.store_executor,
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - the recompute covers every failure
            log.debug("fabric prefetch failed; recompute covers it", exc_info=True)

    def kv_block_bytes(self, hash_hex: str) -> Optional[bytes]:
        """Serve one KV block out of the host pool for a fabric peer
        (``GET /kv/blocks/{hash}``, ``serving/httpserver.py``): host
        tensors in, PMKV1 wire bytes out, no device and no scheduler.
        None when the block is not pooled here (the peer treats that 404
        as index-eviction feedback)."""
        from ..fabric.wire import encode_block

        metrics = self.generator.metrics
        store = getattr(self.scheduler, "_kvstore", None)
        pool = getattr(store, "host_pool", None)
        try:
            block_hash = bytes.fromhex(hash_hex)
        except ValueError:
            return None
        entry = pool.get(block_hash) if pool is not None else None
        if entry is None:
            metrics.incr("fabric_serve_miss", exemplar=hash_hex)
            return None
        metrics.incr("fabric_serve_hit", exemplar=hash_hex)
        return encode_block(block_hash, entry[0], entry[1])

    async def add_prefix(self, text: str) -> int:
        """Register a shared prompt prefix (``Generator.add_shared_prefix``)
        on the worker, between steps: safe while serving, since
        registration only allocates pages and writes them.  The programs
        of the new prefix's buckets are captured on their first waves
        (restart to fold them into the warmup grid).  Returns the prefix
        tokens cached (0: none)."""
        return await asyncio.wrap_future(
            self._submit_host_task(lambda: self.generator.add_shared_prefix(text))
        )

    def _submit_host_task(self, fn: Any) -> concurrent.futures.Future:
        """Queue ``fn()`` for the worker's next step boundary (either
        loop); its future carries the result."""
        if self._closed.is_set():
            raise RuntimeError("serving engine is closed")
        task = _HostTask(fn)
        self._host_tasks.put(task)
        self._kick.set()
        if self._supervisor is None and self._error is not None:
            # the worker died: nothing will run the task
            self._fail_outstanding(RuntimeError("serving engine loop died"))
            return task.future
        self.start()
        return task.future

    def _run_host_tasks(self) -> None:
        """Run the queued store tasks (worker thread, worker lock held)."""
        while True:
            try:
                task = self._host_tasks.get_nowait()
            except queue.Empty:
                return
            if not task.future.set_running_or_notify_cancel():
                continue
            try:
                result = task.fn()
            except BaseException as exc:  # noqa: BLE001 - handed to the caller
                task.future.set_exception(exc)
            else:
                task.future.set_result(result)

    def _fail_host_tasks(self, exc: BaseException) -> None:
        while True:
            try:
                task = self._host_tasks.get_nowait()
            except queue.Empty:
                return
            _settle(task.future, exc=exc)

    # -- recovery --------------------------------------------------------

    def _reset_engine(self, fresh: bool = False) -> None:
        """Rebuild the device state after a loop death or a stall
        (``fresh``: under a worker still wedged, see ``Generator.reset``).
        The scheduler drops its rows, queue and in-flight steps first, so
        nothing of the engine holds the old page pool when it is freed."""
        if self.scheduler is not None:
            self.scheduler.reset()
        self.generator.reset(fresh=fresh)

    def _try_recover(self) -> None:
        """One bounded attempt to revive a dead loop (lazy recovery): the
        requests in flight were already failed when it died.  Leaves
        ``_error`` set when the reset budget is spent or the reset
        fails."""
        with self._reset_lock, self._work_lock:
            if self._error is None or self._closed.is_set():  # raced another caller
                return
            now = time.monotonic()
            self._reset_times = [t for t in self._reset_times if now - t < self.RESET_WINDOW_S]
            if len(self._reset_times) >= self.MAX_RESETS_PER_WINDOW:
                return
            self._reset_times.append(now)
            log.warning(
                "serving engine loop died (%s); resetting device state and "
                "restarting (%d/%d resets in window)",
                self._error, len(self._reset_times), self.MAX_RESETS_PER_WINDOW,
            )
            try:
                self._reset_engine()
            except Exception as exc:  # noqa: BLE001 - the reset failed: stay down
                log.exception("engine reset failed; staying down")
                self._error = exc
                return
            with self._lock:
                self._error = None
                self._epoch += 1
                self._thread = None  # the caller's submit starts a fresh worker

    def _supervise(self) -> None:
        """The watchdog thread: spots a device call older than the stall
        budget, or is woken by a loop death, and runs the supervised
        restart — proactively, so in-flight work is requeued at once."""
        policy = self._supervisor
        while not self._closed.is_set():
            # the budget may be tightened after warmup: poll at a quarter
            woke = self._wake.wait(max(0.01, min(0.1, policy.stall_timeout_s / 4)))
            if woke:
                self._wake.clear()
            if self._closed.is_set():
                return
            if self._error is None:
                if not self._abandon_stalled(policy):
                    continue
            elif not woke:
                continue
            try:
                self._supervised_restart()
            except Exception:  # noqa: BLE001 - the watchdog must outlive one bad restart
                log.exception("supervised engine restart itself failed")

    def _abandon_stalled(self, policy: SupervisorPolicy) -> bool:
        """Declare a stall when the current worker's device call is older
        than the budget: bump the epoch so the worker, when its call
        returns, exits touching nothing."""
        busy = self._busy
        if busy is None or time.monotonic() - busy[1] <= policy.stall_timeout_s:
            return False
        with self._work_lock:
            busy = self._busy
            if (
                self._error is not None or busy is None or busy[0] != self._epoch
                or time.monotonic() - busy[1] <= policy.stall_timeout_s
            ):
                return False
            self._orphan_back.clear()
            self._returned = None
            self._handoff.clear()
            self._handoff_to = None
            self._epoch += 1
            self._busy = None
            self._stalled = True
            self._error = EngineStalled(
                f"{busy[2]} made no progress in {policy.stall_timeout_s:.1f}s"
            )
        log.error("serving engine stalled: %s", self._error)
        return True

    def _audit_leaks(self) -> dict:
        """After a reset every slot is free and every page is back in the
        pool; anything else is a reclamation bug, counted as
        ``supervisor_leak`` and written into the black box."""
        g = self.generator
        leaks: dict = {}
        free = len(g.free_slots())
        if free != g.max_slots:
            leaks["slots"] = g.max_slots - free
        if g.allocator is not None:
            expected = g.allocator.num_pages - 1 - g.prefix_held_pages
            if g.allocator.available != expected:
                leaks["pages"] = expected - g.allocator.available
        return leaks

    def _step_tail(self) -> list:
        """The last step records, taken before a reset wipes the clock."""
        try:
            return [r.to_dict() for r in self.generator.step_clock.ring.records(last=32)]
        except Exception:  # noqa: BLE001 - forensics must never block recovery
            return []

    def _dump_blackbox(self, reason: str, extra: dict) -> None:
        """A black-box record for a supervisor event: a one-span trace
        (the watchdog has no analysis trace of its own) carrying the
        restart's context."""
        recorder = self.recorder
        if recorder is None:
            from ..obs import RECORDER as recorder
        if "steps" not in extra:
            steps = self._step_tail()
            if steps:
                extra = {**extra, "steps": steps}
        try:
            from ..obs import Tracer

            tracer = Tracer(recorder=recorder)
            with tracer.trace("engine.supervisor", attributes={"reason": reason}) as root:
                pass
            recorder.black_box(root.trace_id, reason, extra)
        except Exception:  # noqa: BLE001 - forensics must never block recovery
            log.warning("supervisor black-box dump failed", exc_info=True)

    def _collect_survivors(self) -> "tuple[list[_Submission], int]":
        """Every outstanding request (admitted, waiting, queued) for the
        requeue; one already requeued ``max_requeues`` times fails now.
        Called with the worker lock held.  Returns (requeue list, gave-up
        count)."""
        requests = list(self._pending.values())
        self._pending.clear()
        self._partial_cbs.clear()  # re-armed from each submission's feed
        self._queue_wait_ms.clear()
        self._stalled_avail = None
        requests.extend(self._waiting)
        self._waiting.clear()
        while True:
            try:
                requests.append(self._submissions.get_nowait())
            except queue.Empty:
                break
        # a queued store task's prefetch falls back to recompute
        self._fail_host_tasks(RuntimeError("serving engine restarting"))
        retry: list[_Submission] = []
        gaveup = 0
        for item in requests:
            if item.future.done():
                continue
            if item.requeues >= self._supervisor.max_requeues:
                failure = RuntimeError(
                    "request failed after a supervised engine restart "
                    f"(requeued {item.requeues}x)"
                )
                failure.__cause__ = self._error
                _settle(item.future, exc=failure)
                self.generator.metrics.incr("supervisor_gaveup")
                gaveup += 1
            else:
                retry.append(item)
        return retry, gaveup

    def _fail_survivors(self, retry: "list[_Submission]", why: str) -> int:
        failed = 0
        for item in retry:
            if item.future.done():
                continue
            failure = RuntimeError(why)
            failure.__cause__ = self._error
            _settle(item.future, exc=failure)
            self.generator.metrics.incr("supervisor_gaveup")
            failed += 1
        return failed

    def _give_up_restart(
        self, retry: "list[_Submission]", gaveup: int, *,
        reason: str, cause: str, message: str, outcome: str,
    ) -> None:
        """The supervised restart's terminal exit: fail the survivors, mark
        the engine given up, fail what was submitted during the restart
        (no loop is left to take it) and leave a black-box record."""
        # given up before the survivors hear it: a caller woken by its
        # failure reads ``load_report().gave_up`` from another thread
        self._gave_up = True
        gaveup += self._fail_survivors(retry, message)
        self._restarting = []
        self._handoff.set()  # a parked orphan exits
        self._fail_outstanding(RuntimeError(message))
        self._dump_blackbox(reason, {
            "cause": cause, "gaveup": gaveup, "requeued": 0, "outcome": outcome,
        })

    def _supervised_restart(self) -> None:
        """Collect the survivors, retire a stalled worker, reset the device
        state (bounded resets per window), audit slots and pages, start a
        fresh worker, requeue the survivors once with their deadlines and
        leave a black-box record."""
        policy = self._supervisor
        restart_t0 = time.monotonic()
        stalled = self._stalled
        reason = "engine-stall" if stalled else "engine-error"
        cause = str(self._error)
        step_tail = self._step_tail()  # before the reset wipes the clock
        with self._work_lock:
            retry, gaveup = self._collect_survivors()
            # parked here until requeued or failed: close() reaches them
            self._restarting = retry
            old = self._thread
        returned = False
        if stalled:
            # the wedged worker cannot be interrupted: give the orphan a
            # bounded grace to come back, then reset under it anyway
            deadline = time.monotonic() + policy.join_grace_s
            while self._returned is not old and time.monotonic() < deadline:
                self._orphan_back.wait(deadline - time.monotonic())
                self._orphan_back.clear()
            returned = old is not None and self._returned is old
            if not returned:
                log.error(
                    "stalled worker still wedged after %.1fs; resetting "
                    "device state under it", policy.join_grace_s,
                )
            self._stalled = False
        now = time.monotonic()
        self._reset_times = [t for t in self._reset_times if now - t < self.RESET_WINDOW_S]
        if len(self._reset_times) >= self.MAX_RESETS_PER_WINDOW:
            self._give_up_restart(
                retry, gaveup, reason=reason, cause=cause,
                message="serving engine down: supervisor reset budget exhausted",
                outcome="reset-budget-exhausted",
            )
            log.error("engine supervisor giving up: %d resets within %.0fs",
                      self.MAX_RESETS_PER_WINDOW, self.RESET_WINDOW_S)
            return
        self._reset_times.append(now)
        try:
            with self._work_lock:
                # a worker still wedged may replay into the graphs and the
                # pool: it keeps them, and the engine takes fresh ones
                self._reset_engine(fresh=stalled and not returned)
        except Exception as exc:  # noqa: BLE001 - the reset failed: stay down
            log.exception("supervised engine reset failed; staying down")
            self._error = exc
            self._give_up_restart(
                retry, gaveup, reason=reason, cause=cause,
                message="serving engine down: device-state reset failed",
                outcome="reset-failed",
            )
            return
        leaks = self._audit_leaks()
        if leaks:
            self.generator.metrics.incr("supervisor_leak")
            log.error("post-reset leak audit failed: %s", leaks)
        for item in retry:
            item.requeues += 1
            # above the normal lanes (they were admitted once); the
            # deadline is an absolute instant, so the residual budget
            # carries through the restart
            item.priority = max(item.priority, 1)
            self.generator.metrics.incr("supervisor_requeue")
            self._submissions.put(item)
        self._kick.set()
        self._restarting = []
        with self._lock:
            self._error = None
            self._epoch += 1
            if returned and old is not None:
                # the orphan is parked: it carries on as this epoch's worker
                self._handoff_to = (old, self._epoch)
                self._handoff.set()
            else:
                self._thread = None
        if self._closed.is_set():
            return  # close() fails what was requeued
        self.start()
        self.generator.metrics.incr("supervisor_restart")
        ready_s = time.monotonic() - restart_t0
        self.generator.metrics.set_gauge("supervisor_restart_ready_seconds", round(ready_s, 3))
        self._dump_blackbox(reason, {
            "cause": cause,
            "requeued": len(retry),
            "gaveup": gaveup,
            "leaks": leaks,
            "resets_in_window": len(self._reset_times),
            "restart_ready_s": round(ready_s, 3),
            "aot_cache": (
                self.generator._aot.stats() if self.generator._aot is not None else "off"
            ),
            "graphs": self.generator.graphs.stats(),
            "steps": step_tail,
        })
        log.warning(
            "supervised engine restart (%s) ready in %.2fs: %d requeued, "
            "%d failed, leaks=%s",
            reason, ready_s, len(retry), gaveup, leaks or "none",
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
        result, so a stream hears every step before its end.  An
        abandoned worker's snapshots are dropped."""
        if getattr(self._local, "epoch", None) != self._epoch:
            return
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
        stream never rewinds, however commits, cancellations and
        requeues interleave."""
        if feed.future.cancelled() or len(token_ids) <= feed.sent:
            return
        feed.sent = len(token_ids)
        feed.callback(token_ids)

    # -- the worker ----------------------------------------------------

    def _device_call(self, epoch: int, what: str, fn: Any, *args: Any) -> Any:
        """Run one device call (a step, a wave's prefill) without the
        worker lock, stamped for the watchdog.  A worker abandoned while
        inside raises :class:`_Orphaned` when the call returns."""
        self._busy = (epoch, time.monotonic(), what)
        self._work_lock.release()
        try:
            result = fn(*args)
        except BaseException:
            self._work_lock.acquire()
            self._check_epoch(epoch)
            raise
        self._work_lock.acquire()
        self._check_epoch(epoch)
        return result

    def _abandoned(self) -> bool:
        """True on a worker whose epoch the supervisor has moved past."""
        epoch = getattr(self._local, "epoch", None)
        return epoch is not None and epoch != self._epoch

    def _check_epoch(self, epoch: int) -> None:
        if epoch != self._epoch:
            raise _Orphaned()
        self._busy = None

    def _admit_submissions(self, block: bool) -> None:
        if block:
            self._kick.wait(0.05)  # an idle worker: a submission or a store task
        self._kick.clear()
        while True:
            try:
                item = self._submissions.get_nowait()
            except queue.Empty:
                return
            if not item.future.cancelled():
                try:
                    req_id = self.scheduler.enqueue(
                        item.prompt, item.params, submitted=item.submitted,
                        priority=item.priority, resume_tokens=item.resume_tokens,
                    )
                except (ValueError, MemoryError, ShedLowValue) as exc:  # per-request verdict
                    _settle(item.future, exc=exc)
                else:
                    self._pending[req_id] = item
                    self._register_partial(req_id, item)

    def _run(self, epoch: int) -> None:
        while epoch is not None:
            epoch = self._run_epoch(epoch)

    def _await_handoff(self) -> Optional[int]:
        """An abandoned worker back from its device call: it has touched
        nothing; it waits for the supervisor to hand it the next epoch
        (after the reset), or exits when a fresh thread took over, the
        engine gave up or closed."""
        me = threading.current_thread()
        self._returned = me
        self._orphan_back.set()
        while not self._closed.is_set():
            if self._handoff.wait(1.0):
                handoff = self._handoff_to
                if handoff is not None and handoff[0] is me and not self._closed.is_set():
                    return handoff[1]
                return None
            if self._thread is not me:
                return None  # a fresh worker took over
        return None

    def _run_epoch(self, epoch: int) -> Optional[int]:
        """Serve as the worker of ``epoch``; returns the next epoch when an
        abandoned worker is handed one, else None (the thread ends)."""
        self._local.epoch = epoch
        try:
            with self._work_lock:
                if self.scheduler is not None:
                    self._run_sched(epoch)
                else:
                    self._run_wave(epoch)
            return None
        except _Orphaned:
            # abandoned by the supervisor: touch nothing
            return self._await_handoff()
        except Exception as exc:  # noqa: BLE001 - the loop's boundary: fail loudly
            with self._work_lock:
                if epoch != self._epoch:
                    return None
                log.exception("serving engine loop died")
                self._error = exc
                if self._supervisor is not None and not self._closed.is_set():
                    # keep the requests: the supervisor resets the engine
                    # and requeues them once instead of failing them
                    self._wake.set()
                    return None
                if self.scheduler is not None:
                    # drop rows, queue and the gathered offload buffers:
                    # the device state they point into is not trusted
                    self.scheduler.reset()
                self._fail_outstanding(exc)
            return None

    def _cancelled(self) -> list[int]:
        """Keys of in-flight requests whose callers went away."""
        return [key for key, item in self._pending.items() if item.future.cancelled()]

    def _run_sched(self, epoch: int) -> None:
        sched = self.scheduler
        while not self._closed.is_set():
            self._run_host_tasks()
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
            outcomes = self._device_call(epoch, "mixed dispatch", sched.step)
            if sched.mirror_pending and not sched.total_work:
                # the fabric: the last mirrored blocks of a replica left
                # idle land in the pool now (no later window comes), before
                # their requests settle, so a peer's fetch finds them
                self._device_call(epoch, "mirror drain", sched.drain_mirror)
            for outcome in outcomes:
                self._forget(outcome.req_id)
                item = self._pending.pop(outcome.req_id, None)
                if item is None:
                    continue
                if outcome.error is not None:
                    _settle(item.future, exc=outcome.error)
                else:
                    _settle(item.future, result=outcome.result)

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

    def _admit_waiting(self, epoch: int, arrived: bool) -> None:
        """Admit the head of the waiting line into free slots and pages;
        what does not fit stays in line (backpressure).  The batched
        prefill is a device call under the stall watchdog."""
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
            slots = self._device_call(
                epoch, "batched prefill", g.admit,
                [b.prompt for b in batch], [b.params for b in batch],
            )
        except OversizedRequest as exc:
            # only the head is impossible: fail it alone, the rest retry
            _settle(self._waiting.popleft().future, exc=exc)
            return
        for slot_id, item in zip(slots, batch):
            self._waiting.popleft()
            self._pending[slot_id] = item
            self._register_partial(slot_id, item)
            self._queue_wait_ms[slot_id] = max(0.0, (admitted_t - item.submitted) * 1e3)
        # a stall is recorded only while active sequences hold pages: their
        # release is the retry trigger (a contiguous wave is never partial)
        self._stalled_avail = (
            g.allocator.available
            if len(slots) < len(batch) and g.num_active > 0 else None
        )

    def _run_wave(self, epoch: int) -> None:
        g = self.generator
        while not self._closed.is_set():
            self._run_host_tasks()
            busy = bool(self._waiting) or g.num_active > 0 or bool(g._inflight_blocks)
            arrived = self._take_submissions(block=not busy)
            if self._waiting:
                self._sweep_waiting()
            if self._waiting:
                self._admit_waiting(epoch, arrived)
            if g.num_active:
                # reclaim slots whose callers are gone: an abandoned
                # request must not decode to max_tokens holding its pages.
                # A chunk-prefilling (reserved) slot cannot be cancelled
                # mid-job: its request stays pending, and this sweep frees
                # it once the job's wave is live, so its grant is released
                # once, by that cancel
                for slot_id in self._cancelled():
                    if g.cancel(slot_id):
                        self._pending.pop(slot_id, None)
                        self._queue_wait_ms.pop(slot_id, None)
                        self._forget(slot_id)
            if not (g.num_active or g._inflight_blocks):
                continue
            for slot_id, result in self._device_call(epoch, "decode step", g.step):
                self._forget(slot_id)
                item = self._pending.pop(slot_id, None)
                result.queue_wait_ms = self._queue_wait_ms.pop(slot_id, 0.0)
                if item is not None:
                    _settle(item.future, result=result)

    def _fail_outstanding(self, exc: BaseException) -> None:
        self._partial_cbs.clear()
        self._fail_host_tasks(exc)
        for item in self._restarting:  # a restart interrupted by close()
            _settle(item.future, exc=exc)
        self._restarting = []
        for item in list(self._pending.values()):
            _settle(item.future, exc=exc)
        self._pending.clear()
        while self._waiting:
            _settle(self._waiting.popleft().future, exc=exc)
        while True:
            try:
                item = self._submissions.get_nowait()
            except queue.Empty:
                break
            _settle(item.future, exc=exc)
