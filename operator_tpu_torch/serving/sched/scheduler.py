"""The continuous-batching scheduler: schedule → dispatch → commit.

The port's own copy of ``operator_tpu/serving/sched/scheduler.py``: one
loop over ONE ragged mixed-phase step (``sched/mixed.py`` +
``ops/ragged_attention.py``).

- **schedule** (:meth:`Scheduler._schedule`) — form this step's ragged
  wave: every decode row contributes its next token (or a prompt-lookup
  speculation verify chunk), every prefill row its next chunk
  (Sarathi-style: at most ``chunk`` tokens), and queued requests join the
  RUNNING wave the moment a slot and pages free up — token-level
  admission;
- **dispatch** (:meth:`Scheduler._dispatch`) — pack the wave onto the flat
  token axis, copy it to the device without blocking, and enqueue the
  step, WITHOUT waiting for it;
- **commit** (:meth:`Scheduler._commit_oldest`) — wait for a dispatched
  step's sampled tokens (the step's ONE host sync), advance rows, and
  recycle a finished row's slot and KV pages this step.

**Decode-ahead pipelining** (``pipeline_depth`` 1–3): dispatch and commit
are decoupled through a bounded in-flight queue, so step N+1 is planned
from PREDICTED row state (``_Row.pred_*``) and enqueued while step N's
tokens are still on the device.  A chained decode row's input id never
visits the host — the step substitutes its carried per-slot ``latest``
sample (``from_prev``).  A commit that finishes or cancels a row releases
it at once; later in-flight work for it commits as a no-op.  Stale KV
writes from voided work are safe: the device runs the steps in order on
one stream, so a re-granted page's new owner writes every position it
will read after the voided write lands.

**Prompt-lookup self-speculation** (``spec_decode``, sched/draft.py): a
greedy decode row with no in-flight work proposes up to ``spec_lookup_k``
draft tokens from its own context and verifies them as ONE
``q_count = k + 1`` row; the commit accepts the longest sample-confirmed
prefix, byte-identical to one-token greedy decoding by construction.

**Block-hash prefix caching** (``kvstore=``, serving/kvstore.py): at
admission the request's longest cached block chain is matched and those
STORE-OWNED device pages are mapped into the row's page table read-only
(refcounted); the row's ``pos`` starts at ``cached_len``, so only the
uncached suffix prefills — a hit is just a shorter first chunk for the
ragged kernel.  At prefill completion the row donates its full prompt
blocks' pages to the store (ownership transfer, no copy).  When admission
needs pages, LRU refcount-zero blocks are evicted; with a host pool
(ops/kv_transfer.py) the page is gathered on the compute stream, copied
to pinned host memory on a side stream, and put into the pool inside the
commit step's existing host-sync window, restorable later with one page
copy.  ``fabric_mirror`` copies newly donated blocks into the pool the
same way.  Greedy output is byte-identical cache-on vs cache-off.

**Admission** is the reference's, one request at a time: expired queued
requests fail (``_sweep_expired``), the head is the highest priority
class then the earliest deadline (``_edf_head``), the generator's
``deadline_policy`` clamps, degrades, sheds or rejects it, then the
prefix match and the page grant.  ``queue_limit`` with an
``overload_policy`` sheds the lowest-value request at enqueue.  Every
committed step is recorded in the generator's step clock, and
``audit_hook(self)`` runs after each commit window.

Counters (on the generator's ``metrics``): ``sched_admitted_midwave``,
``sched_chunked_prefill``, ``sched_recycled_slot``,
``sched_stall_free_step``, ``sched_stall_step``,
``sched_pipeline_dispatch_ahead``, ``sched_pipeline_voided``,
``sched_queue_evicted``, ``spec_rounds``, ``spec_proposed``,
``spec_accepted``, ``spec_rest``, ``kv_hit``, ``kv_miss``, ``kv_evict``,
``kv_offload``, ``kv_restore``, ``kv_prefill_tokens_saved``,
``fabric_mirror``, ``admission_shed``, ``admission_deadline_rejected``,
``admission_deadline_truncated``.

Not ported yet: the chaos seam (``fault_plan``) and the fabric's wire
(ROADMAP Queue 1 item 5b).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..types import (
    DeadlineExceeded,
    GenerationResult,
    OversizedRequest,
    SamplingParams,
    ShedLowValue,
    _Slot,
    pages_needed,
    prompt_budget,
)
from .draft import PromptLookupDraft
from .types import RowWork, StepOutcome, StepPlan, _Row

log = logging.getLogger(__name__)

__all__ = ["Scheduler"]


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-uncommitted step: the plan, the step's sampled
    tokens and accepted-draft counts (host tensors the device fills
    asynchronously on a card), and the events that bracket the step."""

    plan: StepPlan
    toks: torch.Tensor  # [B, W] sampled token ids
    accept: torch.Tensor  # [B] accepted-draft counts
    dispatch_t: float = 0.0
    started: float = 0.0
    held_rows: int = 0
    begin: Optional[Any] = None  # torch.cuda.Event before the step
    end: Optional[Any] = None  # torch.cuda.Event after the token copies


class Scheduler:
    """Continuous-batching scheduler over a paged :class:`Generator`
    (``serving/engine.py``)."""

    def __init__(
        self,
        generator: Any,
        *,
        chunk: int = 64,
        token_budget: int = 0,
        pipeline_depth: int = 1,
        spec_decode: bool = False,
        spec_lookup_k: int = 4,
        kvstore: Optional[Any] = None,
        queue_limit: int = 0,
        overload_policy: Optional[Any] = None,
        fabric_mirror: bool = False,
        audit_hook: Optional[Any] = None,
    ) -> None:
        if kvstore is not None and kvstore.page_size != generator.page_size:
            raise ValueError(
                f"kvstore page_size={kvstore.page_size} != generator "
                f"page_size={generator.page_size}: block hashes would not "
                f"align with KV pages"
            )
        self.generator = generator
        self.chunk = max(1, min(chunk, generator.max_seq))
        self.t_budget = token_budget or max(self.chunk, generator.max_slots)
        if self.t_budget < generator.max_slots:
            # a full decode batch must always fit one step, or decode
            # rows would be starved by construction
            raise ValueError(
                f"sched token_budget={self.t_budget} < max_slots="
                f"{generator.max_slots}: a full decode batch would not fit"
            )
        if self.chunk > self.t_budget:
            raise ValueError(
                f"sched chunk={self.chunk} > token_budget={self.t_budget}"
            )
        #: bounded in-flight dispatch queue; 1 = synchronous
        self.depth = max(1, int(pipeline_depth))
        k = int(spec_lookup_k) if spec_decode else 0
        self.spec_k = max(0, min(k, self.chunk - 1, self.t_budget - 1))
        #: sampled positions per slot in the mixed step (static)
        self.width = 1 + self.spec_k
        self._draft = PromptLookupDraft() if self.spec_k else None
        self._draft_ms = 0.0
        self._inflight: deque = deque()
        #: device [B] carry of each slot's freshest sampled token
        self._latest: Optional[torch.Tensor] = None
        self._host_syncs = 0
        self._decode_committed = 0
        self.metrics = generator.metrics
        #: ``hook(req_id, token_ids_so_far)`` after each step for rows
        #: still generating — the streaming feed (ServingEngine marshals
        #: it onto the caller's event loop).  Called from the worker.
        self.partial_hook: Optional[Any] = None
        # (req_id, tokens, params, submitted, priority) — admission order
        # is priority class first, then earliest deadline (EDF) within a
        # class, then FIFO (_edf_head)
        self._queue: deque = deque()
        self._rows: dict[int, _Row] = {}  # req_id -> row, insertion order
        self._next_req = itertools.count(1)
        self._kv_shadow = np.zeros((generator.max_slots,), np.int32)
        self._staged_tables: list[tuple[int, np.ndarray]] = []
        #: block-hash prefix cache (serving/kvstore.py); None = off
        self._kvstore = kvstore
        #: evicted blocks gathered on the device, their host copies in
        #: flight: (hash, k_dev, v_dev, PageFetch) — put into the pool
        #: inside the commit step's host-sync window (_drain_offload)
        self._pending_offload: list[tuple] = []
        #: KV fabric mirror: newly donated prompt blocks copied into the
        #: host pool at prefill completion, (hash, PageFetch), drained
        #: next to the offloads (_drain_mirror)
        self._fabric_mirror = bool(fabric_mirror)
        self._pending_mirror: list[tuple] = []
        self._fn = None
        self.steps = 0
        self.occupancy_sum = 0.0
        self.stall_steps = 0
        #: device milliseconds of each committed step, measured between
        #: the events that bracket it on the stream (CUDA only)
        self.device_ms: list[float] = []
        #: set to a list to record every step's ``StepPlan.trace()``
        self.plan_log: Optional[list] = None
        #: ``hook(self)`` after each step's commit window (page
        #: conservation holds exactly there: :meth:`page_accounting`)
        self.audit_hook: Optional[Any] = audit_hook
        #: queue eviction (router/value.py): when the queue holds
        #: ``queue_limit`` entries and an ``overload_policy`` is set,
        #: enqueue sheds the LOWEST-VALUE non-protected request; 0 =
        #: unbounded
        self.queue_limit = max(0, int(queue_limit))
        self.overload_policy = overload_policy
        # queued requests evicted by value between steps; surfaced as
        # terminal outcomes by the next step()
        self._evicted: list[StepOutcome] = []

    # ------------------------------------------------------------------
    # submit side
    # ------------------------------------------------------------------

    def enqueue(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        *,
        submitted: Optional[float] = None,
        priority: int = 0,
        resume_tokens: Optional[list[int]] = None,
    ) -> int:
        """Tokenise + queue one request; returns its req id.  Raises
        :class:`OversizedRequest` when the request can never fit the KV
        pool, ``ValueError`` for guided decoding or LoRA (not ported), and
        :class:`ShedLowValue` when the queue is at ``queue_limit`` and the
        arrival is its lowest-value request.  ``priority`` orders
        admission (higher class first; earliest deadline first within a
        class).  ``resume_tokens`` (token-level failover) are appended
        VERBATIM after the prompt, so the survivor re-prefills
        prompt+generated-so-far — cheap under the prefix cache — and the
        result carries only the continuation."""
        g = self.generator
        params = params or SamplingParams()
        if params.guided_choice is not None or params.guided_regex is not None:
            raise ValueError(
                "guided decoding is not supported by the continuous scheduler, "
                "and guided decoding is not ported to operator_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 9)"
            )
        if params.adapter is not None:
            raise ValueError(
                "LoRA adapters are not supported by the continuous scheduler, "
                "and LoRA is not ported to operator_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 9)"
            )
        ids = g.tokenizer.encode(prompt)
        # same truncation budget as the wave path's admit()
        budget = prompt_budget(g.max_seq, params.max_tokens)
        if resume_tokens:
            # the generated suffix must survive VERBATIM (the caller
            # already streamed it): truncation may only eat the prompt
            if len(resume_tokens) >= budget:
                raise OversizedRequest(
                    f"resume checkpoint of {len(resume_tokens)} tokens "
                    f"leaves no prompt budget (budget {budget})"
                )
            tokens = (
                g._truncate_prompt(ids, budget - len(resume_tokens))
                + list(resume_tokens)
            )
        else:
            tokens = g._truncate_prompt(ids, budget)
        pool = g.allocator.num_pages - 1 - g.prefix_held_pages
        need = self._pages_needed(tokens, params)
        if need > pool:
            raise OversizedRequest(
                f"request needs {need} KV pages, cache holds {pool}"
            )
        req_id = next(self._next_req)
        if (
            self.queue_limit
            and self.overload_policy is not None
            and len(self._queue) >= self.queue_limit
        ):
            # queue at its limit: shed the lowest-value request — which
            # may be the arrival itself — instead of growing unboundedly
            self._evict_lowest_value(req_id, params)
        self._queue.append((
            req_id, tokens, params,
            submitted if submitted is not None else time.perf_counter(),
            priority,
        ))
        return req_id

    def _request_value(self, params: SamplingParams, now: float):
        """Score one request with the shared value model (residual
        deadline on the generator's injectable clock)."""
        residual = None if params.deadline is None else params.deadline - now
        return self.overload_policy.model.value(
            slo_class=params.slo_class,
            residual_s=residual,
            recall_p=params.recall_p,
        )

    def _evict_lowest_value(self, incoming_id: int, incoming: SamplingParams) -> None:
        """Shed-lowest-value-first queue eviction: score every queued
        request plus the arrival, drop the minimum non-protected one.  A
        queued victim surfaces as a :class:`ShedLowValue` outcome at the
        next step; the arrival itself losing raises to the caller.  An
        all-protected queue grows instead."""
        now = self.generator._clock()
        pressure = len(self._queue) + len(self._rows)
        candidates = [(str(incoming_id), self._request_value(incoming, now))]
        by_id = {}
        for entry in self._queue:
            candidates.append((str(entry[0]), self._request_value(entry[2], now)))
            by_id[str(entry[0])] = entry
        victim = self.overload_policy.pick_eviction(candidates)
        if victim is None:
            return  # every candidate protected: let the queue grow
        rid, value = victim
        self.overload_policy.record_eviction(rid, value, pressure=pressure, site="sched")
        self.metrics.incr("sched_queue_evicted")
        if rid == str(incoming_id):
            raise ShedLowValue(
                f"request shed at enqueue: value score "
                f"{round(value.score, 6)} is the queue minimum at "
                f"pressure {pressure}"
            )
        entry = by_id[rid]
        self._queue.remove(entry)
        self._evicted.append(StepOutcome(entry[0], error=ShedLowValue(
            f"queued request evicted by higher-value arrival at "
            f"pressure {pressure}"
        )))

    def cancel(self, req_id: int) -> bool:
        """Drop a queued request or reclaim a live row's slot/pages now."""
        for i, entry in enumerate(self._queue):
            if entry[0] == req_id:
                del self._queue[i]
                return True
        row = self._rows.get(req_id)
        if row is None:
            return False
        self._release_row(row)
        return True

    @property
    def num_active(self) -> int:
        return len(self._rows)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def total_work(self) -> int:
        return len(self._rows) + len(self._queue)

    def stats(self) -> dict:
        """Step-level occupancy/stall/pipelining/speculation stats and the
        prefix cache's economy (``kv_economy``, None without a store)."""
        counter = self.metrics.counter
        proposed = counter("spec_proposed")
        accepted = counter("spec_accepted")
        rounds = counter("spec_rounds")
        return {
            "steps": self.steps,
            "batch_occupancy_avg": round(
                self.occupancy_sum / self.steps, 4
            ) if self.steps else None,
            "decode_stall_steps": self.stall_steps,
            "admitted_midwave": counter("sched_admitted_midwave"),
            "chunked_prefills": counter("sched_chunked_prefill"),
            "recycled_slots": counter("sched_recycled_slot"),
            "pipeline_depth": self.depth,
            "dispatch_ahead": counter("sched_pipeline_dispatch_ahead"),
            "voided_work": counter("sched_pipeline_voided"),
            "host_syncs": self._host_syncs,
            "decode_tokens_committed": self._decode_committed,
            "decode_tokens_per_host_sync": round(
                self._decode_committed / self._host_syncs, 4
            ) if self._host_syncs else None,
            "spec_decode": {
                "enabled": self._draft is not None,
                "lookup_k": self.spec_k,
                "rest_rounds": counter("spec_rest"),
                "verify_rounds": rounds,
                "drafts_proposed": proposed,
                "drafts_accepted": accepted,
                "acceptance_rate": round(accepted / proposed, 4)
                if proposed else None,
                "mean_accepted_per_round": round(accepted / rounds, 4)
                if rounds else None,
                "draft_overhead_ms": round(self._draft_ms, 3),
            },
            "kv_economy": (
                {
                    **self._kvstore.stats(),
                    "evictions": counter("kv_evict"),
                    "offloads": counter("kv_offload"),
                    "restores": counter("kv_restore"),
                    "prefill_tokens_saved": counter("kv_prefill_tokens_saved"),
                    "offload_pending": len(self._pending_offload),
                    "mirrored": counter("fabric_mirror"),
                    "mirror_pending": len(self._pending_mirror),
                }
                if self._kvstore is not None else None
            ),
        }

    def reset(self) -> None:
        """Drop every row and queued request (the engine's error path: the
        device state may be gone).  In-flight dispatches and the gathered
        offload and mirror buffers are abandoned; the store's host-pool
        copies survive and stay restorable."""
        self._queue.clear()
        self._rows.clear()
        self._kv_shadow[:] = 0
        self._staged_tables.clear()
        self._inflight.clear()
        self._latest = None
        self._pending_offload.clear()
        self._pending_mirror.clear()
        if self._kvstore is not None:
            self._kvstore.reset()

    def spill_cache(self) -> int:
        """Evict every refcount-zero cached block off the device — to the
        host pool when one is configured, else dropped.  Returns the
        number of blocks spilled.  The deterministic hook the tests and
        ``chip_smoke.py`` use to drive the restore-from-host lane."""
        if self._kvstore is None:
            return 0
        count = len(self._kvstore.evictable())
        if count:
            self._evict_blocks(count)
        return count

    def precompile(self) -> None:
        """Run one empty wave end to end (builds the kernels and warms the
        step; its shapes are workload-independent by construction)."""
        entry = self._dispatch(StepPlan())
        self._wait(entry)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def step(self) -> list[StepOutcome]:
        """One scheduler round: plan + dispatch the next ragged wave from
        predicted row state, then commit dispatched steps down to the
        pipeline bound.  Returns every request that reached a terminal
        state (result or admission error)."""
        g = self.generator
        outcomes: list[StepOutcome] = []
        if self._evicted:
            # value-based queue evictions since the last step
            outcomes.extend(self._evicted)
            self._evicted.clear()
        plan = self._schedule(outcomes)
        held_rows = len(self._rows)  # snapshot BEFORE commit recycles
        if self.plan_log is not None:
            self.plan_log.append(plan.trace())
        if plan.work:
            started = time.perf_counter()
            with torch.profiler.record_function("podmortem.sched_step"):
                entry = self._dispatch(plan)
            entry.started = started
            entry.held_rows = held_rows
            if self._inflight:
                self.metrics.incr("sched_pipeline_dispatch_ahead")
            self._inflight.append(entry)
            # occupancy is HELD slots over capacity; a stall step is one
            # where a decode-ready row got no token (never, while
            # token_budget >= max_slots: the counter is the proof)
            self.steps += 1
            occupancy = held_rows / g.max_slots
            self.occupancy_sum += occupancy
            self.metrics.record("sched_occupancy", occupancy * 100.0)
            if plan.deferred_decode:
                self.stall_steps += 1
                self.metrics.incr("sched_stall_step")
            else:
                self.metrics.incr("sched_stall_free_step")
        elif not self._inflight:
            return outcomes
        # commit down to the pipeline bound (depth - 1 stays in flight
        # across calls); with nothing to dispatch, drain one entry per
        # round
        while len(self._inflight) > self.depth - 1 or (
            self._inflight and not plan.work
        ):
            self._commit_oldest(outcomes)
            if not plan.work:
                break
        if self.audit_hook is not None:
            # commit barrier: every page granted, cached, offloaded or
            # freed this step has settled
            self.audit_hook(self)
        return outcomes

    def page_accounting(self) -> dict:
        """Where every KV page is right now — the terms of page
        conservation, ``available + row_pages + store_pages +
        prefix_pages == total`` (page 0 is the trash page, hence
        ``num_pages - 1``): grants held by live rows, device pages the
        prefix cache owns, and the generator's shared-prefix hold."""
        g = self.generator
        return {
            "available": g.allocator.available,
            "row_pages": sum(len(row.pages) for row in self._rows.values()),
            "store_pages": (
                self._kvstore.device_pages_held if self._kvstore is not None else 0
            ),
            "prefix_pages": g.prefix_held_pages,
            "total": g.allocator.num_pages - 1,
        }

    # -- schedule ------------------------------------------------------

    def _pages_needed(self, tokens: list, params: SamplingParams) -> int:
        g = self.generator
        return pages_needed(
            len(tokens), params.max_tokens, g.max_seq, g.page_size
        )

    # -- prefix cache (serving/kvstore.py) -----------------------------

    def _match_prefix(self, tokens: list, need: int) -> list:
        """Match + acquire the longest AFFORDABLE cached block chain for
        ``tokens``.  Off-device blocks are restored into fresh store-owned
        pages (one page copy each); LRU refcount-zero blocks are evicted
        when the row grant + restores would not fit.  Returns
        device-resident blocks with refs held; the chain shrinks from the
        tail until it fits, possibly to nothing."""
        g = self.generator
        store = self._kvstore
        chain = store.match(tokens)
        if not chain:
            return []
        store.acquire(chain)
        # a chain entry that lost both its device page and its host copy
        # ends the usable prefix
        usable = []
        for blk in chain:
            if blk.page >= 0 or store.restorable(blk.hash):
                usable.append(blk)
            else:
                break
        if len(usable) < len(chain):
            store.release([b.hash for b in chain[len(usable) :]])
        while usable:
            restores = sum(1 for b in usable if b.page < 0)
            required = (need - len(usable)) + restores
            deficit = required - g.allocator.available
            if deficit > 0:
                self._evict_blocks(deficit)
            if required <= g.allocator.available:
                break
            dropped = usable.pop()
            store.release([dropped.hash])
        for blk in usable:
            if blk.page < 0:
                self._restore_block(blk)
        return usable

    def _evict_blocks(self, count: int) -> None:
        """Evict up to ``count`` LRU refcount-zero blocks from the device.
        With a host pool each victim's page is GATHERED into fresh device
        buffers first (ordered on the stream before any new owner's
        writes) and its host copy started on the side stream; the commit
        window puts it into the pool.  Without one the block is
        forgotten."""
        from ...ops import kv_transfer

        g = self.generator
        store = self._kvstore
        pool = store.host_pool
        for blk in store.evict_lru(count):
            # capture the page BEFORE mark_offloaded/forget clear it
            page = blk.page
            if pool is not None and pool.has(blk.hash):
                store.mark_offloaded(blk.hash)  # host copy already there
            elif pool is not None and pool.capacity_bytes > 0:
                k_dev, v_dev = kv_transfer.gather_page(g.paged_cache, page)
                fetch = kv_transfer.fetch_page(k_dev, v_dev)
                self._pending_offload.append((blk.hash, k_dev, v_dev, fetch))
                store.pending_offload.add(blk.hash)
                store.mark_offloaded(blk.hash)
            else:
                store.forget(blk.hash)
            g.allocator.release([page])

    def _restore_block(self, blk: Any) -> None:
        """Bring an off-device block back: one freshly allocated
        store-owned page + one page copy (from the pending-offload device
        buffers when the drain has not run yet, else from the host pool)
        — never recompute."""
        from ...ops import kv_transfer

        g = self.generator
        store = self._kvstore
        page = g.allocator.allocate(1)[0]
        entry = None
        if blk.hash in store.pending_offload:
            for i, (h, k_dev, v_dev, _) in enumerate(self._pending_offload):
                if h == blk.hash:
                    entry = (k_dev, v_dev)
                    del self._pending_offload[i]
                    break
            store.pending_offload.discard(blk.hash)
        if entry is None:
            entry = store.host_pool.get(blk.hash)
        g.paged_cache = kv_transfer.restore_page(g.paged_cache, page, entry[0], entry[1])
        blk.page = page
        self.metrics.incr("kv_restore")

    def _drain_offload(self) -> None:
        """Put the evicted pages' host copies into the pool — called ONLY
        inside the commit step's existing host-sync window; each wait is
        on that copy's own event."""
        store = self._kvstore
        pool = store.host_pool
        for h, _, _, fetch in self._pending_offload:
            if h not in store.pending_offload:
                continue  # restored from these buffers meanwhile
            store.pending_offload.discard(h)
            dropped = pool.put(h, *fetch.wait())
            if dropped is None:
                store.forget(h)  # pool refused: the block is gone
                continue
            self.metrics.incr("kv_offload")
            for old in dropped:
                # LRU-dropped host copies: forget any index entry that has
                # no device page left either
                entry = store.get(old)
                if entry is not None and entry.page < 0:
                    store.forget(old)
        self._pending_offload.clear()

    def _drain_mirror(self) -> None:
        """Put mirrored prompt blocks' host copies into the pool — same
        discipline as _drain_offload.  The device page stays resident; a
        refused put just means peers cannot fetch the block."""
        store = self._kvstore
        pool = store.host_pool
        for h, fetch in self._pending_mirror:
            if pool.has(h):
                continue  # the offload drain beat us to it
            dropped = pool.put(h, *fetch.wait())
            if dropped is None:
                continue
            self.metrics.incr("fabric_mirror")
            for old in dropped:
                entry = store.get(old)
                if entry is not None and entry.page < 0:
                    store.forget(old)
        self._pending_mirror.clear()

    def _register_row_blocks(self, row: _Row) -> None:
        """Prefill completed: donate the row's FULL prompt blocks to the
        store (ownership transfer of the device pages — no copy).  Only
        full blocks are immutable (generation writes at positions >=
        prompt_len), and the row keeps a reference on each donated block
        until release."""
        from ...ops import kv_transfer
        from ..kvstore import block_hashes

        g = self.generator
        store = self._kvstore
        ps = g.page_size
        pool = store.host_pool
        mirror = self._fabric_mirror and pool is not None and pool.capacity_bytes > 0
        k_full = row.prompt_len // ps
        c0 = row.cached_len // ps
        if k_full <= c0:
            return
        hashes = block_hashes(row.tokens[: k_full * ps], ps)
        transferred: set[int] = set()
        for j in range(c0, k_full):
            h = hashes[j]
            entry = store.get(h)
            page = row.pages[j - c0]
            if entry is not None and entry.page >= 0:
                # a concurrent identical prompt registered first: keep the
                # row-owned duplicate page, no transfer
                continue
            store.insert(
                h,
                hashes[j - 1] if j else None,
                row.tokens[j * ps : (j + 1) * ps],
                page,
                refs=1,
            )
            store.pending_offload.discard(h)
            transferred.add(j - c0)
            row.cached_hashes.append(h)
            if mirror and not pool.has(h):
                k_dev, v_dev = kv_transfer.gather_page(g.paged_cache, page)
                self._pending_mirror.append((h, kv_transfer.fetch_page(k_dev, v_dev)))
        if transferred:
            row.pages = [p for i, p in enumerate(row.pages) if i not in transferred]

    # -- admission -----------------------------------------------------

    def _sweep_expired(self, outcomes: list[StepOutcome]) -> None:
        """Fail EVERY queued request whose deadline already expired — the
        whole queue, every step, regardless of capacity."""
        if not self._queue:
            return
        now = self.generator._clock()
        live = deque()
        for entry in self._queue:
            params = entry[2]
            if params.deadline is not None and params.deadline <= now:
                self.metrics.incr("admission_deadline_rejected")
                outcomes.append(StepOutcome(entry[0], error=DeadlineExceeded(
                    "deadline expired while queued for admission"
                )))
            else:
                live.append(entry)
        self._queue = live

    def _edf_head(self) -> int:
        """Index of the next request to admit: highest priority class
        first, earliest deadline within the class (EDF), FIFO among
        deadline-free peers.  Admission stops (does not skip ahead) when
        the chosen head's pages do not fit."""
        best = 0
        best_key = None
        for i, entry in enumerate(self._queue):
            params, priority = entry[2], entry[4]
            deadline = params.deadline if params.deadline is not None else float("inf")
            key = (-priority, deadline, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _admit_queued(self, outcomes: list[StepOutcome]) -> tuple[list[int], int]:
        """Token-level admission: pull queued requests into free slots
        while pages last.  Returns the admitted req ids and the prompt
        tokens they reused from the prefix cache
        (``StepPlan.cached_tokens``)."""
        g = self.generator
        self._sweep_expired(outcomes)
        admitted: list[int] = []
        cached_total = 0
        while self._queue:
            free = g.free_slots()
            if not free:
                break
            head = self._edf_head()
            req_id, tokens, params, submitted, _ = self._queue[head]
            clamped, outcome = g.deadline_policy(
                params, pressure=len(self._queue) + len(self._rows)
            )
            if outcome == "shed":
                # overload ladder: lowest value at admission under storm
                del self._queue[head]
                self.metrics.incr("admission_shed")
                outcomes.append(StepOutcome(req_id, error=ShedLowValue(
                    "request shed at admission: lowest value under "
                    "overload (router/value.py ladder)"
                )))
                continue
            if outcome == "rejected":
                # expired between the sweep and the policy's clock read:
                # the minimal one-token clamp, as the wave path does
                clamped = dataclasses.replace(params, max_tokens=1, deadline_clamped=True)
                outcome = "truncated"
            if outcome == "truncated":
                self.metrics.incr("admission_deadline_truncated")
            need = self._pages_needed(tokens, clamped)
            # prefix-cache match: the longest affordable cached chain
            # replaces the head of the row's grant
            picked: list = []
            if self._kvstore is not None:
                picked = self._match_prefix(tokens, need)
            grant_need = need - len(picked)
            if grant_need > g.allocator.available and self._kvstore is not None:
                # the store may sit on refcount-zero cached pages: reclaim
                # them first, or an idle engine whose pool is all cache
                # would deadlock (nothing decoding frees a page)
                self._evict_blocks(grant_need - g.allocator.available)
            if grant_need > g.allocator.available:
                # backpressure: decode frees pages, retry next step
                if picked:
                    self._kvstore.release([b.hash for b in picked])
                break
            del self._queue[head]
            grant = g.allocator.allocate(grant_need)
            slot = free[0]
            row = _Row(
                req_id=req_id, slot=slot, tokens=tokens, params=clamped,
                pages=grant, submitted=submitted,
            )
            if picked:
                # cached blocks ARE the prompt head: prefill starts at
                # cached_len, always inside a row-owned page (the match is
                # capped one token short of the prompt: no copy-on-write)
                row.cached_len = len(picked) * g.page_size
                row.cached_hashes = [b.hash for b in picked]
                row.pos = row.cached_len
                self._kv_shadow[slot] = row.cached_len
                cached_total += row.cached_len
                self.metrics.incr("kv_prefill_tokens_saved", row.cached_len)
            self._rows[req_id] = row
            row.queue_wait_ms = max(0.0, (time.perf_counter() - submitted) * 1e3)
            self.metrics.record("sched_queue_wait", row.queue_wait_ms)
            g.slots[slot] = _Slot(
                active=True, prompt_len=len(tokens), params=clamped, pages=grant,
            )
            # stage the row's page table for the next dispatch: cached
            # store-owned pages first, then the row's own grant
            row_table = np.zeros((g.pages_per_seq,), np.int32)
            if picked:
                row_table[: len(picked)] = [b.page for b in picked]
            row_table[len(picked) : len(picked) + len(grant)] = grant
            self._staged_tables.append((slot, row_table))
            admitted.append(req_id)
            if len(self._rows) > 1:
                self.metrics.incr("sched_admitted_midwave")
        return admitted, cached_total

    def _schedule(self, outcomes: list[StepOutcome]) -> StepPlan:
        """Plan the next ragged wave from PREDICTED row state.  A row with
        an in-flight verify round (``pend_spec``) is skipped entirely —
        its true length is unknowable until commit."""
        g = self.generator
        plan = StepPlan()
        plan.admitted, plan.cached_tokens = self._admit_queued(outcomes)
        budget = self.t_budget
        cursor = 0
        # decode rows first — one token each (plus drafts), never
        # deferred while budget >= max_slots.  A row predicted to have hit
        # max_tokens or the sequence cap sits out.
        decode_ready = [
            (req_id, row) for req_id, row in self._rows.items()
            if not row.pend_spec
            and row.pred_decoding
            and row.pred_gen < row.params.max_tokens
            and row.pred_kv + 1 < g.max_seq
        ]
        for i, (req_id, row) in enumerate(decode_ready):
            if cursor >= budget:  # unreachable while budget >= max_slots
                plan.deferred_decode += 1
                continue
            greedy = self._draft is not None and row.params.temperature <= 0.0
            # speculation REST: a greedy row with a chained token in
            # flight cannot draft (the proposal needs its committed text);
            # when a probe of the stale context hits, the row sits this
            # round out and verifies k drafts next round
            if greedy and row.pend_gen > 0 and row.pend_pos == 0 and row.decoding:
                t0 = time.perf_counter()
                probe = self._draft.propose(row.tokens + row.generated, self.spec_k)
                dms = (time.perf_counter() - t0) * 1e3
                self._draft_ms += dms
                self.metrics.observe("spec_draft_milliseconds", dms)
                if probe:
                    self.metrics.incr("spec_rest")
                    continue
            # speculation: greedy rows with NO in-flight work try a
            # prompt-lookup proposal, capped so the row cannot overrun
            # max_tokens, the sequence cap, or the peers' reserved
            # one-token budget (rows_after)
            k_eff = 0
            drafts: tuple = ()
            rows_after = len(decode_ready) - i - 1
            if (
                greedy
                and row.pend_gen == 0
                and row.pend_pos == 0
                and row.decoding
                and row.generated
            ):
                cap = min(
                    self.spec_k,
                    row.params.max_tokens - len(row.generated) - 1,
                    g.max_seq - 1 - row.kv_len,
                    budget - cursor - 1 - rows_after,
                )
                if cap > 0:
                    t0 = time.perf_counter()
                    proposed = self._draft.propose(row.tokens + row.generated, cap)
                    dms = (time.perf_counter() - t0) * 1e3
                    self._draft_ms += dms
                    self.metrics.observe("spec_draft_milliseconds", dms)
                    if proposed:
                        drafts = tuple(proposed)
                        k_eff = len(drafts)
            plan.work.append(RowWork(
                row.slot, req_id, cursor, 1 + k_eff,
                "verify" if k_eff else "decode",
                pos0=row.pred_kv, spec_len=k_eff, drafts=drafts,
                from_prev=row.pend_gen > 0,
            ))
            cursor += 1 + k_eff
            plan.decode_rows += 1
        # prefill chunks fill the remaining budget, FIFO by admission
        for req_id, row in self._rows.items():
            if row.pend_spec or row.pred_decoding:
                continue
            count = min(self.chunk, row.prompt_len - row.pred_pos, budget - cursor)
            if count <= 0:
                continue
            kind = "finish" if row.pred_pos + count >= row.prompt_len else "prefill"
            plan.work.append(RowWork(
                row.slot, req_id, cursor, count, kind, pos0=row.pred_pos,
            ))
            cursor += count
            plan.prefill_rows += 1
        plan.tokens_planned = cursor
        return plan

    # -- dispatch ------------------------------------------------------

    def _get_fn(self):
        if self._fn is None:
            from .mixed import make_mixed_step

            g = self.generator
            log.info(
                "mixed step t_budget=%d chunk=%d slots=%d width=%d "
                "pipeline_depth=%d device=%s",
                self.t_budget, self.chunk, g.max_slots, self.width, self.depth,
                g.device,
            )
            self._fn = make_mixed_step(
                g.config, max_slots=g.max_slots, t_budget=self.t_budget,
                chunk=self.chunk, spec_width=self.width,
                sample_top_k=g.sample_top_k, device=g.device,
            )
        return self._fn

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on a card through pinned memory
        with a non-blocking copy, so the host does not wait for it."""
        host = torch.from_numpy(array)
        device = self.generator.device
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)

    def _dispatch(self, plan: StepPlan) -> _InFlight:
        """Pack the plan onto the flat token axis and ENQUEUE the mixed
        step; returns the in-flight entry WITHOUT syncing."""
        g = self.generator
        t, b = self.t_budget, g.max_slots
        ids = np.zeros((t,), np.int32)
        rows = np.zeros((t,), np.int32)
        pos = np.zeros((t,), np.int32)
        valid = np.zeros((t,), np.int32)
        in_row = np.zeros((t,), np.int32)
        from_prev = np.zeros((t,), np.int32)
        q_start = np.zeros((b,), np.int32)
        q_count = np.zeros((b,), np.int32)
        sample_start = np.zeros((b,), np.int32)
        spec_len = np.zeros((b,), np.int32)
        temp = np.zeros((b,), np.float32)
        top_p = np.ones((b,), np.float32)
        kv_len = self._kv_shadow.copy()
        for work in plan.work:
            row = self._rows[work.req_id]
            span = slice(work.start, work.start + work.count)
            if work.kind == "decode":
                # a chained row's input id is the PREVIOUS dispatch's
                # on-device sample: pack a placeholder, the step
                # substitutes its carried latest[slot]
                ids[work.start] = 0 if work.from_prev else row.generated[-1]
                pos[work.start] = work.pos0
                from_prev[work.start] = work.from_prev
            elif work.kind == "verify":
                # committed last token + k prompt-lookup drafts
                ids[span] = [row.generated[-1], *work.drafts]
                pos[span] = np.arange(work.pos0, work.pos0 + work.count, dtype=np.int32)
            else:  # prefill / finish
                ids[span] = row.tokens[work.pos0 : work.pos0 + work.count]
                pos[span] = np.arange(work.pos0, work.pos0 + work.count, dtype=np.int32)
            rows[span] = work.slot
            valid[span] = 1
            in_row[span] = np.arange(work.count, dtype=np.int32)
            q_start[work.slot] = work.start
            q_count[work.slot] = work.count
            # first sampled position: the last NON-draft token
            sample_start[work.slot] = work.start + work.count - 1 - work.spec_len
            spec_len[work.slot] = work.spec_len
            # optimistic: every draft accepted; the step corrects the
            # committed lengths (kv_len - (spec_len - accept))
            kv_len[work.slot] = work.pos0 + work.count
            temp[work.slot] = row.params.temperature
            top_p[work.slot] = row.params.top_p
        # one host->device copy for every int input, one for the floats
        ints = self._to_device(np.concatenate([
            ids, rows, pos, valid, in_row, from_prev,
            q_start, q_count, kv_len, sample_start, spec_len,
        ]))
        floats = self._to_device(np.concatenate([temp, top_p]))
        (d_ids, d_rows, d_pos, d_valid, d_in_row, d_from_prev) = ints[: 6 * t].split(t)
        (d_q_start, d_q_count, d_kv_len, d_sample_start, d_spec_len) = (
            ints[6 * t :].split(b)
        )
        d_temp, d_top_p = floats.split(b)
        paged = g.paged_cache
        if self._staged_tables:
            slots = np.asarray([slot for slot, _ in self._staged_tables], np.int64)
            tables = np.stack([tab for _, tab in self._staged_tables])
            paged.page_table[self._to_device(slots)] = self._to_device(tables)
            self._staged_tables.clear()
        if self._latest is None:
            self._latest = torch.zeros((b,), dtype=torch.int32, device=g.device)
        begin = end = None
        cuda = g.device.type == "cuda"
        if cuda:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
        dispatch_t = time.perf_counter()
        new_paged, toks, accept, latest, rng = self._get_fn()(
            g.params, paged,
            d_ids, d_rows, d_pos, d_valid.bool(), d_in_row,
            d_q_start, d_q_count, d_kv_len,
            self._latest, d_from_prev.bool(),
            d_sample_start, d_spec_len,
            g._rng, d_temp, d_top_p,
        )
        g.paged_cache = new_paged
        g._rng = rng
        self._latest = latest
        if cuda:
            # the sampled ids go back to pinned host memory on the same
            # stream; the commit waits on ``end`` — no sync here
            toks = toks.to("cpu", non_blocking=True)
            accept = accept.to("cpu", non_blocking=True)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        # shadow holds the OPTIMISTIC lengths (all drafts accepted); a
        # verify commit re-anchors the slot when drafts were rejected
        self._kv_shadow = kv_len
        for work in plan.work:
            row = self._rows[work.req_id]
            if work.kind == "decode":
                row.pend_gen += 1
            elif work.kind == "verify":
                row.pend_spec = True
            elif work.kind == "finish":
                row.pend_pos += work.count
                row.pend_gen += 1  # the chunk's first sampled token
            else:  # prefill
                row.pend_pos += work.count
        return _InFlight(
            plan=plan, toks=toks, accept=accept, dispatch_t=dispatch_t,
            begin=begin, end=end,
        )

    # -- commit --------------------------------------------------------

    def _wait(self, entry: _InFlight) -> None:
        """The step's ONE host sync: wait until its sampled ids are on
        the host."""
        if entry.end is not None:
            entry.end.synchronize()
            self.device_ms.append(entry.begin.elapsed_time(entry.end))

    def _release_row(self, row: _Row) -> None:
        """Recycle the row's slot + pages NOW.  The dead row's stale page
        table entries are never read again (its shadow kv length is 0, so
        the ragged kernel walks zero pages) and are overwritten by staging
        at the slot's next admission."""
        g = self.generator
        if self._kvstore is not None and row.cached_hashes:
            # drop the row's references on shared/donated blocks (the
            # pages stay with the store until LRU eviction)
            self._kvstore.release(row.cached_hashes)
            row.cached_hashes = []
        g.allocator.release(row.pages)
        g.slots[row.slot] = _Slot()
        self._kv_shadow[row.slot] = 0
        self._rows.pop(row.req_id, None)
        self.metrics.incr("sched_recycled_slot")

    def _finish(self, row: _Row, reason: str) -> GenerationResult:
        g = self.generator
        eos = g.tokenizer.eos_id
        ids = [t for t in row.generated if t != eos]
        if reason == "length" and row.params.deadline_clamped:
            reason = "deadline"
        elif reason == "length" and row.params.degraded:
            # the overload ladder reduced max_tokens: hitting it IS the
            # degraded outcome
            reason = "degraded"
        # decode wall from the step clock's monotonic cumulative, the same
        # records the step ring carries
        decode_ms = 0.0
        if row.started:
            decode_ms = max(0.0, g.step_clock.decode_cum_ms - row.decode_cum0)
        result = GenerationResult(
            text=g.tokenizer.decode(ids),
            token_ids=ids,
            prompt_tokens=row.prompt_len,
            completion_tokens=len(ids),
            finish_reason=reason,
            prefill_ms=row.prefill_ms,
            decode_ms=decode_ms,
            queue_wait_ms=row.queue_wait_ms,
        )
        self._release_row(row)
        return result

    def _commit_oldest(self, outcomes: list[StepOutcome]) -> None:
        """Wait for + commit the oldest in-flight dispatch: the step's ONE
        host sync.  The offload and mirror drains ride the same window;
        the step-clock record lands BEFORE the rows commit, so a prompt
        completing this step stamps decode_cum0 with this step counted."""
        g = self.generator
        entry = self._inflight.popleft()
        plan = entry.plan
        self._wait(entry)
        t_ready = time.perf_counter()
        toks = entry.toks.numpy()
        accept = entry.accept.numpy()
        if self._pending_offload:
            self._drain_offload()
        if self._pending_mirror:
            self._drain_mirror()
        fetch_t = time.perf_counter()
        self._host_syncs += 1
        if plan.decode_rows and plan.prefill_rows:
            kind = "mixed"
        elif plan.decode_rows:
            kind = "decode"
        else:
            kind = "prefill"
        # tokens the step will really commit: a verify row lands accept+1
        # tokens, voided rows none
        accepted = 0
        for work in plan.work:
            if work.req_id not in self._rows:
                continue
            if work.kind == "verify":
                accepted += int(accept[work.slot]) + 1
            elif work.kind in ("decode", "finish"):
                accepted += 1
        g.step_clock.observe(
            kind=kind,
            tokens=plan.tokens_planned,
            slots=entry.held_rows,
            host_gap_ms=g.step_clock.host_gap_ms(entry.dispatch_t),
            device_ms=max(0.0, (t_ready - entry.dispatch_t) * 1e3),
            sample_xfer_ms=max(0.0, (fetch_t - t_ready) * 1e3),
            commit_t=fetch_t,
            accepted=accepted,
            cached_tokens=plan.cached_tokens if self._kvstore is not None else None,
        )
        elapsed_ms = (fetch_t - entry.started) * 1e3
        outcomes.extend(self._commit(plan, toks, accept, elapsed_ms))
        if plan.decode_rows and not plan.prefill_rows:
            # wall per pure-decode round only: the deadline policy reads
            # p50(decode_step) as seconds per token
            self.metrics.record("decode_step", elapsed_ms)

    def _push_token(self, row: _Row, token: int) -> Optional[str]:
        """Append one committed token; returns the finish reason when the
        row just reached a terminal state."""
        g = self.generator
        eos = g.tokenizer.eos_id
        row.generated.append(token)
        if row.params.stop_on_eos and eos is not None and token == eos:
            return "stop"
        if len(row.generated) >= row.params.max_tokens:
            return "length"
        if row.kv_len + 1 >= g.max_seq:
            # the NEXT decode token would write past the sequence cap
            return "length"
        return None

    def _commit(
        self, plan: StepPlan, toks: np.ndarray, accept: np.ndarray,
        elapsed_ms: float,
    ) -> list[StepOutcome]:
        outcomes: list[StepOutcome] = []
        # the step's wall is attributed to its rows by token share
        share = elapsed_ms / max(1, plan.tokens_planned)
        for work in plan.work:
            row = self._rows.get(work.req_id)
            if row is None:
                # cancelled/finished between dispatch and commit: the
                # prediction this work was planned from is void
                self.metrics.incr("sched_pipeline_voided")
                continue
            finished: Optional[str] = None
            if work.kind in ("prefill", "finish"):
                row.pos += work.count
                row.pend_pos -= work.count
                row.prefill_ms += share * work.count
                if not row.decoding:
                    if not row.chunked:
                        row.chunked = True
                        self.metrics.incr("sched_chunked_prefill")
                    continue
                # prompt completed THIS step: the sampled token is the
                # row's first generated token
                row.started = time.perf_counter()
                row.decode_cum0 = self.generator.step_clock.decode_cum_ms
                row.pend_gen -= 1
                row.generated = []
                if self._kvstore is not None:
                    # the prompt's KV is complete and immutable: donate its
                    # full blocks' pages to the prefix cache
                    self._register_row_blocks(row)
                self.metrics.record("prefill", row.prefill_ms)
                finished = self._push_token(row, int(toks[work.slot, 0]))
                self._decode_committed += 1
            elif work.kind == "decode":
                row.pend_gen -= 1
                finished = self._push_token(row, int(toks[work.slot, 0]))
                self._decode_committed += 1
            else:  # verify
                row.pend_spec = False
                a = int(accept[work.slot])
                self.metrics.incr("spec_rounds")
                self.metrics.incr("spec_proposed", work.spec_len)
                self.metrics.incr("spec_accepted", a)
                for j in range(a + 1):
                    finished = self._push_token(row, int(toks[work.slot, j]))
                    self._decode_committed += 1
                    if finished is not None:
                        break
                if finished is None:
                    # rejected drafts left the shadow optimistic: re-anchor
                    # the slot to the row's authoritative length
                    self._kv_shadow[row.slot] = row.kv_len
            if finished is not None:
                outcomes.append(
                    StepOutcome(work.req_id, result=self._finish(row, finished))
                )
            elif (
                self.partial_hook is not None
                and row.decoding
                and row.generated
            ):
                # list COPY: the hook crosses into the event-loop thread
                self.partial_hook(row.req_id, list(row.generated))
        return outcomes
