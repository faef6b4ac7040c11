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

Not ported yet (the JAX scheduler has them): the block-hash prefix cache
and its host pool (``kvstore``, offload/mirror drains), the fabric
mirror, overload eviction and ``queue_limit``, the deadline policy, the
step clock and the audit hook.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from ..types import GenerationResult, OversizedRequest, SamplingParams, _Slot
from ..types import pages_needed, prompt_budget
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
    started: float = 0.0
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
    ) -> None:
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
        self.counters: collections.Counter = collections.Counter()
        # (req_id, tokens, params, submitted) in admission (FIFO) order
        self._queue: deque = deque()
        self._rows: dict[int, _Row] = {}  # req_id -> row, insertion order
        self._next_req = itertools.count(1)
        self._kv_shadow = np.zeros((generator.max_slots,), np.int32)
        self._staged_tables: list[tuple[int, np.ndarray]] = []
        self._fn = None
        self.steps = 0
        self.occupancy_sum = 0.0
        self.stall_steps = 0
        #: device milliseconds of each committed step, measured between
        #: the events that bracket it on the stream (CUDA only)
        self.device_ms: list[float] = []
        #: set to a list to record every step's ``StepPlan.trace()``
        self.plan_log: Optional[list] = None

    # ------------------------------------------------------------------
    # submit side
    # ------------------------------------------------------------------

    def enqueue(
        self,
        prompt: str,
        params: Optional[SamplingParams] = None,
        *,
        submitted: Optional[float] = None,
    ) -> int:
        """Tokenise + queue one request; returns its req id.  Raises
        :class:`OversizedRequest` when the request can never fit the KV
        pool."""
        g = self.generator
        params = params or SamplingParams()
        ids = g.tokenizer.encode(prompt)
        tokens = g._truncate_prompt(ids, prompt_budget(g.max_seq, params.max_tokens))
        pool = g.allocator.num_pages - 1
        need = self._pages_needed(tokens, params)
        if need > pool:
            raise OversizedRequest(
                f"request needs {need} KV pages, cache holds {pool}"
            )
        req_id = next(self._next_req)
        self._queue.append((
            req_id, tokens, params,
            submitted if submitted is not None else time.perf_counter(),
        ))
        return req_id

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
        """Step-level occupancy/stall/pipelining/speculation stats."""
        proposed = self.counters["spec_proposed"]
        accepted = self.counters["spec_accepted"]
        rounds = self.counters["spec_rounds"]
        return {
            "steps": self.steps,
            "batch_occupancy_avg": round(
                self.occupancy_sum / self.steps, 4
            ) if self.steps else None,
            "decode_stall_steps": self.stall_steps,
            "admitted_midwave": self.counters["sched_admitted_midwave"],
            "chunked_prefills": self.counters["sched_chunked_prefill"],
            "recycled_slots": self.counters["sched_recycled_slot"],
            "pipeline_depth": self.depth,
            "dispatch_ahead": self.counters["sched_pipeline_dispatch_ahead"],
            "voided_work": self.counters["sched_pipeline_voided"],
            "host_syncs": self._host_syncs,
            "decode_tokens_committed": self._decode_committed,
            "decode_tokens_per_host_sync": round(
                self._decode_committed / self._host_syncs, 4
            ) if self._host_syncs else None,
            "spec_decode": {
                "enabled": self._draft is not None,
                "lookup_k": self.spec_k,
                "rest_rounds": self.counters["spec_rest"],
                "verify_rounds": rounds,
                "drafts_proposed": proposed,
                "drafts_accepted": accepted,
                "acceptance_rate": round(accepted / proposed, 4)
                if proposed else None,
                "draft_overhead_ms": round(self._draft_ms, 3),
            },
        }

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
        state."""
        g = self.generator
        outcomes: list[StepOutcome] = []
        plan = self._schedule()
        held_rows = len(self._rows)  # snapshot BEFORE commit recycles
        if self.plan_log is not None:
            self.plan_log.append(plan.trace())
        if plan.work:
            started = time.perf_counter()
            with torch.profiler.record_function("podmortem.sched_step"):
                entry = self._dispatch(plan)
            entry.started = started
            if self._inflight:
                self.counters["sched_pipeline_dispatch_ahead"] += 1
            self._inflight.append(entry)
            self.steps += 1
            self.occupancy_sum += held_rows / g.max_slots
            if plan.deferred_decode:
                self.stall_steps += 1
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
        return outcomes

    def page_accounting(self) -> dict:
        """Where every KV page is right now:
        ``available + row_pages == total`` (page 0 is the trash page)."""
        g = self.generator
        return {
            "available": g.allocator.available,
            "row_pages": sum(len(row.pages) for row in self._rows.values()),
            "total": g.allocator.num_pages - 1,
        }

    # -- schedule ------------------------------------------------------

    def _pages_needed(self, tokens: list, params: SamplingParams) -> int:
        g = self.generator
        return pages_needed(
            len(tokens), params.max_tokens, g.max_seq, g.page_size
        )

    def _admit_queued(self) -> list[int]:
        """Token-level admission: pull queued requests into free slots
        while pages last, FIFO; stops (never skips ahead) when the head's
        pages do not fit."""
        g = self.generator
        admitted: list[int] = []
        while self._queue:
            free = g.free_slots()
            if not free:
                break
            req_id, tokens, params, submitted = self._queue[0]
            need = self._pages_needed(tokens, params)
            if need > g.allocator.available:
                break  # backpressure: decode frees pages, retry next step
            self._queue.popleft()
            grant = g.allocator.allocate(need)
            slot = free[0]
            row = _Row(
                req_id=req_id, slot=slot, tokens=tokens, params=params,
                pages=grant, submitted=submitted,
            )
            self._rows[req_id] = row
            row.queue_wait_ms = max(0.0, (time.perf_counter() - submitted) * 1e3)
            g.slots[slot] = _Slot(
                active=True, prompt_len=len(tokens), params=params, pages=grant,
            )
            # stage the row's page table for the next dispatch
            row_table = np.zeros((g.pages_per_seq,), np.int32)
            row_table[: len(grant)] = grant
            self._staged_tables.append((slot, row_table))
            admitted.append(req_id)
            if len(self._rows) > 1:
                self.counters["sched_admitted_midwave"] += 1
        return admitted

    def _schedule(self) -> StepPlan:
        """Plan the next ragged wave from PREDICTED row state.  A row with
        an in-flight verify round (``pend_spec``) is skipped entirely —
        its true length is unknowable until commit."""
        g = self.generator
        plan = StepPlan()
        plan.admitted = self._admit_queued()
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
                self._draft_ms += (time.perf_counter() - t0) * 1e3
                if probe:
                    self.counters["spec_rest"] += 1
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
                    self._draft_ms += (time.perf_counter() - t0) * 1e3
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
            plan=plan, toks=toks, accept=accept, begin=begin, end=end,
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
        g.allocator.release(row.pages)
        g.slots[row.slot] = _Slot()
        self._kv_shadow[row.slot] = 0
        self._rows.pop(row.req_id, None)
        self.counters["sched_recycled_slot"] += 1

    def _finish(self, row: _Row, reason: str) -> GenerationResult:
        g = self.generator
        eos = g.tokenizer.eos_id
        ids = [t for t in row.generated if t != eos]
        decode_ms = (
            max(0.0, (time.perf_counter() - row.started) * 1e3)
            if row.started else 0.0
        )
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
        entry = self._inflight.popleft()
        self._wait(entry)
        toks = entry.toks.numpy()
        accept = entry.accept.numpy()
        self._host_syncs += 1
        elapsed_ms = (time.perf_counter() - entry.started) * 1e3
        outcomes.extend(self._commit(entry.plan, toks, accept, elapsed_ms))

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
                self.counters["sched_pipeline_voided"] += 1
                continue
            finished: Optional[str] = None
            if work.kind in ("prefill", "finish"):
                row.pos += work.count
                row.pend_pos -= work.count
                row.prefill_ms += share * work.count
                if not row.decoding:
                    if not row.chunked:
                        row.chunked = True
                        self.counters["sched_chunked_prefill"] += 1
                    continue
                # prompt completed THIS step: the sampled token is the
                # row's first generated token
                row.started = time.perf_counter()
                row.pend_gen -= 1
                row.generated = []
                finished = self._push_token(row, int(toks[work.slot, 0]))
                self._decode_committed += 1
            elif work.kind == "decode":
                row.pend_gen -= 1
                finished = self._push_token(row, int(toks[work.slot, 0]))
                self._decode_committed += 1
            else:  # verify
                row.pend_spec = False
                a = int(accept[work.slot])
                self.counters["spec_rounds"] += 1
                self.counters["spec_proposed"] += work.spec_len
                self.counters["spec_accepted"] += a
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
        return outcomes
