"""Wave admission: tokenise, grant pages, batch-prefill into free slots.

Counterpart of ``operator_tpu/serving/admission.py``, both
cache layouts (a contiguous engine grants no pages, never admits in part
and prefills into the slots' rows, ``_admit_batch``'s ``else`` branch):
:meth:`AdmissionMixin.admit` (:395), ``_admit_tokens`` (:429), the batch
buckets ``_admission_n_pads``/``_admission_n_pad`` (:478-499),
``_admit_batch`` (:501-664) with its three paths — the chunked job
(``_start_prefill_job``, :790), the suffix-only prefill over a registered
shared prefix, and the plain prefill — and the ``prefill_waves_prefix`` /
``prefill_waves_plain`` counters, ``_stage_page_tables`` (:747), the
head-keeping ``_truncate_prompt`` (:666) and the prefix match
``_wave_prefix_match`` / ``_wave_shared_prefix`` (:696-745); and the
deadline budget's policy, which both loops share:
``decode_token_estimate_s`` (:53), ``deadline_policy`` (:64, on the
injectable ``_clock``, with the overload ladder when ``overload_policy``
is wired) and the wave's ``_deadline_clamp_wave`` (:142); the warmup grid
``precompile_grid`` (:178) with its coverage count ``_program_count``
(:164).  A wave carries each row's LoRA adapter index and, when any
active or admitted request is guided, the restacked automaton tables
(the row's automaton masks its first token; ``_apply_guided_activation``
binds the slots).

Mixed into :class:`serving.engine.Generator`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Sequence

import numpy as np
import torch

from ..ops.flash_prefill import flash_prefill_enabled
from ..ops.paged_attention import PagedKVCache
from .types import (
    OversizedRequest,
    SamplingParams,
    _bucket,
    _PrefillJob,
    pages_needed,
    prompt_budget,
)

__all__ = ["AdmissionMixin"]

log = logging.getLogger(__name__)


class AdmissionMixin:
    """Batched admission of the wave engine and the deadline policy (see
    module doc)."""

    # -- deadline budget (utils/deadline.py) ----------------------------

    def decode_token_estimate_s(self) -> float:
        """Expected seconds per decoded token: the MEASURED p50 of the
        decode_step stage once any step has run, else the constructor's
        roofline estimate (``roofline_token_s``).  0.0 = unknown — the
        policy then only rejects already-expired requests."""
        stats = self.metrics.stage("decode_step")
        if stats.count:
            return stats.p50_ms / 1e3
        return self.roofline_token_s or 0.0

    def deadline_policy(
        self,
        params: SamplingParams,
        *,
        now: "float | None" = None,
        pressure: "float | None" = None,
    ) -> "tuple[SamplingParams, str]":
        """(possibly clamped params, outcome) for one request's budget.

        Outcomes: ``"ok"`` (fits, untouched), ``"truncated"``
        (``max_tokens`` clamped to the estimated fit, ``deadline_clamped``
        set so the finish reason reads "deadline"), ``"degraded"`` (the
        overload ladder scaled ``max_tokens`` down), ``"shed"`` (the
        ladder dropped the request: lowest value under storm, class
        unprotected), ``"rejected"`` (the residue cannot fit even one
        token).  ``pressure`` is the caller's load signal (queued +
        running rows): with an ``overload_policy`` wired the ladder may
        reduce the ask BEFORE the deadline math."""
        policy = getattr(self, "overload_policy", None)
        degraded = False
        if policy is not None and pressure is not None and not params.degraded:
            residual = None
            if params.deadline is not None:
                residual = params.deadline - (self._clock() if now is None else now)
            value = policy.model.value(
                slo_class=params.slo_class,
                residual_s=residual,
                recall_p=params.recall_p,
            )
            verdict = policy.decide(
                value, pressure, site="admission",
                request_id=params.trace_tag or "",
            )
            if verdict.action == "shed":
                return params, "shed"
            if verdict.action == "degrade":
                params = dataclasses.replace(
                    params,
                    max_tokens=max(
                        1, int(params.max_tokens * verdict.degrade_tokens_frac)
                    ),
                    degraded=True,
                )
                degraded = True
        ok = "degraded" if degraded else "ok"
        if params.deadline is None:
            return params, ok
        now = self._clock() if now is None else now
        remaining = params.deadline - now
        if remaining <= 0.0:
            return params, "rejected"
        per_token = self.decode_token_estimate_s()
        if per_token <= 0.0:
            return params, ok
        fit = int(remaining / per_token)
        if fit < 1:
            return params, "rejected"
        if fit < params.max_tokens:
            return (
                dataclasses.replace(params, max_tokens=fit, deadline_clamped=True),
                "truncated",
            )
        return params, ok

    def _deadline_clamp_wave(
        self, params_list: Sequence[SamplingParams]
    ) -> list[SamplingParams]:
        """Apply the deadline policy to a whole admission wave at
        ADMISSION time (after any queue wait eroded the budget).  A request
        that expired since the serve loop's sweep gets the minimal
        one-token clamp instead of failing the co-batched wave; its result
        still carries finish_reason "deadline"."""
        out = []
        for sampling in params_list:
            clamped, outcome = self.deadline_policy(sampling)
            if outcome == "rejected":
                clamped = dataclasses.replace(
                    sampling, max_tokens=1, deadline_clamped=True
                )
                outcome = "truncated"
            if outcome == "truncated":
                self.metrics.incr("admission_deadline_truncated")
            out.append(clamped)
        return out

    # -- the warmup grid --------------------------------------------------

    def _program_count(self) -> int:
        """Serving programs: the prefill buckets captured so far (on the
        CPU: keys first used), the prefixed prefill, chunk and finish
        programs, plus the decode blocks — the precompile coverage
        metric, counted as the JAX generator counts it (its plain decode
        program exists from construction, the guided one from its first
        use)."""
        decode = 1 + int(bool(self._decode_guided_program.keys()))
        return (
            len(self._prefill_fns)
            + len(self._prefix_fns)
            + len(self._chunk_fns)
            + len(self._finish_fns)
            + decode
        )

    def precompile_grid(
        self,
        level: str = "serving",
        *,
        workload_prompts: "Sequence[str] | None" = None,
        workload_params: "SamplingParams | None" = None,
    ) -> dict:
        """Capture every program the admission policy can select BEFORE
        serving: a capture mid-run is a latency outlier, not noise.

        ``level``:
          - ``"off"``: nothing.
          - ``"serving"``: the unguided grid — plain and shared-prefix
            prefill for every ``(n_pad, t_pad)`` bucket admission can
            produce (the chunked job's chunk and finish programs wherever
            ``prefill_chunk`` makes them the selected path), plus the
            decode block.  Guided programs capture on the first guided
            request.
          - ``"full"``: additionally the guided variants of the whole grid
            and the guided decode block.

        ``workload_prompts`` (with ``workload_params``) restricts the
        length buckets to exactly those the given prompts produce under
        the real encode/truncate/prefix pipeline; every wave size stays
        covered.
        With an AOT cache, every prefill bucket its records name joins the
        grid, so a warm boot captures what the last boot recorded.

        Every wave runs through the real admission path
        (``_admit_tokens``), so bucket selection, page granting and the
        shared-prefix match run as production traffic would.  Waves the KV pool cannot grant are
        skipped, as are waves a concurrently admitted live request leaves
        too few free slots for.  All grid slots are cancelled and their
        pages released afterwards.  The JAX grid also drives one cheap
        wave at every batch size to compile its host glue; the port's host
        glue is eager PyTorch, compiled by nothing, so those waves are not
        driven.
        """
        if level not in ("off", "serving", "full"):
            raise ValueError(
                f"warmup grid level {level!r}: expected off/serving/full"
            )
        t0 = time.perf_counter()
        before = self._program_count()
        if level == "off":
            return {"level": level, "programs": 0, "seconds": 0.0}

        vocab = self.config.vocab_size
        filler = 7 % vocab
        prefixes = [list(entry["tokens"]) for entry in self._prefixes]
        # plain waves must diverge from every registered prefix at once
        while any(p[0] == filler for p in prefixes if p):
            filler = (filler + 1) % vocab
        short = 8  # filler rows: only row 0 drives the t_pad bucket
        n_pads = self._admission_n_pads()

        def t_buckets(limit: int) -> list:
            ts, t = [], 64
            while t < min(limit, self.max_seq):
                ts.append(t)
                t *= 2
            ts.append(min(limit if limit >= 64 else 64, self.max_seq))
            return sorted(set(ts))

        plain_ts = t_buckets(self.max_seq - 1)
        # per registered prefix, its suffix buckets (prefixes of one
        # length share programs)
        prefix_ts = {
            i: t_buckets(self.max_seq - 1 - len(ptoks)) for i, ptoks in enumerate(prefixes)
        }
        if workload_prompts is not None:
            if workload_params is None:
                raise ValueError(
                    "workload_prompts requires workload_params: the "
                    "truncation budget (max_tokens) decides the buckets"
                )
            budget = self.max_seq - max(
                1, min(workload_params.max_tokens, self.max_seq // 2)
            )
            plain_set: set = set()
            prefix_sets: dict = {i: set() for i in range(len(prefixes))}
            for prompt in workload_prompts:
                toks = self._truncate_prompt(self.tokenizer.encode(prompt), budget)
                for i, ptoks in enumerate(prefixes):
                    if len(toks) - 1 >= len(ptoks) and toks[: len(ptoks)] == ptoks:
                        prefix_sets[i].add(_bucket(len(toks) - len(ptoks), 64, self.max_seq))
                # every prompt's full-length plain bucket is admissible: a
                # mixed wave (a sharer and a non-sharer) takes the plain
                # program at its longest row's full length
                plain_set.add(_bucket(len(toks), 64, self.max_seq))
            plain_ts = sorted(plain_set)
            prefix_ts = {i: sorted(v) for i, v in prefix_sets.items()}

        guided_variants = [False] + ([True] if level == "full" else [])
        # the buckets a previous boot recorded (a guided one only when
        # this level warms guided programs at all)
        recorded = set()
        if self._aot is not None:
            for record in self._aot.records():
                key = record.get("key")
                if record.get("program") == "prefill_fn" and key[2] in guided_variants:
                    recorded.add(tuple(key))
        base = dict(max_tokens=1, stop_on_eos=False)
        waves: list[tuple[list, SamplingParams]] = []
        for guided in guided_variants:
            params = SamplingParams(
                **base, guided_choice=("warm", "cold") if guided else None,
            )
            buckets = {(n, t) for t in plain_ts for n in n_pads}
            buckets |= {(n, t) for n, t, g in recorded if g == guided}
            for n, t in sorted(buckets, key=lambda b: (b[1], b[0])):
                long_row = [filler] * min(t, self.max_seq - 1)
                rows = [list(long_row)] + [[filler] * short for _ in range(n - 1)]
                waves.append((rows, params))
            # the shared-prefix grid, per registered prefix: every row
            # starts with that prefix
            for i, ptoks in enumerate(prefixes):
                for t in prefix_ts.get(i, []):
                    long_sfx = min(t, self.max_seq - 1 - len(ptoks))
                    if long_sfx < 1:
                        continue
                    for n in n_pads:
                        rows = [ptoks + [filler] * long_sfx] + [
                            ptoks + [filler] * short for _ in range(n - 1)
                        ]
                        waves.append((rows, params))

        decode_warm = {False: False, True: False}
        skipped = 0

        def drive(rows: list, params: SamplingParams) -> None:
            nonlocal skipped
            guided = params.guided_choice is not None
            if len(self.free_slots()) < len(rows):
                skipped += 1  # a live request holds slots: degrade, never assert
                return
            try:
                taken = self._admit_tokens(
                    [list(r) for r in rows], [params] * len(rows),
                    time.perf_counter(),
                )
            except OversizedRequest:
                skipped += 1
                return
            while self._prefill_job is not None:
                self.step()
            if len(taken) < len(rows):
                skipped += 1  # the page pool cannot grant the full wave
            if taken and not decode_warm[guided]:
                self.step()  # captures the (guided) decode block
                decode_warm[guided] = True
            for slot_id in taken:
                self.cancel(slot_id)
            while self._inflight_blocks:
                self.step()

        for rows, params in waves:
            guided = params.guided_choice is not None
            n_pad = self._admission_n_pad(len(rows))
            shared = self._wave_shared_prefix(rows, [params] * len(rows))
            t_pad = _bucket(max(len(r) for r in rows) - shared, 64, self.max_seq)
            if shared:
                key_hit = (n_pad, t_pad, shared, guided) in self._prefix_fns
            elif self.prefill_chunk is not None and t_pad > self.prefill_chunk:
                key_hit = (n_pad, t_pad, guided) in self._finish_fns
            else:
                key_hit = (n_pad, t_pad, guided) in self._prefill_fns
            if key_hit and decode_warm[guided]:
                continue
            drive(rows, params)

        result = {
            "level": level,
            "programs": self._program_count() - before,
            "skipped_waves": skipped,
            "seconds": round(time.perf_counter() - t0, 2),
        }
        if self._aot is not None:
            # a warm boot captures what its records name (hits) and stores
            # nothing: live_compiles == 0 is the warm-start signature
            result["aot"] = self._aot.stats()
        log.info("precompile grid: %s", result)
        return result

    # -- wave admission -------------------------------------------------

    def admit(
        self, prompts: Sequence[str], params_list: Sequence[SamplingParams]
    ) -> list[int]:
        """Tokenise + batch-prefill prompts into free slots; returns slot ids.

        One forward pass for the whole group.  Admission may be PARTIAL:
        when the KV free list cannot cover every prompt's worst case
        (prompt + max_tokens), only the longest prefix that fits is
        admitted and the returned list is shorter than ``prompts`` — the
        caller requeues the rest.  A single request larger than the whole
        cache raises :class:`OversizedRequest`.
        """
        free = self.free_slots()
        assert len(prompts) <= len(free), "admit() called with too few free slots"
        if not prompts:
            return []
        started = time.perf_counter()
        if any(p.deadline is not None for p in params_list):
            # clamp BEFORE token budgeting: max_tokens decides both the
            # truncation budget and the page grant below
            params_list = self._deadline_clamp_wave(params_list)
        token_lists = []
        for prompt, sampling in zip(prompts, params_list):
            ids = self.tokenizer.encode(prompt)
            budget = prompt_budget(self.max_seq, sampling.max_tokens)
            token_lists.append(self._truncate_prompt(ids, budget))
        return self._admit_tokens(token_lists, params_list, started)

    def _admit_tokens(
        self,
        token_lists: list,
        params_list: Sequence[SamplingParams],
        started: float,
    ) -> list[int]:
        """Admission after tokenisation/truncation: the shared-prefix
        decision, page grants, then the batched prefill of the prefix of
        the wave that fits.  When every prompt starts with one registered
        prefix, rows reference its generator-owned pages and are granted
        (and later prefill) only their suffix.  A contiguous engine grants
        nothing and admits the whole wave: each slot's row already holds
        ``max_seq`` positions."""
        if not self.paged:
            return self._admit_batch(token_lists, params_list, [], started)
        shared, prefix_pages = self._wave_prefix_match(token_lists, params_list)
        page_grants: list[list[int]] = []
        pool = self.allocator.num_pages - 1 - self.prefix_held_pages
        for toks, sampling in zip(token_lists, params_list):
            need = pages_needed(
                len(toks), sampling.max_tokens, self.max_seq, self.page_size
            ) - shared // self.page_size
            if need > pool:
                if not page_grants:
                    raise OversizedRequest(
                        f"request needs {need} KV pages, cache holds {pool}"
                    )
                break
            try:
                page_grants.append(self.allocator.allocate(need))
            except MemoryError:
                break  # backpressure: admit the prefix that fits
        if not page_grants:
            return []
        token_lists = token_lists[: len(page_grants)]
        params_list = params_list[: len(page_grants)]
        try:
            return self._admit_batch(
                token_lists, params_list, page_grants, started,
                prefix_shared=shared, prefix_pages=prefix_pages,
            )
        except BaseException:
            for grant in page_grants:  # don't leak pages on prefill failure
                self.allocator.release(grant)
            raise

    def _admission_n_pads(self) -> list[int]:
        """The closed set of batch buckets admission can assign:
        power-of-two buckets, on a mesh rounded up to multiples of
        ``dp * fsdp`` (so prefill rows split over the data axes and never
        run replicated; JAX ``admission.py:480-492``), capped at
        max_slots.  Taking the smallest member >= n keeps
        ``_admission_n_pad`` idempotent where ``dp * fsdp`` is not a power
        of two."""
        d = 1 if self.shard is None else self.shard.data
        return sorted({
            min(self.max_slots, -(-(1 << k) // d) * d)
            for k in range(self.max_slots.bit_length() + 1)
        })

    def _admission_n_pad(self, n: int) -> int:
        """Smallest batch bucket that fits ``n`` rows (padding rows are
        row-0 duplicates)."""
        for pad in self._admission_n_pads():
            if pad >= n:
                return pad
        return self.max_slots

    def _admit_batch(
        self,
        token_lists: list[list[int]],
        params_list: Sequence[SamplingParams],
        page_grants: list[list[int]],
        started: float,
        prefix_shared: int = 0,
        prefix_pages: "list[int] | None" = None,
    ) -> list[int]:
        free = self.free_slots()
        n = len(token_lists)
        if prefix_shared:
            # the prefixed program sees only suffixes; lengths stay FULL
            # (decode appends at the true sequence length)
            token_lists = [toks[prefix_shared:] for toks in token_lists]
        max_len = max(len(t) for t in token_lists)
        n_pad = self._admission_n_pad(n)
        t_pad = _bucket(max_len, 64, self.max_seq)

        ids = np.zeros((n_pad, t_pad), np.int32)
        lengths = np.ones((n_pad,), np.int32)
        temp = np.zeros((n_pad,), np.float32)
        top_p = np.ones((n_pad,), np.float32)
        slot_ids = np.zeros((n_pad,), np.int32)
        adapter_idx = np.zeros((n_pad,), np.int64)
        taken = free[:n]
        for row, (toks, sampling) in enumerate(zip(token_lists, params_list)):
            ids[row, : len(toks)] = toks
            lengths[row] = len(toks) + prefix_shared  # the FULL sequence length
            temp[row] = sampling.temperature
            top_p[row] = sampling.top_p
            slot_ids[row] = taken[row]
            if sampling.adapter is not None and sampling.adapter not in self._adapter_ids:
                raise ValueError(
                    f"unknown LoRA adapter {sampling.adapter!r}; registered: "
                    f"{sorted(n for n in self._adapter_ids if n)}"
                )
            adapter_idx[row] = self._adapter_ids[sampling.adapter]
        # padding rows duplicate row 0 verbatim (tokens, length AND slot):
        # the scatter then writes identical values to one slot's pages from
        # several rows, which is order-independent
        for row in range(n, n_pad):
            ids[row] = ids[0]
            lengths[row] = lengths[0]
            slot_ids[row] = slot_ids[0]
            adapter_idx[row] = adapter_idx[0]

        self.prefill_waves += 1
        # the fast path's observability: a template that silently stopped
        # matching shows up as plain waves
        self.metrics.incr("prefill_waves_prefix" if prefix_shared else "prefill_waves_plain")
        # guided decoding: stack the automata this wave + active slots need
        wave_specs = [self._guided_spec(p) for p in params_list]
        if any(wave_specs) or self._guided_tables is not None:
            self._refresh_guided_tables(wave_specs)
        guided = self._guided_tables is not None
        row_aut = self._guided_row_aut(wave_specs, n_pad) if guided else None
        if (
            self.prefill_chunk is not None
            and t_pad > self.prefill_chunk
            and self._prefill_job is None
            and not prefix_shared  # a suffix-only prefill is short already
        ):
            return self._start_prefill_job(
                (n_pad, t_pad), ids, lengths, temp, top_p, slot_ids, adapter_idx,
                params_list, page_grants, taken,
            )
        if self.paged:
            cache, rows = self._stage_page_tables(
                n, n_pad, slot_ids, page_grants, lengths,
                prefix_shared=prefix_shared, prefix_pages=prefix_pages,
            )
        else:
            # contiguous: the bucket's rows land in the slots' own rows
            cache, rows = self.cache, slot_ids
        device = self.device
        args = (
            torch.from_numpy(ids).to(device),
            torch.from_numpy(lengths).to(device),
            torch.from_numpy(rows).to(device),
            torch.from_numpy(temp).to(device),
            torch.from_numpy(top_p).to(device),
            self.lora,
            torch.from_numpy(adapter_idx).to(device) if self.lora is not None else None,
            self._guided_tables,
            torch.from_numpy(row_aut).to(device) if guided else None,
        )
        with torch.profiler.record_function("podmortem.prefill"):
            if prefix_shared:
                key = (n_pad, t_pad, prefix_shared, guided)
                program = self._prefix_fns.get(key)
                if program is None:
                    log.info("capturing prefixed prefill bucket n=%d t_sfx=%d shared=%d "
                             "(guided=%s)", n_pad, t_pad, prefix_shared, guided)
                    # fixed by address: params, the adapter stack, the tables
                    program = self._prefix_fns[key] = self._aot_wrap(
                        f"prefix_n{n_pad}_t{t_pad}_s{prefix_shared}_g{int(guided)}",
                        self._prefill_paged_prefixed, fixed_args=(0, 8, 10),
                        fixed_fields=("k_pages", "v_pages"), generators=(self._rng,),
                    )
                prefix_table = np.asarray(
                    (prefix_pages or [])[: prefix_shared // self.page_size], np.int32
                )
                cache, first_tokens, first_state = program(
                    self.params, cache, torch.from_numpy(prefix_table).to(device), *args,
                    prefix_shared, key=key,
                )
            else:
                # one program per bucket, as the JAX generator keys
                # ``_prefill_fns``; the flash-prefill switch is read here,
                # as JAX reads it at trace time, and selects its own graph
                cache, first_tokens, first_state = self._prefill_program(
                    self.params, cache, *args,
                    key=(n_pad, t_pad, guided), variant=flash_prefill_enabled(),
                )
            first_np = first_tokens.cpu().numpy()  # the wave's ONE host sync
        if self.paged:  # the contiguous cache was written in place
            self.paged_cache = cache
        result = self._activate_slots(
            first_np, lengths, taken, params_list, page_grants,
            (time.perf_counter() - started) * 1e3,
        )
        if guided:
            self._apply_guided_activation(row_aut, taken, first_state)
        return result

    def _truncate_prompt(self, ids: list, budget: int) -> list:
        """Fit ``ids`` into ``budget`` tokens.

        Failure evidence concentrates at the TAIL and the instructions
        sit at the HEAD: when the prompt starts with a registered prefix,
        the MIDDLE goes so both survive.  The head keeps at most half the
        budget, floored to a page, so the evidence always has the larger
        share; without a matching prefix this is plain tail truncation.
        A truncated prompt usually keeps only PART of the prefix, so its
        wave takes the plain prefill (``_wave_shared_prefix`` is
        all-or-nothing): the head is kept for the instructions, not for
        KV reuse."""
        if len(ids) <= budget:
            return ids
        head = 0
        if self._prefixes:
            # the longest registered-prefix run, whichever template made it
            for entry in self._prefixes:
                common = 0
                for a, b in zip(ids, entry["tokens"]):
                    if a != b:
                        break
                    common += 1
                head = max(head, common)
            head = min(head, budget // 2)
            head = (head // self.page_size) * self.page_size
        return ids[:head] + ids[-(budget - head):]

    def _wave_prefix_match(
        self, token_lists: list, params_list: Sequence[SamplingParams]
    ) -> "tuple[int, list[int]]":
        """(shared token count, that prefix's pages) for the LONGEST
        registered prefix that EVERY prompt in the wave fully matches;
        (0, []) when none covers the whole wave.

        All or nothing per prefix: the suffix program is keyed on the
        static shared length, so an interior length (the page-floored
        half budget a truncated long prompt keeps) would capture a graph
        of its own mid-run.  Every row also keeps at least one suffix
        token, whose logits give its first token.  LoRA waves never
        share: adapters change the K/V projections, so the base model's
        prefix KV is not what the adapted prefill computes.  An empty row
        never shares."""
        if not (self._prefixes and token_lists):
            return 0, []
        if any(p.adapter for p in params_list):
            return 0, []
        if any(not toks for toks in token_lists):
            return 0, []
        best, best_pages = 0, []
        for entry in self._prefixes:
            ptoks = entry["tokens"]
            shared = len(ptoks)
            for toks in token_lists:
                if len(toks) - 1 < len(ptoks) or toks[: len(ptoks)] != ptoks:
                    shared = 0
                    break  # this prefix cannot cover the whole wave
            if shared > best:
                best, best_pages = shared, entry["pages"]
        return best, best_pages

    def _wave_shared_prefix(
        self, token_lists: list, params_list: Sequence[SamplingParams]
    ) -> int:
        """The shared token count alone (see :meth:`_wave_prefix_match`)."""
        return self._wave_prefix_match(token_lists, params_list)[0]

    def _stage_page_tables(
        self, n: int, n_pad: int, slot_ids: np.ndarray,
        page_grants: list[list[int]], lengths: np.ndarray,
        prefix_shared: int = 0, prefix_pages: "list[int] | None" = None,
    ) -> tuple[PagedKVCache, np.ndarray]:
        """Build the wave's page-table rows and a STAGED cache carrying
        them (one-shot, prefixed and chunked prefill alike); padding rows
        duplicate row 0.  In a shared-prefix wave every row's table starts
        with the matched prefix's generator-owned pages (read-only, never
        in a grant).  The staged cache holds new page-table and length
        tensors and is not committed to ``self.paged_cache`` here: the
        caller assigns it from its program's return, so a failed prefill
        leaves the engine's tables untouched.

        Returns ``(staged_cache, row_tables)``."""
        row_tables = np.zeros((n_pad, self.pages_per_seq), np.int32)
        n_prefix = prefix_shared // self.page_size
        for row, grant in enumerate(page_grants):
            if n_prefix:
                row_tables[row, :n_prefix] = (prefix_pages or [])[:n_prefix]
            row_tables[row, n_prefix: n_prefix + len(grant)] = grant
        for row in range(n, n_pad):
            row_tables[row] = row_tables[0]
        paged = self.paged_cache
        device = self.device
        slots = torch.from_numpy(slot_ids[:n].astype(np.int64)).to(device)
        table = paged.page_table.clone()
        table[slots] = torch.from_numpy(row_tables[:n]).to(device)
        lens = paged.lengths.clone()
        lens[slots] = torch.from_numpy(lengths[:n]).to(device)
        staged = PagedKVCache(
            k_pages=paged.k_pages, v_pages=paged.v_pages,
            page_table=table, lengths=lens,
        )
        return staged, row_tables

    def _start_prefill_job(
        self, key: tuple, ids: np.ndarray, lengths: np.ndarray, temp: np.ndarray,
        top_p: np.ndarray, slot_ids: np.ndarray, adapter_idx: np.ndarray,
        params_list: Sequence[SamplingParams], page_grants: list[list[int]],
        taken: list[int],
    ) -> list[int]:
        """Reserve the wave's slots and stage the job: its chunks run one
        per ``step()`` so the decode blocks of live slots interleave.  The
        device page table is not touched here (see ``_advance_prefill``).
        The tokens and the chunk offsets go to the card once, here, so a
        chunk round enqueues no host copy."""
        n_pad, t_pad = key
        device = self.device
        mini, last_logits = self._job_buffers_for(n_pad, t_pad)
        self._prefill_job = _PrefillJob(
            key=key,
            ids=torch.from_numpy(ids).to(device),
            offsets=torch.arange(
                0, t_pad, self.prefill_chunk, dtype=torch.int32
            ).to(device),
            lengths_np=lengths,
            lengths=torch.from_numpy(lengths).to(device),
            temp=torch.from_numpy(temp).to(device),
            top_p=torch.from_numpy(top_p).to(device),
            slot_ids_np=slot_ids,
            taken=list(taken),
            params_list=list(params_list),
            page_grants=list(page_grants),
            adapter_idx=(
                torch.from_numpy(adapter_idx).to(device) if self.lora is not None else None
            ),
            mini=mini,
            last_logits=last_logits,
            written=0,
        )
        self._reserved.update(taken)
        return list(taken)
