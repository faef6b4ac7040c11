"""Wave admission: tokenise, grant pages, batch-prefill into free slots.

Counterpart of the paged, plain branch of ``operator_tpu/serving/admission.py``:
:meth:`AdmissionMixin.admit` (:395), ``_admit_tokens`` (:429), the batch
buckets ``_admission_n_pads``/``_admission_n_pad`` (:478-499), the plain
paged branch of ``_admit_batch`` (:501-664), ``_stage_page_tables`` (:747)
and ``_truncate_prompt``; and the deadline budget's policy, which both
loops share: ``decode_token_estimate_s`` (:53), ``deadline_policy`` (:64,
on the injectable ``_clock``, with the overload ladder when
``overload_policy`` is wired) and the wave's ``_deadline_clamp_wave``
(:142).  Not ported yet: the registered shared prefix (prefix matching
and the suffix-only prefill), chunked prefill, guided decoding and LoRA
adapters.

Mixed into :class:`serving.engine.Generator`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..ops.paged_attention import PagedKVCache
from .types import OversizedRequest, SamplingParams, _bucket, pages_needed, prompt_budget

__all__ = ["AdmissionMixin"]


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
        """Admission after tokenisation/truncation: page grants, then the
        batched prefill of the prefix of the wave that fits."""
        page_grants: list[list[int]] = []
        pool = self.allocator.num_pages - 1
        for toks, sampling in zip(token_lists, params_list):
            need = pages_needed(
                len(toks), sampling.max_tokens, self.max_seq, self.page_size
            )
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
            return self._admit_batch(token_lists, params_list, page_grants, started)
        except BaseException:
            for grant in page_grants:  # don't leak pages on prefill failure
                self.allocator.release(grant)
            raise

    def _admission_n_pads(self) -> list[int]:
        """The closed set of batch buckets admission can assign:
        power-of-two buckets capped at max_slots."""
        return sorted({
            min(self.max_slots, 1 << k)
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
    ) -> list[int]:
        free = self.free_slots()
        n = len(token_lists)
        max_len = max(len(t) for t in token_lists)
        n_pad = self._admission_n_pad(n)
        t_pad = _bucket(max_len, 64, self.max_seq)

        ids = np.zeros((n_pad, t_pad), np.int32)
        lengths = np.ones((n_pad,), np.int32)
        temp = np.zeros((n_pad,), np.float32)
        top_p = np.ones((n_pad,), np.float32)
        slot_ids = np.zeros((n_pad,), np.int32)
        taken = free[:n]
        for row, (toks, sampling) in enumerate(zip(token_lists, params_list)):
            ids[row, : len(toks)] = toks
            lengths[row] = len(toks)
            temp[row] = sampling.temperature
            top_p[row] = sampling.top_p
            slot_ids[row] = taken[row]
        # padding rows duplicate row 0 verbatim (tokens, length AND slot):
        # the scatter then writes identical values to one slot's pages from
        # several rows, which is order-independent
        for row in range(n, n_pad):
            ids[row] = ids[0]
            lengths[row] = lengths[0]
            slot_ids[row] = slot_ids[0]

        self.prefill_waves += 1
        # the reference counts plain against prefix-shared waves; the
        # wave engine's shared prefix is not ported (Queue 1 item 6), so
        # every wave is plain
        self.metrics.incr("prefill_waves_plain")
        staged, row_tables = self._stage_page_tables(
            n, n_pad, slot_ids, page_grants, lengths
        )
        device = self.device
        with torch.profiler.record_function("podmortem.prefill"):
            self.paged_cache, first_tokens = self._prefill_paged(
                self.params, staged,
                torch.from_numpy(ids).to(device),
                torch.from_numpy(lengths).to(device),
                torch.from_numpy(row_tables).to(device),
                torch.from_numpy(temp).to(device),
                torch.from_numpy(top_p).to(device),
            )
            first_np = first_tokens.cpu().numpy()  # the wave's ONE host sync
        return self._activate_slots(
            first_np, lengths, taken, params_list, page_grants,
            (time.perf_counter() - started) * 1e3,
        )

    def _truncate_prompt(self, ids: list, budget: int) -> list:
        """Fit ``ids`` into ``budget`` tokens, keeping the TAIL (failure
        evidence concentrates there).  The JAX generator keeps a registered
        shared prefix as the head; the port registers none yet."""
        if len(ids) <= budget:
            return ids
        return ids[-budget:]

    def _stage_page_tables(
        self, n: int, n_pad: int, slot_ids: np.ndarray,
        page_grants: list[list[int]], lengths: np.ndarray,
    ) -> tuple[PagedKVCache, np.ndarray]:
        """Build the wave's page-table rows and a STAGED cache carrying
        them; padding rows duplicate row 0.  The staged cache holds new
        page-table and length tensors and is not committed to
        ``self.paged_cache`` here: the caller assigns it from the prefill's
        return, so a failed prefill leaves the engine's tables untouched.

        Returns ``(staged_cache, row_tables)``."""
        row_tables = np.zeros((n_pad, self.pages_per_seq), np.int32)
        for row, grant in enumerate(page_grants):
            row_tables[row, : len(grant)] = grant
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
