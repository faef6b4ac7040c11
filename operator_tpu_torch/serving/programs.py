"""The wave engine's device programs: the decode blocks and the prefills.

Counterpart of ``operator_tpu/serving/programs.py``, for both cache
layouts, with and without a serving mesh.  Contiguous (``KVCache``, one ``[max_seq]`` row per
slot): :meth:`ProgramBuilderMixin._decode_step` (:47),
:meth:`~ProgramBuilderMixin._decode_block` (:101, and with the guided
args its twin ``_decode_block_guided``, :160) and
:meth:`~ProgramBuilderMixin._prefill`, the program ``_make_prefill``
(:314) builds: the bucket forwarded through a fresh mini cache (flash
prefill, K4, when enabled) and scattered into ``cache[:, slot_ids,
:t_pad]`` (one function for both layouts).  Each slot's offset lives in a device vector the decode step
advances in place for active slots; an inactive slot keeps writing into
its own row at its frozen offset, masked by ``kv_valid`` like any stale
position past a row's length.  Paged:
:meth:`ProgramBuilderMixin._decode_step_paged` (:71),
:meth:`~ProgramBuilderMixin._decode_block_paged` (:132, and its guided
twin ``_decode_block_paged_guided``, :192),
:meth:`~ProgramBuilderMixin._prefill` again, the program that
``_make_prefill_paged`` (:370) builds, the suffix-only prefill over a
registered shared prefix (:meth:`~ProgramBuilderMixin._prefill_paged_prefixed`,
``_make_prefill_paged_prefixed``, :431), the chunked prefill's chunk and
finish programs (:meth:`~ProgramBuilderMixin._prefill_chunk`,
:meth:`~ProgramBuilderMixin._prefill_finish`; ``_make_chunk_fn`` :522,
``_make_finish_fn`` :580, both layouts) and the shared prefix's build
(:meth:`~ProgramBuilderMixin._prefix_build`, ``engine.py:818-838``).
JAX compiles each into one program per shape behind ``_aot_wrap``
(``engine.py:390-425``); here each runs through the generator's
``_aot_wrap`` as a ``serving/graphs.py`` program: one CUDA graph per
decode variant and per prefill, prefix, chunk and finish key on the
card, eager on the CPU.  A static value of a key that no tensor shape
carries (the shared length) is a Python ``int`` argument, part of the
program's signature.  They read nothing back to the host (the callers do
that once per block and once per prefill wave) and draw from the
generator's registered ``torch.Generator``.  Sampling is the port's ``serving/sampling.py``.

Multi-LoRA: the stacked adapters (``lora``, ``[L, n_adapters, ...]``) and
the per-row ``lora_idx`` ride along as arguments into the model's
projections.  Guided decoding: the stacked automaton tables
(``gtables``, ``[A, S, vocab]`` int32, -1 = forbidden), each row's
automaton id (``gaut``) and DFA state (``gstate``) mask the logits with
``-inf`` where the row's transition is -1, and the state steps on the
device for active rows whose sampled token is allowed — the state is
carried through the block, never read back per step.

On a serving mesh (``Generator(mesh=...)``) each rank runs every program
on its shard, and the programs make the collectives that JAX's
``in_shardings``/``out_shardings`` imply (``parallel/mesh.py:
ServingShard``).  A data rank decodes and prefills only its rows: the
per-slot vectors are whole on every rank and each program takes its
rows (:meth:`~ProgramBuilderMixin._local_rows`).  Each program's results
(sampled tokens, lengths, DFA states) are gathered over the data axes
once, at its end (:meth:`~ProgramBuilderMixin._gather_rows`), so every
rank's host sees every slot's token; a prefill's mini cache is gathered
before the store (:meth:`~ProgramBuilderMixin._gather_mini`), because a
wave's row and the slot it fills may lie on different data ranks.  The
model (``models/llama.py``) runs the tp all-reduces, the fsdp weight
gathers and the vocab gather.

Mixed into :class:`serving.engine.Generator`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import torch

from ..models.llama import KVCache, decode_step, decode_step_paged, forward
from ..ops.paged_attention import PagedKVCache, write_tokens
from .sampling import sample

if TYPE_CHECKING:
    from ..parallel.mesh import ServingShard

__all__ = ["ProgramBuilderMixin"]


def _mask(logits: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Forbidden transitions (``row < 0``) become ``-inf``."""
    return torch.where(row >= 0, logits, torch.full_like(logits, float("-inf")))


def _transition(row: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``row[b, tokens[b]]``: the state each row's sampled token leads to."""
    return torch.gather(row, 1, tokens.long()[:, None])[:, 0]


class ProgramBuilderMixin:
    """The decode blocks and the prefills of the wave engine."""

    config: Any
    decode_block: int
    sample_top_k: int
    lora_alpha: float
    _rng: torch.Generator
    #: this rank's place on a serving mesh, else None
    shard: Optional["ServingShard"]

    # -- a serving mesh's rows ------------------------------------------------

    def _local_rows(self, n: int, *tensors: Optional[torch.Tensor]) -> tuple:
        """Each tensor's rows of this data rank (``ServingShard.rows``), or
        the tensors as they are without a mesh; None stays None."""
        if self.shard is None:
            return tensors
        rows = self.shard.rows(n)
        return tuple(None if t is None else t[rows] for t in tensors)

    def _gather_rows(self, *tensors: Optional[torch.Tensor]) -> tuple:
        """The inverse of :meth:`_local_rows` for per-row integer results
        (1-d, one row each): every data rank's rows, joined by ONE gather
        over the data axes.  Without a mesh, as they are."""
        if self.shard is None:
            return tensors
        present = [t for t in tensors if t is not None]
        packed = self.shard.gather_data(torch.stack([t.to(torch.int64) for t in present]), 1)
        out, i = [], 0
        for t in tensors:
            if t is None:
                out.append(None)
            else:
                out.append(packed[i].to(t.dtype))
                i += 1
        return tuple(out)

    def _gather_mini(self, mini: KVCache) -> KVCache:
        """A prefill's mini cache of this data rank's rows, joined over the
        data axes: a wave's row and the slot it fills may lie on different
        data ranks (the paged pool is whole on every data rank, as
        ``paged_cache_specs`` places it in JAX; a contiguous rank keeps
        its own slots' rows, ``_store_prompt_kv``)."""
        if self.shard is None:
            return mini
        return KVCache(k=self.shard.gather_data(mini.k, 1), v=self.shard.gather_data(mini.v, 1))

    def _decode_step(
        self, params, cache: KVCache, tokens: torch.Tensor, offsets: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
        gstate: Optional[torch.Tensor] = None,
    ) -> tuple[KVCache, torch.Tensor, Optional[torch.Tensor]]:
        """[B, 1] tokens at each slot's offset -> the next token per slot,
        over the contiguous cache.  ``offsets`` ([B] int32, the engine's
        device vector) advances in place for active slots only; inactive
        slots keep decoding junk into their own rows at their frozen
        offset.  Guided args as in :meth:`_decode_step_paged`; returns
        (cache, tokens, the new state or None)."""
        logits, cache = decode_step(
            params, self.config, tokens, offsets[:, None], cache, offsets,
            lora=lora, lora_alpha=self.lora_alpha, lora_indices=lora_idx, shard=self.shard,
        )
        row = None
        if gtables is not None:
            row = gtables[gaut, gstate]  # [B, vocab] allowed-transition rows
            logits = _mask(logits, row)
        next_tokens = sample(logits, self._rng, temp, top_p, self.sample_top_k)
        offsets.copy_(torch.where(active, offsets + 1, offsets))
        if row is not None:
            stepped = _transition(row, next_tokens)
            gstate = torch.where(active & (stepped >= 0), stepped, gstate)
        return cache, next_tokens, gstate

    def _decode_block(
        self, params, cache: KVCache, tokens: torch.Tensor, offsets: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
        gstate: Optional[torch.Tensor] = None,
    ) -> tuple[KVCache, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``decode_block`` chained contiguous decode steps (the JAX
        ``lax.scan``, or its straight line under
        ``OPERATOR_TPU_DECODE_UNROLL``: here both are the same enqueued
        sequence); with ``gtables`` its guided twin.  ``offsets`` advance
        in place.  Returns (cache, the [K, B] token matrix, the last
        tokens [B, 1], the final DFA state or None).

        On a mesh a data rank decodes its own slots' rows (its cache holds
        only those), and the tokens and states of every rank's rows are
        gathered once, at the block's end."""
        tokens, offsets, temp, top_p, active, lora_idx, gaut, gstate = self._local_rows(
            tokens.shape[0], tokens, offsets, temp, top_p, active, lora_idx, gaut, gstate)
        toks = []
        for _ in range(self.decode_block):
            cache, next_tokens, gstate = self._decode_step(
                params, cache, tokens, offsets, temp, top_p, active,
                lora, lora_idx, gtables, gaut, gstate,
            )
            tokens = next_tokens[:, None]
            toks.append(next_tokens)
        *toks, gstate = self._gather_rows(*toks, gstate)
        return cache, torch.stack(toks), toks[-1][:, None], gstate

    def _decode_step_paged(
        self, params, paged: PagedKVCache, tokens: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
        gstate: Optional[torch.Tensor] = None,
    ) -> tuple[PagedKVCache, torch.Tensor, Optional[torch.Tensor]]:
        """[B, 1] tokens -> the next token per slot.  Released slots write
        to the trash page through their zeroed page-table row, and only
        active slots' lengths advance.  With guided args the sampler is
        masked by each row's automaton row and the DFA state advances;
        returns (cache, tokens, the new state or None)."""
        logits, new_paged = decode_step_paged(
            params, self.config, tokens, paged,
            lora=lora, lora_alpha=self.lora_alpha, lora_indices=lora_idx, shard=self.shard,
        )
        row = None
        if gtables is not None:
            row = gtables[gaut, gstate]  # [B, vocab] allowed-transition rows
            logits = _mask(logits, row)
        next_tokens = sample(logits, self._rng, temp, top_p, self.sample_top_k)
        lengths = torch.where(active, new_paged.lengths, paged.lengths)
        if row is not None:
            stepped = _transition(row, next_tokens)
            gstate = torch.where(active & (stepped >= 0), stepped, gstate)
        return PagedKVCache(
            k_pages=new_paged.k_pages, v_pages=new_paged.v_pages,
            page_table=new_paged.page_table, lengths=lengths,
        ), next_tokens, gstate

    def _decode_block_paged(
        self, params, paged: PagedKVCache, tokens: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
        gstate: Optional[torch.Tensor] = None,
    ) -> tuple[PagedKVCache, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``decode_block`` chained decode steps, enqueued back to back on
        the stream (the JAX ``lax.scan``; with ``gtables`` its guided twin,
        the DFA state in the carry).  Returns (cache, the [K, B] token
        matrix, the last tokens [B, 1], the final DFA state or None).

        On a mesh a data rank decodes its own slots' rows over the whole
        pool (at its KV heads), and the tokens, lengths and states of every
        rank's rows are gathered once, at the block's end."""
        table = paged.page_table
        tokens, temp, top_p, active, lora_idx, gaut, gstate, rows_table, lengths = (
            self._local_rows(tokens.shape[0], tokens, temp, top_p, active, lora_idx, gaut,
                             gstate, table, paged.lengths))
        paged = PagedKVCache(k_pages=paged.k_pages, v_pages=paged.v_pages,
                             page_table=rows_table, lengths=lengths)
        toks = []
        for _ in range(self.decode_block):
            paged, next_tokens, gstate = self._decode_step_paged(
                params, paged, tokens, temp, top_p, active,
                lora, lora_idx, gtables, gaut, gstate,
            )
            tokens = next_tokens[:, None]
            toks.append(next_tokens)
        *toks, lengths, gstate = self._gather_rows(*toks, paged.lengths, gstate)
        paged = PagedKVCache(k_pages=paged.k_pages, v_pages=paged.v_pages,
                             page_table=table, lengths=lengths)
        return paged, torch.stack(toks), toks[-1][:, None], gstate

    def _store_prompt_kv(
        self, cache: "KVCache | PagedKVCache", mini: KVCache, lengths: torch.Tensor,
        rows: torch.Tensor, start: int = 0,
    ) -> None:
        """A prefilled mini cache's KV into the engine's cache, in place.
        Paged: each row's tokens from ``start`` on into its pages
        (``rows``, the ``[n_pad, pages_per_seq]`` tables; ``write_tokens``
        with ``valid_len``, so padding lands in the trash page).
        Contiguous: the whole ``[:, :, start:t_pad]`` block into the slots'
        rows (``rows``, the ``[n_pad]`` slot ids: JAX's ``cache.at[:,
        slot_ids, :t_pad].set``); padding rows duplicate row 0 and write
        its values again, and positions past a row's length are masked
        until its decode writes them."""
        if isinstance(cache, KVCache) and self.shard is not None:
            # a data rank holds its own slots' rows: each takes the first
            # wave row that fills it (padding rows repeat row 0's values)
            t_pad = mini.k.shape[2]
            held = cache.k.shape[1]
            slots = rows.long() - self.shard.data_rank * held
            match = slots[None, :] == torch.arange(held, device=slots.device)[:, None]
            filled = match.any(1)[None, :, None, None, None]
            source = match.int().argmax(1)
            for dest, src in ((cache.k, mini.k), (cache.v, mini.v)):
                region = dest[:, :, start:t_pad]
                region.copy_(torch.where(filled, src[:, source, start:].to(dest.dtype), region))
            return
        if isinstance(cache, KVCache):
            t_pad = mini.k.shape[2]
            slots = rows.long()
            for dest, src in ((cache.k, mini.k), (cache.v, mini.v)):
                dest[:, :, start:t_pad].index_copy_(1, slots, src[:, :, start:].to(dest.dtype))
            return
        n_pad = lengths.shape[0]
        offset = torch.full((n_pad,), start, dtype=torch.int32, device=lengths.device)
        for index in range(self.config.num_layers):
            write_tokens(cache.k_pages[index], rows, mini.k[index, :, start:], offset,
                         lengths - start)
            write_tokens(cache.v_pages[index], rows, mini.v[index, :, start:], offset,
                         lengths - start)

    def _prefill(
        self, params, cache: "KVCache | PagedKVCache", token_ids: torch.Tensor,
        lengths: torch.Tensor, rows: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
    ) -> tuple["KVCache | PagedKVCache", torch.Tensor, Optional[torch.Tensor]]:
        """One prefill bucket ``[n_pad, t_pad]``, the program JAX
        ``_make_prefill_paged`` (paged) or ``_make_prefill`` (contiguous)
        builds: the mini-cache forward (flash prefill, K4, when enabled),
        then each row's prompt KV stored into the engine's cache
        (:meth:`_store_prompt_kv`: ``rows`` are the page tables or the
        slot ids), and the first token sampled from each row's last
        prompt position.

        The hidden state is gathered at ``lengths - 1`` before the vocab
        head (``forward(logits_at=...)``): the same logits the JAX program
        takes from its full ``[n_pad, t_pad, vocab]`` tensor, which at
        n = 16, t = 2048 would be 4 GiB of float32.

        With guided args the first token is masked by each row's start
        state (state 0) and the state it leads to is returned, clamped at
        0 as the JAX program does; else the third value is None.

        On a mesh a data rank forwards its rows of the bucket (admission
        pads it to a multiple of ``dp * fsdp``), the mini caches are
        gathered over the data axes before the store, and the first
        tokens after the sampling."""
        dtype = cache.k.dtype if isinstance(cache, KVCache) else cache.k_pages.dtype
        ids, lens, temp, top_p, lora_idx, gaut = self._local_rows(
            token_ids.shape[0], token_ids, lengths, temp, top_p, lora_idx, gaut)
        last_logits, mini = self._prefill_forward(params, ids, lens, dtype, lora, lora_idx)
        self._store_prompt_kv(cache, self._gather_mini(mini), lengths, rows)
        first_tokens, first_state = self._sample_first(last_logits, temp, top_p, gtables, gaut)
        first_tokens, first_state = self._gather_rows(first_tokens, first_state)
        return cache, first_tokens, first_state

    def _prefill_forward(
        self, params, token_ids: torch.Tensor, lengths: torch.Tensor, dtype: torch.dtype,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, KVCache]:
        """A bucket through a fresh mini cache with ``prefill_lengths``
        (the flash-prefill path): each row's last-prompt-position logits
        and the mini cache."""
        n_pad, t_pad = token_ids.shape
        device = token_ids.device
        mini = self._mini_cache(n_pad, t_pad, dtype, device)
        positions = torch.arange(t_pad, dtype=torch.int32, device=device)[None].expand(
            n_pad, t_pad
        )
        kv_valid = positions < lengths[:, None]
        return forward(
            params, self.config, token_ids, positions, cache=mini,
            cache_offset=0, kv_valid=kv_valid, prefill_lengths=lengths,
            logits_at=lengths - 1,
            lora=lora, lora_alpha=self.lora_alpha, lora_indices=lora_idx, shard=self.shard,
        )

    def _mini_cache(self, n: int, t: int, dtype: torch.dtype, device: Any) -> KVCache:
        """A fresh ``[n, t]`` mini cache at this rank's KV heads."""
        return KVCache.create(self.config, n, t, dtype=dtype, device=device,
                              kv_heads=self._kv_heads)

    @property
    def _kv_heads(self) -> int:
        """KV heads this rank holds: all, or a tp rank's share."""
        return self.config.num_kv_heads // (1 if self.shard is None else self.shard.tp)

    def _sample_first(
        self, last_logits: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor,
        gtables: Optional[torch.Tensor], gaut: Optional[torch.Tensor],
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Each row's first token from its last prompt position's logits;
        with guided args masked by the row's start state (state 0), and
        the state it leads to, clamped at 0 as the JAX programs do (else
        None)."""
        row = None
        if gtables is not None:
            row = gtables[gaut, torch.zeros_like(gaut)]  # DFA start state
            last_logits = _mask(last_logits, row)
        first_tokens = sample(last_logits, self._rng, temp, top_p, self.sample_top_k)
        first_state = None
        if row is not None:
            first_state = torch.clamp_min(_transition(row, first_tokens), 0)
        return first_tokens, first_state

    def _prefill_paged_prefixed(
        self, params, paged: PagedKVCache, prefix_table: torch.Tensor,
        token_ids: torch.Tensor, lengths: torch.Tensor, row_tables: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
        shared: int = 0,
    ) -> tuple[PagedKVCache, torch.Tensor, Optional[torch.Tensor]]:
        """Suffix-only prefill over a registered shared prefix: the first
        ``shared`` tokens' KV is gathered from the prefix pages
        (``prefix_table``) into the mini cache once, broadcast over the
        rows, and only the ``[n_pad, t_sfx]`` suffix runs through the
        model at ``cache_offset = shared``.  ``lengths`` are the FULL
        sequence lengths.  Only the suffix is scattered, from position
        ``shared`` on, into each row's own pages: the prefix pages are
        read, never written.  Guided rows mask the first token as the
        plain prefill does.  The attention is the dense path (no
        ``prefill_lengths``), as in the JAX program.  On a mesh as
        :meth:`_prefill`: a data rank's rows, gathered before the store."""
        full_lengths = lengths
        token_ids, lengths, temp, top_p, lora_idx, gaut = self._local_rows(
            token_ids.shape[0], token_ids, lengths, temp, top_p, lora_idx, gaut)
        n_pad, t_sfx = token_ids.shape
        device = token_ids.device
        t_total = shared + t_sfx
        layers = self.config.num_layers
        mini = self._mini_cache(n_pad, t_total, paged.k_pages.dtype, device)
        # pages -> contiguous [L, shared, KH, D], the same for every row
        for pages, dest in ((paged.k_pages, mini.k), (paged.v_pages, mini.v)):
            picked = pages[:, prefix_table.long()]  # [L, n_pp, ps, KH, D]
            dest[:, :, :shared] = picked.reshape(layers, 1, shared, *pages.shape[3:])
        positions = shared + torch.arange(t_sfx, dtype=torch.int32, device=device)[None].expand(
            n_pad, t_sfx
        )
        kv_positions = torch.arange(t_total, dtype=torch.int32, device=device)[None]
        kv_valid = kv_positions.expand(n_pad, t_total) < lengths[:, None]
        last_logits, mini = forward(
            params, self.config, token_ids, positions, cache=mini,
            cache_offset=shared, kv_valid=kv_valid,
            logits_at=lengths - 1 - shared,
            lora=lora, lora_alpha=self.lora_alpha, lora_indices=lora_idx, shard=self.shard,
        )
        self._store_prompt_kv(paged, self._gather_mini(mini), full_lengths, row_tables,
                              start=shared)
        first_tokens, first_state = self._sample_first(last_logits, temp, top_p, gtables, gaut)
        first_tokens, first_state = self._gather_rows(first_tokens, first_state)
        return paged, first_tokens, first_state

    def _prefill_chunk(
        self, params, mini: KVCache, ids_chunk: torch.Tensor, lengths: torch.Tensor,
        offset: torch.Tensor, last_logits: torch.Tensor,
        lora: Optional[dict] = None, lora_idx: Optional[torch.Tensor] = None,
    ) -> tuple[KVCache, torch.Tensor]:
        """One prefill chunk: ``[n_pad, chunk]`` tokens forwarded at the
        device offset ``offset`` (a 0-d tensor, so one program serves
        every chunk of a job) into the job's mini cache, in place; rows
        whose prompt ends inside this chunk write their last-token logits
        into ``last_logits``, in place.  Both are the job's buffers, read
        by address under a graph, so a chunk copies neither.  On a mesh
        the job's buffers hold this data rank's rows, and the chunk
        forwards those."""
        ids_chunk, lengths, lora_idx = self._local_rows(
            ids_chunk.shape[0], ids_chunk, lengths, lora_idx)
        n_pad, chunk = ids_chunk.shape
        t_pad = mini.k.shape[2]
        device = ids_chunk.device
        steps = torch.arange(chunk, dtype=torch.int32, device=device)
        positions = (offset + steps)[None].expand(n_pad, chunk)
        kv_positions = torch.arange(t_pad, dtype=torch.int32, device=device)[None]
        # valid cache slots: written so far (this chunk included) AND real
        kv_valid = kv_positions.expand(n_pad, t_pad) < torch.minimum(
            lengths, offset + chunk
        )[:, None]
        rel = (lengths - 1 - offset).long()  # the last token, chunk-relative
        in_chunk = (rel >= 0) & (rel < chunk)
        gathered, mini = forward(
            params, self.config, ids_chunk, positions, cache=mini,
            cache_offset=offset, kv_valid=kv_valid,
            logits_at=rel.clamp(0, chunk - 1),
            lora=lora, lora_alpha=self.lora_alpha, lora_indices=lora_idx, shard=self.shard,
        )
        last_logits.copy_(torch.where(in_chunk[:, None], gathered, last_logits))
        return mini, last_logits

    def _prefill_finish(
        self, cache: "KVCache | PagedKVCache", mini: KVCache, lengths: torch.Tensor,
        rows: torch.Tensor, last_logits: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor,
        gtables: Optional[torch.Tensor] = None, gaut: Optional[torch.Tensor] = None,
    ) -> tuple["KVCache | PagedKVCache", torch.Tensor, Optional[torch.Tensor]]:
        """A chunked job's end: the completed mini cache scattered into
        the engine's cache (each row's pages, ``rows`` the page tables;
        or the slots' contiguous rows, ``rows`` the slot ids: JAX's
        ``else`` branch of ``_make_finish_fn``), and each row's first
        token sampled from the carried last logits (masked by the
        automaton's start state for guided rows).  On a mesh the job's
        mini cache and last logits hold this data rank's rows: the cache
        is gathered before the store, the first tokens after the sampling."""
        self._store_prompt_kv(cache, self._gather_mini(mini), lengths, rows)
        temp, top_p, gaut = self._local_rows(lengths.shape[0], temp, top_p, gaut)
        first_tokens, first_state = self._sample_first(last_logits, temp, top_p, gtables, gaut)
        first_tokens, first_state = self._gather_rows(first_tokens, first_state)
        return cache, first_tokens, first_state

    def _prefix_build(
        self, params, paged: PagedKVCache, ids: torch.Tensor, table: torch.Tensor
    ) -> PagedKVCache:
        """A shared prefix's KV, prefilled once (``[1, n_keep]`` tokens,
        flash prefill when enabled) and scattered into its
        generator-owned pages ``table`` (``[1, n_keep / page]``).  On a
        mesh every rank builds the whole prefix at its own KV heads."""
        lengths = torch.full((1,), ids.shape[1], dtype=torch.int32, device=ids.device)
        _, mini = self._prefill_forward(params, ids, lengths, paged.k_pages.dtype)
        self._store_prompt_kv(paged, mini, lengths, table)
        return paged
