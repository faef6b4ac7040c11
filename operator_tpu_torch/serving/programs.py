"""The wave engine's device programs: the paged decode block and prefill.

Counterpart of ``operator_tpu/serving/programs.py`` for the paged path
without mesh, LoRA or guided decoding: :meth:`ProgramBuilderMixin._decode_step_paged`
(:71), :meth:`~ProgramBuilderMixin._decode_block_paged` (:132) and
:meth:`~ProgramBuilderMixin._prefill_paged`, the program that
``_make_prefill_paged`` (:370) builds.  JAX compiles each into one program
per shape; here they are eager PyTorch, so nothing is cached per bucket.
They read nothing back to the host: the callers do that once per block
and once per prefill wave.  Sampling is the port's ``serving/sampling.py``.

Mixed into :class:`serving.engine.Generator`.
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.llama import KVCache, decode_step_paged, forward
from ..ops.paged_attention import PagedKVCache, write_tokens
from .sampling import sample

__all__ = ["ProgramBuilderMixin"]


class ProgramBuilderMixin:
    """The decode block and the prefill of the paged wave engine."""

    config: Any
    decode_block: int
    sample_top_k: int
    _rng: torch.Generator

    def _decode_step_paged(
        self, params, paged: PagedKVCache, tokens: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
    ) -> tuple[PagedKVCache, torch.Tensor]:
        """[B, 1] tokens -> the next token per slot.  Released slots write
        to the trash page through their zeroed page-table row, and only
        active slots' lengths advance."""
        logits, new_paged = decode_step_paged(params, self.config, tokens, paged)
        next_tokens = sample(logits, self._rng, temp, top_p, self.sample_top_k)
        lengths = torch.where(active, new_paged.lengths, paged.lengths)
        return PagedKVCache(
            k_pages=new_paged.k_pages, v_pages=new_paged.v_pages,
            page_table=new_paged.page_table, lengths=lengths,
        ), next_tokens

    def _decode_block_paged(
        self, params, paged: PagedKVCache, tokens: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor, active: torch.Tensor,
    ) -> tuple[PagedKVCache, torch.Tensor, torch.Tensor]:
        """``decode_block`` chained decode steps, enqueued back to back on
        the stream (the JAX ``lax.scan``).  Returns (cache, the [K, B]
        token matrix, the last tokens [B, 1])."""
        toks = []
        for _ in range(self.decode_block):
            paged, next_tokens = self._decode_step_paged(
                params, paged, tokens, temp, top_p, active
            )
            tokens = next_tokens[:, None]
            toks.append(next_tokens)
        return paged, torch.stack(toks), tokens

    def _prefill_paged(
        self, params, paged: PagedKVCache, token_ids: torch.Tensor,
        lengths: torch.Tensor, row_tables: torch.Tensor,
        temp: torch.Tensor, top_p: torch.Tensor,
    ) -> tuple[PagedKVCache, torch.Tensor]:
        """One prefill bucket ``[n_pad, t_pad]``: the mini-cache forward,
        then each row's prompt KV scattered into its pages (``write_tokens``
        with ``valid_len``, so padded positions land in the trash page),
        and the first token sampled from each row's last prompt position.

        The hidden state is gathered at ``lengths - 1`` before the vocab
        head (``forward(logits_at=...)``): the same logits the JAX program
        takes from its full ``[n_pad, t_pad, vocab]`` tensor, which at
        n = 16, t = 2048 would be 4 GiB of float32."""
        n_pad, t_pad = token_ids.shape
        device = token_ids.device
        mini = KVCache.create(
            self.config, n_pad, t_pad, dtype=paged.k_pages.dtype, device=device
        )
        positions = torch.arange(t_pad, dtype=torch.int32, device=device)[None].expand(
            n_pad, t_pad
        )
        kv_valid = positions < lengths[:, None]
        last_logits, mini = forward(
            params, self.config, token_ids, positions, cache=mini,
            cache_offset=0, kv_valid=kv_valid, prefill_lengths=lengths,
            logits_at=lengths - 1,
        )
        zero = torch.zeros((n_pad,), dtype=torch.int32, device=device)
        for index in range(self.config.num_layers):
            write_tokens(paged.k_pages[index], row_tables, mini.k[index], zero, lengths)
            write_tokens(paged.v_pages[index], row_tables, mini.v[index], zero, lengths)
        first_tokens = sample(last_logits, self._rng, temp, top_p, self.sample_top_k)
        return paged, first_tokens
