"""The mixed-phase step: ONE fixed-shape forward for the whole ragged wave.

Port of ``operator_tpu/serving/sched/mixed.py:make_mixed_fn``.  The
scheduler packs every row's work for a step — one token per decode row,
up to ``chunk`` prompt tokens per prefill row, ``1 + k`` tokens per
speculation verify row — onto a FLAT token axis of static length
``t_budget`` (right-padded with trash tokens), so the per-token trunk
(projections, MLP, norms) runs at the wave's token count whatever its
split between phases.  Attention is the only op that needs row
structure: the flat queries are re-packed per row into ``[B, chunk]`` and
handed to the ragged paged-attention kernel (``ops/ragged_attention.py``),
whose causal mask makes a decode row the ``q_count == 1`` case of a
prefill chunk.  The step's K/V are scattered into the pages BEFORE
attention, in place (the JAX step donated the cache for the same
effect), so the kernel is a pure page read.

``t_budget``, ``chunk``, ``max_slots`` and ``width`` are fixed when the
step is made, and the step reads nothing back to the host (no
``.item()``, ``.cpu()`` or ``.tolist()``): every shape is the same from
one call to the next, the property a later CUDA-graph capture needs.
"""

from __future__ import annotations

from typing import Union

import torch

from ...models.configs import ModelConfig
from ...models.llama import (
    _layer_weights,
    _logits,
    _mlp,
    _proj,
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from ...ops.paged_attention import PagedKVCache
from ...ops.ragged_attention import ragged_paged_attention
from ..sampling import SAMPLE_TOP_K, sample

__all__ = ["make_mixed_step"]


def make_mixed_step(
    config: ModelConfig,
    *,
    max_slots: int,
    t_budget: int,
    chunk: int,
    spec_width: int = 1,
    sample_top_k: int = SAMPLE_TOP_K,
    device: Union[str, torch.device],
):
    """Make the mixed step for ``config``.  The returned function::

        step(params, paged, ids, rows, pos, valid, in_row,
             q_start, q_count, kv_len, latest, from_prev,
             sample_start, spec_len, rng, temp, top_p)
        -> (paged, toks [B, W], accept [B], latest_out [B], rng)

    takes the JAX step's 17 inputs and returns its 5 outputs.  Flat
    inputs (length ``t_budget``): ``ids`` token ids, ``rows`` the owning
    slot per token, ``pos`` absolute positions, ``valid`` live mask
    (padding tokens write to the trash page), ``in_row`` each token's
    index within its row's chunk, ``from_prev`` tokens whose id is the
    PREVIOUS step's on-device sample for that slot (the step substitutes
    its carried ``latest`` buffer).  Per-slot inputs (length
    ``max_slots``): ``q_start``, ``q_count`` (0 = not scheduled),
    ``kv_len`` (the pages' valid length after this step's writes assuming
    every draft is accepted), ``sample_start``, ``spec_len``, ``temp``,
    ``top_p``.  ``rng`` is a ``torch.Generator`` on the step's device.

    ``W = spec_width`` positions are sampled per slot from
    ``sample_start``; ``accept[b]`` is the longest draft prefix the
    samples confirm, and the returned cache's lengths are corrected to
    ``kv_len - (spec_len - accept)``.  ``latest_out[b]`` is each slot's
    freshest accepted sample (passthrough when the slot sat out).  The
    page tensors of ``paged`` are written in place and shared with the
    returned cache.
    """
    if max_slots > t_budget:
        raise ValueError(f"max_slots={max_slots} > t_budget={t_budget}")
    device = torch.device(device)
    width = max(1, int(spec_width))
    inv_freq = rope_frequencies(config, device)
    chunk_steps = torch.arange(chunk, device=device)
    width_steps = torch.arange(width, device=device)
    draft_steps = torch.arange(width - 1, device=device)
    eps = config.rms_norm_eps
    qh, kvh, hd = config.num_heads, config.num_kv_heads, config.head_dim

    def step(params, paged, ids, rows, pos, valid, in_row,
             q_start, q_count, kv_len, latest, from_prev,
             sample_start, spec_len, rng, temp, top_p):
        page_size = paged.page_size
        rows_i = rows.long()
        pos_i = pos.long()
        # decode-ahead chaining: a token flagged from_prev takes its id
        # from the carried per-slot latest-sample buffer
        eff_ids = torch.where(from_prev, latest[rows_i], ids)
        x = params["embed"][eff_ids.long()][None]  # [1, T, H]
        positions = pos[None]  # [1, T]
        # flat -> per-row packing indices for the attention re-pack
        pack_idx = (q_start.long()[:, None] + chunk_steps[None, :]).clamp(
            0, t_budget - 1
        )  # [B, chunk]
        # per-token page/slot targets (invalid tokens -> trash page 0)
        page_ids = torch.where(
            valid, paged.page_table[rows_i, pos_i // page_size].long(), 0
        )
        page_slots = torch.where(valid, pos_i % page_size, 0)
        gather_rows = rows_i
        gather_in_row = in_row.long()
        token_live = valid[:, None, None]

        for index in range(config.num_layers):
            weights = _layer_weights(params["layers"], index)
            attn_in = rms_norm(x, weights["ln_attn"], eps)
            q = _proj(attn_in, weights, "wq").reshape(1, t_budget, qh, hd)
            k = _proj(attn_in, weights, "wk").reshape(1, t_budget, kvh, hd)
            v = _proj(attn_in, weights, "wv").reshape(1, t_budget, kvh, hd)
            q = apply_rope(q, positions, inv_freq)
            k = apply_rope(k, positions, inv_freq)
            # scatter this step's K/V into the pages FIRST — the ragged
            # kernel then reads a cache that already holds every token a
            # causal query may attend to (its own included)
            k_pages = paged.k_pages[index]
            v_pages = paged.v_pages[index]
            k_pages[page_ids, page_slots] = k[0].to(k_pages.dtype)
            v_pages[page_ids, page_slots] = v[0].to(v_pages.dtype)
            q_pack = q[0][pack_idx].to(k_pages.dtype)  # [B, chunk, QH, D]
            attn_pack = ragged_paged_attention(
                q_pack, k_pages, v_pages, paged.page_table, kv_len, q_count,
                sliding_window=config.sliding_window,
            )
            # back to flat [T, QH, D]; padding tokens read rows the kernel
            # leaves unwritten, so they are zeroed to keep them finite
            attn = attn_pack[gather_rows, gather_in_row]
            attn = torch.where(token_live, attn, torch.zeros_like(attn))
            x = x + _proj(attn.to(x.dtype).reshape(1, t_budget, -1), weights, "wo")
            x = _mlp(x, weights, eps)

        # only each slot's sampled positions need logit rows: gather them
        # before the final norm and the head matmul ([B * W] rows, not [T])
        samp_idx = (sample_start.long()[:, None] + width_steps[None]).clamp(
            0, t_budget - 1
        )  # [B, W]
        logits = _logits(params, config, x[0][samp_idx])  # [B, W, V]
        flat_toks = sample(
            logits.reshape(max_slots * width, -1), rng,
            temp.repeat_interleave(width), top_p.repeat_interleave(width),
            sample_top_k,
        )
        toks = flat_toks.reshape(max_slots, width)
        if width > 1:
            # longest matching draft prefix: draft j (flat position
            # sample_start + 1 + j) is confirmed iff the sample at the
            # position before it predicted exactly it, and every earlier
            # draft was confirmed (cumprod)
            draft_idx = (
                sample_start.long()[:, None] + 1 + draft_steps[None]
            ).clamp(0, t_budget - 1)  # [B, W-1]
            drafts = eff_ids[draft_idx]
            confirmed = (toks[:, : width - 1] == drafts) & (
                draft_steps[None] < spec_len[:, None]
            )
            accept = torch.cumprod(confirmed.to(torch.int32), dim=1).sum(dim=1)
            accept = accept.to(torch.int32)
        else:
            accept = torch.zeros((max_slots,), dtype=torch.int32, device=device)
        # rejected drafts wrote KV the row must never read again: shrink
        # the committed lengths (spec_len - accept positions)
        new_lengths = (kv_len - (spec_len - accept)).to(torch.int32)
        fresh = torch.gather(
            toks, 1, accept.clamp(0, width - 1).long()[:, None]
        )[:, 0]
        latest_out = torch.where(q_count > 0, fresh, latest)
        new_paged = PagedKVCache(
            k_pages=paged.k_pages, v_pages=paged.v_pages,
            page_table=paged.page_table, lengths=new_lengths,
        )
        return new_paged, toks, accept, latest_out, rng

    return step
