"""Paged KV cache: layout, token writes and the decode-attention oracle.

Port of ``operator_tpu/ops/paged_attention.py`` (``PagedKVCache``,
``write_tokens``, ``paged_attention_reference``).  KV lives in fixed-size
pages::

    k_pages, v_pages  [layers, num_pages, page_size, kv_heads, head_dim]
    page_table        [batch, pages_per_seq] int32  (page ids per sequence)
    lengths           [batch] int32                 (tokens currently held)

Page 0 is the trash page: padding tokens and released slots write there,
so a page granted to a live sequence is never touched by anyone else.
Unlike the JAX arrays, the page tensors are updated in place — that is
what ``donate_argnums`` bought the JAX step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

_NEG_INF = -1e30

__all__ = ["PagedKVCache", "paged_attention_reference", "write_tokens"]


@dataclass
class PagedKVCache:
    """Per-layer paged KV storage (layers stacked on axis 0)."""

    k_pages: torch.Tensor  # [layers, num_pages, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [batch, pages_per_seq] int32
    lengths: torch.Tensor  # [batch] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @classmethod
    def create(
        cls,
        num_layers: int,
        num_pages: int,
        page_size: int,
        kv_heads: int,
        head_dim: int,
        batch_size: int,
        pages_per_seq: int,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "PagedKVCache":
        shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.zeros(
                (batch_size, pages_per_seq), dtype=torch.int32, device=device
            ),
            lengths=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        )


def write_tokens(
    pages: torch.Tensor,  # [num_pages, page_size, KH, D] (single layer)
    page_table: torch.Tensor,  # [B, pages_per_seq]
    new: torch.Tensor,  # [B, T, KH, D] tokens to store
    start: torch.Tensor,  # [B] int32 position of new[:, 0]
    valid_len: Optional[torch.Tensor] = None,  # [B] tokens of new[] that are real
) -> torch.Tensor:
    """Scatter T new tokens per sequence into their pages, in place, and
    return ``pages``.  Rows past ``valid_len`` go to the trash page 0."""
    t = new.shape[1]
    page_size = pages.shape[1]
    steps = torch.arange(t, dtype=torch.int64, device=pages.device)
    positions = start.to(torch.int64)[:, None] + steps[None, :]  # [B, T]
    page_ids = torch.gather(page_table.to(torch.int64), 1, positions // page_size)
    slots = positions % page_size
    if valid_len is not None:
        valid = steps[None, :] < valid_len.to(torch.int64)[:, None]
        page_ids = torch.where(valid, page_ids, 0)
        slots = torch.where(valid, slots, 0)
    pages[page_ids, slots] = new.to(pages.dtype)
    return pages


def paged_attention_reference(
    q: torch.Tensor,  # [B, QH, D] current-token queries (RoPE applied)
    k_pages: torch.Tensor,  # [num_pages, page_size, KH, D] (single layer)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, pages_per_seq]
    lengths: torch.Tensor,  # [B] number of valid tokens (incl. current)
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Gather-then-attend decode oracle.  Returns [B, QH, D] in q.dtype."""
    b, qh, d = q.shape
    kh = k_pages.shape[2]
    g = qh // kh
    page_size = k_pages.shape[1]
    max_seq = page_table.shape[1] * page_size

    table = page_table.to(torch.int64)
    k = k_pages[table].reshape(b, max_seq, kh, d)
    v = v_pages[table].reshape(b, max_seq, kh, d)

    q_grouped = q.reshape(b, kh, g, d).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", q_grouped, k.to(torch.float32)) * (
        d ** -0.5
    )
    positions = torch.arange(max_seq, device=q.device)[None, :]
    lengths = lengths.to(torch.int64)
    valid = positions < lengths[:, None]
    if sliding_window is not None:
        valid = valid & (positions >= lengths[:, None] - sliding_window)
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return out.reshape(b, qh, d).to(q.dtype)
