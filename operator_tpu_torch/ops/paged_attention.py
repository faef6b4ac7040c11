"""Paged KV cache: layout, token writes and decode attention.

Port of ``operator_tpu/ops/paged_attention.py`` (``PagedKVCache``,
``write_tokens``, ``paged_attention_reference``, ``_kernel_version``,
``paged_attention``).  KV lives in fixed-size pages::

    k_pages, v_pages  [layers, num_pages, page_size, kv_heads, head_dim]
    page_table        [batch, pages_per_seq] int32  (page ids per sequence)
    lengths           [batch] int32                 (tokens currently held)

Page 0 is the trash page: padding tokens and released slots write there,
so a page granted to a live sequence is never touched by anyone else.
Unlike the JAX arrays, the page tensors are updated in place — that is
what ``donate_argnums`` bought the JAX step.

:func:`paged_attention` is the wave engine's decode attention.  CUDA
tensors launch the hand-written Hopper kernel (``csrc/paged_attention.cu``),
the port of BOTH Pallas decode kernels: ``OPERATOR_TPU_PAGED_KERNEL`` keeps
the JAX package's selector (``v1``, the default, or ``v2``; anything else
raises where the wave engine is built, ``serving/provider.py``), and both
values reach the one kernel, since the two TPU kernels compute one function
and differ only in how they move pages.  CPU tensors take
:func:`paged_attention_reference`, the plain PyTorch version.  There is no
fallback from the kernel to the plain version.

On the card the dtype picks the kernel, by design: bf16 runs on the tensor
cores (``mma.sync``) with split-KV, the splits merged in the same launch;
f32 on the CUDA cores, unsplit (TF32 would miss the f32 tolerance and the
card-vs-CPU greedy parity of the f32 engines).  :func:`launch_plan` sizes
the split from shapes alone, so a decode step never syncs on ``lengths``.
"""

from __future__ import annotations

import ctypes
import sys
import os
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import torch

from . import ragged_attention as _ragged
from . import _build
from ._build import ticket_counters

_NEG_INF = -1e30

__all__ = [
    "LaunchPlan",
    "PagedKVCache",
    "launch_plan",
    "launches",
    "paged_attention",
    "paged_attention_cuda",
    "paged_attention_reference",
    "write_tokens",
]

#: ``launches``: decode-kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the wave path went through the kernel)
_launch_counter = _build.LaunchCounter()
sys.modules[__name__].__class__ = _build.KernelModule  # ``launches``

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128)
#: query heads per KV head the kernels pack into one block; also the rows
#: of a split's partial (csrc/paged_attention.cu kSplitRows, checked against
#: the library's paged_attention_tc_geometry when it is first bound)
_MAX_GROUP = 8


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
    return ``pages``.  Rows past ``valid_len`` go to the trash page 0, and
    so do positions past the end of the page table, which the JAX scatter
    drops (a finished wave slot's decode-ahead junk can run past it)."""
    t = new.shape[1]
    page_size = pages.shape[1]
    steps = torch.arange(t, dtype=torch.int64, device=pages.device)
    positions = start.to(torch.int64)[:, None] + steps[None, :]  # [B, T]
    page_index = positions // page_size
    keep = page_index < page_table.shape[1]
    if valid_len is not None:
        keep = keep & (steps[None, :] < valid_len.to(torch.int64)[:, None])
    page_ids = torch.gather(
        page_table.to(torch.int64), 1, page_index.clamp(max=page_table.shape[1] - 1)
    )
    page_ids = torch.where(keep, page_ids, 0)
    slots = torch.where(keep, positions % page_size, 0)
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


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _kernel_version(environ: Optional[Mapping[str, str]] = None) -> str:
    """The decode-kernel selector, ``OPERATOR_TPU_PAGED_KERNEL``: ``v1``
    (default) or ``v2``.  Both reach ``csrc/paged_attention.cu``, so it is
    read once, where the wave engine is built; unknown values raise rather
    than silently benching the wrong kernel."""
    env = os.environ if environ is None else environ
    version = env.get("OPERATOR_TPU_PAGED_KERNEL", "v1").strip().lower()
    if version not in ("v1", "v2"):
        raise ValueError(
            f"OPERATOR_TPU_PAGED_KERNEL={version!r}: expected 'v1' or 'v2'"
        )
    return version


@dataclass(frozen=True)
class LaunchPlan:
    """How the bf16 kernel cuts each row's key span: ``n_splits`` spans of
    ``split_keys`` positions, each walked by its own block into f32
    scratch (``acc_shape``, ``ml_shape``) that the row's last block merges,
    with one int32 counter per (row, KV head) (``counters``).
    ``n_splits == 1``: no split, no scratch."""

    n_splits: int
    split_keys: int
    acc_shape: tuple = ()
    ml_shape: tuple = ()
    counters: int = 0


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor) -> LaunchPlan:
    """The kernel's split plan, from shapes and dtype only (never from
    ``lengths``, which lives on the card): the longest possible span,
    ``pages_per_seq * page_size`` positions, cut by K1's rule
    (:func:`ragged_attention.split_plan`); f32 and spans of one split are
    not cut.  At tinyllama's wave shapes (B=32, KH=4, D=64, 32 pages of
    64) that is 8 splits of 256 positions and 2.1 MB of scratch."""
    b, _, d = q.shape
    page_size, kh = k_pages.shape[1], k_pages.shape[2]
    n_splits, split_keys = _ragged.split_plan(page_table.shape[1] * page_size)
    if q.dtype != torch.bfloat16 or n_splits <= 1:
        return LaunchPlan(1, 0)
    return LaunchPlan(
        n_splits, split_keys,
        acc_shape=(b, kh, n_splits, _MAX_GROUP, d),
        ml_shape=(b, kh, n_splits, _MAX_GROUP, 2),
        counters=b * kh,
    )


def _kernel_fn():
    from ._build import load_library

    lib = load_library("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        _check_geometry(lib)
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_geometry(lib) -> None:
    """Hold :func:`launch_plan`'s copy of the kernel's geometry (partial
    rows a split, stage keys, most splits) against the library's own: the
    scratch it sizes is what the kernel writes."""
    values = [ctypes.c_int() for _ in range(3)]
    lib.paged_attention_tc_geometry(*(ctypes.byref(v) for v in values))
    built = tuple(v.value for v in values)
    want = (_MAX_GROUP, _ragged.STAGE_KEYS, _ragged.MAX_SPLITS)
    if built != want:
        raise RuntimeError(
            f"paged_attention library geometry (split rows, stage keys, max splits) {built} "
            f"!= the wrapper's {want}"
        )


def paged_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream (no
    synchronisation): the split tensor-core kernel for bf16, the CUDA-core
    kernel for f32.  Raises on anything the kernels do not take and on a
    non-zero launch status."""
    tensors = {
        "q": q, "k_pages": k_pages, "v_pages": v_pages,
        "page_table": page_table, "lengths": lengths,
    }
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"pages must share q's dtype {q.dtype}, got {k_pages.dtype}/{v_pages.dtype}"
        )
    for name in ("page_table", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"want q [B, QH, D] and pages [P, page, KH, D], got "
            f"{tuple(q.shape)} / {tuple(k_pages.shape)} / {tuple(v_pages.shape)}"
        )
    b, qh, d = q.shape
    _, page_size, kh, dk = k_pages.shape
    if dk != d or qh % kh != 0 or d not in _HEAD_DIMS or qh // kh > _MAX_GROUP:
        raise ValueError(
            f"unsupported heads/dims: QH={qh} KH={kh} D={d} (pages D={dk}); "
            f"D must be one of {_HEAD_DIMS}, KH must divide QH and "
            f"QH/KH be at most {_MAX_GROUP}"
        )
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B={b}, pages_per_seq], got {tuple(page_table.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B={b}], got {tuple(lengths.shape)}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads 16 bytes at a time)")
    plan = launch_plan(q, k_pages, page_table)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = counters = None
    if plan.n_splits > 1:
        part_acc = torch.empty(plan.acc_shape, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=q.device)
        counters = ticket_counters(q.device, stream, plan.counters)
    status = _kernel_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, qh, kh, d, page_size, page_table.shape[1], int(sliding_window or 0),
        plan.n_splits, plan.split_keys, float(d ** -0.5), _DTYPE_CODES[q.dtype], stream,
    )
    if status != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {status}")
    _launch_counter.launched(q.device)
    return out


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch: the CUDA decode kernel for CUDA tensors (either selector
    value), the plain version for CPU tensors."""
    if q.is_cuda:
        return paged_attention_cuda(
            q, k_pages, v_pages, page_table, lengths, sliding_window=sliding_window
        )
    return paged_attention_reference(
        q, k_pages, v_pages, page_table, lengths, sliding_window=sliding_window
    )
