"""Ragged mixed-phase paged attention: one kernel for prefill AND decode.

Port of ``operator_tpu/ops/ragged_attention.py``.  ONE call serves a wave
where every batch row sits at an arbitrary position — a decode row
contributes one query token, a prefill row its next chunk, a speculation
verify row its committed token plus ``k`` drafts — against the shared
paged KV cache (``ops/paged_attention.py`` layout).  KV is written to the
pages BEFORE attention runs, so the call is a pure read of the pages::

    q          [B, C, QH, D]  this step's query tokens, row-padded past
                              ``q_count[b]`` (padding rows are don't-care)
    k_pages    [num_pages, page_size, KH, D]  (single layer)
    v_pages    likewise
    page_table [B, pages_per_seq] int32
    kv_len     [B] int32  valid tokens in the row's pages INCLUDING this
                          step's writes
    q_count    [B] int32  live query rows this step (0 = inactive row)

Query token ``i`` of row ``b`` sits at absolute position
``kv_len[b] - q_count[b] + i`` and attends causally over positions
``<=`` its own (and, with a sliding window, ``> position - window``).

:func:`ragged_paged_attention` dispatches on where the tensors lie: CUDA
tensors launch the hand-written Hopper kernel (``csrc/ragged_attention.cu``,
the port of the Pallas ``_ragged_attn_kernel``); CPU tensors take
:func:`ragged_attention_reference`, the plain PyTorch version.  There is
no third branch and no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = [
    "launches",
    "ragged_attention_cuda",
    "ragged_attention_reference",
    "ragged_paged_attention",
]

_NEG_INF = -1e30

#: kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the main path went through the kernel)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


# ---------------------------------------------------------------------------
# plain PyTorch version (oracle + CPU path)
# ---------------------------------------------------------------------------


def ragged_attention_reference(
    q: torch.Tensor,  # [B, C, QH, D]
    k_pages: torch.Tensor,  # [num_pages, page_size, KH, D]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, pages_per_seq]
    kv_len: torch.Tensor,  # [B]
    q_count: torch.Tensor,  # [B]
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Gather-then-attend oracle.  Returns [B, C, QH, D] in q.dtype.
    Rows past ``q_count`` produce finite garbage; callers gather only the
    valid rows."""
    b, c, qh, d = q.shape
    kh = k_pages.shape[2]
    g = qh // kh
    page_size = k_pages.shape[1]
    max_seq = page_table.shape[1] * page_size

    table = page_table.to(torch.int64)
    k = k_pages[table].reshape(b, max_seq, kh, d)
    v = v_pages[table].reshape(b, max_seq, kh, d)

    q_grouped = q.reshape(b, c, kh, g, d).to(torch.float32)
    scores = torch.einsum("bckgd,bskd->bkgcs", q_grouped, k.to(torch.float32)) * (
        d ** -0.5
    )
    kv_len = kv_len.to(torch.int64)
    kv_pos = torch.arange(max_seq, device=q.device)[None, None, :]  # [1, 1, S]
    q_pos = (
        (kv_len - q_count.to(torch.int64))[:, None]
        + torch.arange(c, device=q.device)[None, :]
    )[:, :, None]  # [B, C, 1]
    mask = (kv_pos <= q_pos) & (kv_pos < kv_len[:, None, None])
    if sliding_window is not None:
        mask = mask & (kv_pos > q_pos - sliding_window)
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", probs, v)
    return out.reshape(b, c, qh, d).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _kernel_fn():
    from ._build import load_library

    fn = load_library("ragged_attention").ragged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def ragged_attention_cuda(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_len: torch.Tensor,
    q_count: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``csrc/ragged_attention.cu`` on the current stream (no
    synchronisation).  Raises on anything the kernel does not take and
    on a non-zero launch status."""
    global launches

    tensors = {
        "q": q, "k_pages": k_pages, "v_pages": v_pages,
        "page_table": page_table, "kv_len": kv_len, "q_count": q_count,
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
    for name in ("page_table", "kv_len", "q_count"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"want q [B, C, QH, D] and pages [P, page, KH, D], got "
            f"{tuple(q.shape)} / {tuple(k_pages.shape)} / {tuple(v_pages.shape)}"
        )
    b, c, qh, d = q.shape
    _, page_size, kh, dk = k_pages.shape
    if dk != d or qh % kh != 0 or d not in _HEAD_DIMS:
        raise ValueError(
            f"unsupported heads/dims: QH={qh} KH={kh} D={d} (pages D={dk}); "
            f"D must be one of {_HEAD_DIMS} and KH must divide QH"
        )
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B={b}, pages_per_seq], got {tuple(page_table.shape)}")
    if kv_len.shape != (b,) or q_count.shape != (b,):
        raise ValueError(f"kv_len and q_count must be [B={b}]")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads 16 bytes at a time)")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), q_count.data_ptr(),
        out.data_ptr(),
        b, c, qh, kh, d, page_size, page_table.shape[1],
        int(sliding_window or 0), float(d ** -0.5), _DTYPE_CODES[q.dtype],
        stream,
    )
    if status != 0:
        raise RuntimeError(f"ragged_attention kernel launch failed: CUDA error {status}")
    launches += 1
    return out


def ragged_paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    kv_len: torch.Tensor,
    q_count: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.is_cuda:
        return ragged_attention_cuda(
            q, k_pages, v_pages, page_table, kv_len, q_count,
            sliding_window=sliding_window,
        )
    return ragged_attention_reference(
        q, k_pages, v_pages, page_table, kv_len, q_count,
        sliding_window=sliding_window,
    )
