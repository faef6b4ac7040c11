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

On the card the dtype picks the kernel, by design: bf16 runs on the tensor
cores (``mma.sync``) with split-KV for the tile that holds the decode and
verify rows, f32 on the CUDA cores (TF32 would miss the f32 tolerance and
the card-vs-CPU greedy parity of the f32 engines).  :func:`launch_plan`
sizes the split from shapes alone, so the mixed step never syncs on
``kv_len``.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

__all__ = [
    "LaunchPlan",
    "launch_plan",
    "launches",
    "ragged_attention_cuda",
    "ragged_attention_reference",
    "ragged_paged_attention",
    "split_plan",
]

_NEG_INF = -1e30

#: ``launches``: kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the main path went through the kernel)
_launch_counter = _build.LaunchCounter()
sys.modules[__name__].__class__ = _build.KernelModule  # ``launches``

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

# the bf16 kernel's geometry (csrc/ragged_attention.cu; checked against the
# library's ragged_attention_tc_geometry when it is first bound)
TILE_ROWS = 64  # flash rows per tile
STAGE_KEYS = 64  # KV positions per shared-memory stage
SPLIT_KEYS = 256  # positions per split of tile 0, raised to keep <= MAX_SPLITS
MAX_SPLITS = 16


@dataclass(frozen=True)
class LaunchPlan:
    """How the bf16 kernel cuts tile 0's key span: ``n_splits`` spans of
    ``split_keys`` positions, each walked by its own block into f32
    scratch (``acc_shape``, ``ml_shape``) that a merge kernel combines.
    ``n_splits == 1``: no split, no scratch."""

    n_splits: int
    split_keys: int
    acc_shape: tuple = ()
    ml_shape: tuple = ()


def split_plan(max_seq: int) -> tuple[int, int]:
    """(n_splits, split_keys) for a key span of up to ``max_seq``
    positions: splits of ``SPLIT_KEYS``, more when that would need over
    ``MAX_SPLITS`` (the paged decode kernel cuts its rows by the same
    rule)."""
    split_keys = max(SPLIT_KEYS, STAGE_KEYS * -(-max_seq // (MAX_SPLITS * STAGE_KEYS)))
    return -(-max_seq // split_keys), split_keys


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor) -> LaunchPlan:
    """The kernel's split plan, from shapes and dtype only (never from
    ``kv_len``, which lives on the card).  Tile 0's longest possible span,
    ``pages_per_seq * page_size`` positions, is cut into splits of
    ``SPLIT_KEYS`` (more when that would need over ``MAX_SPLITS``); f32
    and spans of one split are not cut.  At tinyllama's serve shapes (B=32,
    KH=4, D=64, 32 pages of 64) that is 8 splits of 256 positions and
    17.3 MB of scratch."""
    b, _, _, d = q.shape
    page_size, kh = k_pages.shape[1], k_pages.shape[2]
    n_splits, split_keys = split_plan(page_table.shape[1] * page_size)
    if q.dtype != torch.bfloat16 or n_splits <= 1:
        return LaunchPlan(1, 0)
    return LaunchPlan(
        n_splits, split_keys,
        acc_shape=(b, kh, n_splits, TILE_ROWS, d),
        ml_shape=(b, kh, n_splits, TILE_ROWS, 2),
    )


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

    lib = load_library("ragged_attention")
    fn = lib.ragged_attention_launch
    if fn.argtypes is None:
        _check_geometry(lib)
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check_geometry(lib) -> None:
    """Hold :func:`launch_plan`'s copy of the kernel's geometry against the
    library's own: the scratch it sizes is what the kernel writes."""
    values = [ctypes.c_int() for _ in range(3)]
    lib.ragged_attention_tc_geometry(*(ctypes.byref(v) for v in values))
    built = tuple(v.value for v in values)
    if built != (TILE_ROWS, STAGE_KEYS, MAX_SPLITS):
        raise RuntimeError(
            f"ragged_attention library geometry (tile rows, stage keys, max splits) {built} "
            f"!= the wrapper's {(TILE_ROWS, STAGE_KEYS, MAX_SPLITS)}"
        )


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
    synchronisation): the tensor-core kernel for bf16 (and, when
    :func:`launch_plan` splits, its merge kernel; one launch counted), the
    CUDA-core kernel for f32.  Raises on anything the kernels do not take
    and on a non-zero launch status."""
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
    plan = launch_plan(q, k_pages, page_table)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if plan.n_splits > 1:
        part_acc = torch.empty(plan.acc_shape, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(plan.ml_shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel_fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), q_count.data_ptr(),
        out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        b, c, qh, kh, d, page_size, page_table.shape[1],
        int(sliding_window or 0), plan.n_splits, plan.split_keys,
        float(d ** -0.5), _DTYPE_CODES[q.dtype], stream,
    )
    if status != 0:
        raise RuntimeError(f"ragged_attention kernel launch failed: CUDA error {status}")
    _launch_counter.launched(q.device)
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
