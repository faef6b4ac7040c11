"""Flash prefill attention: self-attention over a right-padded prefill bucket.

Port of ``operator_tpu/ops/flash_prefill.py``.  The wave engine's prefill
bucket self-attends over its own right-padded tokens (q = kv, positions
``0..T``), with per-row validity ``pos < lengths[b]``, causality and the
optional sliding window ``kv_pos > q_pos - window``::

    q        [B, T, QH, D]
    k, v     [B, T, KH, D]
    lengths  [B] int32
    -> out   [B, T, QH * D] in q's dtype

:func:`flash_prefill_attention` dispatches on where the tensors lie: CUDA
tensors launch the hand-written Hopper kernel (``csrc/flash_prefill.cu``,
the port of the Pallas ``_flash_prefill_kernel``); CPU tensors take
:func:`flash_prefill_reference`, the plain PyTorch version.  There is no
fallback from the kernel to the plain version.  ``models/llama.py:forward``
takes this path only when :func:`flash_prefill_enabled` (off by default,
as in the JAX package) and :func:`flash_prefill_supported` say so.

On the card the dtype picks the kernel, by design: bf16 runs on the tensor
cores (``mma.sync``, 128-row tiles, K and V staged as bf16 by
``cp.async``), f32 on the CUDA cores (TF32 would miss the f32 tolerance
and the card-vs-CPU greedy parity of the f32 engines).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

__all__ = [
    "flash_prefill_attention",
    "flash_prefill_cuda",
    "flash_prefill_enabled",
    "flash_prefill_reference",
    "flash_prefill_supported",
    "launches",
]

_NEG_INF = -1e30

#: kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the wave path went through the kernel)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_prefill_enabled() -> bool:
    """``OPERATOR_TPU_FLASH_PREFILL=1`` turns flash prefill on (default
    off, the JAX package's gate)."""
    return os.environ.get("OPERATOR_TPU_FLASH_PREFILL", "0").strip() == "1"


def flash_prefill_supported(t: int, s: int, cache_offset) -> bool:
    """Self-attention prefill shapes only: the kv range is exactly the q
    range (a mini cache at offset 0, given as a Python int) and T divides
    into the TPU kernel's blocks — the JAX gate, kept so both packages
    take flash prefill on the same buckets."""
    if t != s or t < 2:
        return False
    if not isinstance(cache_offset, int) or cache_offset != 0:
        return False
    return t % min(128, t) == 0


# ---------------------------------------------------------------------------
# plain PyTorch version (oracle + CPU path)
# ---------------------------------------------------------------------------


def flash_prefill_reference(
    q: torch.Tensor,  # [B, T, QH, D]
    k: torch.Tensor,  # [B, T, KH, D]
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B]
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Dense oracle (the model's masked attention).  Returns
    [B, T, QH * D] in q.dtype."""
    b, t, qh, d = q.shape
    kh = k.shape[2]
    g = qh // kh
    positions = torch.arange(t, device=q.device)
    causal = positions[None, :] <= positions[:, None]  # [T, S]
    valid = positions[None, None, :] < lengths.to(torch.int64)[:, None, None]  # [B, 1, S]
    mask = causal[None] & valid
    if sliding_window is not None:
        mask = mask & (positions[None, :] > positions[:, None] - sliding_window)[None]
    q_grouped = q.reshape(b, t, kh, g, d).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", q_grouped, k.to(torch.float32)) * (
        d ** -0.5
    )
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, qh * d).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _kernel_fn():
    from ._build import load_library

    fn = load_library("flash_prefill").flash_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def flash_prefill_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``csrc/flash_prefill.cu`` on the current stream (no
    synchronisation): the tensor-core kernel for bf16, the CUDA-core
    kernel for f32.  Raises on anything the kernels do not take and on a
    non-zero launch status."""
    global launches

    tensors = {"q": q, "k": k, "v": v, "lengths": lengths}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must share q's dtype {q.dtype}, got {k.dtype}/{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"want q [B, T, QH, D] and k, v [B, T, KH, D], got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    b, t, qh, d = q.shape
    kb, kt, kh, dk = k.shape
    if (kb, kt, dk) != (b, t, d) or qh % kh != 0 or d not in _HEAD_DIMS:
        raise ValueError(
            f"unsupported shapes: q {tuple(q.shape)}, k {tuple(k.shape)}; "
            f"D must be one of {_HEAD_DIMS} and KH must divide QH"
        )
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B={b}], got {tuple(lengths.shape)}")
    for name in ("q", "k", "v"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads 16 bytes at a time)")
    out = torch.empty((b, t, qh * d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, qh, kh, d, int(sliding_window or 0), float(d ** -0.5),
        _DTYPE_CODES[q.dtype], stream,
    )
    if status != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {status}")
    launches += 1
    return out


def flash_prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.is_cuda:
        return flash_prefill_cuda(q, k, v, lengths, sliding_window=sliding_window)
    return flash_prefill_reference(q, k, v, lengths, sliding_window=sliding_window)
