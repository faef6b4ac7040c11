"""Embedding-similarity scoring: log windows x pattern library.

Port of ``operator_tpu/ops/similarity.py``.  The semantic pattern path
embeds every log window and every pattern's anchor text, then scores
``windows @ patterns.T``; both sides are L2-normalised, so the dot product
is the cosine.  Incident recall uses the same call with one query row as
the only window and the stored incidents as the patterns.

Shapes::

    windows  [W, D]  float32 or bfloat16, L2-normalised rows
    patterns [P, D]  same dtype
    -> scores [P] float32, best_window [P] int32 (the FIRST window that
       reaches the pattern's best score)

:func:`best_window_scores` dispatches on where the tensors lie: CUDA
tensors launch the hand-written Hopper kernel (``csrc/similarity.cu``, the
port of the Pallas ``_best_window_kernel``), which keeps the ``[W, P]``
score matrix out of device memory; CPU tensors take
:func:`best_window_scores_reference`, the plain PyTorch version.  There is
no third branch and no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "best_window_scores",
    "best_window_scores_cuda",
    "best_window_scores_reference",
    "launches",
    "similarity_matrix",
    "top_k_windows",
]

#: kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the main path went through the kernel)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's tiling (``csrc/similarity.cu``): window rows per tile,
#: patterns per block
_TILE_W = 64
_TILE_P = 32


# ---------------------------------------------------------------------------
# plain PyTorch version (oracle + CPU path)
# ---------------------------------------------------------------------------


def similarity_matrix(windows: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """Dense ``[W, P]`` cosine-score matrix in float32 (inputs assumed
    normalised); bf16 inputs are widened exactly before the product."""
    return windows.to(torch.float32) @ patterns.to(torch.float32).T


def best_window_scores_reference(
    windows: torch.Tensor, patterns: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pattern best window: (scores [P] f32, indices [P] i32).
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``."""
    scores = similarity_matrix(windows, patterns)  # [W, P]
    return scores.amax(dim=0), torch.argmax(scores, dim=0).to(torch.int32)


def top_k_windows(
    windows: torch.Tensor, patterns: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k windows by best-pattern score (for prompt context selection):
    (scores [k] f32, window indices [k] i32), descending, ``k`` clamped to
    the window count."""
    per_window = similarity_matrix(windows, patterns).amax(dim=1)  # [W]
    scores, idx = torch.topk(per_window, min(k, per_window.shape[0]))
    return scores, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _kernel_fn():
    from ._build import load_library

    fn = load_library("similarity").best_window_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _shares(num_windows: int, num_patterns: int, sm_count: int) -> tuple[int, int]:
    """(window tiles per share, shares).  The windows are cut into shares
    so that the grid (pattern tiles x shares) is about two blocks per SM:
    W = 4,096 against 19 patterns gives 64 shares of one tile, against
    1,024 patterns 8 shares of 8 tiles; W = 1 one share."""
    w_tiles = -(-num_windows // _TILE_W)
    p_tiles = -(-num_patterns // _TILE_P)
    shares = max(1, min(w_tiles, (2 * sm_count) // p_tiles))
    tiles_per_share = -(-w_tiles // shares)
    return tiles_per_share, -(-w_tiles // tiles_per_share)


def best_window_scores_cuda(
    windows: torch.Tensor, patterns: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/similarity.cu`` on the current stream (no
    synchronisation).  Raises on anything the kernel does not take and on
    a non-zero launch status."""
    global launches

    for name, t in (("windows", windows), ("patterns", patterns)):
        if not t.is_cuda or t.device != windows.device:
            raise ValueError(f"{name} must be a CUDA tensor on {windows.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ValueError(f"{name} must be [rows, D], got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads 16 bytes at a time)")
    if windows.dtype not in _DTYPE_CODES:
        raise TypeError(f"windows must be bfloat16 or float32, got {windows.dtype}")
    if patterns.dtype != windows.dtype:
        raise TypeError(f"patterns must share the windows' dtype {windows.dtype}, got {patterns.dtype}")
    (w, d), (p, dp) = windows.shape, patterns.shape
    if dp != d or d % 8:
        raise ValueError(f"embedding dims must match and be a multiple of 8, got {d} and {dp}")
    if w == 0 or p == 0:
        raise ValueError(f"need at least one window and one pattern, got W={w}, P={p}")

    device = windows.device
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    tiles_per_share, shares = _shares(w, p, sm_count)
    scores = torch.empty(p, dtype=torch.float32, device=device)
    best = torch.empty(p, dtype=torch.int32, device=device)
    part_scores = part_idx = None
    if shares > 1:  # scratch for the per-share partials (pass 2 merges them)
        part_scores = torch.empty((shares, p), dtype=torch.float32, device=device)
        part_idx = torch.empty((shares, p), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    status = _kernel_fn()(
        windows.data_ptr(), patterns.data_ptr(), scores.data_ptr(), best.data_ptr(),
        None if part_scores is None else part_scores.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(),
        w, p, d, tiles_per_share, _DTYPE_CODES[windows.dtype], stream,
    )
    if status != 0:
        raise RuntimeError(f"best_window kernel launch failed: CUDA error {status}")
    launches += 1
    return scores, best


def best_window_scores(
    windows: torch.Tensor, patterns: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: the CUDA kernel when either tensor lies on a card (a mix
    of CPU and CUDA tensors raises there), the plain version for CPU
    tensors."""
    if windows.is_cuda or patterns.is_cuda:
        return best_window_scores_cuda(windows, patterns)
    return best_window_scores_reference(windows, patterns)
