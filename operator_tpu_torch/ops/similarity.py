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
:func:`launch_plan` picks the kernel's layout and cuts the windows into
shares from the shapes and the card's SM count alone.
"""

from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass

import torch

from . import _build
from ._build import ticket_counters

__all__ = [
    "LaunchPlan",
    "best_window_scores",
    "best_window_scores_cuda",
    "best_window_scores_reference",
    "launch_plan",
    "launches",
    "similarity_matrix",
    "top_k_windows",
]

#: ``launches``: kernel launches since the count was last set to 0 (``chip_smoke.py``
#: reads it to show the main path went through the kernel)
_launch_counter = _build.LaunchCounter()
sys.modules[__name__].__class__ = _build.KernelModule  # ``launches``

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's layouts (``csrc/similarity.cu``; checked against the
#: library's ``best_window_geometry`` when it is first bound): config ->
#: (patterns per block, window rows per tile).  Config 0 is the rows
#: layout (one warp a pattern, at most 8 windows); 1-4 tile 8-32 patterns
#: against 32 window rows; 5 tiles 64 patterns against 256, 6 (wide rows)
#: 32 against 128; 7 (rows wider than 4 KB) is config 6 with the pattern
#: rows streamed through the ring instead of resident.
CONFIGS = ((8, 8), (8, 32), (16, 32), (24, 32), (32, 32), (64, 256), (32, 128), (32, 128))
#: the rows layout stages all windows in 48 KB of shared memory
_ROWS_SMEM = 48 * 1024
#: a row of more bytes makes the large tile's resident patterns (config 5)
#: too large for one SM; config 6 then halves them
_WIDE_ROW = 2048
#: the widest row whose pattern tile stays resident (configs 1-6: 32 rows);
#: wider rows take the streaming layout, config 7
_MAX_ROW = 4096


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


@dataclass(frozen=True)
class LaunchPlan:
    """The kernel's layout (``config``, an index into :data:`CONFIGS`) and
    the windows cut into ``shares`` of ``share_w`` rows; the grid is
    ``p_tiles`` pattern tiles x ``shares``.  With more than one share the
    call needs [shares, P] partials and ``p_tiles`` counters."""

    config: int
    share_w: int
    shares: int
    p_tiles: int


def launch_plan(num_windows: int, num_patterns: int, dim: int, itemsize: int,
                sm_count: int) -> LaunchPlan:
    """The layout and the shares, from shapes and the SM count alone.

    At most 8 windows (incident recall: one query) take the rows layout,
    one warp a pattern, no shares: 2,048 patterns are 256 blocks.  Up to
    32 patterns take the smallest pattern tile that holds them (19 -> 24)
    and shares cut to give every SM at least one block: 4,096 windows are
    133 shares of 31.  More patterns take a large tile, and shares of whole
    window tiles keep the grid within one block per SM: 1,024 patterns are
    16 tiles x 8 shares of 512.  Rows wider than 4 KB take the streaming
    layout like a large library (1,536 f32 columns: 19 patterns are one
    tile x 32 shares of 128 windows).  Any D: the kernel pads rows to whole
    16-byte vectors with zeros."""
    vec = 16 // itemsize
    row_bytes = -(-dim // vec) * 16  # a row padded to whole 16-byte vectors
    if num_windows <= CONFIGS[0][1] and num_windows * row_bytes <= _ROWS_SMEM:
        return LaunchPlan(0, num_windows, 1, -(-num_patterns // CONFIGS[0][0]))
    if num_patterns <= CONFIGS[4][0] and dim * itemsize <= _MAX_ROW:
        config = -(-num_patterns // CONFIGS[1][0])
        p_tiles = 1
        share_w = max(1, num_windows // -(-sm_count // p_tiles))
    else:
        config = 5 if dim * itemsize <= _WIDE_ROW else 6 if dim * itemsize <= _MAX_ROW else 7
        tile_p, tile_w = CONFIGS[config]
        p_tiles = -(-num_patterns // tile_p)
        shares = max(1, sm_count // p_tiles)
        share_w = tile_w * -(-num_windows // (shares * tile_w))
    return LaunchPlan(config, share_w, -(-num_windows // share_w), p_tiles)


def _kernel_fn():
    from ._build import load_library

    lib = load_library("similarity")
    fn = lib.best_window_launch
    if fn.argtypes is None:
        _check_geometry(lib)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_geometry(lib) -> None:
    """Hold :data:`CONFIGS` against the library's own layouts: the plan
    and the scratch it sizes are the kernel's."""
    n = len(CONFIGS)
    tile_p, tile_w = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    count = lib.best_window_geometry(tile_p, tile_w)
    built = tuple(zip(tile_p, tile_w)) if count == n else f"{count} layouts"
    if built != CONFIGS:
        raise RuntimeError(
            f"similarity library layouts (patterns, window rows) {built} != the wrapper's {CONFIGS}"
        )


#: device index -> SM count, read once per device
_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    count = _sm_counts.get(device.index)
    if count is None:
        count = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = count
    return count


def best_window_scores_cuda(
    windows: torch.Tensor, patterns: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/similarity.cu`` on the current stream (no
    synchronisation): one kernel launch, whatever the plan.  Raises on
    anything the kernel does not take and on a non-zero launch status."""
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
    if dp != d or d == 0:
        raise ValueError(f"embedding dims must match and be at least 1, got {d} and {dp}")
    if w == 0 or p == 0:
        raise ValueError(f"need at least one window and one pattern, got W={w}, P={p}")

    device = windows.device
    plan = launch_plan(w, p, d, windows.element_size(), _sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    scores = torch.empty(p, dtype=torch.float32, device=device)
    best = torch.empty(p, dtype=torch.int32, device=device)
    part_scores = part_idx = counters = None
    if plan.shares > 1:  # the per-share partials the last block merges
        part_scores = torch.empty((plan.shares, p), dtype=torch.float32, device=device)
        part_idx = torch.empty((plan.shares, p), dtype=torch.int32, device=device)
        counters = ticket_counters(device, stream, plan.p_tiles)
    status = _kernel_fn()(
        windows.data_ptr(), patterns.data_ptr(), scores.data_ptr(), best.data_ptr(),
        None if part_scores is None else part_scores.data_ptr(),
        None if part_idx is None else part_idx.data_ptr(),
        None if counters is None else counters.data_ptr(),
        w, p, d, plan.config, plan.share_w, plan.shares, _DTYPE_CODES[windows.dtype], stream,
    )
    if status != 0:
        raise RuntimeError(f"best_window kernel launch failed: CUDA error {status}")
    _launch_counter.launched(device)
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
