"""Ops of the port: the paged KV layout and its three attention kernels
(ragged mixed-phase, paged decode, flash prefill), and the best-window
similarity of the semantic path.

Modules here import no compiler and load no library at import time; a
kernel is built (``_build.py``) the first time a CUDA tensor reaches its
wrapper.
"""

from .similarity import (
    best_window_scores,
    best_window_scores_reference,
    similarity_matrix,
    top_k_windows,
)

__all__ = [
    "best_window_scores",
    "best_window_scores_reference",
    "similarity_matrix",
    "top_k_windows",
]
