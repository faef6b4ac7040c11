"""Attention ops of the port: the paged KV layout and its three kernels
(ragged mixed-phase, paged decode, flash prefill).

Modules here import no compiler and load no library at import time; a
kernel is built (``_build.py``) the first time a CUDA tensor reaches its
wrapper.
"""
