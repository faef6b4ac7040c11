"""The kernel build cache for the port's entry points.

Counterpart of ``operator_tpu/utils/platform.py``.  The JAX package points
XLA's persistent compilation cache at a directory
(:func:`enable_persistent_compilation_cache`) and pins ``jax`` to the CPU
on request (``pin_cpu_if_requested``).  What the port compiles is the
``nvcc`` libraries of ``ops/csrc``, so its persistent cache is the
directory those libraries are built into (``ops/_build.py:build_dir``).
Its device choice is ``utils/device.py:resolve_device`` (``cuda`` unless
the caller asks for the CPU, never a quiet fallback), so nothing here
takes the place of ``pin_cpu_if_requested``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

__all__ = ["enable_persistent_compilation_cache"]

log = logging.getLogger(__name__)


def enable_persistent_compilation_cache(path: str) -> Optional[str]:
    """Build and load the kernel libraries under ``path`` for the rest of
    the process, so a later process on the same path runs no ``nvcc``.
    An entry point calls it once, before any kernel is built; an explicit
    ``OPERATOR_TPU_TORCH_BUILD_DIR`` wins.  Returns the directory in use,
    or None when ``path`` is not writable (an optimisation never blocks
    startup)."""
    from ..ops import _build

    if os.environ.get("OPERATOR_TPU_TORCH_BUILD_DIR", "").strip():
        return str(_build.build_dir())
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as exc:
        log.warning("persistent kernel cache disabled: %s unusable (%s)", path, exc)
        return None
    _build.set_build_dir(path)
    return path
