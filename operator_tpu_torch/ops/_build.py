"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into its own
shared library with a plain C interface and loaded with ``ctypes``
(pointers travel as ``c_void_p``, the stream as PyTorch's current
``cuda_stream``).  The sources include no PyTorch header, so a build takes
seconds.  Libraries land in ``build/operator_tpu_torch/`` at the root of
the checkout (``OPERATOR_TPU_TORCH_BUILD_DIR`` overrides it), named by a
hash of the ``.cu`` file and every header beside it, so an edited source
rebuilds and an unchanged one loads from disk.  A failed build raises with
``nvcc``'s stderr.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["build_all", "library_path", "load_library", "source_names", "ticket_counters"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    override = os.environ.get("OPERATOR_TPU_TORCH_BUILD_DIR", "").strip()
    if override:
        return Path(override)
    return CSRC.parents[2] / "build" / "operator_tpu_torch"


def source_names() -> list[str]:
    """Every kernel source of the package, by stem."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        candidate = Path(root) / "bin" / "nvcc" if root else None
        if candidate is not None and candidate.is_file():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of operator_tpu_torch are built from source on first use"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (or will)."""
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    """Launch nvcc for one source unless its library is already built;
    the output goes to a temporary file renamed into place on success."""
    target = library_path(name)
    if target.is_file():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, Path(tmp), target


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path, target: Path) -> None:
    _, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{stderr}"
        )
    os.replace(tmp, target)


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Build every (or the named) kernel source, one ``nvcc`` per source,
    all started together."""
    names = list(names) if names is not None else source_names()
    with _lock:
        started = []
        try:
            for name in names:
                job = _start_build(name)
                if job is not None:
                    started.append((name, *job))
        finally:
            errors = []
            for name, proc, tmp, target in started:
                try:
                    _finish_build(name, proc, tmp, target)
                except RuntimeError as exc:
                    errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib


#: (device index, stream) -> int32 zeros: the merge tickets of the kernels
#: whose last block to finish merges the others' partials (paged decode,
#: similarity).  The merging block resets its counter, so the tensor stays
#: zero between launches, and launches on one stream run in order, so they
#: may share it; launches that may overlap (other streams) never do.
_counters: dict = {}


def ticket_counters(device, stream: int, n: int):
    """At least ``n`` int32 zeros on ``device`` for launches on ``stream``,
    allocated once and reused."""
    import torch

    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
