"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on first use into its own
shared library with a plain C interface and loaded with ``ctypes``
(pointers travel as ``c_void_p``, the stream as PyTorch's current
``cuda_stream``).  The sources include no PyTorch header, so a build takes
seconds.  Libraries land in ``build/operator_tpu_torch/`` at the root of
the checkout (``OPERATOR_TPU_TORCH_BUILD_DIR`` overrides it), named by a
hash of the ``.cu`` file and every header beside it, so an edited source
rebuilds and an unchanged one loads from disk.  A failed build raises with
``nvcc``'s stderr.  An entry point may move the directory once, before
any library is loaded (:func:`set_build_dir`, through
``utils/platform.py``).  Every ``nvcc`` run is reported to
``utils/compilewatch.py``.

Each kernel module counts its launches with a :class:`LaunchCounter`,
read and set as the module's ``launches`` (:class:`KernelModule`).

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
import time
import types
from pathlib import Path
from typing import Iterable, Optional

__all__ = [
    "KernelModule", "LaunchCounter", "build_all", "build_dir", "library_path",
    "load_library", "set_build_dir", "source_names", "sources_digest",
    "ticket_counters",
]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_dir_override: Optional[Path] = None


def set_build_dir(path: "str | os.PathLike") -> None:
    """Build and load libraries under ``path`` for the rest of the
    process.  Only before the first library is loaded: the process's
    kernels come from one directory."""
    global _dir_override
    with _lock:
        if _loaded and Path(path) != build_dir():
            raise RuntimeError(
                f"the kernel build directory is {build_dir()} and libraries "
                f"are loaded from it; set it before the first kernel runs"
            )
        _dir_override = Path(path)


def build_dir() -> Path:
    if _dir_override is not None:
        return _dir_override
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


def sources_digest() -> str:
    """One digest over every kernel library's name (each named by the hash
    of its sources and the flags): what the AOT cache's fingerprint keys
    on."""
    names = " ".join(library_path(name).name for name in source_names())
    return hashlib.sha256(names.encode()).hexdigest()[:16]


def _start_build(name: str) -> Optional[tuple[subprocess.Popen, Path, Path, float]]:
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
    return proc, Path(tmp), target, time.monotonic()


def _finish_build(
    name: str, proc: subprocess.Popen, tmp: Path, target: Path, started: float
) -> None:
    from ..utils import compilewatch

    _, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{stderr}"
        )
    os.replace(tmp, target)
    compilewatch.record(f"nvcc:{name}", time.monotonic() - started, started)


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
            for name, proc, tmp, target, t0 in started:
                try:
                    _finish_build(name, proc, tmp, target, t0)
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
#: may share it; launches that may overlap (other streams) never do.  A
#: captured CUDA graph keeps the address it was captured with, so a buffer
#: that is outgrown is retired, never freed.
_counters: dict = {}
_retired: list = []


def ticket_counters(device, stream: int, n: int):
    """At least ``n`` int32 zeros on ``device`` for launches on ``stream``,
    allocated once and reused."""
    import torch

    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


class LaunchCounter:
    """One kernel's launches since its count was last set.

    The kernel's wrapper calls :meth:`launched` where it launches the
    kernel, and nowhere else.  Run eagerly, that adds one on the host.
    Under CUDA-graph capture (``serving/graphs.py``) nothing launches
    until the graph replays, so the add is a device op captured beside the
    launch: every replay adds one to a counter on the card.  :meth:`value`
    reads both (synchronising the device); a count read from the device
    counts the replays that ran, whichever thread replayed them."""

    def __init__(self) -> None:
        self.host = 0
        #: device -> int64 [1], made at the kernel's first eager launch
        #: there (a capture always follows an eager call of its function)
        self._device: dict = {}

    def launched(self, device) -> None:
        import torch

        counter = self._device.get(device)
        if torch.cuda.is_current_stream_capturing():
            if counter is None:
                raise RuntimeError(
                    "a kernel captured into a CUDA graph before its first eager "
                    "launch on the device: no device counter to count its replays"
                )
            counter.add_(1)
            return
        self.host += 1
        if counter is None:
            self._device[device] = torch.zeros(1, dtype=torch.int64, device=device)

    def value(self) -> int:
        import torch

        total = self.host
        for device, counter in list(self._device.items()):
            torch.cuda.synchronize(device)
            total += int(counter.item())
        return total

    def set(self, n: int) -> None:
        import torch

        self.host = int(n)
        for device, counter in list(self._device.items()):
            torch.cuda.synchronize(device)
            counter.zero_()
            torch.cuda.synchronize(device)


class KernelModule(types.ModuleType):
    """The type of a kernel module (``ops/ragged_attention.py`` and the
    others set it on themselves): its ``launches`` reads and sets the
    module's :class:`LaunchCounter`, ``_launch_counter``, so callers keep
    reading and zeroing one integer."""

    @property
    def launches(self) -> int:
        return self._launch_counter.value()

    @launches.setter
    def launches(self, n: int) -> None:
        self._launch_counter.set(n)
