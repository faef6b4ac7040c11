"""Multi-literal scanner of the literal prefilter (``patterns/prefilter.py``).

The port's counterpart of ``operator_tpu/native/__init__.py``: the
checkout's ``native/logscan.cpp`` (an Aho-Corasick automaton, one pass
over the text) is compiled by ``g++`` on first use into the kernels'
build directory (``ops/_build.py:build_dir``, ``build/operator_tpu_torch/``
by default), named by a hash of the source, and loaded with ``ctypes``.
Without a compiler, or when the build or the load fails, the scanner is
the pure-Python sweep (one ``bytes.find`` pass per literal), and that is
logged once, at INFO, as the JAX package logs it.  Both find the same
hits (the automaton in text order, the sweep literal by literal), so the
prefilter's candidates do not depend on which one ran;
:attr:`MultiPatternScanner.native` says which did.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["MultiPatternScanner", "library_path"]

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "logscan.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def library_path() -> Path:
    """Where the scanner built from ``native/logscan.cpp`` lives (or
    will): beside the kernels, named by a hash of the source and flags."""
    from ..ops import _build

    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return _build.build_dir() / f"liblogscan-{digest.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    """Compile the source unless its library is already built; returns
    the library's path, or None (no source, no compiler, a failed build),
    logged at INFO."""
    try:
        target = library_path()
        if target.is_file():
            return target
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, scratch = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *GXX_FLAGS, str(SOURCE), "-o", scratch],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(scratch, target)
        finally:
            if os.path.exists(scratch):
                os.unlink(scratch)
        return target
    except (OSError, subprocess.SubprocessError) as exc:
        log.info("native scanner build skipped: %s", exc)
        return None


def _load() -> Optional[ctypes.CDLL]:
    """The built library, once per process (None: the Python sweep)."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.ls_build.restype = ctypes.c_void_p
            lib.ls_build.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.ls_scan.restype = ctypes.c_int64
            lib.ls_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            lib.ls_free.restype = None
            lib.ls_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError as exc:
            log.warning("native scanner load failed (%s); using Python fallback", exc)
            _lib_failed = True
        return _lib


class _PyScanner:
    """The fallback: one ``bytes.find`` sweep per literal."""

    def __init__(self, literals: Sequence[bytes]) -> None:
        self.literals = list(literals)

    def scan_arrays(self, text: bytes, max_hits: int) -> tuple[np.ndarray, np.ndarray]:
        ids: list[int] = []
        offsets: list[int] = []
        for literal_id, literal in enumerate(self.literals):
            if not literal:
                continue
            start = text.find(literal)
            while start >= 0 and len(ids) < max_hits:
                ids.append(literal_id)
                offsets.append(start + len(literal) - 1)
                start = text.find(literal, start + 1)
        return np.asarray(ids, np.int32), np.asarray(offsets, np.int64)


class _NativeScanner:
    """The built automaton over one literal set (freed with the object)."""

    def __init__(self, lib: ctypes.CDLL, literals: Sequence[bytes]) -> None:
        self._lib = lib
        array = (ctypes.c_char_p * len(literals))(*literals)
        lens = (ctypes.c_int32 * len(literals))(*[len(lit) for lit in literals])
        self._handle = lib.ls_build(array, lens, len(literals))

    def scan_arrays(self, text: bytes, max_hits: int) -> tuple[np.ndarray, np.ndarray]:
        ids = np.empty(max_hits, np.int32)
        offsets = np.empty(max_hits, np.int64)
        count = self._lib.ls_scan(
            self._handle, text, len(text),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            max_hits,
        )
        return ids[:count].copy(), offsets[:count].copy()

    def __del__(self) -> None:  # pragma: no cover - interpreter shutdown ordering
        try:
            if self._handle:
                self._lib.ls_free(self._handle)
                self._handle = None
        except (AttributeError, TypeError):
            pass


class MultiPatternScanner:
    """Find all occurrences of N byte literals in a text.

    ``scan_arrays`` returns (literal ids [N] int32, end offsets [N] int64)
    of every hit, overlapping ones included: in text order from the
    automaton, literal by literal from the sweep; ``scan`` the same as
    pairs.  ``native`` is True when the built automaton scans."""

    def __init__(self, literals: Sequence[bytes]) -> None:
        self.literals = list(literals)
        lib = _load()
        self.native = lib is not None
        self._impl = _NativeScanner(lib, self.literals) if lib is not None else _PyScanner(
            self.literals
        )

    def scan_arrays(
        self, text: bytes, max_hits: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Never drops a hit: a full buffer retries with four times the
        room (a dropped hit would be a lost prefilter candidate)."""
        capacity = max_hits or max(4096, len(text) // 4)
        while True:
            ids, offsets = self._impl.scan_arrays(text, capacity)
            if len(ids) < capacity:
                return ids, offsets
            capacity *= 4

    def scan(self, text: bytes, max_hits: Optional[int] = None) -> list[tuple[int, int]]:
        ids, offsets = self.scan_arrays(text, max_hits)
        return [(int(i), int(o)) for i, o in zip(ids, offsets)]
