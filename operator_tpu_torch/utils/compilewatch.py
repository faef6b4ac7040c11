"""Runtime compile observation: count and attribute every program build.

Counterpart of ``operator_tpu/utils/compilewatch.py``.  The JAX package
taps ``jax_log_compiles``; the port compiles two things, and both report
here as they finish: a CUDA-graph capture of a serving program
(``serving/graphs.py``: the program's name and key, on the CPU the first
use of a key) and an ``nvcc`` build of a kernel library
(``ops/_build.py``, named ``nvcc:<source>``).  A warm engine records none
after its warmup grid; a soak or a smoke run asserts
``count_since_mark() == 0`` after its warmup mark.

Usage::

    watcher = CompileWatcher()          # starts listening
    ... build + warm the engine ...
    watcher.mark()                      # warmup/steady-state boundary
    ... measured window ...
    watcher.events_since_mark()         # [(t_since_mark_s, name, s), ...]
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

__all__ = ["CompileWatcher", "record"]

_lock = threading.Lock()
_watchers: list["CompileWatcher"] = []


def record(name: str, seconds: Optional[float], started: Optional[float] = None) -> None:
    """Report one finished build or capture to every open watcher;
    ``started`` is its ``time.monotonic()`` start (default: now less
    ``seconds``)."""
    if started is None:
        started = time.monotonic() - (seconds or 0.0)
    with _lock:
        watchers = list(_watchers)
    for watcher in watchers:
        watcher._record(started, name, seconds)


class CompileWatcher:
    """Collect ``(timestamp, program, seconds)`` events while open.

    Thread-safe: captures happen on the engine's worker and the encoder's
    caller, builds on whichever thread first needs a kernel."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._mark: Optional[float] = None
        self._events: List[Tuple[float, str, Optional[float]]] = []
        with _lock:
            _watchers.append(self)

    def _record(self, t: float, name: str, seconds: Optional[float]) -> None:
        with self._lock:
            self._events.append((t, name, seconds))

    # -- query ------------------------------------------------------------
    def mark(self) -> None:
        """Set the warmup/steady-state boundary for events_since_mark()."""
        with self._lock:
            self._mark = time.monotonic()

    def events(self) -> List[Tuple[float, str, Optional[float]]]:
        with self._lock:
            return [(t - self._t0, n, d) for t, n, d in self._events]

    def events_since_mark(self) -> List[Tuple[float, str, Optional[float]]]:
        with self._lock:
            if self._mark is None:
                return [(t - self._t0, n, d) for t, n, d in self._events]
            return [
                (t - self._mark, n, d)
                for t, n, d in self._events
                if t >= self._mark
            ]

    def count_since_mark(self) -> int:
        return len(self.events_since_mark())

    def close(self) -> None:
        with _lock:
            if self in _watchers:
                _watchers.remove(self)
