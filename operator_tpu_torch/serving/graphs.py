"""Serving programs as captured CUDA graphs: capture once per key, replay.

The JAX package runs each serving program as one compiled executable per
shape (``jax.jit``, behind ``serving/aotcache.py:_aot_wrap``).  The port's
counterpart is a :class:`GraphProgram`: on the card, the first call at a
key runs the function eagerly (that call's own result, its launches
counted once) and then captures it into a ``torch.cuda.CUDAGraph``, with
Python's automatic collection off meanwhile (a collected cycle's graphs
would be destroyed inside the capture, which CUDA forbids); every
later call at the key copies its inputs into the graph's static buffers
and replays.  On the CPU (the tests' path) programs run eagerly, and the
same registry records each key's first use, so the warmup grid's coverage
and the compile watch are testable there.

A call's arguments are flattened (tuples, lists, dicts, dataclasses such
as ``PagedKVCache``) into leaves.  The key of an entry is the caller's key
(JAX's, e.g. ``(n_pad, t_pad, guided)`` for a prefill bucket) together
with the leaves' signature (shapes, dtypes, which arguments are None), so
a LoRA stack or a guided table of a new shape is a new graph under the
same key.  Two kinds of tensor leaf:

- **fixed** (``fixed_args``, and the dataclass fields in
  ``fixed_fields``: the weights, the KV page pools, the adapter stack,
  the guided tables): read in place, by address.  A call whose fixed leaf
  moved re-captures the entry (counted).
- **inputs** (everything else): cloned into static buffers at capture;
  each replay copies the caller's tensor in, unless it already is the
  static buffer.

Outputs that alias an input come back as that static buffer or fixed
tensor.  Every other output is copied, inside the graph, into a buffer
allocated outside the graph pool, so one memory pool can serve every
graph of an engine (they never run at once) without a later capture
reusing the memory a live output sits in.  The next replay of the same
graph overwrites its outputs: a caller that keeps one across replays
reads it through a stream-ordered copy (the sampled ids' device-to-host
copies) or hands it back as the next call's input.

A ``torch.Generator`` argument (or one named in ``generators``) is
registered with each graph and advances its offset on each replay
(``CUDAGraph.register_generator_state``), so sampled draws differ
between replays.  A kernel's wrapper counts its launch where it launches
it: under capture that count is a device add captured beside the launch
(``ops/_build.py:LaunchCounter``), so every replay counts its launches on
the card.  A capture or replay error raises, naming the program; there is
no eager fallback on the card: a serving mesh whose collectives no graph
can capture (gloo's) runs its programs eagerly by an explicit mode
(``GraphSet(eager=reason)``), logged and stated in ``stats()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import logging
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Optional

import torch

from ..utils import compilewatch

log = logging.getLogger(__name__)

__all__ = ["GraphProgram", "GraphSet"]

#: only one capture at a time in the process (captures of different
#: engines and the encoder may come from different threads)
_capture_lock = threading.Lock()

_SCALARS = (int, float, bool, str, torch.dtype, torch.device, torch.Generator)


@contextlib.contextmanager
def _no_collection():
    """Python's automatic collection off while a graph is captured.
    ``torch.cuda.graph`` collects once before the capture begins; a cycle
    that becomes garbage later (an engine closed on another thread, its
    graphs inside) and is collected by an allocation in the capturing
    thread would destroy its graphs there, a call CUDA forbids during a
    capture, which invalidates it."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


# -- flattening -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Node:
    kind: str  # "leaf", "seq", "dict", "dc"
    meta: Any = None
    children: tuple = ()


_LEAF = _Node("leaf")


def _flatten(
    obj: Any, leaves: list, fixed: list, is_fixed: bool, fixed_fields: frozenset
) -> _Node:
    if obj is None or isinstance(obj, (torch.Tensor, *_SCALARS)):
        leaves.append(obj)
        fixed.append(is_fixed)
        return _LEAF
    if isinstance(obj, (tuple, list)):
        return _Node("seq", type(obj), tuple(
            _flatten(v, leaves, fixed, is_fixed, fixed_fields) for v in obj
        ))
    if isinstance(obj, dict):
        keys = tuple(obj)
        return _Node("dict", keys, tuple(
            _flatten(obj[k], leaves, fixed, is_fixed, fixed_fields) for k in keys
        ))
    if dataclasses.is_dataclass(obj):
        names = tuple(f.name for f in dataclasses.fields(obj))
        return _Node("dc", (type(obj), names), tuple(
            _flatten(getattr(obj, n), leaves, fixed, is_fixed or n in fixed_fields, fixed_fields)
            for n in names
        ))
    raise TypeError(f"a graph program cannot take {type(obj).__name__}")


def _unflatten(node: _Node, leaves: Iterable) -> Any:
    it = iter(leaves)

    def build(n: _Node) -> Any:
        if n.kind == "leaf":
            return next(it)
        values = [build(c) for c in n.children]
        if n.kind == "seq":
            return list(values) if n.meta is list else tuple(values)
        if n.kind == "dict":
            return dict(zip(n.meta, values))
        cls, names = n.meta
        return cls(**dict(zip(names, values)))

    return build(node)


def _leaf_sig(leaf: Any) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return ("T", tuple(leaf.shape), tuple(leaf.stride()), str(leaf.dtype))
    if leaf is None:
        return ("N",)
    if isinstance(leaf, torch.Generator):
        return ("G",)
    return ("S", leaf)


def _describe(leaves: list, fixed: list) -> list:
    """Shapes and dtypes of the static inputs (the AOT cache's record)."""
    return [
        (tuple(leaf.shape), str(leaf.dtype))
        for leaf, f in zip(leaves, fixed)
        if isinstance(leaf, torch.Tensor) and not f
    ]


# -- the program ----------------------------------------------------------


class _Entry:
    """One captured graph (``graph`` None: a key seen on the CPU)."""

    __slots__ = ("graph", "static", "fixed", "outputs")

    def __init__(self, graph=None, static=(), fixed=(), outputs=None):
        self.graph = graph
        self.static = static
        self.fixed = fixed
        self.outputs = outputs


class _Moved(Exception):
    """A fixed leaf is not where the graph was captured with it."""


class GraphProgram:
    """One serving program: eager on the CPU, a CUDA graph per key on the
    card (see module doc).  Built by :meth:`GraphSet.program`."""

    def __init__(
        self, name: str, fn: Callable, graphs: "GraphSet", *,
        fixed_args: Iterable[int] = (), fixed_fields: Iterable[str] = (),
        generators: Iterable[torch.Generator] = (), cached: Any = None,
    ) -> None:
        self.name = name
        # a bound method is held weakly: its owner holds this program, and
        # a cycle would keep the owner's weights and the graphs' pool alive
        # past the owner's last reference
        self._fn = weakref.WeakMethod(fn) if inspect.ismethod(fn) else (lambda: fn)
        self.graphs = graphs
        self.fixed_args = frozenset(fixed_args)
        self.fixed_fields = frozenset(fixed_fields)
        #: generators ``fn`` draws from without taking them as arguments
        #: (argument generators are found among the leaves)
        self.generators = tuple(generators)
        #: ``aotcache.CachedProgram`` or None
        self.cached = cached
        self._entries: dict = {}

    @property
    def fn(self) -> Callable:
        return self._fn()

    def keys(self) -> set:
        """The caller keys this program has been captured (or, on the CPU,
        first used) at."""
        return {key for key, _sig in self._entries}

    def __call__(self, *args: Any, key: Any = None, variant: Any = None) -> Any:
        leaves: list = []
        fixed: list = []
        spec = _Node("seq", tuple, tuple(
            _flatten(a, leaves, fixed, i in self.fixed_args, self.fixed_fields)
            for i, a in enumerate(args)
        ))
        sig = tuple(_leaf_sig(leaf) for leaf in leaves) + (variant,)
        user_key = sig if key is None else key
        entry = self._entries.get((user_key, sig))
        if entry is not None:
            if entry.graph is None:
                return self.fn(*args)
            try:
                return self._replay(entry, leaves)
            except _Moved:
                log.warning(
                    "graph %s %r: a fixed input moved; capturing again",
                    self.name, user_key,
                )
                del self._entries[(user_key, sig)]
        return self._first_use(user_key, sig, args, leaves, fixed, spec)

    # -- first use --------------------------------------------------------

    def _first_use(self, key, sig, args, leaves, fixed, spec) -> Any:
        started = time.monotonic()
        if self.cached is not None:
            self.cached.lookup(key)
        # the first call's own result, eager: every kernel is loaded and
        # every library handle made before the capture, and nothing runs twice
        out = self.fn(*args)
        if self.graphs.device.type == "cuda" and self.graphs.eager is None:
            entry = self._capture(key, leaves, fixed, spec, out)
        else:
            entry = _Entry()
        self._entries[(key, sig)] = entry
        seconds = time.monotonic() - started
        self.graphs._note_capture(self.name, key, seconds, started)
        if self.cached is not None:
            self.cached.captured(key, _describe(leaves, fixed), seconds)
        return out

    def _capture(self, key, leaves, fixed, spec, out) -> _Entry:
        graphs = self.graphs
        static = [
            leaf.clone() if isinstance(leaf, torch.Tensor) and not f else leaf
            for leaf, f in zip(leaves, fixed)
        ]
        static_args = _unflatten(spec, static)
        eager_leaves: list = []
        _flatten(out, eager_leaves, [], False, frozenset())
        in_ptrs = {leaf.data_ptr() for leaf in leaves if isinstance(leaf, torch.Tensor)}
        # outputs land in buffers outside the graph pool (see module doc)
        persist = [
            torch.empty_like(leaf)
            if isinstance(leaf, torch.Tensor) and leaf.data_ptr() not in in_ptrs
            else None
            for leaf in eager_leaves
        ]
        by_ptr = {
            (leaf.data_ptr(), tuple(leaf.shape)): leaf
            for leaf in static if isinstance(leaf, torch.Tensor)
        }
        graph = torch.cuda.CUDAGraph()
        gens = [leaf for leaf in leaves if isinstance(leaf, torch.Generator)]
        for gen in {id(g): g for g in [*gens, *self.generators]}.values():
            graph.register_generator_state(gen)
        with _capture_lock, _no_collection():
            try:
                with torch.cuda.graph(
                    graph, pool=graphs.pool(), stream=graphs.stream(),
                    capture_error_mode="thread_local",
                ):
                    captured = self.fn(*static_args)
                    cap_leaves: list = []
                    out_spec = _flatten(captured, cap_leaves, [], False, frozenset())
                    if len(cap_leaves) != len(persist):
                        raise RuntimeError("the captured call returned another structure")
                    returned = []
                    for leaf, buf in zip(cap_leaves, persist):
                        if not isinstance(leaf, torch.Tensor):
                            returned.append(leaf)
                            continue
                        alias = by_ptr.get((leaf.data_ptr(), tuple(leaf.shape)))
                        if alias is not None:
                            returned.append(alias)
                        elif buf is not None:
                            buf.copy_(leaf)
                            returned.append(buf)
                        else:
                            raise RuntimeError(
                                "an output aliased an input eagerly but not under capture"
                            )
            except Exception as exc:
                raise RuntimeError(
                    f"CUDA-graph capture of {self.name} {key!r} failed: {exc}"
                ) from exc
        return _Entry(
            graph=graph, static=static, fixed=fixed,
            outputs=_unflatten(out_spec, returned),
        )

    # -- replay -------------------------------------------------------------

    def _replay(self, entry: _Entry, leaves: list) -> Any:
        for leaf, static, f in zip(leaves, entry.static, entry.fixed):
            if not isinstance(leaf, torch.Tensor):
                continue
            if leaf.data_ptr() == static.data_ptr():
                continue
            if f:
                raise _Moved()
            static.copy_(leaf, non_blocking=True)
        try:
            entry.graph.replay()
        except Exception as exc:
            raise RuntimeError(f"CUDA-graph replay of {self.name} failed: {exc}") from exc
        self.graphs.replays += 1
        return entry.outputs


class GraphSet:
    """The graph programs of one engine (or one encoder): one memory pool
    and one capture stream for all of them, and their counters."""

    def __init__(self, device: Any, eager: Optional[str] = None) -> None:
        self.device = torch.device(device)
        #: why the programs run eagerly on the card (a serving mesh whose
        #: collectives no graph can capture, such as gloo's), or None: an
        #: explicit mode, logged and stated in :meth:`stats`, never a
        #: fallback from a capture that failed (that raises)
        self.eager = eager
        if eager is not None and self.device.type == "cuda":
            log.warning("serving programs run eagerly on %s: %s", self.device, eager)
        #: by name, held weakly: the owner holds its programs
        self.programs: "weakref.WeakValueDictionary[str, GraphProgram]" = (
            weakref.WeakValueDictionary()
        )
        #: captures (on the CPU: first uses) and their seconds, replays
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        #: (program, key, seconds) of every capture, in order
        self.log: list[tuple[str, Any, float]] = []
        #: times :meth:`drop` let every graph go
        self.drops = 0
        self._pool = None
        self._stream = None

    def program(self, name: str, fn: Callable, **kwargs: Any) -> GraphProgram:
        program = GraphProgram(name, fn, self, **kwargs)
        self.programs[name] = program
        return program

    def drop(self) -> None:
        """Let every program's graphs go: each key is captured again at its
        next use, into a new pool.  A call still replaying an old graph
        holds it, its buffers and the memory it was captured with."""
        for program in list(self.programs.values()):
            program._entries = {}
        self._pool = None
        self.drops += 1

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _note_capture(self, name: str, key: Any, seconds: float, started: float) -> None:
        self.captures += 1
        self.capture_s += seconds
        self.log.append((name, key, seconds))
        compilewatch.record(f"{name}{key!r}", seconds, started)

    def pool_bytes(self) -> Optional[int]:
        """Bytes of device memory the shared graph pool holds (None off
        the card, or before any capture)."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        total = 0
        for segment in torch.cuda.memory_snapshot():
            if tuple(segment.get("segment_pool_id", ())) == pool:
                total += int(segment.get("total_size", 0))
        return total

    def stats(self) -> dict:
        return {
            "mode": "graphs" if self.eager is None else f"eager: {self.eager}",
            "captures": self.captures,
            "capture_s": round(self.capture_s, 3),
            "replays": self.replays,
            "drops": self.drops,
            "programs": {
                name: sorted(map(repr, p.keys())) for name, p in self.programs.items()
            },
        }
