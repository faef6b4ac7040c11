"""Per-analysis distributed tracing — the span model and the tracer.

The port's copy of ``operator_tpu/obs/span.py`` (no JAX in it).

The aggregate stage percentiles in :mod:`..utils.timing` answer "is the
fleet fast?"; they cannot answer "where did THIS analysis's budget go?"
when one request blows its deadline or trips a breaker.  A :class:`Span`
is one timed region of one analysis (collect, parse, recall, the AI leg,
an engine generate, a kube call); a :class:`Trace` is the complete tree
for one analysis, identified by a W3C-shaped 16-byte trace id.

Propagation is **ambient** — the current span rides a ``contextvars``
context variable, exactly like the asyncio task context the pipeline
already runs in, so every stage, provider call, recall lookup and engine
request gets a span without a single new plumbing argument.  The context
flows through ``await`` and ``asyncio.to_thread`` (which copies the
context into the worker) for free; code running on executors that do NOT
copy context (the decode worker) is tied back in via span *tags* instead
(``SamplingParams.trace_tag``, which the overload ladder's decision log
keys on).

Thread-safety: spans from concurrent tasks/threads of one trace append
to the trace's shared state under a lock; span *identity* (ids, parents)
is immutable after creation.

W3C ``traceparent`` (``00-<trace>-<span>-01``) is the wire form: emitted
on the OpenAI-compatible provider path and accepted by both HTTP servers,
so a trace crosses process boundaries intact (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "annotate",
    "annotate_root",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "format_traceparent",
    "parse_traceparent",
    "span",
]

#: W3C trace-context header shape (version 00; future versions accepted
#: as long as the id fields parse)
_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})"
    r"-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})(?:-.*)?$"
)


def _new_trace_id() -> str:
    return uuid.uuid4().hex  # 16 random bytes = the W3C trace-id width


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a traceparent header, or None
    for anything malformed (all-zero ids are explicitly invalid per the
    spec — a buggy client must not join every request into one trace)."""
    if not header:
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if match is None:
        return None
    if match.group("version") == "ff":
        return None
    trace_id, span_id = match.group("trace_id"), match.group("span_id")
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


class _TraceState:
    """Shared mutable state of one in-flight trace: the finished-span
    list (appended from any task/thread under the lock) and the root
    span, reachable from every child via the ambient context."""

    __slots__ = ("trace_id", "root", "finished", "lock", "clock_ns")

    def __init__(self, trace_id: str, root: "Span", clock_ns: Callable[[], int]) -> None:
        self.trace_id = trace_id
        self.root = root
        self.finished: list["Span"] = []
        self.lock = threading.Lock()
        self.clock_ns = clock_ns

    def add(self, span_: "Span") -> None:
        with self.lock:
            self.finished.append(span_)


@dataclass
class Span:
    """One timed region of one trace.  ``start_ns``/``end_ns`` are on the
    tracer's monotonic clock — durations and in-trace ordering are exact;
    wall-clock anchoring lives on the enclosing trace record."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    attributes: dict = field(default_factory=dict)
    status: str = "ok"  # "ok" | "error"
    error: Optional[str] = None
    #: trace bookkeeping, never serialized
    _state: Optional[_TraceState] = field(default=None, repr=False, compare=False)

    @property
    def duration_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else self.start_ns
        return (end - self.start_ns) / 1e6

    def set(self, **attributes: Any) -> "Span":
        self.attributes.update(attributes)
        return self

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "name": self.name,
            "startNs": self.start_ns,
            "endNs": self.end_ns,
            "durationMs": round(self.duration_ms, 3),
            "status": self.status,
        }
        if self.parent_id:
            out["parentId"] = self.parent_id
        if self.attributes:
            out["attributes"] = dict(self.attributes)
        if self.error:
            out["error"] = self.error
        return out

    @classmethod
    def parse(cls, data: dict) -> "Span":
        return cls(
            trace_id=data.get("traceId", ""),
            span_id=data.get("spanId", ""),
            parent_id=data.get("parentId"),
            name=data.get("name", ""),
            start_ns=int(data.get("startNs", 0)),
            end_ns=(None if data.get("endNs") is None else int(data["endNs"])),
            attributes=dict(data.get("attributes") or {}),
            status=data.get("status", "ok"),
            error=data.get("error"),
        )


@dataclass
class Trace:
    """One completed analysis: the root span plus every finished child,
    sorted by start time."""

    trace_id: str
    name: str
    spans: list[Span] = field(default_factory=list)

    @property
    def root(self) -> Optional[Span]:
        for span_ in self.spans:
            if span_.parent_id is None:
                return span_
        return self.spans[0] if self.spans else None

    @property
    def duration_ms(self) -> float:
        root = self.root
        return root.duration_ms if root is not None else 0.0

    @property
    def status(self) -> str:
        root = self.root
        return root.status if root is not None else "ok"

    def children(self, span_id: str) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def to_dict(self) -> dict:
        return {
            "traceId": self.trace_id,
            "name": self.name,
            "durationMs": round(self.duration_ms, 3),
            "status": self.status,
            "spans": [s.to_dict() for s in self.spans],
        }

    @classmethod
    def parse(cls, data: dict) -> "Trace":
        return cls(
            trace_id=data.get("traceId", ""),
            name=data.get("name", ""),
            spans=[Span.parse(s) for s in (data.get("spans") or [])],
        )


def stage_durations(root: "Span") -> dict:
    """Finished DIRECT children of ``root`` as ``{name: duration_ms}`` —
    the stage split the SLO ledger journals per request (one source of
    truth: the same spans the flight recorder stores).  A repeated stage
    name keeps its last finish; an out-of-trace root returns ``{}``."""
    state = root._state
    if state is None:
        return {}
    with state.lock:
        spans = list(state.finished)
    return {
        s.name: round(s.duration_ms, 3)
        for s in spans
        if s.parent_id == root.span_id
    }


#: the ambient current span (None outside any trace).  One ContextVar for
#: the whole process: traces are distinguished by the span's _state, not
#: by the variable, so concurrent tasks each see their own chain.
_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "operator_tpu_obs_span", default=None
)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    span_ = _CURRENT.get()
    return span_.trace_id if span_ is not None and span_._state is not None else None


def current_traceparent() -> Optional[str]:
    """The outbound W3C header for the ambient span (None outside a
    trace) — what the OpenAI-compat provider stamps on its HTTP calls."""
    span_ = _CURRENT.get()
    if span_ is None or span_._state is None:
        return None
    return format_traceparent(span_.trace_id, span_.span_id)


def annotate(**attributes: Any) -> None:
    """Attach attributes to the ambient span; no-op outside a trace."""
    span_ = _CURRENT.get()
    if span_ is not None:
        span_.attributes.update(attributes)


def annotate_root(key: str, value: Any, *, overwrite: bool = True) -> None:
    """Attach an attribute to the ambient trace's ROOT span — how deep
    code (a provider backend, the engine) flags a trace-level condition
    (``blackbox`` reasons) without plumbing the root around.  With
    ``overwrite=False`` the first writer wins — the first failure cause
    is the one the black-box dump reports."""
    span_ = _CURRENT.get()
    if span_ is None or span_._state is None:
        return
    root = span_._state.root
    if overwrite or key not in root.attributes:
        root.attributes[key] = value


@contextmanager
def span(name: str, **attributes: Any) -> Iterator[Span]:
    """A child span of the ambient span.

    Module-level (not a Tracer method) so deep layers — the serving
    engine, provider backends — can open spans without holding a tracer:
    the span joins whatever trace is ambient, and outside any trace it
    degrades to a detached, never-recorded timer (zero-cost observability
    for external completion-API callers that sent no traceparent).

    An exception propagating out marks the span ``status="error"`` and
    re-raises.
    """
    parent = _CURRENT.get()
    state = parent._state if parent is not None else None
    clock_ns = state.clock_ns if state is not None else time.monotonic_ns
    span_ = Span(
        trace_id=state.trace_id if state is not None else "",
        span_id=_new_span_id(),
        parent_id=parent.span_id if parent is not None else None,
        name=name,
        start_ns=clock_ns(),
        attributes=dict(attributes),
        _state=state,
    )
    token = _CURRENT.set(span_)
    try:
        yield span_
    except BaseException as exc:
        span_.status = "error"
        span_.error = span_.error or repr(exc)
        raise
    finally:
        _CURRENT.reset(token)
        span_.end_ns = clock_ns()
        if state is not None:
            state.add(span_)


class Tracer:
    """Starts traces and hands the completed :class:`Trace` to a flight
    recorder (``recorder.record(trace)``); ``recorder=None`` keeps
    everything in-flight-only (spans still time, nothing is retained).

    ``clock_ns`` is injectable so tests can shape span durations
    deterministically; child spans inherit the trace's clock.
    """

    def __init__(
        self,
        recorder: Optional[Any] = None,
        *,
        clock_ns: Optional[Callable[[], int]] = None,
    ) -> None:
        self.recorder = recorder
        self.clock_ns = clock_ns or time.monotonic_ns

    # spans delegate to the module-level ambient implementation, so a
    # mixed codebase (tracer-holding pipeline, tracer-free engine) builds
    # ONE tree per trace
    span = staticmethod(span)

    @contextmanager
    def trace(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attributes: Optional[dict] = None,
    ) -> Iterator[Span]:
        """Open a new trace (root span).  ``trace_id``/``parent_id`` from
        a parsed inbound ``traceparent`` join the caller's distributed
        trace; otherwise a fresh id is minted.  On exit the assembled
        :class:`Trace` goes to the recorder; exceptions mark the root
        ``error`` and re-raise."""
        tid = trace_id or _new_trace_id()
        root = Span(
            trace_id=tid,
            span_id=_new_span_id(),
            parent_id=None,
            name=name,
            start_ns=self.clock_ns(),
            attributes=dict(attributes or {}),
        )
        state = _TraceState(tid, root, self.clock_ns)
        root._state = state
        #: a remote parent is metadata, not a local span — the local root
        #: stays the tree root and the link survives in the attributes
        if parent_id:
            root.attributes.setdefault("remote_parent", parent_id)
        token = _CURRENT.set(root)
        try:
            yield root
        except BaseException as exc:
            root.status = "error"
            root.error = root.error or repr(exc)
            raise
        finally:
            _CURRENT.reset(token)
            root.end_ns = self.clock_ns()
            with state.lock:
                spans = [root, *state.finished]
            spans.sort(key=lambda s: s.start_ns)
            completed = Trace(trace_id=tid, name=name, spans=spans)
            if self.recorder is not None:
                try:
                    self.recorder.record(completed)
                except Exception:  # noqa: BLE001 - tracing must never fail the traced work
                    import logging

                    logging.getLogger(__name__).warning(
                        "flight recorder rejected trace %s", tid, exc_info=True
                    )
