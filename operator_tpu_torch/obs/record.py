"""Flight recorder — bounded trace ring + append-only JSONL + black-box dumps.

Every completed analysis trace lands in a bounded in-memory ring (the
recent history ``GET /traces`` serves) and, when a journal path is
configured, appends one JSONL line — the same crash-safe discipline as
``memory/store.py``: write + flush per record, torn tail lines detected
and skipped at load, losing at most the one trace that was mid-write.

A **black-box dump** is the full trace plus its failure context (deadline
ledger, fault-plan seed/fingerprint) written the moment an analysis ends
``deadline-exceeded``, a circuit breaker opens, or the serving engine
reports a device error — the replayable record that turns "the counter
went up" into "the budget died HERE" (docs/OBSERVABILITY.md).

Counters (docs/METRICS.md): ``podmortem_trace_recorded_total``,
``podmortem_trace_blackbox_total``, ``podmortem_trace_evicted_total`` —
each carrying the most recent trace id as an OpenMetrics exemplar so an
alert links straight to ``GET /traces/{id}``.

The port's own copy of ``operator_tpu/obs/record.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..utils.journal import Journal
from ..utils.timing import METRICS, MetricsRegistry
from .span import Trace

log = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "TraceRecord", "render_tree"]


@dataclass
class TraceRecord:
    """One remembered trace: the serialized span tree plus recorder
    metadata (wall-clock anchor, black-box marking)."""

    trace: dict
    recorded_at: float = 0.0
    blackbox: bool = False
    reason: Optional[str] = None
    extra: dict = field(default_factory=dict)

    @property
    def trace_id(self) -> str:
        return self.trace.get("traceId", "")

    def summary(self) -> dict:
        out = {
            "traceId": self.trace_id,
            "name": self.trace.get("name"),
            "durationMs": self.trace.get("durationMs"),
            "status": self.trace.get("status"),
            "spans": len(self.trace.get("spans") or []),
            "recordedAt": self.recorded_at,
        }
        if self.blackbox:
            out["blackbox"] = True
            out["reason"] = self.reason
        return out

    def to_dict(self) -> dict:
        out = {"recordedAt": self.recorded_at, "trace": self.trace}
        if self.blackbox:
            out["blackbox"] = True
            out["reason"] = self.reason
            out["extra"] = dict(self.extra)
        return out


class FlightRecorder:
    """Thread-safe bounded ring of completed traces, newest last."""

    def __init__(
        self,
        capacity: int = 256,
        *,
        path: Optional[str] = None,
        blackbox_path: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.capacity = max(1, capacity)
        self.path = path
        #: black-box dumps go here; falls back to the main journal so a
        #: recorder configured with only ``path`` still persists dumps
        self.blackbox_path = blackbox_path or path
        self.metrics = metrics or METRICS
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._ring: "OrderedDict[str, TraceRecord]" = OrderedDict()
        # journal appends ride the shared durable-journal helper
        # (utils/journal.py) in writer-thread mode: record() runs on the
        # asyncio event loop (the tracer's context exit), and a per-trace
        # write+flush on a slow disk — the exact condition black-box
        # forensics target — must stall the writer thread, never the
        # loop.  One Journal per distinct path (the black-box path
        # defaults to the main journal, sharing its instance) keeps
        # append order per file; pending writes drain via flush().
        # Folding onto the helper means the
        # torn-line/compaction discipline can no longer drift from the
        # incident store's and claim ledger's.
        self._journals: dict[str, "Journal"] = {}
        for journal_path in {
            p for p in (self.path, self.blackbox_path) if p
        }:
            journal = Journal(
                journal_path, label="flight-recorder", async_writes=True
            )
            journal.open()
            self._journals[journal_path] = journal

    # -- ingest --------------------------------------------------------
    def record(self, trace: "Trace | dict") -> TraceRecord:
        """Remember one completed trace (called by the Tracer on trace
        end, possibly from worker threads).

        A black-box record already holding this trace id is NEVER
        replaced: W3C semantics keep one id across a distributed
        transaction, and the analysis's trace id is published (CR status,
        outbound traceparent) — a later request echoing it back must not
        erase forensic evidence from the ring.  The new trace still
        journals to disk."""
        payload = trace.to_dict() if isinstance(trace, Trace) else dict(trace)
        record = TraceRecord(trace=payload, recorded_at=self._clock())
        with self._lock:
            existing = self._ring.get(record.trace_id)
            if existing is not None and existing.blackbox:
                record = existing
            else:
                self._ring[record.trace_id] = record
                self._ring.move_to_end(record.trace_id)
            evicted = self._evict_locked()
        self.metrics.incr("trace_recorded", exemplar=record.trace_id)
        if evicted:
            self.metrics.incr("trace_evicted", evicted)
        self._append(self.path, {"recordedAt": self._clock(), "trace": payload})
        return record

    def _evict_locked(self) -> int:
        """Shrink to capacity, preferring non-black-box victims: dumps are
        the records /traces exists for, so routine (or adversarial
        traceparent-minted) traffic cannot churn them out.  At most half
        the ring stays pinned — beyond that the oldest dump goes too,
        keeping the bound hard."""
        evicted = 0
        pin_limit = max(1, self.capacity // 2)
        while len(self._ring) > self.capacity:
            victim = None
            pinned = 0
            for trace_id, rec in self._ring.items():  # oldest first
                if rec.blackbox and pinned < pin_limit:
                    pinned += 1
                    continue
                victim = trace_id
                break
            if victim is None:  # all remaining are pinned dumps
                victim = next(iter(self._ring))
            self._ring.pop(victim)
            evicted += 1
        return evicted

    def black_box(
        self, trace_id: str, reason: str, extra: Optional[dict] = None
    ) -> Optional[TraceRecord]:
        """Mark a recorded trace as a black-box event and dump it in full
        (trace + reason + context) to the black-box JSONL.  Returns the
        record, or None when the trace already fell off the ring."""
        with self._lock:
            record = self._ring.get(trace_id)
            if record is None:
                return None
            record.blackbox = True
            record.reason = reason
            if extra:
                record.extra.update(extra)
            payload = record.to_dict()
        self.metrics.incr("trace_blackbox", exemplar=trace_id)
        self._append(self.blackbox_path, payload)
        return record

    def _append(self, path: Optional[str], payload: dict) -> None:
        """Enqueue one record to the path's journal (Journal serializes
        NOW — the record is live and mutated under the ring lock — and
        writes on its writer thread; IO failure is logged, never raised:
        a full disk must not fail the analysis being recorded)."""
        if not path:
            return
        journal = self._journals.get(path)
        if journal is not None:
            journal.append(payload)

    def flush(self, timeout: Optional[float] = 5.0) -> None:
        """Barrier: returns once every previously submitted journal write
        has hit disk (tests, pre-shutdown forensics)."""
        for journal in self._journals.values():
            journal.flush(timeout)

    # -- queries -------------------------------------------------------
    def get(self, trace_id: str) -> Optional[TraceRecord]:
        with self._lock:
            return self._ring.get(trace_id)

    def traces(
        self, limit: Optional[int] = None, *, blackbox_only: bool = False
    ) -> list[TraceRecord]:
        """Newest-first records (bounded by ``limit``)."""
        with self._lock:
            records = list(reversed(self._ring.values()))
        if blackbox_only:
            records = [r for r in records if r.blackbox]
        if limit is not None:
            records = records[: max(0, limit)]
        return records

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- reload --------------------------------------------------------
    @staticmethod
    def load(path: str) -> list[TraceRecord]:
        """Parse a journal/black-box JSONL back into records, skipping
        torn or corrupt lines (same tolerance as the incident journal —
        a crash mid-append loses one line, never the dump).

        Records are deduped by trace id: with ``blackbox_path`` defaulting
        to the journal, a dumped trace appears twice (the plain record,
        then its black-box twin) — the dump supersedes; for plain
        duplicates (a rejoined remote trace id) the latest wins."""
        records: list[TraceRecord] = []
        dropped = 0
        try:
            handle = open(path, encoding="utf-8", errors="replace")
        except OSError as exc:
            raise FileNotFoundError(f"cannot read trace dump {path}: {exc}") from exc
        with handle:
            for line in handle:
                line = line.strip()
                if not line:
                    continue
                try:
                    data = json.loads(line)
                    trace = data["trace"]
                    if not isinstance(trace, dict) or "traceId" not in trace:
                        raise KeyError("trace")
                except (ValueError, KeyError, TypeError):
                    dropped += 1
                    continue
                records.append(
                    TraceRecord(
                        trace=trace,
                        recorded_at=float(data.get("recordedAt") or 0.0),
                        blackbox=bool(data.get("blackbox")),
                        reason=data.get("reason"),
                        extra=dict(data.get("extra") or {}),
                    )
                )
        if dropped:
            log.warning("trace dump %s: skipped %d corrupt line(s)", path, dropped)
        deduped: "OrderedDict[str, TraceRecord]" = OrderedDict()
        for record in records:
            previous = deduped.get(record.trace_id)
            if previous is not None and previous.blackbox and not record.blackbox:
                continue  # never let a plain twin shadow the dump
            deduped[record.trace_id] = record  # keeps first-seen position
        return list(deduped.values())


# --------------------------------------------------------------------------
# rendering (shared by the view CLI and GET /traces/{id})
# --------------------------------------------------------------------------

_BAR_WIDTH = 24


def _render_span(
    span: dict,
    by_parent: dict[Optional[str], list[dict]],
    root_start: int,
    root_ms: float,
    depth: int,
    lines: list[str],
) -> None:
    duration = float(span.get("durationMs") or 0.0)
    offset_ms = (int(span.get("startNs") or 0) - root_start) / 1e6
    pct = (duration / root_ms * 100.0) if root_ms > 0 else 0.0
    # flame-style bar: position = offset within the root, width = share
    lead = int(offset_ms / root_ms * _BAR_WIDTH) if root_ms > 0 else 0
    width = max(1, int(duration / root_ms * _BAR_WIDTH)) if root_ms > 0 else 1
    lead = min(lead, _BAR_WIDTH - 1)
    width = min(width, _BAR_WIDTH - lead)
    bar = " " * lead + "█" * width + " " * (_BAR_WIDTH - lead - width)
    marker = " !" if span.get("status") == "error" else ""
    attrs = span.get("attributes") or {}
    attr_text = ""
    if attrs:
        shown = ", ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        attr_text = f"  [{shown[:120]}]"
    lines.append(
        f"{'  ' * depth}{span.get('name', '?'):<{max(4, 28 - 2 * depth)}}"
        f" {duration:>9.1f}ms {pct:>5.1f}% |{bar}|{marker}{attr_text}"
    )
    for child in by_parent.get(span.get("spanId"), []):
        _render_span(child, by_parent, root_start, root_ms, depth + 1, lines)


def render_tree(trace: dict) -> str:
    """Flame-style text tree of one serialized trace — offsets and widths
    scaled to the root span, children indented under their parents."""
    spans = list(trace.get("spans") or [])
    if not spans:
        return f"trace {trace.get('traceId', '?')}: no spans"
    spans.sort(key=lambda s: int(s.get("startNs") or 0))
    roots = [s for s in spans if not s.get("parentId")]
    root = roots[0] if roots else spans[0]
    by_parent: dict[Optional[str], list[dict]] = {}
    for span in spans:
        if span is root:
            continue
        by_parent.setdefault(span.get("parentId"), []).append(span)
    root_ms = float(root.get("durationMs") or 0.0)
    header = (
        f"trace {trace.get('traceId', '?')}  {trace.get('name', '?')}"
        f"  {root_ms:.1f}ms  status={trace.get('status', '?')}"
    )
    lines = [header]
    _render_span(root, by_parent, int(root.get("startNs") or 0), root_ms, 0, lines)
    # orphans (parent span fell outside the dump) still render, flat
    known = {s.get("spanId") for s in spans}
    for span in spans:
        parent = span.get("parentId")
        if span is not root and parent and parent not in known:
            _render_span(span, by_parent, int(root.get("startNs") or 0),
                         root_ms, 1, lines)
    return "\n".join(lines)
