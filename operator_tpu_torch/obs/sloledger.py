"""SLO ledger: per-request SLO classes, attainment, and goodput-under-SLO.

Every analysis (or serving request) is assigned an SLO class + latency
target at admission and recorded over its full lifetime; the ledger then
computes **attainment** (fraction of terminal requests that completed
within their target) and **goodput-under-SLO** (completed-within-target
tokens/s and analyses/min) per class, per replica, and fleet-wide — the
arbiter metric the open-loop storm harness (``operator_tpu/loadgen/``)
reports, the way DeepServe gates pre-warmed pools on SLO attainment and
xLLM judges its async scheduler on deadline satisfaction rather than raw
throughput (docs/PERF.md "Open-loop methodology").

Timings are NOT re-measured here: the ledger's stamps come from the same
injectable clock the deadline envelopes use, stage splits come from the
flight recorder's span tree (``stage_durations``), and serving-side token
latencies come from the step clock — one source of truth, no new host
syncs.  Terminal records journal with the shared ``utils/journal.py``
discipline (torn-line-tolerant load, ``python -m operator_tpu.obs.view
--slo <journal>`` renders them offline).

Two accounting surfaces:

- :class:`SLOLedger` — the operator/loadgen side: full per-request
  records, journaling, ``podmortem_slo_*`` counters and the attainment
  histogram.
- :class:`SLOBoard` — the serving-replica side: bounded per-class
  aggregates only (no journal, no metrics — the ledger owns counters, so
  an in-process operator+serving pair never double-counts), carried on
  ``GET /healthz`` via ``ServingEngine.load_report()`` and rolled up
  fleet-wide by the router's ``fleet_rollup`` / token-gated ``GET /fleet``.

The port's own copy of ``operator_tpu/obs/sloledger.py``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.journal import Journal

__all__ = [
    "DEFAULT_SLO_CLASSES",
    "SLO_OUTCOME_ATTR",
    "SLOBoard",
    "SLOLedger",
    "SLORecord",
    "parse_slo_classes",
    "summarize",
]

#: class spec default (config.slo_classes / env SLO_CLASSES):
#: ``name:target_seconds`` pairs, comma-separated
DEFAULT_SLO_CLASSES = "interactive:2,standard:30,batch:120"

#: root-span attribute a backend may set to OVERRIDE the ledger's outcome
#: inference — the storm harness stamps "shed" here when the router
#: refused the dispatch, so shed load is attributed as shed, not failed
SLO_OUTCOME_ATTR = "slo_outcome"

#: "degraded" is a DISTINCT terminal outcome (not conflated with
#: deadline-exceeded): the overload ladder truncated the analysis depth
#: but the request still finished — it attains its SLO when in budget
TERMINAL_OUTCOMES = ("completed", "degraded", "deadline-exceeded", "shed", "failed")

#: latency histogram bounds (ms): analysis SLO targets run to minutes, so
#: the serving DEFAULT_BUCKETS_MS top of 10s would dump every batch-class
#: observation into +Inf
SLO_LATENCY_BUCKETS_MS: "tuple[float, ...]" = (
    50.0, 100.0, 250.0, 500.0, 1000.0, 2000.0, 5000.0,
    10_000.0, 30_000.0, 60_000.0, 120_000.0, 300_000.0,
)

#: attainment histogram: latency as a PERCENT of the class target — the
#: cumulative mass at or under the 100 bucket IS the attainment rate, so
#: one histogram answers both "how close to the edge" and "what fraction
#: made it" per scrape window
SLO_TARGET_FRACTION_BUCKETS: "tuple[float, ...]" = (
    10.0, 25.0, 50.0, 75.0, 90.0, 100.0, 125.0, 150.0, 200.0, 400.0, 1000.0,
)


def parse_slo_classes(spec: Optional[str]) -> "dict[str, float]":
    """``"interactive:2,standard:30,batch:120"`` -> name->target-seconds.

    Malformed entries are skipped; an empty or fully-garbage spec falls
    back to :data:`DEFAULT_SLO_CLASSES` so a bad env var can never leave
    the ledger classless."""
    classes: dict[str, float] = {}
    for raw in (spec or "").replace(",", " ").split():
        name, _, target = raw.partition(":")
        try:
            target_s = float(target)
        except ValueError:
            continue
        if name and target_s > 0:
            classes[name] = target_s
    if not classes:
        for raw in DEFAULT_SLO_CLASSES.split(","):
            name, _, target = raw.partition(":")
            classes[name] = float(target)
    return classes


@dataclass
class SLORecord:
    """One request's SLO lifetime.  ``admitted_at``/``completed_at`` are
    on the ledger's (injectable, monotonic) clock; ``stages`` carries the
    flight-recorder stage splits (name -> ms) so the worst-offender view
    can show WHERE a miss spent its budget."""

    trace_id: str
    cls: str
    target_s: float
    admitted_at: float
    completed_at: Optional[float] = None
    latency_s: Optional[float] = None
    outcome: str = "pending"  # "pending" | TERMINAL_OUTCOMES
    attained: bool = False
    tokens: int = 0
    replica: Optional[str] = None
    stages: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "cls": self.cls,
            "target_s": round(self.target_s, 6),
            "admitted_at": round(self.admitted_at, 6),
            "completed_at": (
                round(self.completed_at, 6)
                if self.completed_at is not None else None
            ),
            "latency_s": (
                round(self.latency_s, 6) if self.latency_s is not None else None
            ),
            "outcome": self.outcome,
            "attained": self.attained,
            "tokens": self.tokens,
            "replica": self.replica,
            "stages": dict(self.stages),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "SLORecord":
        return cls(
            trace_id=str(data.get("trace_id", "")),
            cls=str(data.get("cls", "default")),
            target_s=float(data.get("target_s") or 0.0),
            admitted_at=float(data.get("admitted_at") or 0.0),
            completed_at=(
                None if data.get("completed_at") is None
                else float(data["completed_at"])
            ),
            latency_s=(
                None if data.get("latency_s") is None
                else float(data["latency_s"])
            ),
            outcome=str(data.get("outcome", "pending")),
            attained=bool(data.get("attained")),
            tokens=int(data.get("tokens") or 0),
            replica=data.get("replica"),
            stages=dict(data.get("stages") or {}),
        )


def _percentile(sorted_vals: "list[float]", q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending list (deterministic, the
    definition the hand-valued tests replay)."""
    if not sorted_vals:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return sorted_vals[rank - 1]


def _bucket_summary(records: "list[SLORecord]") -> dict:
    """Aggregate one group of terminal records (a class, a replica, or
    the whole ledger) into the attainment/goodput row every surface
    shares."""
    admitted = len(records)
    completed = [r for r in records if r.outcome == "completed"]
    degraded = [r for r in records if r.outcome == "degraded"]
    attained = [r for r in records if r.attained]
    # degraded requests DID finish — their latencies belong in the
    # percentile view alongside full completions
    latencies = sorted(
        r.latency_s for r in completed + degraded if r.latency_s is not None
    )
    shed = sum(1 for r in records if r.outcome == "shed")
    deadline_exceeded = sum(
        1 for r in records if r.outcome == "deadline-exceeded"
    )
    failed = sum(1 for r in records if r.outcome == "failed")
    stamps = [r.admitted_at for r in records]
    ends = [r.completed_at for r in records if r.completed_at is not None]
    elapsed_s = max(ends) - min(stamps) if stamps and ends else 0.0
    tokens_attained = sum(r.tokens for r in attained)
    span = max(elapsed_s, 1e-9)
    return {
        "admitted": admitted,
        "completed": len(completed),
        "degraded": len(degraded),
        "attained": len(attained),
        "attainment": round(len(attained) / admitted, 6) if admitted else None,
        "shed": shed,
        "deadline_exceeded": deadline_exceeded,
        "failed": failed,
        "p50_s": _percentile(latencies, 50),
        "p95_s": _percentile(latencies, 95),
        "p99_s": _percentile(latencies, 99),
        "tokens_attained": tokens_attained,
        "goodput_tokens_s": (
            round(tokens_attained / span, 6) if attained else 0.0
        ),
        "goodput_analyses_per_min": (
            round(len(attained) * 60.0 / span, 6) if attained else 0.0
        ),
        "elapsed_s": round(elapsed_s, 6),
    }


def summarize(records: "list[SLORecord]") -> dict:
    """Attainment + goodput-under-SLO over terminal records: per class,
    per replica, and total.  Attainment counts EVERY terminal request in
    its denominator — shed and deadline-exceeded load counts against the
    SLO, which is the point of measuring open-loop (a closed-loop
    harness would simply not offer the load it can't carry)."""
    terminal = [r for r in records if r.outcome in TERMINAL_OUTCOMES]
    classes: dict[str, list[SLORecord]] = {}
    replicas: dict[str, list[SLORecord]] = {}
    for record in terminal:
        classes.setdefault(record.cls, []).append(record)
        if record.replica:
            replicas.setdefault(record.replica, []).append(record)
    out_classes = {}
    for cls in sorted(classes):
        row = _bucket_summary(classes[cls])
        row["target_s"] = classes[cls][0].target_s
        out_classes[cls] = row
    return {
        "classes": out_classes,
        "replicas": {
            rid: _bucket_summary(replicas[rid]) for rid in sorted(replicas)
        },
        "total": _bucket_summary(terminal),
    }


class SLOLedger:
    """Admission-to-terminal SLO accounting with journaling + metrics.

    ``admit`` stamps the class + target at admission (keyed by the
    flight-recorder trace id so ledger records join span trees and
    status entries on one id); ``finish`` computes latency and
    attainment, journals the terminal record, and bumps the
    ``podmortem_slo_*`` counters + histograms.  Single-threaded use
    (event loop / bench loop) — the journal's own thread contract
    applies."""

    def __init__(
        self,
        classes: Optional["dict[str, float]"] = None,
        *,
        default_class: Optional[str] = None,
        path: Optional[str] = None,
        metrics=None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.classes = dict(classes) if classes else parse_slo_classes(None)
        self.default_class = (
            default_class if default_class in self.classes
            else ("standard" if "standard" in self.classes
                  else next(iter(self.classes)))
        )
        self.metrics = metrics
        self._clock = clock or time.monotonic
        self._open: dict[str, SLORecord] = {}
        self._closed: list[SLORecord] = []
        # incremental per-class [terminal, attained] counts: the live
        # attainment feed the overload ladder's class protection reads
        # (O(classes), no rescan of _closed per admission decision)
        self._class_agg: dict[str, "list[int]"] = {}
        # async_writes: finish() runs inside the analysis pipeline's async
        # path — terminal-record appends must enqueue to the writer
        # thread, not block the event loop (graftlint GL006); close()
        # still barriers, so no record is lost on drain
        self._journal = (
            Journal(path, label="slo-ledger", async_writes=True)
            if path else None
        )
        if self._journal is not None:
            self._journal.open()

    # -- admission / terminal ------------------------------------------
    def admit(
        self,
        trace_id: str,
        *,
        cls: Optional[str] = None,
        target_s: Optional[float] = None,
        replica: Optional[str] = None,
    ) -> SLORecord:
        name = cls if cls in self.classes else self.default_class
        record = SLORecord(
            trace_id=trace_id,
            cls=name,
            target_s=(
                target_s if target_s is not None else self.classes[name]
            ),
            admitted_at=self._clock(),
            replica=replica,
        )
        self._open[trace_id] = record
        if self.metrics is not None:
            self.metrics.incr("slo_admitted")
        return record

    def finish(
        self,
        trace_id: str,
        *,
        outcome: str,
        tokens: int = 0,
        replica: Optional[str] = None,
        stages: Optional[dict] = None,
    ) -> Optional[SLORecord]:
        record = self._open.pop(trace_id, None)
        if record is None:
            return None
        if outcome not in TERMINAL_OUTCOMES:
            outcome = "failed"
        record.completed_at = self._clock()
        record.latency_s = max(0.0, record.completed_at - record.admitted_at)
        record.outcome = outcome
        record.tokens = int(tokens or 0)
        if replica is not None:
            record.replica = replica
        if stages:
            record.stages = dict(stages)
        # a degraded (depth-truncated) analysis that lands in budget still
        # attains — that trade IS the degradation ladder's point: smooth
        # attainment decay under storm instead of a reject cliff
        record.attained = (
            outcome in ("completed", "degraded")
            and record.latency_s <= record.target_s
        )
        self._closed.append(record)
        agg = self._class_agg.setdefault(record.cls, [0, 0])
        agg[0] += 1
        if record.attained:
            agg[1] += 1
        if self._journal is not None:
            self._journal.append(record.to_dict())
        m = self.metrics
        if m is not None:
            m.incr("slo_attained" if record.attained else "slo_missed")
            if outcome == "shed":
                m.incr("slo_shed")
            elif outcome == "degraded":
                m.incr("slo_degraded")
            elif outcome == "deadline-exceeded":
                m.incr("slo_deadline_exceeded")
            elif outcome == "failed":
                m.incr("slo_failed")
            m.observe(
                "slo_latency_milliseconds",
                record.latency_s * 1e3,
                buckets=SLO_LATENCY_BUCKETS_MS,
            )
            if record.target_s > 0:
                m.observe(
                    "slo_target_fraction_percent",
                    record.latency_s / record.target_s * 100.0,
                    buckets=SLO_TARGET_FRACTION_BUCKETS,
                )
        return record

    # -- reads ---------------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._open)

    @property
    def records(self) -> "list[SLORecord]":
        return list(self._closed)

    def attainment_by_class(self) -> "dict[str, Optional[float]]":
        """Live per-class attainment fraction over terminal records (None
        until a class has any) — the feed ``router/value.py``'s
        ValueModel protection reads, so "never shed the class already
        below its attainment target" tracks reality, not a snapshot."""
        out: dict[str, Optional[float]] = {}
        for cls, (terminal, attained) in self._class_agg.items():
            out[cls] = round(attained / terminal, 6) if terminal else None
        return out

    def pending_by_class(self) -> "dict[str, int]":
        depth: dict[str, int] = {}
        for record in self._open.values():
            depth[record.cls] = depth.get(record.cls, 0) + 1
        return depth

    def snapshot(self) -> dict:
        """The summary every surface shares, plus current queue state."""
        out = summarize(self._closed)
        out["pending"] = self.pending
        out["pending_by_class"] = self.pending_by_class()
        return out

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()

    # -- offline -------------------------------------------------------
    @staticmethod
    def load_records(path: str) -> "list[SLORecord]":
        """Terminal records from a ledger journal, torn-line tolerant
        (the view CLI and the CI smoke both read through here)."""
        records: list[SLORecord] = []
        journal = Journal(path, label="slo-ledger")
        journal.load(lambda data: records.append(SLORecord.from_dict(data)))
        return records


class SLOBoard:
    """Bounded per-class aggregates for ONE serving replica: what
    ``load_report()`` / ``GET /healthz`` carries and ``fleet_rollup``
    weights.  No journal, no record list, no metrics — O(classes) state
    however long the replica serves."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.monotonic
        self._first: Optional[float] = None
        self._last: Optional[float] = None
        self._pending: dict[str, int] = {}
        self._agg: dict[str, "list[int]"] = {}  # cls -> [completed, attained]
        self.tokens_attained = 0
        self.completed = 0
        self.attained = 0

    def submitted(self, cls: str) -> None:
        if self._first is None:
            self._first = self._clock()
        self._pending[cls] = self._pending.get(cls, 0) + 1

    def finished(self, cls: str, *, attained: bool, tokens: int = 0) -> None:
        count = self._pending.get(cls, 0) - 1
        if count > 0:
            self._pending[cls] = count
        else:
            self._pending.pop(cls, None)
        row = self._agg.setdefault(cls, [0, 0])
        row[0] += 1
        self.completed += 1
        if attained:
            row[1] += 1
            self.attained += 1
            self.tokens_attained += max(0, int(tokens))
        self._last = self._clock()

    def attainment(self) -> Optional[float]:
        if not self.completed:
            return None
        return round(self.attained / self.completed, 6)

    def goodput_tokens_s(self) -> Optional[float]:
        if self._first is None or self._last is None:
            return None
        span = max(self._last - self._first, 1e-9)
        return round(self.tokens_attained / span, 6)

    def per_class(self) -> dict:
        classes = sorted(set(self._pending) | set(self._agg))
        out = {}
        for cls in classes:
            completed, attained = self._agg.get(cls, (0, 0))
            out[cls] = {
                "queued": self._pending.get(cls, 0),
                "completed": completed,
                "attained": attained,
                "attainment": (
                    round(attained / completed, 6) if completed else None
                ),
            }
        return out
