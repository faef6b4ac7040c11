"""Lightweight stage timing + metrics registry.

The port's own copy of ``operator_tpu/utils/timing.py``: the
``MetricsRegistry`` (stage percentiles, counters, labeled counters,
histograms, gauges, ``snapshot``) that the continuous scheduler, the
prefix cache, the step clock, the overload ladder and the operator record
into, its Prometheus text exposition (the operator's ``/metrics``), and
the process-wide ``METRICS`` default.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left, insort
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

#: default bucket upper bounds (ms) for latency histograms: sub-millisecond
#: decode steps through multi-second queue waits under storm load
DEFAULT_BUCKETS_MS: "tuple[float, ...]" = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


def _le(bound: float) -> str:
    """Prometheus ``le`` label rendering (``0.5``, ``1``, ``2.5`` — no
    trailing zeros, so both exposition flavours parse it as a float)."""
    return f"{bound:g}"


@dataclass
class StageStats:
    """Rolling latency record for one named stage (bounded memory)."""

    name: str
    count: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0
    _sorted: list[float] = field(default_factory=list, repr=False)
    _cap: int = 4096

    def record(self, duration_ms: float) -> None:
        self.count += 1
        self.total_ms += duration_ms
        self.max_ms = max(self.max_ms, duration_ms)
        if len(self._sorted) >= self._cap:
            # drop a middle sample to stay bounded while keeping the tails
            del self._sorted[len(self._sorted) // 2]
        insort(self._sorted, duration_ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        idx = min(len(self._sorted) - 1, int(q / 100.0 * len(self._sorted)))
        return self._sorted[idx]

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99)


class HistogramStats:
    """Fixed-bucket latency histogram (Prometheus semantics: each bucket
    counts observations ``<= le``; exposition renders the cumulative
    counts plus ``+Inf``/``_sum``/``_count``).  Per-bucket counts are
    stored raw and cumulated at render so `observe` stays O(log buckets)
    with constant memory — unlike StageStats there is no sample list to
    cap, which is what makes histograms the right shape for per-step
    and per-token observations at serving rates."""

    __slots__ = ("name", "bounds", "counts", "sum", "count")

    def __init__(
        self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS_MS
    ) -> None:
        self.name = name
        self.bounds: tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
        self.counts: list[int] = [0] * (len(self.bounds) + 1)  # [-1] = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.counts[bisect_left(self.bounds, value)] += 1

    def cumulative(self) -> "list[tuple[str, int]]":
        """``[(le_label, cumulative_count), ..., ("+Inf", count)]``."""
        out: list[tuple[str, int]] = []
        running = 0
        for bound, bucket in zip(self.bounds, self.counts):
            running += bucket
            out.append((_le(bound), running))
        out.append(("+Inf", self.count))
        return out


class MetricsRegistry:
    """Thread-safe registry of stage stats + counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: dict[str, StageStats] = {}
        self._counters: dict[str, int] = {}
        # fixed-bucket histograms (step duration, host gap, queue wait,
        # TTFT, per-token latency — docs/METRICS.md "Histograms")
        self._histograms: dict[str, HistogramStats] = {}
        # last-value gauges (e.g. supervisor_restart_ready_seconds):
        # point-in-time observations where only the latest value matters
        self._gauges: dict[str, float] = {}
        # most recent exemplar per counter (a trace id, obs/record.py):
        # rendered OpenMetrics-style so an alert on a counter links
        # straight to the trace that last bumped it
        self._exemplars: dict[str, str] = {}
        # labeled counter series: name -> {sorted (k, v) label tuple: count}.
        # Flat counters stay in _counters; a labeled incr ALSO bumps the
        # flat total so existing counter() readers keep working.
        self._labeled: dict[str, dict[tuple, int]] = {}

    def stage(self, name: str) -> StageStats:
        with self._lock:
            stats = self._stages.get(name)
            if stats is None:
                stats = StageStats(name)
                self._stages[name] = stats
            return stats

    def record(self, name: str, duration_ms: float) -> None:
        with self._lock:
            stats = self._stages.get(name)
            if stats is None:
                stats = StageStats(name)
                self._stages[name] = stats
            stats.record(duration_ms)

    @contextmanager
    def timed(self, name: str) -> Iterator[None]:
        started = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - started) * 1e3)

    def observe(
        self,
        name: str,
        value: float,
        *,
        buckets: Optional[Sequence[float]] = None,
    ) -> None:
        """One histogram observation; the first call fixes the bucket
        bounds (later ``buckets=`` arguments are ignored — Prometheus
        cannot re-bucket a live series)."""
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = HistogramStats(name, buckets or DEFAULT_BUCKETS_MS)
                self._histograms[name] = hist
            hist.observe(value)

    def histogram(self, name: str) -> Optional[HistogramStats]:
        with self._lock:
            return self._histograms.get(name)

    def incr(
        self,
        name: str,
        amount: int = 1,
        *,
        exemplar: Optional[str] = None,
        labels: Optional[dict] = None,
    ) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount
            if exemplar:
                self._exemplars[name] = exemplar
            if labels:
                series = self._labeled.setdefault(name, {})
                key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
                series[key] = series.get(key, 0) + amount

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def labeled(self, name: str) -> "dict[tuple, int]":
        """Per-series counts for a labeled counter (keyed by the sorted
        ``(label, value)`` tuple); empty when never bumped with labels."""
        with self._lock:
            return dict(self._labeled.get(name, {}))

    def labeled_total(
        self, name: str, *, where: Optional[dict] = None
    ) -> int:
        """Sum of a labeled counter's series, optionally filtered to the
        series whose labels include every ``where`` pair."""
        with self._lock:
            series = self._labeled.get(name, {})
            if not where:
                return sum(series.values())
            need = {(str(k), str(v)) for k, v in where.items()}
            return sum(
                n for key, n in series.items() if need.issubset(set(key))
            )

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "stages": {
                    name: {
                        "count": s.count,
                        "mean_ms": round(s.mean_ms, 3),
                        "p50_ms": round(s.p50_ms, 3),
                        "p99_ms": round(s.p99_ms, 3),
                        "max_ms": round(s.max_ms, 3),
                    }
                    for name, s in self._stages.items()
                },
                "counters": dict(self._counters),
            }
            if self._labeled:
                out["labeled"] = {
                    name: {
                        ",".join(f"{k}={v}" for k, v in key): n
                        for key, n in series.items()
                    }
                    for name, series in self._labeled.items()
                }
            if self._histograms:
                out["histograms"] = {
                    name: {
                        "buckets": dict(h.cumulative()),
                        "sum": round(h.sum, 3),
                        "count": h.count,
                    }
                    for name, h in self._histograms.items()
                }
            if self._gauges:
                out["gauges"] = {k: round(v, 6) for k, v in self._gauges.items()}
            if self._exemplars:
                # trace-id exemplars ride the JSON surface unconditionally
                # (no format constraints there, unlike the text exposition)
                out["exemplars"] = dict(self._exemplars)
            return out

    def prometheus(self, *, openmetrics: bool = False) -> str:
        """Prometheus text exposition (version 0.0.4) of the same data, so
        any standard scraper can consume the operator's metrics; stage
        latencies render as summaries with p50/p99 quantiles.

        ``openmetrics=True`` renders the OpenMetrics flavour instead
        (trailing ``# EOF``, counter exemplars): exemplars are ONLY legal
        there — a mid-line ``#`` in classic text makes the legacy parser
        reject the whole scrape, so the default exposition never emits
        them.  Servers switch on content negotiation
        (``Accept: application/openmetrics-text``)."""

        def sane(name: str) -> str:
            return "".join(c if c.isalnum() or c == "_" else "_" for c in name)

        lines: list[str] = []
        with self._lock:
            if self._stages:
                metric = "podmortem_stage_duration_milliseconds"
                lines.append(f"# HELP {metric} Per-stage latency (detect->store pipeline).")
                lines.append(f"# TYPE {metric} summary")
                for name, s in sorted(self._stages.items()):
                    stage = sane(name)
                    lines.append(f'{metric}{{stage="{stage}",quantile="0.5"}} {s.p50_ms:.3f}')
                    lines.append(f'{metric}{{stage="{stage}",quantile="0.99"}} {s.p99_ms:.3f}')
                    lines.append(f'{metric}_sum{{stage="{stage}"}} {s.total_ms:.3f}')
                    lines.append(f'{metric}_count{{stage="{stage}"}} {s.count}')
            for name, h in sorted(self._histograms.items()):
                # histograms are legal (and identical) in BOTH flavours:
                # cumulative le-buckets ending at +Inf, then _sum/_count
                metric = f"podmortem_{sane(name)}"
                lines.append(f"# TYPE {metric} histogram")
                for le, cumulative in h.cumulative():
                    lines.append(f'{metric}_bucket{{le="{le}"}} {cumulative}')
                lines.append(f"{metric}_sum {h.sum:.3f}")
                lines.append(f"{metric}_count {h.count}")
            for name, value in sorted(self._counters.items()):
                family = f"podmortem_{sane(name)}"
                metric = f"{family}_total"
                if openmetrics:
                    # OpenMetrics names the counter FAMILY without the
                    # _total suffix (the sample keeps it); declaring the
                    # family as ..._total makes the reference parser
                    # reject the exemplar-carrying sample — and the whole
                    # scrape with it
                    lines.append(f"# TYPE {family} counter")
                else:
                    lines.append(f"# TYPE {metric} counter")
                series = self._labeled.get(name)
                if series:
                    # labeled counters expose one sample per label set (the
                    # flat total stays on the JSON surface via counter());
                    # emitting BOTH would double every sum() over the family
                    for key in sorted(series):
                        labels = ",".join(
                            f'{sane(k)}="{v}"' for k, v in key
                        )
                        lines.append(f"{metric}{{{labels}}} {series[key]}")
                    continue
                exemplar = self._exemplars.get(name) if openmetrics else None
                if exemplar:
                    lines.append(
                        f'{metric} {value} # {{trace_id="{sane(exemplar)}"}} 1'
                    )
                else:
                    lines.append(f"{metric} {value}")
            for name, value in sorted(self._gauges.items()):
                metric = f"podmortem_{sane(name)}"
                lines.append(f"# TYPE {metric} gauge")
                lines.append(f"{metric} {value:.6g}")
            if openmetrics:
                lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: process-wide default registry (dependency-inject a fresh one in tests)
METRICS = MetricsRegistry()
