"""The port's observability: its own copies of ``operator_tpu/obs``.

``span.py`` holds the span/trace model and the ambient (contextvars)
tracer; ``record.py`` the bounded flight recorder with JSONL journaling
and black-box dumps; ``sloledger.py`` the per-analysis SLO ledger;
``steptrace.py`` the step clock's records; ``view.py`` the offline viewer
(``python -m operator_tpu_torch.obs.view``).

Module defaults mirror :data:`..utils.timing.METRICS`: one process-wide
``RECORDER``/``TRACER`` pair (dependency-inject fresh ones in tests).
The default recorder honours ``TRACE_JOURNAL_PATH`` /
``TRACE_BLACKBOX_PATH``.
"""

from __future__ import annotations

import os
from typing import Optional

from .record import FlightRecorder, TraceRecord, render_tree
from .sloledger import (
    DEFAULT_SLO_CLASSES,
    SLOBoard,
    SLOLedger,
    SLORecord,
    parse_slo_classes,
)
from .steptrace import StepRecord, StepRing, attribution, render_steps
from .span import (
    Span,
    Trace,
    Tracer,
    annotate,
    annotate_root,
    current_span,
    current_trace_id,
    current_traceparent,
    format_traceparent,
    parse_traceparent,
    span,
    stage_durations,
)

__all__ = [
    "DEFAULT_SLO_CLASSES",
    "FlightRecorder",
    "RECORDER",
    "SLOBoard",
    "SLOLedger",
    "SLORecord",
    "Span",
    "StepRecord",
    "StepRing",
    "Trace",
    "TraceRecord",
    "Tracer",
    "TRACER",
    "annotate",
    "annotate_root",
    "attribution",
    "build_tracer",
    "parse_slo_classes",
    "current_span",
    "current_trace_id",
    "current_traceparent",
    "format_traceparent",
    "parse_traceparent",
    "render_steps",
    "render_tree",
    "span",
    "stage_durations",
]

def _env_capacity(default: int = 256) -> int:
    try:
        return int(os.environ.get("TRACE_RING_CAPACITY", "") or default)
    except ValueError:  # garbage env must not fail every importer
        return default


#: process-wide defaults (tests inject their own)
RECORDER = FlightRecorder(
    capacity=_env_capacity(),
    path=os.environ.get("TRACE_JOURNAL_PATH") or None,
    blackbox_path=os.environ.get("TRACE_BLACKBOX_PATH") or None,
)
TRACER = Tracer(recorder=RECORDER)


def build_tracer(config, metrics=None) -> "tuple[Tracer, Optional[FlightRecorder]]":
    """(tracer, recorder) from an OperatorConfig — the operator's wiring
    path (operator/app.py).  ``obs_enabled=False`` returns a recorder-less
    tracer: spans still time (they are how stage code reads its own
    elapsed), traces are dropped on completion."""
    if not getattr(config, "obs_enabled", True):
        return Tracer(recorder=None), None
    recorder = FlightRecorder(
        capacity=getattr(config, "trace_ring_capacity", 256),
        path=getattr(config, "trace_journal_path", None) or None,
        blackbox_path=getattr(config, "trace_blackbox_path", None) or None,
        metrics=metrics,
    )
    return Tracer(recorder=recorder), recorder
