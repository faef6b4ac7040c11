"""The port's observability: copies of ``operator_tpu/obs`` modules.

``steptrace.py`` holds the step clock's records; ``span.py`` the span and
trace model with the ambient (contextvars) tracer that the provider reads
(``current_trace_id``) and flags (``annotate_root``).  The flight
recorder, the SLO ledger and the offline viewer come with the operator
(ROADMAP Queue 1 item 5a).
"""

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
    "stage_durations",
]
