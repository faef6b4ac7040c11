"""Cross-cutting utilities: config, timing and metrics, deadline
budgets, fault injection, the device resolver."""

from .config import OperatorConfig
from .deadline import Deadline
from .device import resolve_device
from .faultinject import FaultAction, FaultPlan
from .timing import METRICS, MetricsRegistry, StageStats

__all__ = [
    "METRICS",
    "Deadline",
    "FaultAction",
    "FaultPlan",
    "MetricsRegistry",
    "OperatorConfig",
    "StageStats",
    "resolve_device",
]
