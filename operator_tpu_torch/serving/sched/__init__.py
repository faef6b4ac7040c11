"""Continuous-batching scheduler: ragged mixed prefill+decode waves.

The schedule → dispatch → commit loop (:mod:`.scheduler`) over the one
mixed-phase step (:mod:`.mixed`) and the ragged paged-attention kernel.
"""

from .scheduler import Scheduler
from .types import SchedConfig, StepPlan

__all__ = ["SchedConfig", "Scheduler", "StepPlan"]
