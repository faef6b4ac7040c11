"""Game-day chaos: composed scenarios, always-on invariants, shrinking.

The port's own copy of ``operator_tpu/chaos``.  Three composing pieces
(the reference's docs/ROBUSTNESS.md, "Game days"):

- :mod:`.scenario` / :mod:`.conductor` — declarative seeded
  :class:`ChaosScenario` (phased injections by registered seam name +
  fleet actions) driven through the storm stack, byte-identical from
  one seed with a sha256 fingerprint;
- :mod:`.invariants` — the :class:`InvariantAuditor` checking
  fleet-wide conservation probes at commit barriers and scenario end,
  black-boxing violations through the flight recorder;
- :mod:`.shrink` — ddmin over a failing scenario's injection set down
  to a minimal runnable reproducer.
"""

from .conductor import run_scenario
from .invariants import GameDayView, InvariantAuditor, Violation
from .library import builtin_scenarios, composed_storm, disagg_fabric, scale_churn
from .scenario import ERRORS, ChaosScenario, FleetAction, Injection, Phase
from .shrink import ShrinkResult, shrink

__all__ = [
    "ChaosScenario",
    "ERRORS",
    "FleetAction",
    "GameDayView",
    "Injection",
    "InvariantAuditor",
    "Phase",
    "ShrinkResult",
    "Violation",
    "builtin_scenarios",
    "composed_storm",
    "disagg_fabric",
    "run_scenario",
    "scale_churn",
    "shrink",
]
