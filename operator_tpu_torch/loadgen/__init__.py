"""Deterministic open-loop load generation: the port's copy of
``operator_tpu/loadgen``.

``arrivals.py`` builds seeded arrival schedules — Poisson baseline,
failure-storm bursts, diurnal ramps — with EVERY random draw materialised
at build time (the ``utils/faultinject.py`` discipline), so the same
(spec, seed) replays byte-identically; ``driver.py`` fires them open-loop
(arrivals keep coming when the system falls behind — that is the point);
``storm.py`` assembles the in-process operator→router→serving stack the
storm drives, shared by ``chip_smoke.py`` and the CI smoke
(``python -m operator_tpu_torch.loadgen``).
"""

from __future__ import annotations

from .arrivals import ArrivalEvent, ArrivalProcess, ArrivalSpec
from .driver import run_open_loop
from .storm import StormStack, build_storm_stack, run_storm

__all__ = [
    "ArrivalEvent",
    "ArrivalProcess",
    "ArrivalSpec",
    "StormStack",
    "build_storm_stack",
    "run_open_loop",
    "run_storm",
]
