"""Health checks.

Readiness parity with reference PatternLibraryReadinessCheck
(health/PatternLibraryReadinessCheck.java:22-86): ready when no
PatternLibrary CRs exist; otherwise require at least one pattern YAML in the
cache; after a 5-minute startup grace period report ready regardless (so a
broken Git remote can't keep the operator out of rotation forever).

Beyond parity, readiness also gates on serving-engine WARMTH when the
operator is warming one (weights loaded + default-bucket programs
compiled).  The reference gates readiness on its heavy dependency being
usable (the pattern cache, :22-86); this system's heavy dependency is the
in-process TPU engine — minutes of weight load + XLA compile at 8B scale.
Without the gate a pod reports Ready cold, and the first failures
analyzed in that window eat the compile latency inside their 2 s budget.
The same grace period applies so a permanently broken engine (which the
operator survives by degrading to pattern-only analyses) cannot keep the
pod out of rotation forever.

The port's own copy of ``operator_tpu/operator/health.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..patterns.loader import discover_library_files
from ..utils.config import OperatorConfig
from .kubeapi import ApiError, KubeApi

STARTUP_GRACE_S = 300.0  # reference :26 (5 minutes)

#: engine warmth states an ``engine_state`` callable may report
ENGINE_DISABLED = "disabled"   # no engine is being warmed (no gating)
ENGINE_LOADING = "loading"     # weights/compile in progress (gate)
ENGINE_READY = "ready"         # warmup generation completed
ENGINE_FAILED = "failed"       # build failed; operator degrades to pattern-only


@dataclass
class HealthStatus:
    ready: bool
    reason: str


class ReadinessCheck:
    def __init__(
        self,
        api: KubeApi,
        config: Optional[OperatorConfig] = None,
        *,
        started_at: Optional[float] = None,
        engine_state: Optional[Callable[[], str]] = None,
    ) -> None:
        self.api = api
        self.config = config or OperatorConfig()
        self.started_at = time.monotonic() if started_at is None else started_at
        #: callable reporting ENGINE_* warmth; None = no engine gating
        self.engine_state = engine_state

    def _in_grace(self) -> bool:
        return (time.monotonic() - self.started_at) > STARTUP_GRACE_S

    async def check(self) -> HealthStatus:
        patterns = await self._check_patterns()
        if not patterns.ready:
            return patterns
        state = self.engine_state() if self.engine_state is not None else ENGINE_DISABLED
        if state == ENGINE_LOADING:
            if self._in_grace():
                return HealthStatus(
                    True, f"{patterns.reason}; engine still warming but grace elapsed"
                )
            return HealthStatus(
                False, "serving engine warming (weight load / XLA compile)"
            )
        if state == ENGINE_FAILED:
            # deliberate: the operator stays in rotation serving
            # pattern-only analyses (app.py degrades quietly); a dead
            # optional engine must not unschedule the control plane
            return HealthStatus(True, f"{patterns.reason}; engine failed (degraded)")
        if state == ENGINE_READY:
            return HealthStatus(True, f"{patterns.reason}; engine warm")
        return patterns

    async def _check_patterns(self) -> HealthStatus:
        try:
            libraries = await self.api.list("PatternLibrary")
        except ApiError as exc:
            # can't even list CRs: not ready unless grace elapsed
            if self._in_grace():
                return HealthStatus(True, f"degraded (list failed: {exc}) but grace elapsed")
            return HealthStatus(False, f"cannot list PatternLibrary CRs: {exc}")
        if not libraries:
            return HealthStatus(True, "no PatternLibrary CRs configured")  # reference :38-41
        files = discover_library_files(self.config.pattern_cache_directory)
        if files:
            return HealthStatus(True, f"{len(files)} pattern file(s) cached")
        if self._in_grace():
            return HealthStatus(True, "no patterns cached but startup grace elapsed")  # :72-76
        return HealthStatus(False, "PatternLibrary CRs exist but no patterns cached yet")


class LivenessCheck:
    """Alive as long as the event loop answers."""

    async def check(self) -> HealthStatus:
        return HealthStatus(True, "alive")
