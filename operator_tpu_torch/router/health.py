"""Circuit breakers of the control plane.

The port's copy of the breaker half of ``operator_tpu/router/health.py``:
:class:`CircuitBreaker` / :class:`BreakerBoard`, the consecutive-failure
state machine that turns a dying backend from "every call burns a
deadline budget" into "calls skip it until a half-open probe succeeds".
The pipeline keys its board by provider id.  The replica half
(``ReplicaLoad``, ``ReplicaHealth``, ``HealthBoard``, ``fleet_rollup``)
comes with the router.

The clock is injectable so tests drive the state machine
deterministically.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class CircuitBreaker:
    """Consecutive-failure breaker for one backend (provider or replica).

    States: ``closed`` (calls flow) → after ``failure_threshold``
    consecutive failures ``open`` (calls skipped: a dead backend must stop
    burning the deadline budget — the pipeline falls through the existing
    degradation ladder and stores pattern-only results) → after
    ``reset_s`` ``half-open`` (exactly ONE probe flows) → probe success
    closes, probe failure re-opens for another window.

    The clock is injectable so tests drive the state machine
    deterministically.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.reset_s = reset_s
        self._clock = clock or time.monotonic
        self.state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0

    def allow(self) -> bool:
        """May a call be attempted now?  Transitions open → half-open when
        the reset window elapsed (that caller IS the probe; concurrent
        callers in half-open are refused until the probe resolves).  A
        probe whose caller died without ever reporting (cancelled task,
        operator shutdown mid-call) must not wedge the breaker: after
        another full window in half-open a fresh probe is admitted."""
        now = self._clock()
        if self.state == self.OPEN:
            if now - self._opened_at >= self.reset_s:
                self.state = self.HALF_OPEN
                self._probe_at = now
                return True
            return False
        if self.state == self.HALF_OPEN:
            if now - self._probe_at >= self.reset_s:
                self._probe_at = now
                return True
            return False
        return True

    def can_attempt(self) -> bool:
        """PURE read: would :meth:`allow` admit a call now?  No state
        transition and no probe-token consumption — the router's health
        FILTER asks this about every replica on every route; only the
        caller actually about to dispatch consumes via ``allow()``
        (otherwise routing traffic whose affinity lies elsewhere would
        burn a recovering replica's single half-open probe and starve it
        of readmission)."""
        now = self._clock()
        if self.state == self.OPEN:
            return now - self._opened_at >= self.reset_s
        if self.state == self.HALF_OPEN:
            return now - self._probe_at >= self.reset_s
        return True

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self.state = self.CLOSED

    def record_failure(self) -> bool:
        """Returns True when THIS failure opened (or re-opened) the
        breaker — the caller's cue to count/emit the trip once."""
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self._opened_at = self._clock()
            return True
        self._consecutive_failures += 1
        if (
            self.state == self.CLOSED
            and self._consecutive_failures >= self.failure_threshold
        ):
            self.state = self.OPEN
            self._opened_at = self._clock()
            return True
        return False


class BreakerBoard:
    """One CircuitBreaker per key, created on first use.  Keys are
    provider ids on the pipeline's board and replica ids on the
    router's — same machinery, different granularity."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_s: float = 30.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}

    def remove(self, key: str) -> None:
        """Drop a key's breaker outright (replica left the ring); a
        rejoin under the same id starts closed, like any new replica."""
        self._breakers.pop(key, None)

    def for_key(self, key: str) -> CircuitBreaker:
        breaker = self._breakers.get(key)
        if breaker is None:
            breaker = CircuitBreaker(
                self.failure_threshold, self.reset_s, clock=self._clock
            )
            self._breakers[key] = breaker
        return breaker

    def for_provider(self, provider_id: Optional[str]) -> CircuitBreaker:
        """The pipeline's historical entry point (None → "template")."""
        return self.for_key(provider_id or "template")

    def states(self) -> dict[str, str]:
        return {key: b.state for key, b in self._breakers.items()}
