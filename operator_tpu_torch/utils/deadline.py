"""Deadline budgets — end-to-end latency accounting for the analysis path.

The port's own copy of ``operator_tpu/utils/deadline.py``.

The reference's only latency contract is a flat 180 s external-LLM read
budget (application.properties:8-9) applied to one hop.  Here a
:class:`Deadline` is born the moment a pod failure is CLAIMED
(operator/pipeline.py process_failure_group) and flows through every hop:

- log collection gets a SLICE of the remaining budget,
- the pattern parse is capped by the remainder,
- the AI leg gets whatever is left (``AnalysisRequest.deadline_s``), and
- the serving engine's admission layer clamps ``max_tokens`` or rejects
  requests whose roofline decode estimate cannot fit the residual budget
  (serving/admission.py ``deadline_policy``).

The clock is injectable so chaos tests (tests/test_chaos.py, paired with
utils/faultinject.py) replay deterministically without sleeping through
real budgets.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Deadline:
    """A monotonic time budget with stage slicing.

    All arithmetic is on the injected clock (default ``time.monotonic``),
    never wall-clock, so NTP steps and suspend/resume cannot corrupt a
    budget mid-flight.
    """

    __slots__ = ("total_s", "_clock", "_born")

    def __init__(self, total_s: float, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.monotonic
        self.total_s = max(0.0, float(total_s))
        self._born = self._clock()

    @classmethod
    def start(cls, total_s: float, *, clock: Optional[Callable[[], float]] = None) -> "Deadline":
        return cls(total_s, clock)

    def elapsed(self) -> float:
        return self._clock() - self._born

    def remaining(self) -> float:
        return max(0.0, self.total_s - self.elapsed())

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def slice(self, fraction: float, *, floor_s: float = 0.0,
              cap_s: Optional[float] = None) -> float:
        """A stage's share of the REMAINING budget.

        ``fraction`` of what is left, floored at ``floor_s`` (so a nearly
        spent budget still hands the stage a usable window while any budget
        remains) and optionally capped — but never more than the remainder
        itself.  Returns 0.0 once expired.
        """
        remaining = self.remaining()
        share = max(remaining * fraction, floor_s)
        if cap_s is not None:
            share = min(share, cap_s)
        return min(share, remaining)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(total={self.total_s:.3f}s remaining={self.remaining():.3f}s)"
