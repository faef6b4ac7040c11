"""Fleet-wide conservation invariants checked DURING chaos, not after.

The port's own copy of ``operator_tpu/chaos/invariants.py``.

A game day is only as good as its oracle.  Pass/fail on "the run
finished" misses the bugs chaos is for — a leaked KV page, a double
incident, an arrival that silently vanished between shed and settle.
The :class:`InvariantAuditor` holds a catalogue of conservation PROBES
and is checked at two kinds of barrier:

- **commit barriers** — the serving scheduler calls its ``audit_hook``
  after every step's commit window (sched/scheduler.py), the one point
  where page accounting must balance exactly even mid-flight;
- **scenario end** — after drain, when every admitted arrival must have
  reached exactly one terminal outcome and every transient exclusion
  must have healed.

Each probe takes a :class:`GameDayView` — a duck-typed bag of whatever
planes the harness wired up — and returns ``None`` (holds), a detail
dict (VIOLATED), or skips itself when its plane is absent (a probe must
never invent a violation about state it cannot see).  Violations are
counted (``podmortem_invariant_violation``), kept on
:attr:`InvariantAuditor.violations`, and flight-recorded: the auditor
records a synthetic trace and black-boxes it tagged with the scenario
fingerprint + phase, so a violated run leaves the same forensic
artifact a deadline breach does (obs/record.py).

The catalogue (the reference's docs/ROBUSTNESS.md has the prose
contracts):

====================  ==========  ========================================
probe                 barrier     conservation law
====================  ==========  ========================================
kv-page-conservation  any         available + row + store + prefix pages
                                  == num_pages - 1, per scheduler
stream-monotonicity   any         per-request streamed token counts never
                                  decrease
fabric-checksum       any         adopted fabric blocks <= checksum-
                                  verified fetches (nothing adopted
                                  unverified)
arrival-conservation  end         ledger pending == 0; every record
                                  terminal; denominator == admitted
claim-exactly-once    end         no claim left pending; <= 1 status
                                  write per failure
no-permanent-         end         every live replica routable again after
exclusion                         breaker reset
====================  ==========  ========================================
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..obs.sloledger import TERMINAL_OUTCOMES
from ..utils.timing import METRICS


@dataclass(frozen=True)
class Violation:
    """One broken invariant, tagged for the black box."""

    name: str
    at: str  # "barrier" | "end"
    phase: str
    detail: dict

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "at": self.at,
            "phase": self.phase,
            "detail": self.detail,
        }


@dataclass
class GameDayView:
    """What the auditor can see.  Every field is optional — probes skip
    planes the harness did not wire (``None`` field = probe abstains).
    """

    #: obs.sloledger.SLOLedger
    ledger: Optional[Any] = None
    #: arrivals admitted to the ledger (the conservation denominator)
    expected_terminal: Optional[int] = None
    #: operator.claims.ClaimLedger — NOTE take_pending() drains, so the
    #: claim probe is end-only by construction
    claims: Optional[Any] = None
    #: failure-key -> successful Podmortem status writes
    status_write_counts: Optional[dict] = None
    #: serving schedulers exposing page_accounting()
    schedulers: "list[Any]" = field(default_factory=list)
    #: router.core.EngineRouter (health board read via .health)
    router: Optional[Any] = None
    #: replica ids that SHOULD be routable (still fleet members)
    replica_ids: "list[str]" = field(default_factory=list)
    #: utils.timing metrics registry (counter() reads)
    metrics: Optional[Any] = None
    #: request-id -> cumulative streamed token counts, append-only
    streams: Optional[dict] = None


class InvariantAuditor:
    """Run the probe catalogue at barriers; black-box what breaks."""

    def __init__(
        self,
        *,
        recorder: Optional[Any] = None,
        metrics=None,
        fingerprint: str = "",
        scenario: str = "",
    ) -> None:
        self.recorder = recorder
        self.metrics = metrics if metrics is not None else METRICS
        self.fingerprint = fingerprint
        self.scenario = scenario
        self.violations: "list[Violation]" = []
        self.checks = 0
        #: current phase name, set by the conductor as phases trigger so
        #: violations attribute to the act that broke them
        self.phase = ""
        self._seq = itertools.count(1)
        self._probes: "list[tuple[str, str, Callable[[GameDayView], Optional[dict]]]]" = []
        self._register_defaults()

    # -- catalogue -----------------------------------------------------
    def register(
        self,
        name: str,
        probe: Callable[[GameDayView], Optional[dict]],
        *,
        when: str = "any",
    ) -> None:
        """Add a probe.  ``when`` is ``any`` (every barrier) or ``end``
        (scenario end only — for laws that only hold at quiescence)."""
        if when not in ("any", "end"):
            raise ValueError(f"when must be 'any' or 'end', got {when!r}")
        self._probes.append((name, when, probe))

    def _register_defaults(self) -> None:
        self.register("kv-page-conservation", _probe_kv_pages)
        self.register("stream-monotonicity", _probe_stream_monotonic)
        self.register("fabric-checksum-adoption", _probe_fabric_checksum)
        self.register("arrival-conservation", _probe_arrivals, when="end")
        self.register("claim-exactly-once", _probe_claims, when="end")
        self.register(
            "no-permanent-exclusion", _probe_no_exclusion, when="end"
        )

    # -- checking ------------------------------------------------------
    def check(self, view: GameDayView, *, at: str = "barrier") -> "list[Violation]":
        """Run every probe eligible at this barrier; returns (and
        accumulates) the violations found."""
        self.checks += 1
        self.metrics.incr("invariant_check")
        found: "list[Violation]" = []
        for name, when, probe in self._probes:
            if when == "end" and at != "end":
                continue
            detail = probe(view)
            if detail is None:
                continue
            violation = Violation(
                name=name, at=at, phase=self.phase, detail=detail
            )
            found.append(violation)
            self.violations.append(violation)
            self.metrics.incr("invariant_violation", exemplar=name)
            self._black_box(violation)
        return found

    def barrier_hook(self, view_of: Callable[[Any], GameDayView]) -> Callable:
        """Adapt the auditor to the scheduler's ``audit_hook(sched)``
        shape: ``view_of(sched)`` builds the view each barrier."""

        def hook(sched) -> None:
            self.check(view_of(sched), at="barrier")

        return hook

    def report(self) -> dict:
        return {
            "scenario": self.scenario,
            "fingerprint": self.fingerprint,
            "checks": self.checks,
            "violations": [v.to_dict() for v in self.violations],
        }

    # -- forensics -----------------------------------------------------
    def _black_box(self, violation: Violation) -> None:
        """Leave the same artifact a deadline breach does: the recorder
        ring only dumps traces it holds, so record a synthetic trace for
        the violation FIRST, then black-box it (obs/record.py)."""
        if self.recorder is None:
            return
        trace_id = f"invariant-{violation.name}-{next(self._seq)}"
        self.recorder.record(
            {
                "traceId": trace_id,
                "name": f"invariant/{violation.name}",
                "scenario": self.scenario,
                "fingerprint": self.fingerprint,
                "phase": violation.phase,
                "detail": violation.detail,
            }
        )
        self.recorder.black_box(
            trace_id,
            f"invariant-violation:{violation.name}",
            {
                "scenario": self.scenario,
                "fingerprint": self.fingerprint,
                "phase": violation.phase,
                "at": violation.at,
                **violation.detail,
            },
        )


# -- the default probes ------------------------------------------------


def _probe_kv_pages(view: GameDayView) -> Optional[dict]:
    """Every page is exactly one of: free, granted to a row, pinned by
    the prefix cache, or held for the system prefix."""
    bad = []
    for i, sched in enumerate(view.schedulers):
        acct = sched.page_accounting()
        held = (
            acct["available"]
            + acct["row_pages"]
            + acct["store_pages"]
            + acct["prefix_pages"]
        )
        if held != acct["total"]:
            bad.append({"scheduler": i, **acct, "sum": held})
    return {"imbalanced": bad} if bad else None


def _probe_stream_monotonic(view: GameDayView) -> Optional[dict]:
    if not view.streams:
        return None
    bad = {
        rid: counts
        for rid, counts in view.streams.items()
        if any(b < a for a, b in zip(counts, counts[1:]))
    }
    return {"regressed": bad} if bad else None


def _probe_fabric_checksum(view: GameDayView) -> Optional[dict]:
    """Adoption implies verification: prefetch only adopts blocks whose
    checksum round-tripped, so adopted can never exceed verified-ok."""
    if view.metrics is None:
        return None
    adopted = view.metrics.counter("fabric_prefetch_adopted")
    ok = view.metrics.counter("fabric_fetch_ok")
    if adopted > ok:
        return {"adopted": adopted, "fetch_ok": ok}
    return None


def _probe_arrivals(view: GameDayView) -> Optional[dict]:
    """Every admitted arrival reaches EXACTLY ONE terminal outcome: no
    pending stragglers after drain, no non-terminal records, and the
    ledger denominator equals what the harness admitted."""
    ledger = view.ledger
    if ledger is None:
        return None
    detail: dict = {}
    if ledger.pending:
        detail["pending"] = ledger.pending
    records = ledger.records
    non_terminal = [
        r.trace_id for r in records if r.outcome not in TERMINAL_OUTCOMES
    ]
    if non_terminal:
        detail["non_terminal"] = non_terminal[:10]
    if (
        view.expected_terminal is not None
        and len(records) + ledger.pending != view.expected_terminal
    ):
        detail["ledger_total"] = len(records) + ledger.pending
        detail["expected"] = view.expected_terminal
    return detail or None


def _probe_claims(view: GameDayView) -> Optional[dict]:
    detail: dict = {}
    if view.claims is not None:
        leftover = view.claims.take_pending()
        if leftover:
            detail["unresumed_claims"] = [c.key for c in leftover]
    if view.status_write_counts:
        doubled = {
            key: n for key, n in view.status_write_counts.items() if n > 1
        }
        if doubled:
            detail["double_status_writes"] = doubled
    return detail or None


def _probe_no_exclusion(view: GameDayView) -> Optional[dict]:
    """Transient exclusion must heal: after the breaker reset window,
    every replica still in the fleet is routable again.  A replica the
    scenario KILLED is gone from ``replica_ids`` — this is about healed
    peers, not corpses."""
    if view.router is None or not view.replica_ids:
        return None
    health = getattr(view.router, "health", None)
    if health is None:
        return None
    excluded = [
        rid for rid in view.replica_ids if not health.can_route(rid)
    ]
    return {"permanently_excluded": excluded} if excluded else None
