"""Declarative game-day scenarios: composed fleet-wide chaos from one seed.

The port's own copy of ``operator_tpu/chaos/scenario.py``: the same
JSON, the same compiled plan and so the same fingerprint for a scenario.

A :class:`ChaosScenario` is the unit a game day runs, shrinks, and
commits as a regression: an arrival shape (:class:`ArrivalSpec`), a
fleet layout, and an ordered list of :class:`Phase`\\ s, each carrying

- **injections** — faults addressed by REGISTERED SEAM NAME (the
  ``fault_plan`` seams the repo's lint rule GL012 audits: ``kube.*``,
  ``router.dispatch``, ``fabric.fetch``, ``http.provider``,
  ``engine.step``, ...), expressed in the :class:`FaultPlan` vocabulary
  extended with latency shaping (``delay``/``jitter``), and
- **fleet actions** — structural events no seam can express: kill a
  replica, add one (a scale event), depose the leader.

Determinism is the whole design.  Two different clocks exist in a run —
the arrival clock (scaled wall time) and each seam's CALL COUNTER — and
only the second is reproducible, so the two halves of a phase bind to
different triggers:

- **Injections are compiled into ONE FaultPlan at build time.**  Every
  probabilistic draw (jitter values, bernoulli picks) happens during
  :meth:`ChaosScenario.compile_plan` from the scenario seed, and each
  rule consumes per-site in call order; ``after=N`` call windows — not
  wall offsets — place a fault "later".  The per-site fired sequence is
  identical across runs regardless of event-loop interleaving.
- **Fleet actions trigger on ARRIVAL INDEX** (``Phase.at_arrival``):
  the conductor applies a phase's actions immediately before submitting
  arrival ``at_arrival``.  The arrival sequence is itself materialised
  from the seed, so "kill r1 at arrival 40" replays exactly even when
  wall time does not.

The scenario **fingerprint** is sha256 over the scenario dict, the
materialised arrival schedule, and the compiled plan rules — the same
materialisation-identity discipline as ``ArrivalSpec.fingerprint``.
Equal fingerprints mean the run is built from byte-identical inputs;
the CI gameday gate asserts fingerprint identity across two builds plus
zero invariant violations on both runs.

Scenarios round-trip through JSON (:meth:`to_json` / :meth:`from_json`)
so a shrunk minimal reproducer is a runnable artifact
(``LOADGEN_SCENARIO=repro.json python -m operator_tpu_torch.loadgen``), and
:meth:`with_injections` re-derives a scenario from an injection subset —
the ddmin hook the shrinker (chaos/shrink.py) reduces over.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..loadgen.arrivals import ArrivalProcess, ArrivalSpec
from ..operator.kubeapi import (
    ApiError,
    ConflictError,
    NotFoundError,
    WatchClosed,
    WatchExpired,
)
from ..utils import faultinject
from ..utils.faultinject import FaultPlan

#: named error factories an injection may raise — names, not callables,
#: so scenarios serialise to JSON and replay from it.  Keep in sync with
#: the reference's docs/ROBUSTNESS.md scenario-schema table.
ERRORS: dict = {
    "conflict": lambda: ConflictError("chaos: injected 409"),
    "api-500": lambda: ApiError("chaos: injected apiserver 500", 500),
    "not-found": lambda: NotFoundError("chaos: injected 404"),
    "watch-closed": lambda: WatchClosed("chaos: watch dropped"),
    "watch-expired": lambda: WatchExpired("chaos: resourceVersion expired"),
    "timeout": lambda: TimeoutError("chaos: injected timeout"),
    "connection": lambda: ConnectionError("chaos: connection refused"),
    "runtime": lambda: RuntimeError("chaos: injected fault"),
}

#: fleet action kinds the conductor knows how to apply
ACTION_KINDS = ("kill_replica", "add_replica", "depose_leader")


@dataclass(frozen=True)
class Injection:
    """One seam-addressed fault.

    ``kind``:

    - ``fail`` — raise ``ERRORS[error]`` at the seam, ``count`` times;
    - ``delay`` — hold the seam call ``seconds`` then succeed, ``count``
      times (never blocks the event loop — see faultinject.delay_);
    - ``jitter`` — ``count`` seeded uniform ``[low, seconds)`` delays
      drawn at compile time.

    ``after`` skips that many matching calls first (a call window, the
    deterministic stand-in for "later in the run").  ``match`` narrows
    by seam context, compared stringly so it survives JSON: a partition
    of replica r1 is ``Injection("router.dispatch", "fail",
    error="connection", count=999, match=(("replica", "r1"),))``.
    """

    seam: str
    kind: str = "fail"
    count: int = 1
    after: int = 0
    error: str = "runtime"
    seconds: float = 0.0
    low: float = 0.0
    match: "tuple[tuple[str, str], ...]" = ()

    def __post_init__(self) -> None:
        if self.kind not in ("fail", "delay", "jitter"):
            raise ValueError(f"unknown injection kind {self.kind!r}")
        if self.kind == "fail" and self.error not in ERRORS:
            raise ValueError(
                f"unknown error {self.error!r}; known: {sorted(ERRORS)}"
            )

    def to_dict(self) -> dict:
        out: dict = {"seam": self.seam, "kind": self.kind}
        if self.count != 1:
            out["count"] = self.count
        if self.after:
            out["after"] = self.after
        if self.kind == "fail":
            out["error"] = self.error
        else:
            out["seconds"] = self.seconds
            if self.kind == "jitter":
                out["low"] = self.low
        if self.match:
            out["match"] = {k: v for k, v in self.match}
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "Injection":
        match = tuple(
            sorted((str(k), str(v)) for k, v in (data.get("match") or {}).items())
        )
        return cls(
            seam=data["seam"],
            kind=data.get("kind", "fail"),
            count=int(data.get("count", 1)),
            after=int(data.get("after", 0)),
            error=data.get("error", "runtime"),
            seconds=float(data.get("seconds", 0.0)),
            low=float(data.get("low", 0.0)),
            match=match,
        )

    def matcher(self) -> Optional[Callable[..., bool]]:
        if not self.match:
            return None
        pairs = self.match

        def _match(**ctx) -> bool:
            return all(str(ctx.get(k)) == v for k, v in pairs)

        return _match

    def compile_into(self, plan: FaultPlan) -> dict:
        """Append this injection's rule to ``plan``; returns the
        compiled-rule dict that feeds the scenario fingerprint (jitter
        values are drawn HERE, so they are part of the fingerprint)."""
        if self.kind == "fail":
            actions = faultinject.times(
                self.count, faultinject.raise_(ERRORS[self.error], self.error)
            )
            compiled = {"actions": [self.error] * self.count}
        elif self.kind == "delay":
            actions = faultinject.times(
                self.count, faultinject.delay_(self.seconds)
            )
            compiled = {"actions": [repr(a) for a in actions]}
        else:  # jitter: seeded draws happen NOW, from the plan rng
            actions = plan.jitter(self.count, self.low, self.seconds)
            compiled = {"actions": [repr(a) for a in actions]}
        plan.rule(self.seam, actions, after=self.after, match=self.matcher())
        compiled.update(
            {"seam": self.seam, "after": self.after, "match": dict(self.match)}
        )
        return compiled


@dataclass(frozen=True)
class FleetAction:
    """A structural fleet event applied at the owning phase's trigger
    arrival: ``kill_replica`` / ``add_replica`` (scale events against
    the serving backend) or ``depose_leader`` (graceful lease handover +
    claim resume on the standby)."""

    kind: str
    replica: str = ""
    role: str = "mixed"

    def __post_init__(self) -> None:
        if self.kind not in ACTION_KINDS:
            raise ValueError(
                f"unknown action kind {self.kind!r}; known: {ACTION_KINDS}"
            )

    def to_dict(self) -> dict:
        out: dict = {"kind": self.kind}
        if self.replica:
            out["replica"] = self.replica
        if self.role != "mixed":
            out["role"] = self.role
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "FleetAction":
        return cls(
            kind=data["kind"],
            replica=data.get("replica", ""),
            role=data.get("role", "mixed"),
        )


@dataclass(frozen=True)
class Phase:
    """One act of the scenario: fleet ``actions`` fire immediately
    before arrival ``at_arrival`` is submitted; ``injections`` are
    compiled into the run's single FaultPlan at build time (their
    placement is their ``after`` call window, not the phase trigger —
    the phase is documentation + black-box attribution for them)."""

    name: str
    at_arrival: int = 0
    injections: "tuple[Injection, ...]" = ()
    actions: "tuple[FleetAction, ...]" = ()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "at_arrival": self.at_arrival,
            "injections": [i.to_dict() for i in self.injections],
            "actions": [a.to_dict() for a in self.actions],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Phase":
        return cls(
            name=data["name"],
            at_arrival=int(data.get("at_arrival", 0)),
            injections=tuple(
                Injection.from_dict(i) for i in data.get("injections", ())
            ),
            actions=tuple(
                FleetAction.from_dict(a) for a in data.get("actions", ())
            ),
        )


@dataclass(frozen=True)
class ChaosScenario:
    """A full game day: arrivals + fleet layout + phased chaos.

    ``fleet`` is the synthetic replica roles to start with (length =
    initial fleet size); ``leadership`` routes submissions through the
    claim ledger under a live lease pair so ``depose_leader`` has a
    leader to depose (it is implied when any phase deposes).
    """

    name: str
    seed: int = 0
    arrivals: ArrivalSpec = field(default_factory=ArrivalSpec)
    phases: "tuple[Phase, ...]" = ()
    fleet: "tuple[str, ...]" = ("mixed", "mixed")
    disaggregate: bool = False
    leadership: bool = False
    time_scale: float = 0.02
    drain_s: float = 30.0
    deadline_factor: float = 4.0

    # -- serialisation -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "arrivals": self.arrivals.to_dict(),
            "phases": [p.to_dict() for p in self.phases],
            "fleet": list(self.fleet),
            "disaggregate": self.disaggregate,
            "leadership": self.leadership,
            "time_scale": self.time_scale,
            "drain_s": self.drain_s,
            "deadline_factor": self.deadline_factor,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ChaosScenario":
        spec_data = dict(data.get("arrivals", {}))
        if "class_mix" in spec_data:
            spec_data["class_mix"] = tuple(
                (str(n), float(w)) for n, w in spec_data["class_mix"]
            )
        return cls(
            name=data["name"],
            seed=int(data.get("seed", 0)),
            arrivals=ArrivalSpec(**spec_data),
            phases=tuple(Phase.from_dict(p) for p in data.get("phases", ())),
            fleet=tuple(data.get("fleet", ("mixed", "mixed"))),
            disaggregate=bool(data.get("disaggregate", False)),
            leadership=bool(data.get("leadership", False)),
            time_scale=float(data.get("time_scale", 0.02)),
            drain_s=float(data.get("drain_s", 30.0)),
            deadline_factor=float(data.get("deadline_factor", 4.0)),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ChaosScenario":
        return cls.from_dict(json.loads(text))

    # -- shrinking surface ---------------------------------------------
    def injections(self) -> "list[Injection]":
        """All injections in phase order — the flat index space ddmin
        (chaos/shrink.py) reduces over."""
        return [i for phase in self.phases for i in phase.injections]

    def with_injections(self, indices: "list[int]") -> "ChaosScenario":
        """The same scenario keeping only the injections at ``indices``
        (into :meth:`injections` order).  Phases and fleet actions are
        preserved so the structural context of a shrunk repro is intact;
        empty phases stay as named markers."""
        keep = set(indices)
        phases = []
        cursor = 0
        for phase in self.phases:
            kept_list = []
            for inj in phase.injections:
                if cursor in keep:
                    kept_list.append(inj)
                cursor += 1
            kept = tuple(kept_list)
            phases.append(
                Phase(
                    name=phase.name,
                    at_arrival=phase.at_arrival,
                    injections=kept,
                    actions=phase.actions,
                )
            )
        return ChaosScenario(
            name=self.name,
            seed=self.seed,
            arrivals=self.arrivals,
            phases=tuple(phases),
            fleet=self.fleet,
            disaggregate=self.disaggregate,
            leadership=self.leadership,
            time_scale=self.time_scale,
            drain_s=self.drain_s,
            deadline_factor=self.deadline_factor,
        )

    # -- compilation ---------------------------------------------------
    def compile_plan(self) -> "tuple[FaultPlan, list[dict]]":
        """Materialise every injection into one seeded FaultPlan.  All
        probabilistic draws happen here; the returned compiled-rule
        list is the fingerprint's record of them."""
        plan = FaultPlan(seed=self.seed)
        compiled = [
            inj.compile_into(plan)
            for phase in self.phases
            for inj in phase.injections
        ]
        return plan, compiled

    def fingerprint(self) -> str:
        """sha256 over the scenario, its materialised arrival schedule,
        and its compiled plan — materialisation identity, the same
        discipline as ``ArrivalProcess.fingerprint``.  Equal
        fingerprints = the run is driven by byte-identical inputs."""
        _, compiled = self.compile_plan()
        basis = {
            "scenario": self.to_dict(),
            "arrivals": ArrivalProcess(self.arrivals, self.seed).fingerprint(),
            "plan": compiled,
        }
        return hashlib.sha256(
            json.dumps(basis, sort_keys=True).encode()
        ).hexdigest()
