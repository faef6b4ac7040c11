"""Value-aware overload control: shed-lowest-value-first, degrade-before-reject.

The port's own copy of ``operator_tpu/router/value.py`` (the value model
and the overload ladder the continuous scheduler's admission reads).

One value model for every point the stack can drop work (router shed,
scheduler queue eviction, admission clamp, supervisor requeue):

    value = f(SLO class, residual deadline, recall-hit probability)

DeepServe (arxiv 2501.14417) argues SLO-attainment signals must drive
admission, not just reporting; FailSafe (arxiv 2511.14116) argues resilient
serving degrades output quality before dropping requests.  Both disciplines
land here:

* **shed-lowest-value-first** — every shed site scores its candidates with
  the SAME model and drops the minimum-score request, so the router, the
  scheduler and the supervisor never disagree about who goes first;
* **degrade-before-reject** — above the shed line a ladder fires in order:
  truncate analysis depth (reduced ``max_tokens``, ``finish_reason:
  "degraded"``), then reject cold before recalled, and NEVER shed the SLO
  class already below its attainment target (fed live from
  ``obs/sloledger.py`` per-class attainment).

A recalled incident costs ~:data:`RECALL_COST_FRACTION` of a cold analysis
(memory/recall.py reuses the stored explanation), so the recall-hit
probability is an admission signal: a recalled request's expected cost is a
few percent of a cold one, which multiplies its value/cost score by ~25 —
structurally guaranteeing "recalled shed only after all cold requests of
equal-or-lower class" without a special case in the shed loop.

Everything in this module is pure and replay-deterministic (GL007): no
wall clocks, no ambient randomness — residual deadlines and queue pressure
are passed in by the caller, so the same seeded storm replays to a
byte-identical decision log.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "RECALL_COST_FRACTION",
    "RequestValue",
    "ValueModel",
    "OverloadPolicy",
    "OverloadVerdict",
    "ShedDecisionLog",
]

#: a recall hit replays a stored explanation instead of running a cold
#: analysis — measured at ~4% of the cold cost (prefill of the fingerprint
#: probe only), so expected cost = 1 - 0.96 * P(hit)
RECALL_COST_FRACTION = 0.04


@dataclass(frozen=True)
class RequestValue:
    """One request's scored admission value (pure data, no clocks).

    ``score`` is value per unit expected cost: class weight x deadline
    feasibility / expected cost fraction.  ``protected`` marks the request
    as belonging to an SLO class currently below its attainment target —
    the ladder never sheds those.
    """

    slo_class: str
    weight: float
    #: min(1, residual_s / target_s): 1.0 = whole budget left, 0.0 = spent.
    #: A request whose deadline is already blown has zero value — shedding
    #: it first is free goodput.
    feasibility: float
    recall_p: float
    protected: bool = False

    @property
    def expected_cost(self) -> float:
        return 1.0 - (1.0 - RECALL_COST_FRACTION) * self.recall_p

    @property
    def score(self) -> float:
        if self.feasibility <= 0.0:
            return 0.0
        return self.weight * self.feasibility / max(self.expected_cost, 1e-9)


class ValueModel:
    """Scores requests for the overload ladder.

    ``classes`` maps SLO class -> latency target seconds (the parsed
    ``slo_classes`` config).  Class weights are rank-based powers of 4 in
    order of tightening target (loosest first): with the default
    ``interactive:2,standard:30,batch:120`` that is batch=1, standard=4,
    interactive=16.  The spacing is chosen so a recalled request of class c
    (score ~ weight x 1/0.04 = 25x) always outranks EVERY cold request of
    class <= c, making "reject cold before recalled" fall out of plain
    min-score shedding.

    ``attainment`` is a live callable returning per-class attainment
    fractions (obs/sloledger.py ``attainment_by_class``); classes below
    ``attainment_target`` are protected from shedding.  When every known
    class is below target (total overload — someone must give), the class
    with the HIGHEST attainment loses its protection so the ladder cannot
    deadlock.
    """

    def __init__(
        self,
        classes: Mapping[str, float],
        *,
        attainment: Optional[Callable[[], Mapping[str, Optional[float]]]] = None,
        attainment_target: float = 0.9,
    ) -> None:
        self.classes: Dict[str, float] = {
            str(k): float(v) for k, v in classes.items()
        }
        self.attainment = attainment
        self.attainment_target = float(attainment_target)
        # loosest target first -> weight 4^rank; ties broken by name so the
        # ranking (and therefore every downstream shed decision) is stable
        # across replays regardless of dict insertion order
        ranked = sorted(
            self.classes.items(), key=lambda kv: (-kv[1], kv[0])
        )
        self.weights: Dict[str, float] = {
            name: float(4 ** rank) for rank, (name, _t) in enumerate(ranked)
        }

    def weight(self, slo_class: Optional[str]) -> float:
        if slo_class is None or slo_class not in self.weights:
            # unknown classes score as the loosest (cheapest to shed)
            return min(self.weights.values(), default=1.0)
        return self.weights[slo_class]

    def target_s(self, slo_class: Optional[str]) -> Optional[float]:
        if slo_class is None:
            return None
        return self.classes.get(slo_class)

    def protected_classes(self) -> "frozenset[str]":
        """Classes currently below their attainment target (never shed).

        Anti-deadlock waiver: when EVERY class with known attainment is
        below target and more than one is known, the best-attaining class
        is un-protected — total overload means someone must absorb the
        shed, and the least-behind class hurts least.
        """
        if self.attainment is None:
            return frozenset()
        att = self.attainment() or {}
        known = {
            c: a for c, a in att.items() if a is not None and c in self.classes
        }
        below = {c for c, a in known.items() if a < self.attainment_target}
        if below and len(known) > 1 and below == set(known):
            spare = max(below, key=lambda c: (known[c], c))
            below.discard(spare)
        return frozenset(below)

    def value(
        self,
        *,
        slo_class: Optional[str] = None,
        residual_s: Optional[float] = None,
        recall_p: float = 0.0,
        protected: Optional[bool] = None,
    ) -> RequestValue:
        """Score one request.  ``residual_s`` is the remaining deadline
        budget in seconds (None = no deadline -> feasibility 1.0); the
        caller derives it from ITS clock so this stays wall-clock-free."""
        cls = slo_class or "default"
        target = self.target_s(slo_class)
        if residual_s is None or target is None or target <= 0:
            feasibility = 1.0
        else:
            feasibility = min(1.0, max(0.0, residual_s / target))
        if protected is None:
            protected = cls in self.protected_classes()
        return RequestValue(
            slo_class=cls,
            weight=self.weight(slo_class),
            feasibility=feasibility,
            recall_p=max(0.0, min(1.0, float(recall_p))),
            protected=bool(protected),
        )


class ShedDecisionLog:
    """Bounded, byte-comparable record of every shed/degrade decision.

    Lines are canonical (fixed field order, rounded scores) so two replays
    of the same seeded storm compare with ``==`` on :meth:`text` — the
    GL007 determinism proof surface.  Bounded at ``cap`` lines with a
    dropped-counter so a runaway storm cannot eat the heap.
    """

    def __init__(self, cap: int = 4096) -> None:
        self.cap = int(cap)
        self._lines: List[str] = []
        self.dropped = 0

    def record(
        self,
        *,
        site: str,
        request_id: str,
        value: RequestValue,
        action: str,
        reason: str,
        cutoff: float,
    ) -> None:
        line = (
            f"site={site} id={request_id} cls={value.slo_class} "
            f"action={action} reason={reason} "
            f"score={round(value.score, 6)} cutoff={round(cutoff, 6)} "
            f"recalled={1 if value.recall_p > 0.5 else 0} "
            f"protected={1 if value.protected else 0}"
        )
        if len(self._lines) >= self.cap:
            self.dropped += 1
            return
        self._lines.append(line)

    def lines(self) -> List[str]:
        return list(self._lines)

    def text(self) -> str:
        return "\n".join(self._lines) + ("\n" if self._lines else "")

    def clear(self) -> None:
        self._lines.clear()
        self.dropped = 0


@dataclass(frozen=True)
class OverloadVerdict:
    """What the ladder says to do with one request at one site."""

    action: str  # "serve" | "degrade" | "shed"
    reason: str
    value: RequestValue
    cutoff: float
    #: fraction of the original max_tokens a degraded request keeps
    degrade_tokens_frac: float = 1.0


class OverloadPolicy:
    """The degradation ladder, shared by every shed site.

    Pressure is the caller's unitless load signal (router: queue depth +
    inflight per replica; scheduler: queued + running rows).  The ladder:

    * ``pressure < degrade_pressure`` — serve untouched;
    * ``degrade_pressure <= pressure < shed_pressure`` — DEGRADE: serve
      with ``max_tokens`` scaled by ``degrade_tokens_frac`` (truncate
      analysis depth before rejecting anything);
    * ``pressure >= shed_pressure`` — SHED the request iff its score falls
      below ``cutoff = shed_value_floor * pressure / shed_pressure`` (the
      bar rises with overload) AND its class is not protected; protected
      or above-cutoff requests are degraded instead, never dropped.

    Decisions are appended to :attr:`log` and counted into ``metrics``
    (``shed{reason,slo_class}`` / ``degraded{slo_class}`` labeled
    counters) — the observability surface docs/METRICS.md documents.
    """

    def __init__(
        self,
        model: ValueModel,
        *,
        shed_pressure: float = 8.0,
        degrade_pressure: Optional[float] = None,
        degrade_tokens_frac: float = 0.25,
        shed_value_floor: float = 1.0,
        metrics=None,
        log: Optional[ShedDecisionLog] = None,
    ) -> None:
        self.model = model
        self.shed_pressure = max(1.0, float(shed_pressure))
        if degrade_pressure is None:
            degrade_pressure = max(1.0, self.shed_pressure / 2.0)
        self.degrade_pressure = max(1.0, float(degrade_pressure))
        self.degrade_tokens_frac = float(degrade_tokens_frac)
        self.shed_value_floor = float(shed_value_floor)
        self.metrics = metrics
        self.log = log if log is not None else ShedDecisionLog()

    def cutoff(self, pressure: float) -> float:
        """The shed bar at this pressure: rises linearly past the shed
        line, so deeper overload sheds progressively higher-value work
        (smooth decay, not a cliff)."""
        return self.shed_value_floor * (float(pressure) / self.shed_pressure)

    def decide(
        self,
        value: RequestValue,
        pressure: float,
        *,
        site: str = "router",
        request_id: str = "",
    ) -> OverloadVerdict:
        pressure = float(pressure)
        cutoff = self.cutoff(pressure)
        if pressure < self.degrade_pressure:
            return OverloadVerdict(
                action="serve", reason="under-pressure", value=value,
                cutoff=cutoff,
            )
        if pressure < self.shed_pressure:
            verdict = OverloadVerdict(
                action="degrade", reason="pressure-band", value=value,
                cutoff=cutoff, degrade_tokens_frac=self.degrade_tokens_frac,
            )
        elif value.protected:
            verdict = OverloadVerdict(
                action="degrade", reason="class-protected", value=value,
                cutoff=cutoff, degrade_tokens_frac=self.degrade_tokens_frac,
            )
        elif value.score >= cutoff:
            verdict = OverloadVerdict(
                action="degrade", reason="above-cutoff", value=value,
                cutoff=cutoff, degrade_tokens_frac=self.degrade_tokens_frac,
            )
        else:
            verdict = OverloadVerdict(
                action="shed", reason="below-cutoff", value=value,
                cutoff=cutoff,
            )
        self._account(verdict, site=site, request_id=request_id)
        return verdict

    def pick_eviction(
        self, candidates: Iterable[Tuple[str, RequestValue]]
    ) -> Optional[Tuple[str, RequestValue]]:
        """Lowest-score non-protected candidate, or None when every
        candidate is protected (the queue must grow instead).  Ties break
        on the id so replayed storms evict the same victim."""
        best: Optional[Tuple[str, RequestValue]] = None
        for rid, value in candidates:
            if value.protected:
                continue
            if best is None or (value.score, rid) < (best[1].score, best[0]):
                best = (rid, value)
        return best

    def record_eviction(
        self, rid: str, value: RequestValue, *, pressure: float,
        site: str = "sched",
    ) -> None:
        verdict = OverloadVerdict(
            action="shed", reason="queue-evict", value=value,
            cutoff=self.cutoff(pressure),
        )
        self._account(verdict, site=site, request_id=rid)

    def _account(
        self, verdict: OverloadVerdict, *, site: str, request_id: str
    ) -> None:
        self.log.record(
            site=site, request_id=request_id, value=verdict.value,
            action=verdict.action, reason=verdict.reason,
            cutoff=verdict.cutoff,
        )
        if self.metrics is None:
            return
        cls = verdict.value.slo_class
        if verdict.action == "shed":
            self.metrics.incr(
                "shed", labels={"reason": verdict.reason, "slo_class": cls}
            )
        elif verdict.action == "degrade":
            self.metrics.incr("degraded", labels={"slo_class": cls})
