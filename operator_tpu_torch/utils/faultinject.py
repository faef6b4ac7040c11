"""Deterministic fault-injection harness for chaos tests.

The port's own copy of ``operator_tpu/utils/faultinject.py``: host code, the same names and
behaviour.

A :class:`FaultPlan` is a seeded, DECLARATIVE schedule of faults keyed by
SITE — a dotted string naming a seam, e.g. ``kube.patch_status``,
``kube.watch.Pod``, ``git.clone``, ``http.provider``, ``engine.step``.
Each rule owns an ordered queue of actions consumed one per matching call
through its site; an exhausted rule passes every later call.  Because each
site consumes its own queue in call order, the fired-fault sequence per
site is deterministic regardless of event-loop interleaving across sites —
run the same scenario twice with equal plans and
``plan_a.trace() == plan_b.trace()`` holds byte-identically
(tests/test_chaos.py asserts exactly that).

Seams (each an opt-in ``fault_plan`` attribute, zero cost when ``None``):

- :class:`operator.kubeapi.FakeKubeApi` — every API op
  (``kube.<op>``), watch-stream open (``kube.watch_open.<kind>``) and
  per-event delivery (``kube.watch.<kind>``);
- :class:`operator.patternsync.GitSyncService` — subprocess git verbs
  (``git.clone`` / ``git.fetch`` / ...);
- :class:`operator.providers.OpenAICompatProvider` — each outbound HTTP
  attempt (``http.provider``, ctx ``attempt`` + ``replica``: a rule
  matching one replica id is a replica kill, a rule matching every
  attempt against it is a partition);
- :class:`router.core.EngineRouter` — each routed dispatch attempt
  (``router.dispatch``, ctx ``replica`` + ``attempt``) — the
  transport-agnostic replica-kill/partition seam for the multi-engine
  data plane;
- :class:`serving.engine.BatchedGenerator.step` — the engine step loop
  (``engine.step``: stalls and simulated device errors).

The ``seed`` drives :meth:`FaultPlan.bernoulli` and :meth:`FaultPlan.jitter`
(probabilistic/latency schedules materialised AT BUILD TIME into a fixed
action list), so even randomised plans replay identically.

Beyond fail/drop, plans shape LATENCY: a :func:`delay_` action (or a
seeded :meth:`FaultPlan.jitter` schedule) holds the seam call for its
seconds and then lets it succeed.  Async seams consume the plan through
``await fault_plan.apply_async(site, ...)`` so the hold is an
``asyncio.sleep``, never a blocked event loop; worker-thread seams
``time.sleep`` the value :meth:`FaultPlan.apply` returns.
"""

from __future__ import annotations

import asyncio
import fnmatch
import hashlib
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class FaultAction:
    """One injected behaviour: raise an exception, stall, shape latency,
    or pass."""

    kind: str  # "raise" | "sleep" | "delay" | "ok"
    make: Optional[Callable[[], BaseException]] = None
    seconds: float = 0.0
    label: str = ""

    def fire(self) -> None:
        if self.kind == "raise":
            assert self.make is not None
            raise self.make()
        if self.kind == "sleep":
            # sync seams only (engine step runs on the decode worker
            # thread); async seams should inject errors, not stalls
            time.sleep(self.seconds)

    def __repr__(self) -> str:
        if self.label:
            return f"<{self.kind}:{self.label}>"
        if self.kind in ("sleep", "delay"):
            return f"<{self.kind}:{self.seconds}>"
        return f"<{self.kind}>"


def raise_(factory: Callable[[], BaseException], label: str = "") -> FaultAction:
    """Action that raises ``factory()`` at the seam."""
    return FaultAction("raise", make=factory, label=label or getattr(factory, "__name__", ""))


def sleep_(seconds: float) -> FaultAction:
    """Action that stalls a SYNC seam for ``seconds`` (engine step)."""
    return FaultAction("sleep", seconds=seconds)


def delay_(seconds: float) -> FaultAction:
    """Latency-shaping action: the seam call SUCCEEDS but is held for
    ``seconds`` first.  Unlike :func:`sleep_` the plan never blocks the
    event loop for it — ``apply`` RETURNS the delay and the seam applies
    it in its own idiom (``await fault_plan.apply_async`` on async
    seams, ``time.sleep`` on worker-thread seams)."""
    return FaultAction("delay", seconds=round(float(seconds), 6))


#: explicit no-op entry for readable sequences like [err, OK, err]
OK = FaultAction("ok", label="ok")


def times(n: int, action: FaultAction) -> list[FaultAction]:
    """``n`` consecutive copies of ``action`` (e.g. a 409 storm)."""
    return [action] * n


@dataclass
class _Rule:
    pattern: str
    actions: list[FaultAction]
    after: int = 0  # matching calls let through before consumption starts
    match: Optional[Callable[..., bool]] = None
    seen: int = 0

    def spent(self) -> bool:
        return not self.actions


class FaultPlan:
    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        #: rng for bernoulli(); all draws happen at plan BUILD time so the
        #: materialised action lists — not the draws — drive execution
        self.rng = random.Random(seed)
        self._rules: list[_Rule] = []
        self._trace: list[tuple[str, int, str]] = []
        self._site_seq: dict[str, int] = {}

    # ---- declaration -----------------------------------------------------
    def rule(
        self,
        pattern: str,
        actions: "FaultAction | list[FaultAction]",
        *,
        after: int = 0,
        match: Optional[Callable[..., bool]] = None,
    ) -> "FaultPlan":
        """Declare faults for sites matching ``pattern`` (fnmatch globs:
        ``kube.*`` hits every API op).  ``actions`` are consumed in order,
        one per matching call; ``after=N`` lets the first N matching calls
        through untouched (e.g. drop a watch stream after N events);
        ``match(**ctx)`` further filters on seam context (kind, name, ...).
        Returns self for chaining."""
        if isinstance(actions, FaultAction):
            actions = [actions]
        self._rules.append(_Rule(pattern, list(actions), after=after, match=match))
        return self

    def bernoulli(self, n: int, p: float, action: FaultAction) -> list[FaultAction]:
        """A length-``n`` action list where each entry is ``action`` with
        probability ``p`` (else OK), drawn NOW from the plan's seeded rng —
        a probabilistic schedule that still replays byte-identically."""
        return [action if self.rng.random() < p else OK for _ in range(n)]

    def jitter(self, n: int, lo: float, hi: float) -> list[FaultAction]:
        """A length-``n`` list of :func:`delay_` actions with uniform
        ``[lo, hi)`` seconds drawn NOW from the plan's seeded rng — the
        latency-shaping analogue of :meth:`bernoulli`: jittered tails
        that still replay byte-identically (the drawn values, rounded
        into the action repr, are part of the trace)."""
        return [delay_(self.rng.uniform(lo, hi)) for _ in range(n)]

    # ---- consumption (called from the seams) -----------------------------
    def apply(self, site: str, **ctx) -> float:
        """Consult the plan at a seam; may raise or stall.  Every FIRED
        action is recorded in the trace as (site, per-site call index,
        action repr).

        Returns the latency-shaping delay in seconds (0.0 when no delay
        action fired).  ``delay`` actions are never slept here — the
        seam owns the idiom: async seams ``await`` it via
        :meth:`apply_async`, worker-thread seams ``time.sleep`` the
        returned value.  A seam that ignores the return simply does not
        support latency shaping (the action is still traced)."""
        seq = self._site_seq.get(site, 0)
        self._site_seq[site] = seq + 1
        for rule in self._rules:
            if not fnmatch.fnmatch(site, rule.pattern):
                continue
            if rule.match is not None and not rule.match(**ctx):
                continue
            rule.seen += 1
            if rule.seen <= rule.after:
                continue  # still inside the pass-through window
            if rule.spent():
                continue  # exhausted: later calls pass (or hit later rules)
            action = rule.actions.pop(0)
            self._trace.append((site, seq, repr(action)))
            if action.kind == "delay":
                return action.seconds
            action.fire()
            return 0.0
        return 0.0

    async def apply_async(self, site: str, **ctx) -> None:
        """:meth:`apply` for async seams: a fired ``delay``/``jitter``
        action becomes a non-blocking ``asyncio.sleep`` so latency
        shaping never stalls the event loop.  Raise actions propagate
        exactly as from :meth:`apply`."""
        seconds = self.apply(site, **ctx)
        if seconds > 0:
            await asyncio.sleep(seconds)

    # ---- replay verification --------------------------------------------
    def trace(self) -> list[tuple[str, int, str]]:
        """Ordered (site, per-site call index, action) of every fired
        fault.  Two runs of one scenario with equal plans produce equal
        traces — the determinism contract chaos tests assert."""
        return list(self._trace)

    def fingerprint(self) -> str:
        """Stable hash of the trace for compact replay assertions."""
        basis = "\n".join(f"{s}#{i}:{a}" for s, i, a in self._trace)
        return hashlib.sha256(basis.encode()).hexdigest()

    def pending(self) -> dict[str, int]:
        """Unconsumed actions per rule pattern — lets a test assert its
        whole plan actually fired (a chaos test whose faults never hit
        their seams is vacuously green)."""
        out: dict[str, int] = {}
        for rule in self._rules:
            if rule.actions:
                out[rule.pattern] = out.get(rule.pattern, 0) + len(rule.actions)
        return out
