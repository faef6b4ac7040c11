"""Game-day conductor: run one :class:`ChaosScenario` end to end.

The port's own copy of ``operator_tpu/chaos/conductor.py``.  It drives
``SyntheticReplica``s and runs no serving kernel; the storm stack's
pattern engine and incident memory run on ``device`` (``cuda`` unless
the caller asks for another).

The conductor materialises a scenario into a live harness — the full
storm stack (loadgen/storm.py: FakeKubeApi -> AnalysisPipeline ->
EngineRouter -> synthetic replicas) plus three planes storms alone do
not exercise:

- a **fabric plane**: a seeded :class:`FabricIndex` of per-replica KV
  block inventories and a :class:`FabricFetcher` over an in-memory
  transport.  Recall-hot arrivals fetch a block before submitting, so
  ``fabric.fetch`` injections and the consecutive-failure decay path
  run under load; a KILLED replica's transport goes black-hole
  (timeouts, never 404 — the exact case index decay exists for).
- a **watch plane**: a background consumer of ``api.watch("Pod")`` so
  ``kube.watch_open.* / kube.watch.*`` drop/expire injections hit a
  live stream that must re-establish.
- a **leadership plane** (``scenario.leadership``): a real
  :class:`LeaseElector` pair against the stack's apiserver; arrivals
  route through ``process_failure_group`` (the claim ledger), and a
  ``depose_leader`` action is a graceful handover — release, standby
  acquires, ``resume_pending`` on the survivor.

Determinism contract (see chaos/scenario.py): injections live in ONE
compiled FaultPlan consumed per-site in call order; fleet actions fire
immediately before their phase's trigger ARRIVAL INDEX; every
probabilistic draw happened at compile time.  The scenario fingerprint
is materialisation identity — the CI gameday gate builds each scenario
twice and asserts fingerprint equality, then requires zero invariant
violations on both runs.

The :class:`InvariantAuditor` (chaos/invariants.py) is wired in
always-on: checked every ``BARRIER_EVERY`` arrivals mid-storm and once
at scenario end; violations black-box through the flight recorder
tagged with fingerprint + phase.

The ``mutation`` hook exists to prove the oracle: ``mutation =
"drop-settle-on-conflict"`` suppresses exactly one SLO-ledger settle
once a ``kube.patch_status`` conflict injection has fired, so a
scenario containing a 409 injection MUST produce an
arrival-conservation violation — the auditor-fires test and the
shrinker's failing predicate (chaos/shrink.py) both stand on it.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Optional

import numpy as np
import torch

from ..fabric.fetch import FabricFetcher
from ..fabric.index import FabricIndex
from ..fabric.wire import encode_block
from ..loadgen.arrivals import ArrivalEvent, ArrivalProcess
from ..loadgen.driver import run_open_loop
from ..loadgen.storm import SyntheticReplica, build_storm_stack, storm_log, storm_pod
from ..operator.kubeapi import WatchClosed
from ..operator.lease import LeaseElector
from ..utils.config import OperatorConfig
from ..utils.timing import METRICS
from .invariants import GameDayView, InvariantAuditor
from .scenario import ChaosScenario, FleetAction

#: run the "any"-barrier probes every N submitted arrivals (the serving
#: scheduler's commit-barrier hook covers the per-step cadence when a
#: real engine is in the fleet; this is the fleet-level heartbeat)
BARRIER_EVERY = 16

#: blocks advertised per initial replica in the fabric plane
BLOCKS_PER_REPLICA = 3

#: breaker reset applied to the storm router so "transient exclusion
#: must heal" is checkable within a compressed game day
BREAKER_RESET_S = 0.2


def _fabric_inventory(
    scenario: ChaosScenario,
) -> "dict[str, list[tuple[str, bytes]]]":
    """Deterministic per-replica block inventory: hash -> encoded wire
    payload, derived only from the scenario seed (part of no fingerprint
    — it is a pure function of inputs that already are)."""
    inventory: "dict[str, list[tuple[str, bytes]]]" = {}
    for i, _role in enumerate(scenario.fleet):
        rid = f"storm-replica-{i}"
        blocks = []
        for j in range(BLOCKS_PER_REPLICA):
            digest = hashlib.sha256(
                f"gameday:{scenario.seed}:{rid}:{j}".encode()
            ).digest()[:16]
            rng = np.random.default_rng(int.from_bytes(digest[:8], "big"))
            k = rng.standard_normal((2, 4), dtype=np.float32)
            v = rng.standard_normal((2, 4), dtype=np.float32)
            blocks.append((digest.hex(), encode_block(
                digest, torch.from_numpy(k), torch.from_numpy(v))))
        inventory[rid] = blocks
    return inventory


class _FabricPlane:
    """Index + fetcher over an in-memory transport; killed replicas
    black-hole (hang until the budget times out, never 404)."""

    def __init__(self, scenario: ChaosScenario, *, metrics, fault_plan) -> None:
        self.inventory = _fabric_inventory(scenario)
        self.dead: "set[str]" = set()
        self.index = FabricIndex()
        self._payloads: "dict[tuple[str, str], bytes]" = {}
        for rid, blocks in self.inventory.items():
            self.index.update(
                rid, [h for h, _ in blocks], url=f"fabric://{rid}"
            )
            for block_hash, payload in blocks:
                self._payloads[(rid, block_hash)] = payload
        #: every advertised hash, sorted — the recall-hot pick space
        self.all_blocks = sorted(
            {h for blocks in self.inventory.values() for h, _ in blocks}
        )
        self.fetcher = FabricFetcher(
            self.index,
            timeout_s=0.5,
            self_id="gameday-conductor",
            metrics=metrics,
            fault_plan=fault_plan,
            transport=self._transport,
        )

    async def _transport(self, url: str, budget_s: float) -> "tuple[int, bytes]":
        rid, _, rest = url.removeprefix("fabric://").partition("/")
        if rid in self.dead:
            # a black-holed peer never answers: the fetch burns its
            # budget and times out (the decay path, not the 404 path)
            await asyncio.sleep(max(0.0, budget_s))
            raise asyncio.TimeoutError(f"fabric peer {rid} black-holed")
        block_hash = rest.rsplit("/", 1)[-1]
        payload = self._payloads.get((rid, block_hash))
        if payload is None:
            return 404, b""
        return 200, payload

    async def touch(self, event: ArrivalEvent) -> None:
        """A recall-hot arrival warms one block over the fabric before
        its analysis — the deterministic stand-in for admission-time
        prefetch (pick rotates by arrival index)."""
        if not self.all_blocks:
            return
        block_hash = self.all_blocks[event.index % len(self.all_blocks)]
        await self.fetcher.fetch_block(block_hash, budget_s=0.25)


class _LeadershipPlane:
    """A live lease pair over the stack's apiserver.  ``a`` leads from
    the start; ``depose`` is the graceful half of failover — release,
    standby acquires, pending claims resume on the survivor.  (The
    SIGKILL half — abandon without release — is the leader tests'
    harness; a game day needs the fleet to keep serving through the
    handover, which the graceful path exercises under full load.)"""

    def __init__(self, stack, *, metrics) -> None:
        self.stack = stack
        self.stop = asyncio.Event()
        self.leader_id = "conductor-a"
        self._tasks: "dict[str, asyncio.Task]" = {}
        self.electors = {
            name: LeaseElector(
                stack.api,
                lease_name="gameday-leader",
                namespace=stack.namespace,
                identity=name,
                duration_s=2.0,
                renew_period_s=0.05,
                retry_period_s=0.05,
                metrics=metrics,
            )
            for name in ("conductor-a", "conductor-b")
        }

    async def start(self) -> None:
        a = self.electors["conductor-a"]
        self._tasks["conductor-a"] = asyncio.create_task(a.run(self.stop))
        await asyncio.wait_for(a.wait_leading(self.stop), timeout=10.0)
        b = self.electors["conductor-b"]
        self._tasks["conductor-b"] = asyncio.create_task(b.run(self.stop))

    async def depose(self) -> str:
        """Graceful handover to the standby; returns the new leader.

        The old leader's contention loop stops before its release: a
        loop still renewing writes its holder back onto the blanked lease
        at its next tick, and the standby then waits for a lease that
        never frees (the JAX conductor releases under a live loop and
        loses that race in some runs).  The deposed replica then contends
        again, as the standby."""
        old = self.leader_id
        new = "conductor-b" if old == "conductor-a" else "conductor-a"
        task = self._tasks.pop(old)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await self.electors[old].release()
        await asyncio.wait_for(
            self.electors[new].wait_leading(self.stop), timeout=10.0
        )
        self.leader_id = new
        self._tasks[old] = asyncio.create_task(self.electors[old].run(self.stop))
        # the new leader adopts the old one's in-flight claims — under a
        # graceful handover there are usually none pending, and that is
        # the exactly-once point: resume must not double-analyze
        await self.stack.pipeline.resume_pending()
        return new

    async def close(self) -> None:
        self.stop.set()
        for task in self._tasks.values():
            task.cancel()
        await asyncio.gather(*self._tasks.values(), return_exceptions=True)


async def _watch_plane(api, namespace: str, metrics) -> None:
    """Consume the Pod watch stream forever, re-establishing on drops —
    the live stream ``kube.watch_open.* / kube.watch.*`` injections need
    to have something to break."""
    while True:
        try:
            async for _event in api.watch("Pod", namespace=namespace):
                metrics.incr("chaos_watch_event")
        except asyncio.CancelledError:
            raise
        except WatchClosed:
            metrics.incr("chaos_watch_reopen")
        except Exception:
            metrics.incr("chaos_watch_reopen")
        await asyncio.sleep(0.01)


async def run_scenario(
    scenario: ChaosScenario,
    *,
    mutation: Optional[str] = None,
    ledger_path: Optional[str] = None,
    claims_path: Optional[str] = None,
    recorder: Optional[Any] = None,
    auditor: Optional[InvariantAuditor] = None,
    metrics=None,
    device: Any = None,
) -> dict:
    """Materialise and drive ``scenario``; returns the game-day report
    (driver accounting, SLO snapshot, fired-fault trace fingerprint,
    applied actions, and the auditor's verdict)."""
    metrics = metrics if metrics is not None else METRICS
    fingerprint = scenario.fingerprint()
    plan, _compiled = scenario.compile_plan()
    if auditor is None:
        auditor = InvariantAuditor(
            recorder=recorder,
            metrics=metrics,
            fingerprint=fingerprint,
            scenario=scenario.name,
        )
    else:
        auditor.fingerprint = fingerprint
        auditor.scenario = scenario.name
    metrics.incr("chaos_scenario", exemplar=scenario.name)

    replicas = [
        SyntheticReplica(
            f"storm-replica-{i}", time_scale=scenario.time_scale, role=role
        )
        for i, role in enumerate(scenario.fleet)
    ]
    config = OperatorConfig(
        pattern_cache_directory="/nonexistent",
        conflict_backoff_base_s=0.001,
        memory_enabled=True,
        claims_path=claims_path,
    )
    stack = await build_storm_stack(
        replicas=replicas,
        config=config,
        metrics=metrics,
        ledger_path=ledger_path,
        time_scale=scenario.time_scale,
        deadline_factor=scenario.deadline_factor,
        namespace="gameday",
        fault_plan=plan,
        disaggregate=scenario.disaggregate,
        device=device,
    )
    # compressed game day: exclusion must HEAL within the run, so the
    # breaker reset window shrinks with it (set before any breaker is
    # minted — BreakerBoard passes board values at for_key time)
    stack.backend.router.health.breakers.reset_s = BREAKER_RESET_S

    fabric = _FabricPlane(scenario, metrics=metrics, fault_plan=plan)
    watch_task = asyncio.create_task(
        _watch_plane(stack.api, stack.namespace, metrics)
    )

    leadership = None
    wants_leadership = scenario.leadership or any(
        action.kind == "depose_leader"
        for phase in scenario.phases
        for action in phase.actions
    )
    if wants_leadership:
        leadership = _LeadershipPlane(stack, metrics=metrics)
        await leadership.start()

    if mutation == "drop-settle-on-conflict":
        _arm_mutation(stack, plan, metrics)
    elif mutation is not None:
        raise ValueError(f"unknown mutation {mutation!r}")

    # -- fleet actions, keyed to arrival index ---------------------------
    phase_queue = sorted(scenario.phases, key=lambda p: (p.at_arrival, p.name))
    applied: "list[dict]" = []
    state = {"submitted": 0}

    async def apply_action(action: FleetAction) -> None:
        metrics.incr("chaos_action", exemplar=action.kind)
        entry: dict = {"kind": action.kind, "phase": auditor.phase}
        if action.kind == "kill_replica":
            live = sorted(stack.backend.replicas)
            rid = action.replica or (live[-1] if live else "")
            if rid in stack.backend.replicas:
                stack.backend.remove_replica(rid)
            fabric.dead.add(rid)
            entry["replica"] = rid
        elif action.kind == "add_replica":
            rid = action.replica or f"gameday-scale-{len(applied)}"
            stack.backend.add_replica(
                SyntheticReplica(
                    rid, time_scale=scenario.time_scale, role=action.role
                )
            )
            entry["replica"] = rid
        elif action.kind == "depose_leader":
            if leadership is not None:
                entry["leader"] = await leadership.depose()
        applied.append(entry)

    def make_view(*, expected: Optional[int] = None) -> GameDayView:
        return GameDayView(
            ledger=stack.ledger,
            expected_terminal=expected,
            claims=(stack.pipeline.claims if wants_leadership else None),
            router=stack.backend.router,
            replica_ids=sorted(stack.backend.replicas),
            metrics=metrics,
        )

    async def submit(event: ArrivalEvent) -> None:
        while phase_queue and event.index >= phase_queue[0].at_arrival:
            phase = phase_queue.pop(0)
            auditor.phase = phase.name
            metrics.incr("chaos_phase", exemplar=phase.name)
            for action in phase.actions:
                await apply_action(action)
        if event.recall_hot:
            await fabric.touch(event)
        state["submitted"] += 1
        # capture the ordinal NOW: by the time the analysis await below
        # resumes, every other in-flight submit has bumped the counter
        # and a post-await read would skip (almost) every barrier
        ordinal = state["submitted"]
        # materialise the failing pod IN the apiserver (stack.submit only
        # passes the object) so the watch plane sees one event per
        # arrival — kube.create and kube.watch.* seams run under load
        pod = storm_pod(event, namespace=stack.namespace)
        try:
            await stack.api.create("Pod", pod.to_dict())
        except Exception:
            pass  # an injected create fault must not lose the arrival
        if wants_leadership:
            stack.api.set_pod_log(
                stack.namespace, pod.metadata.name, storm_log(event)
            )
            await stack.pipeline.process_failure_group(
                pod, [stack.podmortem],
                failure_time=f"storm-t{event.index}",
            )
        else:
            await stack.submit(event)
        if ordinal % BARRIER_EVERY == 0:
            auditor.check(make_view(), at="barrier")

    process = ArrivalProcess(scenario.arrivals, scenario.seed)
    try:
        report = await run_open_loop(
            submit, process,
            time_scale=scenario.time_scale, drain_s=scenario.drain_s,
        )
        # any breaker opened by the last injections still needs its
        # reset window to lapse before "exclusion healed" is checkable
        await asyncio.sleep(BREAKER_RESET_S + 0.05)
        # a clean drain is the only state where the ledger denominator
        # is exact; with cancelled arrivals the end probe still checks
        # pending==0 + terminality, just not the count
        expected = (
            state["submitted"]
            if report.get("drained") and not report.get("cancelled_at_drain")
            else None
        )
        auditor.phase = "end"
        auditor.check(make_view(expected=expected), at="end")
    finally:
        watch_task.cancel()
        await asyncio.gather(watch_task, return_exceptions=True)
        if leadership is not None:
            await leadership.close()
        stack.close()

    return {
        "scenario": scenario.name,
        "seed": scenario.seed,
        "fingerprint": fingerprint,
        "driver": report,
        "slo": stack.ledger.snapshot(),
        "violations": [v.to_dict() for v in auditor.violations],
        "invariant_checks": auditor.checks,
        "fault_trace_len": len(plan.trace()),
        "fault_fingerprint": plan.fingerprint(),
        "pending_faults": plan.pending(),
        "actions": applied,
        "fabric": fabric.index.stats(),
        "leader": (leadership.leader_id if leadership is not None else None),
    }


def _arm_mutation(stack, plan, metrics) -> None:
    """The deliberate bug behind the auditor-fires / shrinker tests:
    once any ``kube.patch_status`` conflict injection has FIRED, drop
    exactly one SLO-ledger settle.  Keyed to the fired-fault trace (per
    -site call order), so whether a scenario fails is a deterministic
    function of its injection set — exactly the predicate ddmin needs.
    """
    original_finish = stack.ledger.finish
    dropped = {"done": False}

    def finish(trace_id: str, **kwargs):
        if not dropped["done"] and any(
            site == "kube.patch_status" and "conflict" in action
            for site, _seq, action in plan.trace()
        ):
            dropped["done"] = True
            metrics.incr("chaos_mutation_dropped_settle")
            return None
        return original_finish(trace_id, **kwargs)

    stack.ledger.finish = finish
