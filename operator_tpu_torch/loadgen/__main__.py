"""CI chaos smoke: ``python -m operator_tpu_torch.loadgen``.

Runs a short compressed failure storm through the full in-process
operator→router→serving stack (synthetic replicas, no device) and FAILS
LOUDLY unless:

- the open-loop record is populated (arrivals landed, the ledger settled
  every one of them — admitted == terminal, nothing leaked pending);
- the ledger journal has ZERO torn lines (every line parses back);
- the arrival schedule replays byte-identically (two independent
  materialisations, equal fingerprints).

With ``LOADGEN_OVERLOAD=1`` it instead runs the 2×-collapse overload
pass (router/value.py, docs/ROBUSTNESS.md "Degradation ladder"):
``storm.simulate_overload`` replays the seeded arrival schedule against
a virtual-clock queue through the PRODUCTION ``OverloadPolicy`` /
``ValueModel`` — deterministic by construction, so the gate means the
same thing on an idle laptop and a thrashing CI runner (a live-stack
gate flakes both ways: a fast host never overloads, a contended one
cliffs on wall-clock targets regardless of the ladder).  The sweep runs
0.5×..2× around the collapse rate (``LOADGEN_COLLAPSE_RATE_PER_MIN``,
default 900) and is gated on

- NO-CLIFF decay: total and per-class attainment between adjacent
  sweep points never drops more than ``LOADGEN_MAX_ATTAINMENT_STEP``;
- ZERO value-shed events in any protected class (below its attainment
  target at decision time) anywhere in the sweep;
- the ladder actually engaged at 2× (degraded or shed something) —
  a sweep that never overloads would make both gates hollow;
- byte-identical replay: the 2× point re-run with the same seed must
  reproduce the identical result row and decision-log sha256 (GL007).

``LOADGEN_DISAGG=1`` runs the prefill/decode disaggregation smoke (a
one-prefill, two-decode synthetic fleet, every analysis as two legs
through ``fabric/disagg.py:disaggregated_dispatch``); ``LOADGEN_GAMEDAY=1``
the game-day matrix through the chaos conductor (``chaos/``): the
builtin scenarios reseeded by ``LOADGEN_SEED`` and every committed repro
under ``tests/scenarios/*.json``, or the one ``LOADGEN_SCENARIO`` names,
with ``LOADGEN_MUTATION`` arming the auditor's self-test.

The storm's pattern engine and incident memory run on ``--device``
(``cuda`` unless the caller asks for another, e.g. ``--device cpu``).

Exit code 0 = all gates green; 1 = a gate failed (printed to stderr).
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import sys
import tempfile

from .arrivals import ArrivalProcess, ArrivalSpec
from .storm import (
    SyntheticReplica,
    build_storm_stack,
    run_storm,
    simulate_overload,
)


def _fail(msg: str) -> None:
    print(f"loadgen smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


async def _main(device: str | None) -> None:
    seed = int(os.environ.get("LOADGEN_SEED", "0") or 0)
    spec = ArrivalSpec(
        name="storm",
        rate_per_min=float(os.environ.get("LOADGEN_SMOKE_RATE_PER_MIN", "240")),
        duration_s=float(os.environ.get("LOADGEN_SMOKE_DURATION_S", "5")),
        burst_factor=4.0,
        burst_every_s=2.0,
        burst_len_s=0.5,
    )
    process = ArrivalProcess(spec, seed=seed)

    # gate 3 first (cheap): an independent second materialisation of the
    # same (spec, seed) must replay byte-identically
    replay = ArrivalProcess(spec, seed=seed)
    if process.fingerprint() != replay.fingerprint():
        _fail("arrival schedule is not replay-identical for one (spec, seed)")
    if [e.to_dict() for e in process.materialize()] != [
        e.to_dict() for e in replay.materialize()
    ]:
        _fail("fingerprints matched but materialised events differ")

    with tempfile.TemporaryDirectory(prefix="loadgen-smoke-") as tmp:
        ledger_path = os.path.join(tmp, "slo-ledger.jsonl")
        stack = await build_storm_stack(
            # undersized on purpose: the smoke should see real queueing,
            # not an idle system
            replicas=[
                SyntheticReplica("smoke-replica-0", concurrency=2,
                                 time_scale=0.2),
                SyntheticReplica("smoke-replica-1", concurrency=2,
                                 time_scale=0.2),
            ],
            time_scale=0.2,
            ledger_path=ledger_path,
            device=device,
        )
        report = await run_storm(stack, process, drain_s=20.0)
        stack.close()

        # gate 1: populated open-loop record, every arrival settled
        if report["arrivals"] <= 0:
            _fail("storm produced no arrivals")
        total = report["slo"]["total"]
        if total["admitted"] != report["arrivals"] - report["cancelled_at_drain"]:
            _fail(
                f"ledger admitted {total['admitted']} != "
                f"{report['arrivals']} arrivals - "
                f"{report['cancelled_at_drain']} cancelled"
            )
        if report["slo"]["pending"] != 0:
            _fail(f"{report['slo']['pending']} records leaked pending")
        if total["attainment"] is None:
            _fail("open_loop record has null attainment")
        if not report["slo"]["classes"]:
            _fail("no per-class rows in the SLO summary")

        # gate 2: zero torn ledger lines — every journaled line parses
        with open(ledger_path) as fh:
            raw_lines = [line for line in fh if line.strip()]
        parsed = 0
        for line in raw_lines:
            try:
                json.loads(line)
                parsed += 1
            except ValueError:
                _fail(f"torn ledger line: {line[:80]!r}")
        if parsed != total["admitted"]:
            _fail(f"journal has {parsed} lines, ledger settled {total['admitted']}")

    print(json.dumps({
        "arrivals": report["arrivals"],
        "offered_per_min": report["offered_per_min"],
        "achieved_per_min": report["achieved_per_min"],
        "attainment": total["attainment"],
        "shed": total["shed"],
        "deadline_exceeded": total["deadline_exceeded"],
        "goodput_analyses_per_min": total["goodput_analyses_per_min"],
        "fingerprint": report["fingerprint"][:16],
        "journal_lines": parsed,
    }, indent=2))
    print("loadgen smoke: OK")


async def _disagg_main(device: str | None) -> None:
    """The prefill/decode disaggregation smoke (LOADGEN_DISAGG=1).

    A seeded storm runs against a 1-prefill + 2-decode synthetic fleet
    with the backend in disaggregated dispatch: every analysis is a
    prefill leg routed role=prefill plus a decode leg routed
    role=decode (fabric/disagg.py).  Gates: byte-identical arrival
    replay (two independent materialisations), every arrival settled
    with nothing leaked pending and zero torn ledger lines, the
    disaggregation actually happened (handoff counter fired, the
    prefill replica served prefill legs, the decode replicas served
    decode legs), and the fleet rollup carries the per-role tiers the
    autoscaler keys on."""
    seed = int(os.environ.get("LOADGEN_SEED", "0") or 0)
    time_scale = 0.2
    spec = ArrivalSpec(
        name="disagg",
        rate_per_min=float(
            os.environ.get("LOADGEN_DISAGG_RATE_PER_MIN", "240")
        ),
        duration_s=float(os.environ.get("LOADGEN_DISAGG_DURATION_S", "4")),
        burst_factor=3.0,
        burst_every_s=2.0,
        burst_len_s=0.5,
    )
    process = ArrivalProcess(spec, seed=seed)

    # replay gate first: two independent materialisations of the same
    # (spec, seed) must be byte-identical
    replay = ArrivalProcess(spec, seed=seed)
    if process.fingerprint() != replay.fingerprint():
        _fail("disagg arrival schedule is not replay-identical")
    if [e.to_dict() for e in process.materialize()] != [
        e.to_dict() for e in replay.materialize()
    ]:
        _fail("fingerprints matched but materialised events differ")

    with tempfile.TemporaryDirectory(prefix="loadgen-disagg-") as tmp:
        ledger_path = os.path.join(tmp, "slo-ledger.jsonl")
        fleet = [
            SyntheticReplica("disagg-prefill-0", concurrency=2,
                             time_scale=time_scale, role="prefill"),
            SyntheticReplica("disagg-decode-0", concurrency=2,
                             time_scale=time_scale, role="decode"),
            SyntheticReplica("disagg-decode-1", concurrency=2,
                             time_scale=time_scale, role="decode"),
        ]
        stack = await build_storm_stack(
            replicas=fleet, time_scale=time_scale,
            ledger_path=ledger_path, disaggregate=True, device=device,
        )
        report = await run_storm(stack, process, drain_s=20.0)
        stack.close()

        # gate: populated record, every arrival settled, nothing pending
        if report["arrivals"] <= 0:
            _fail("disagg storm produced no arrivals")
        total = report["slo"]["total"]
        if total["admitted"] != report["arrivals"] - report["cancelled_at_drain"]:
            _fail(
                f"ledger admitted {total['admitted']} != "
                f"{report['arrivals']} arrivals - "
                f"{report['cancelled_at_drain']} cancelled"
            )
        if report["slo"]["pending"] != 0:
            _fail(f"{report['slo']['pending']} records leaked pending")
        if total["attainment"] is None:
            _fail("disagg storm record has null attainment")

        # gate: zero torn ledger lines
        with open(ledger_path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                try:
                    json.loads(line)
                except ValueError:
                    _fail(f"torn ledger line: {line[:80]!r}")

        # gate: disaggregation actually happened, on the right tiers
        handoffs = stack.metrics.counter("fabric_disagg_handoff")
        if handoffs <= 0:
            _fail("no fabric_disagg_handoff recorded — the backend never "
                  "split a request into prefill+decode legs")
        prefill_replica, *decode_replicas = fleet
        if prefill_replica.served_by_phase.get("prefill", 0) <= 0:
            _fail("the prefill replica served no prefill legs")
        if sum(r.served_by_phase.get("decode", 0)
               for r in decode_replicas) <= 0:
            _fail("the decode replicas served no decode legs")
        # role preference, not filter: prefill legs stay OFF the decode
        # tier while the prefill replica is healthy (and vice versa)
        if any(r.served_by_phase.get("prefill", 0) > 0
               for r in decode_replicas) and \
                prefill_replica.served_by_phase.get("decode", 0) > 0:
            _fail("both tiers crossed roles despite healthy exact-role "
                  "candidates — role preference is not being applied")

        # gate: the fleet rollup carries per-role tiers
        roles = (report["fleet"].get("fleet") or {}).get("roles") or {}
        if "prefill" not in roles or "decode" not in roles:
            _fail(f"fleet rollup missing role tiers: {sorted(roles)}")
        if roles["prefill"]["replicas"] != 1 or roles["decode"]["replicas"] != 2:
            _fail(f"role tier shape wrong: {roles}")

    print(json.dumps({
        "arrivals": report["arrivals"],
        "attainment": total["attainment"],
        "goodput_analyses_per_min": total["goodput_analyses_per_min"],
        "handoffs": handoffs,
        "prefill_legs": prefill_replica.served_by_phase,
        "decode_legs": [r.served_by_phase for r in decode_replicas],
        "fingerprint": report["fingerprint"][:16],
    }, indent=2))
    print("loadgen disagg: OK")


async def _elastic_main(device: str | None) -> None:
    """The scale-to-zero-and-back elastic smoke (LOADGEN_ELASTIC=1).

    The fleet starts at ZERO replicas.  A seeded storm arrives; the
    autoscaler (operator/autoscale.py) sees the pending admissions and
    scales the fake Deployment up through the scale subresource; a tiny
    in-process "deployment controller" turns spec.replicas into Endpoints
    addresses; the endpoint watch (router/discovery.py) turns those into
    live ring members serving the very arrivals that woke the fleet.
    When the storm drains, the idle window elapses and the fleet scales
    back to zero.  Gates: byte-identical arrival replay (twice), every
    arrival settled with zero torn ledger lines, the fleet actually made
    the 0→N→0 round trip, and the membership/autoscale counters fired.
    """
    from ..operator.autoscale import AutoscaleController
    from ..router.discovery import EndpointDiscovery

    seed = int(os.environ.get("LOADGEN_SEED", "0") or 0)
    time_scale = 0.2
    spec = ArrivalSpec(
        name="elastic",
        rate_per_min=float(os.environ.get("LOADGEN_ELASTIC_RATE_PER_MIN", "300")),
        duration_s=float(os.environ.get("LOADGEN_ELASTIC_DURATION_S", "4")),
        burst_factor=3.0,
        burst_every_s=2.0,
        burst_len_s=0.5,
    )
    process = ArrivalProcess(spec, seed=seed)

    # replay gate first: two independent materialisations of the same
    # (spec, seed) must be byte-identical — the elastic storm is as
    # replayable as the static one
    replay = ArrivalProcess(spec, seed=seed)
    if process.fingerprint() != replay.fingerprint():
        _fail("elastic arrival schedule is not replay-identical")
    if [e.to_dict() for e in process.materialize()] != [
        e.to_dict() for e in replay.materialize()
    ]:
        _fail("fingerprints matched but materialised events differ")

    with tempfile.TemporaryDirectory(prefix="loadgen-elastic-") as tmp:
        ledger_path = os.path.join(tmp, "slo-ledger.jsonl")
        # replicas=[] — the fleet REALLY starts empty (scale-from-zero)
        stack = await build_storm_stack(
            replicas=[], time_scale=time_scale, ledger_path=ledger_path,
            device=device,
        )
        api, backend, ns = stack.api, stack.backend, stack.namespace
        deployment = "podmortem-serving"
        await api.create("Deployment", {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": deployment, "namespace": ns},
            "spec": {"replicas": 0},
        })
        await api.create("Endpoints", {
            "apiVersion": "v1", "kind": "Endpoints",
            "metadata": {"name": deployment, "namespace": ns},
            "subsets": [],
        })

        class RingAdapter:
            """EngineRouter facade for the discovery loop: a joining
            endpoint becomes a live synthetic replica in the storm
            backend (which pulses the wake event arrivals wait on)."""

            def add(self, replica) -> None:
                backend.add_replica(SyntheticReplica(
                    replica.id, concurrency=2, time_scale=time_scale,
                ))

            def remove(self, replica_id: str) -> None:
                backend.remove_replica(replica_id)

        discovery = EndpointDiscovery(
            api, RingAdapter(), service=deployment, namespace=ns,
            kube_timeout_s=5.0, restart_delay_s=0.05,
        )
        autoscaler = AutoscaleController(
            api, deployment=deployment, namespace=ns,
            min_replicas=0, max_replicas=4, target_pressure=4.0,
            idle_s=0.5, interval_s=0.05, kube_timeout_s=5.0,
            fleet=lambda: backend.fleet_view()["fleet"],
            attainment=stack.ledger.attainment_by_class,
            pending=lambda: stack.ledger.pending,
            metrics=stack.metrics,
        )

        stop = asyncio.Event()
        peak = 0

        async def actuate() -> None:
            # the in-process "deployment controller": spec.replicas
            # becomes ready Endpoints addresses, like kubelets turning
            # pods Ready behind the headless Service
            known = -1
            while not stop.is_set():
                try:
                    scale = await api.get_scale("Deployment", deployment, ns)
                    desired = int(scale["spec"]["replicas"])
                    if desired != known:
                        subsets = [{
                            "addresses": [
                                {"ip": f"10.0.0.{i + 1}"}
                                for i in range(desired)
                            ],
                            "ports": [{"name": "http", "port": 8000}],
                        }] if desired else []
                        await api.patch("Endpoints", deployment, ns,
                                        {"subsets": subsets})
                        known = desired
                except Exception:  # noqa: BLE001 - reconcile again next tick
                    pass
                await asyncio.sleep(0.03)

        async def monitor() -> None:
            nonlocal peak
            while not stop.is_set():
                peak = max(peak, len(backend.router))
                await asyncio.sleep(0.02)

        tasks = [asyncio.create_task(coro) for coro in (
            discovery.run(stop), autoscaler.run(stop), actuate(), monitor(),
        )]
        settled_to_zero = False
        try:
            report = await run_storm(stack, process, drain_s=20.0)
            # the round trip's back half: idle window elapses, the fleet
            # scales to zero and the ring empties (bounded wait, no gate
            # on exact timing)
            for _ in range(300):
                scale = await api.get_scale("Deployment", deployment, ns)
                if (int(scale["spec"]["replicas"]) == 0
                        and len(backend.router) == 0):
                    settled_to_zero = True
                    break
                await asyncio.sleep(0.05)
        finally:
            stop.set()
            api.close_watches()  # unblocks the discovery watch stream
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        stack.close()

        # gate: every arrival settled, nothing leaked, nothing torn
        if report["arrivals"] <= 0:
            _fail("elastic storm produced no arrivals")
        total = report["slo"]["total"]
        if total["admitted"] != report["arrivals"] - report["cancelled_at_drain"]:
            _fail(
                f"ledger admitted {total['admitted']} != "
                f"{report['arrivals']} arrivals - "
                f"{report['cancelled_at_drain']} cancelled"
            )
        if report["slo"]["pending"] != 0:
            _fail(f"{report['slo']['pending']} records leaked pending")
        with open(ledger_path) as fh:
            raw_lines = [line for line in fh if line.strip()]
        parsed = 0
        for line in raw_lines:
            try:
                json.loads(line)
                parsed += 1
            except ValueError:
                _fail(f"torn ledger line: {line[:80]!r}")
        if parsed != total["admitted"]:
            _fail(f"journal has {parsed} lines, ledger settled "
                  f"{total['admitted']}")

        # gate: the fleet made the 0→N→0 round trip
        if peak < 1:
            _fail("fleet never scaled up from zero (peak membership 0)")
        if not settled_to_zero:
            _fail("fleet never scaled back to zero after the storm drained")
        counters = stack.metrics.snapshot()["counters"]
        for name in ("autoscale_up", "autoscale_to_zero",
                     "ring_member_added", "ring_member_removed"):
            if counters.get(name, 0) < 1:
                _fail(f"counter {name} never fired (got "
                      f"{counters.get(name, 0)})")

    print(json.dumps({
        "arrivals": report["arrivals"],
        "attainment": total["attainment"],
        "attainment_by_class": report["overload"]["attainment_by_class"]
        if report.get("overload") else None,
        "peak_fleet": peak,
        "scaled_to_zero": settled_to_zero,
        "autoscale_up": counters.get("autoscale_up", 0),
        "autoscale_down": counters.get("autoscale_down", 0),
        "autoscale_to_zero": counters.get("autoscale_to_zero", 0),
        "ring_member_added": counters.get("ring_member_added", 0),
        "ring_member_removed": counters.get("ring_member_removed", 0),
        "fingerprint": report["fingerprint"][:16],
        "journal_lines": parsed,
    }, indent=2))
    print("loadgen elastic: OK")


def _engaged(row: dict) -> bool:
    return bool(row["shed_total"] or row["degraded_total"])


def _overload_main() -> None:
    """The 2×-collapse overload pass (LOADGEN_OVERLOAD=1).

    Pure virtual-time simulation (storm.simulate_overload) riding the
    production value ladder — no event loop, no wall clocks, so the
    gates below hold identically on any machine under any load."""
    seed = int(os.environ.get("LOADGEN_SEED", "0") or 0)
    duration = float(os.environ.get("LOADGEN_OVERLOAD_DURATION_S", "60"))
    max_step = float(os.environ.get("LOADGEN_MAX_ATTAINMENT_STEP", "0.15"))
    collapse = float(
        os.environ.get("LOADGEN_COLLAPSE_RATE_PER_MIN", "") or 900.0
    )

    rows: "list[dict]" = []
    for factor in (0.5, 0.75, 1.0, 1.5, 2.0):
        row = simulate_overload(
            collapse * factor, seed=seed, duration_s=duration,
        )
        row["factor"] = factor
        rows.append(row)

    # gate 1: NO-CLIFF — attainment decays smoothly across the sweep
    for prev, cur in zip(rows, rows[1:]):
        pairs = [("total", prev["attainment"], cur["attainment"])]
        for cls, prev_att in prev["attainment_by_class"].items():
            pairs.append((cls, prev_att, cur["attainment_by_class"].get(cls)))
        for name, a, b in pairs:
            if a is None or b is None:
                continue
            if a - b > max_step:
                _fail(
                    f"attainment CLIFF for {name}: {a} at "
                    f"{prev['factor']}x -> {b} at {cur['factor']}x "
                    f"(max smooth step {max_step})"
                )

    # gate 2: the ladder never value-shed a class that was protected at
    # decision time, anywhere in the sweep (the sim counts these causally)
    for row in rows:
        if row["protected_shed"]:
            _fail(
                f"{row['protected_shed']} protected-class requests were "
                f"value-shed at {row['factor']}x "
                f"({row['rate_per_min']:.0f}/min)"
            )

    # gate 3: the ladder ENGAGED at 2x — otherwise gates 1-2 are hollow
    peak = rows[-1]
    if not _engaged(peak):
        _fail(
            "overload ladder never fired at 2x collapse "
            f"({peak['rate_per_min']:.0f}/min) — raise "
            "LOADGEN_COLLAPSE_RATE_PER_MIN"
        )

    # gate 4: byte-identical replay of the 2x point (GL007) — same seed,
    # same knobs, identical result row INCLUDING the decision-log sha256
    replay = simulate_overload(
        collapse * 2.0, seed=seed, duration_s=duration,
    )
    replay["factor"] = 2.0
    if replay != peak:
        drift = [
            k for k in sorted(set(peak) | set(replay))
            if peak.get(k) != replay.get(k)
        ]
        _fail(f"2x overload replay is not byte-identical: {drift} differ")

    for row in rows:
        row.pop("decision_log", None)  # sha is printed; the text is bulky
    print(json.dumps(rows, indent=2))
    print("loadgen overload: OK")


async def _gameday_main(device: str | None) -> None:
    """``LOADGEN_GAMEDAY=1``: the seeded game-day matrix.

    Runs each scenario through the chaos conductor
    (``chaos/``) and fails loudly unless, per scenario:

    - BUILD determinism: an independent second build and a JSON
      round-trip both produce the identical fingerprint — the replay
      contract a committed repro depends on;
    - the invariant auditor recorded ZERO violations across its commit
      barriers and the scenario-end sweep;
    - every injection fired (``pending_faults == {}``) — a rule the run
      never consumed is a renamed seam or a dead phase window, and a
      gate that ignores it quietly stops rehearsing that failure.  A
      seam whose every injection is match-scoped (``Injection.match``,
      e.g. the composed storm's partition of one replica) must fire at
      least once: how many calls reach one replica depends on its
      breaker and load, so on wall-clock interleaving, and its leftover
      below the declared count is reported (``pending_match_scoped``),
      not failed.  The JAX lane's gate also fails on that leftover, in
      some runs on a CPU host;
    - arrivals landed and every submit drained without error.

    Scenario selection: the builtin matrix (``chaos/library.py``,
    reseeded by ``LOADGEN_SEED``) plus every committed repro under
    ``tests/scenarios/*.json``; ``LOADGEN_SCENARIO=<file.json>`` runs
    that one file instead — the replay path printed by the shrinker.
    ``LOADGEN_MUTATION=<name>`` arms a mutation lane (the auditor
    self-test), inverting the violation gate: the run must violate.
    """
    from ..chaos import ChaosScenario, run_scenario
    from ..chaos.library import builtin_scenarios
    from ..utils.timing import MetricsRegistry

    seed = int(os.environ.get("LOADGEN_SEED", "0") or 0)
    mutation = os.environ.get("LOADGEN_MUTATION") or None
    single = os.environ.get("LOADGEN_SCENARIO") or None

    # (scenario, source, rebuild): rebuild() is the INDEPENDENT second
    # build the fingerprint-identity gate compares against
    jobs = []
    if single:
        try:
            with open(single, encoding="utf-8") as fh:
                text = fh.read()
            scenario = ChaosScenario.from_json(text)
        except (OSError, ValueError, KeyError) as exc:
            _fail(f"cannot load LOADGEN_SCENARIO={single}: {exc}")
        jobs.append((
            scenario, single,
            lambda text=text: ChaosScenario.from_json(text),
        ))
    else:
        for i, scenario in enumerate(builtin_scenarios(seed)):
            jobs.append((
                scenario, "builtin",
                lambda i=i: builtin_scenarios(seed)[i],
            ))
        scen_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "tests", "scenarios",
        )
        if os.path.isdir(scen_dir):
            for name in sorted(os.listdir(scen_dir)):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(scen_dir, name)
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                try:
                    scenario = ChaosScenario.from_json(text)
                except (ValueError, KeyError) as exc:
                    _fail(f"committed scenario {name} does not load: {exc}")
                jobs.append((
                    scenario, f"tests/scenarios/{name}",
                    lambda text=text: ChaosScenario.from_json(text),
                ))

    rows = []
    for scenario, source, rebuild in jobs:
        where = f"{scenario.name} ({source})"
        if rebuild().fingerprint() != scenario.fingerprint():
            _fail(f"{where}: two builds disagree on the fingerprint")
        round_trip = ChaosScenario.from_json(scenario.to_json())
        if round_trip.fingerprint() != scenario.fingerprint():
            _fail(f"{where}: JSON round-trip changes the fingerprint")

        report = await run_scenario(
            scenario, mutation=mutation, metrics=MetricsRegistry(),
            device=device,
        )
        violated = [v["name"] for v in report["violations"]]
        if mutation is None and violated:
            _fail(
                f"{where}: invariant violation(s) {violated} — black-boxed "
                "by the flight recorder; shrink the scenario to a minimal "
                "repro with operator_tpu_torch.chaos.shrink"
            )
        if mutation is not None and not violated:
            _fail(
                f"{where}: mutation `{mutation}` armed but no invariant "
                "fired — the auditor is asleep"
            )
        scoped = {i.seam for i in scenario.injections() if i.match} - {
            i.seam for i in scenario.injections() if not i.match}
        declared = collections.Counter()
        for inj in scenario.injections():
            declared[inj.seam] += inj.count
        pending = report["pending_faults"]
        unfired = {site: n for site, n in pending.items()
                   if site not in scoped or n >= declared[site]}
        if unfired:
            _fail(
                f"{where}: injections never fired: "
                f"{unfired} — renamed seam or dead "
                "phase window"
            )
        driver = report["driver"]
        if not driver["arrivals"]:
            _fail(f"{where}: no arrivals landed")
        if driver["submit_errors"] or driver["cancelled_at_drain"]:
            _fail(
                f"{where}: {driver['submit_errors']} submit error(s), "
                f"{driver['cancelled_at_drain']} cancelled at drain"
            )
        rows.append({
            "scenario": scenario.name,
            "source": source,
            "seed": scenario.seed,
            "fingerprint": report["fingerprint"],
            "arrivals": driver["arrivals"],
            "completed": report["slo"]["total"]["completed"],
            "invariant_checks": report["invariant_checks"],
            "violations": violated,
            "fault_trace_len": report["fault_trace_len"],
            "pending_match_scoped": {site: n for site, n in pending.items() if site in scoped},
            "actions": len(report["actions"]),
        })

    print(json.dumps(rows, indent=2))
    print("loadgen gameday: OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m operator_tpu_torch.loadgen")
    parser.add_argument("--device", default=None,
                        help="device of the pattern engine and incident memory (default cuda)")
    device = parser.parse_args().device
    if os.environ.get("LOADGEN_OVERLOAD", "0") == "1":
        _overload_main()
    elif os.environ.get("LOADGEN_ELASTIC", "0") == "1":
        asyncio.run(_elastic_main(device))
    elif os.environ.get("LOADGEN_DISAGG", "0") == "1":
        asyncio.run(_disagg_main(device))
    elif os.environ.get("LOADGEN_GAMEDAY", "0") == "1":
        asyncio.run(_gameday_main(device))
    else:
        asyncio.run(_main(device))
