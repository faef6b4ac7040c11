"""The builtin game-day matrix: the port's own copy of
``operator_tpu/chaos/library.py``, the same scenarios and seeds.

Three composed scenarios the CI gameday smoke runs
(``LOADGEN_GAMEDAY=1 python -m operator_tpu_torch.loadgen``), gated on zero
invariant violations and two-build fingerprint identity each.
``composed_storm`` is the acceptance scenario: six injections — watch
drop, apiserver jitter, a 409 storm on status writes, fabric fetch
timeouts, a replica partition — composed with a replica kill and a
leader depose, against the full operator -> router -> serving -> fabric
stack.

Seam names here are REGISTERED names (lint rule GL012 counts chaos
scenarios — python literals and ``tests/scenarios/*.json`` — as seam
naming sources and errors on any name missing from the registry).
"""

from __future__ import annotations

from ..loadgen.arrivals import ArrivalSpec
from .scenario import ChaosScenario, FleetAction, Injection, Phase


def composed_storm(seed: int = 2026) -> ChaosScenario:
    """Replica kill + peer partition + leader depose + watch drop +
    409 storm + fetch timeout, one scenario — the composed acceptance
    game day."""
    return ChaosScenario(
        name="composed-storm",
        seed=seed,
        arrivals=ArrivalSpec(
            name="storm",
            rate_per_min=600.0,
            duration_s=10.0,
            burst_factor=3.0,
            burst_every_s=4.0,
            burst_len_s=1.0,
            recall_hot_fraction=0.6,
        ),
        fleet=("mixed", "mixed", "mixed", "mixed"),
        leadership=True,
        phases=(
            Phase(
                name="baseline",
                at_arrival=0,
                injections=(
                    # latency-shaped apiserver reads from the start
                    Injection(
                        "kube.get", "jitter", count=8,
                        seconds=0.01, low=0.001,
                    ),
                    # drop the pod watch twice once it is established
                    Injection(
                        "kube.watch.Pod", "fail", error="watch-closed",
                        count=2, after=5,
                    ),
                ),
            ),
            Phase(
                name="degrade",
                at_arrival=20,
                injections=(
                    # 409 storm against Podmortem status writes
                    Injection(
                        "kube.patch_status", "fail", error="conflict",
                        count=6, after=10,
                    ),
                    # fabric fetches start timing out (decay path)
                    Injection(
                        "fabric.fetch", "fail", error="timeout",
                        count=4, after=6,
                    ),
                    # partition one replica for a bounded dispatch window
                    # (bounded so the exclusion HEALS — the
                    # no-permanent-exclusion invariant checks it did;
                    # the window sits early because the opened breaker
                    # steers dispatches AWAY from the partitioned
                    # replica, shrinking its matching-call budget)
                    Injection(
                        "router.dispatch", "fail", error="connection",
                        count=5, after=8,
                        match=(("replica", "storm-replica-1"),),
                    ),
                ),
            ),
            Phase(
                name="failover",
                at_arrival=45,
                injections=(
                    # the re-established watch stream dies at open once
                    Injection(
                        "kube.watch_open.Pod", "fail", error="watch-closed",
                        count=1, after=2,
                    ),
                ),
                actions=(
                    FleetAction("kill_replica", replica="storm-replica-3"),
                    FleetAction("depose_leader"),
                ),
            ),
        ),
    )


def scale_churn(seed: int = 7) -> ChaosScenario:
    """Elastic membership under fault load: scale up mid-storm, then
    kill a founding replica, with jittered dispatch and flaky log
    reads throughout."""
    return ChaosScenario(
        name="scale-churn",
        seed=seed,
        arrivals=ArrivalSpec(
            name="storm",
            rate_per_min=400.0,
            duration_s=8.0,
            burst_factor=2.5,
            burst_every_s=3.0,
            burst_len_s=1.0,
        ),
        fleet=("mixed", "mixed"),
        phases=(
            Phase(
                name="surge",
                at_arrival=0,
                injections=(
                    Injection(
                        "router.dispatch", "jitter", count=12,
                        seconds=0.008, low=0.001,
                    ),
                    Injection(
                        "kube.get_log", "fail", error="api-500",
                        count=3, after=4,
                    ),
                ),
            ),
            Phase(
                name="scale-up",
                at_arrival=15,
                actions=(FleetAction("add_replica", role="mixed"),),
            ),
            Phase(
                name="scale-down",
                at_arrival=35,
                injections=(
                    Injection(
                        "fabric.fetch", "fail", error="timeout", count=2,
                    ),
                ),
                actions=(
                    FleetAction("kill_replica", replica="storm-replica-1"),
                ),
            ),
        ),
    )


def disagg_fabric(seed: int = 13) -> ChaosScenario:
    """Disaggregated prefill/decode fleet with a hot fabric: fetch
    timeouts, delayed status writes, and a watch stream that expires
    its resume cursor."""
    return ChaosScenario(
        name="disagg-fabric",
        seed=seed,
        arrivals=ArrivalSpec(
            name="storm",
            rate_per_min=300.0,
            duration_s=8.0,
            recall_hot_fraction=0.7,
        ),
        fleet=("prefill", "decode", "mixed"),
        disaggregate=True,
        phases=(
            Phase(
                name="warm",
                at_arrival=0,
                injections=(
                    Injection(
                        "kube.patch", "delay", count=4, seconds=0.005,
                    ),
                    Injection(
                        "kube.watch_open.Pod", "fail",
                        error="watch-expired", count=1,
                    ),
                ),
            ),
            Phase(
                name="fabric-brownout",
                at_arrival=20,
                injections=(
                    Injection(
                        "fabric.fetch", "fail", error="timeout",
                        count=3, after=4,
                    ),
                ),
            ),
        ),
    )


def builtin_scenarios(seed: int = 0) -> "list[ChaosScenario]":
    """The seeded CI matrix; ``seed`` offsets every scenario's own seed
    so one knob reseeds the whole game day."""
    return [
        composed_storm(2026 + seed),
        scale_churn(7 + seed),
        disagg_fabric(13 + seed),
    ]
