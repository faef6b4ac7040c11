"""The port's mutation lane and fault-plan shrinker
(``operator_tpu_torch/chaos``) against the JAX package's, on the CPU.

Follows ``tests/test_chaos.py::test_mutation_lane_auditor_blackbox_and_shrink``:
a deliberately broken run (one SLO-ledger settle dropped once a 409
injection fired) must violate ``arrival-conservation`` and leave a
black-box record tagged with the fingerprint and phase; ddmin shrinks the
six-injection scenario to the single guilty injection — the one the JAX
shrinker isolates — and the minimal repro replays with the same
fingerprint, fired-fault trace and verdict twice, as the JAX package's
does.  Every conductor run is bounded by a timeout of its own.
"""

import asyncio
import json

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from operator_tpu import chaos as jax_chaos  # noqa: E402
from operator_tpu.loadgen.arrivals import ArrivalSpec as JaxArrivalSpec  # noqa: E402
from operator_tpu.obs.record import FlightRecorder as JaxFlightRecorder  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch import chaos  # noqa: E402
from operator_tpu_torch.loadgen.arrivals import ArrivalSpec  # noqa: E402
from operator_tpu_torch.obs.record import FlightRecorder  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402

#: one conductor run's own bound
RUN_TIMEOUT_S = 120.0
MUTATION = "drop-settle-on-conflict"

PACKAGES = {
    "jax": (jax_chaos, JaxArrivalSpec, JaxMetricsRegistry, JaxFlightRecorder, {}),
    "port": (chaos, ArrivalSpec, MetricsRegistry, FlightRecorder, {"device": "cpu"}),
}


def mutation_bed(module, spec_cls, seed: int = 47):
    """Six injections, one of which (the 409 storm) arms the drop-settle
    mutation."""
    inj, phase = module.Injection, module.Phase
    return module.ChaosScenario(
        name="mutation-bed", seed=seed,
        arrivals=spec_cls(name="storm", rate_per_min=400.0, duration_s=4.0,
                          recall_hot_fraction=0.3),
        fleet=("mixed", "mixed"),
        phases=(
            phase(name="noise", at_arrival=0, injections=(
                inj("kube.get", "jitter", count=3, seconds=0.004, low=0.001),
                inj("kube.patch", "delay", count=2, seconds=0.003),
                inj("kube.get_log", "fail", error="api-500", count=2, after=2),
                inj("kube.watch.Pod", "fail", error="watch-closed", count=1, after=3),
            )),
            phase(name="conflict-storm", at_arrival=8, injections=(
                inj("kube.patch_status", "fail", error="conflict", count=3, after=4),
                inj("fabric.fetch", "fail", error="timeout", count=2),
            )),
        ),
    )


def lane(package: str, tmp_path) -> dict:
    module, spec_cls, metrics_cls, recorder_cls, extra = PACKAGES[package]
    scen = mutation_bed(module, spec_cls)
    assert len(scen.injections()) == 6
    recorder = recorder_cls(path=str(tmp_path / f"{package}-traces.jsonl"),
                            blackbox_path=str(tmp_path / f"{package}-blackbox.jsonl"),
                            metrics=metrics_cls())

    def conduct(scenario, **kw):
        return asyncio.run(asyncio.wait_for(module.run_scenario(
            scenario, mutation=MUTATION, metrics=metrics_cls(), **extra, **kw), RUN_TIMEOUT_S))

    report = conduct(scen, recorder=recorder)
    recorder.flush()
    dumps = [json.loads(line)
             for line in (tmp_path / f"{package}-blackbox.jsonl").read_text().splitlines()]
    dumps = [d for d in dumps if str(d.get("reason", "")).startswith("invariant-violation:")]
    assert dumps, "the violation must leave a black-box artifact"

    async def probe(candidate) -> bool:
        rep = await asyncio.wait_for(module.run_scenario(
            candidate, mutation=MUTATION, metrics=metrics_cls(), **extra), RUN_TIMEOUT_S)
        return bool(rep["violations"])

    result = asyncio.run(module.shrink(scen, probe, metrics=metrics_cls()))
    minimal = module.ChaosScenario.from_json(result.repro_json())
    replays = [conduct(minimal) for _ in range(2)]
    return {
        "violations": [v["name"] for v in report["violations"]],
        "blackbox": [dumps[0]["reason"], dumps[0]["extra"]["fingerprint"] == report["fingerprint"],
                     dumps[0]["extra"]["phase"], dumps[0]["trace"]["scenario"]],
        "fingerprint": report["fingerprint"],
        "indices": result.indices, "original": result.original, "minimal": result.minimal,
        "seams": [i.seam for i in result.scenario.injections()],
        "repro_json": result.repro_json(),
        "command": "LOADGEN_GAMEDAY=1" in result.repro_command("repro.json"),
        "replays": [(r["fingerprint"], r["fault_fingerprint"], r["pending_faults"],
                     [v["name"] for v in r["violations"]]) for r in replays],
    }


def test_mutation_lane_auditor_blackbox_and_shrink(tmp_path):
    got = lane("port", tmp_path)
    assert got["violations"] == ["arrival-conservation"]
    assert got["blackbox"] == ["invariant-violation:arrival-conservation", True, "end",
                               "mutation-bed"]
    assert got["original"] == 6 and got["minimal"] <= 2
    assert set(got["seams"]) == {"kube.patch_status"} and got["command"]
    minimal = chaos.ChaosScenario.from_json(got["repro_json"]).fingerprint()
    (fp0, ff0, pend0, v0), (fp1, ff1, pend1, v1) = got["replays"]
    assert fp0 == fp1 == minimal and ff0 == ff1
    assert pend0 == pend1 == {} and v0 == v1 == ["arrival-conservation"]
    assert got == lane("jax", tmp_path)
