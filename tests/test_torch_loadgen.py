"""The port's open-loop load generation against the JAX package's.

``operator_tpu_torch/loadgen`` is held to ``operator_tpu/loadgen``:

- every arrival spec over several seeds gives the same fingerprint, the
  same materialised events and the same offered rate;
- ``storm_pod`` and ``storm_log`` give the same pods and logs;
- a ``SyntheticReplica`` storm through the full stack under an equal
  seeded 409-storm ``FaultPlan`` settles the same arrivals to the same
  outcomes, with the same attainment arithmetic, and journals every one;
- the overload simulation gives the same rows (decision logs included)
  and keeps the sweep's shape (no cliff, no protected class shed);
- an ``EngineReplica`` storm on the port's engine (CPU, ``tiny-test``,
  supervised as ``build_serving_engine`` builds it) settles every arrival;
- ``python -m operator_tpu_torch.loadgen`` exits 0 with ``loadgen smoke:
  OK``, and its elastic, overload, disaggregation and game-day lanes with
  their own lines;
- a disaggregated storm settles every arrival, each analysis as a
  prefill leg and a decode leg.
"""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from operator_tpu.loadgen import ArrivalProcess as JaxArrivalProcess  # noqa: E402
from operator_tpu.loadgen import ArrivalSpec as JaxArrivalSpec  # noqa: E402
from operator_tpu.loadgen import storm as jax_storm  # noqa: E402
from operator_tpu.obs import sloledger as jax_sloledger  # noqa: E402
from operator_tpu.operator.kubeapi import ConflictError as JaxConflictError  # noqa: E402
from operator_tpu.utils import faultinject as jax_faultinject  # noqa: E402
from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig  # noqa: E402
from operator_tpu_torch.loadgen import ArrivalProcess, ArrivalSpec  # noqa: E402
from operator_tpu_torch.loadgen import storm  # noqa: E402
from operator_tpu_torch.obs import sloledger  # noqa: E402
from operator_tpu_torch.operator.kubeapi import ConflictError  # noqa: E402
from operator_tpu_torch.serving.provider import build_serving_engine  # noqa: E402
from operator_tpu_torch.utils import faultinject  # noqa: E402
from operator_tpu_torch.utils.config import OperatorConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPES = ("poisson", "storm", "diurnal")
SEEDS = (0, 1, 7, 42)


def _events(process) -> list:
    return [e.to_dict() for e in process.materialize()]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SHAPES)
def test_arrivals_match_the_jax_package(name, seed):
    for kw in ({}, {"rate_per_min": 240.0, "duration_s": 5.0, "burst_every_s": 2.0,
                    "burst_len_s": 0.5}, {"rate_per_min": 900.0, "duration_s": 30.0}):
        got = ArrivalProcess(ArrivalSpec(name=name, **kw), seed=seed)
        want = JaxArrivalProcess(JaxArrivalSpec(name=name, **kw), seed=seed)
        assert got.fingerprint() == want.fingerprint()
        assert _events(got) == _events(want)
        assert got.offered_per_min() == want.offered_per_min()
        assert got.spec.to_dict() == want.spec.to_dict()


def test_storm_pod_and_log_match_the_jax_package():
    spec = dict(rate_per_min=300.0, duration_s=5.0)
    got_events = ArrivalProcess(ArrivalSpec(**spec), seed=1).materialize()
    want_events = JaxArrivalProcess(JaxArrivalSpec(**spec), seed=1).materialize()
    assert {e.recall_hot for e in got_events} == {True, False}
    for got, want in zip(got_events, want_events):
        assert storm.storm_log(got) == jax_storm.storm_log(want)
        assert storm.storm_pod(got).to_dict() == jax_storm.storm_pod(want).to_dict()
    assert storm.SLO_CLASS_ANNOTATION == jax_storm.SLO_CLASS_ANNOTATION


def _synthetic_storm(stormmod, process_cls, spec_cls, faults, conflict, config_cls,
                     ledger_path, **stack_kw) -> dict:
    """``test_loadgen.py::...::test_storm_replay_under_fault_plan_byte_identical``
    on one package: one synthetic replica, a 409 storm on status writes,
    envelopes far above the service times and the ladder out of reach, so
    the outcomes depend on the schedule and the plan alone."""

    async def one_run() -> dict:
        plan = faults.FaultPlan(seed=5)
        plan.rule("kube.patch_status", faults.times(2, faults.raise_(
            lambda: conflict("injected 409"), "409")))
        stack = await stormmod.build_storm_stack(
            replicas=[stormmod.SyntheticReplica("r0", time_scale=0.05)],
            config=config_cls(
                pattern_cache_directory="/nonexistent", conflict_backoff_base_s=0.001,
                memory_enabled=True, shed_pressure=10**9,
            ),
            ledger_path=ledger_path, time_scale=0.05, deadline_factor=200.0,
            fault_plan=plan, **stack_kw,
        )
        process = process_cls(spec_cls(name="storm", rate_per_min=600.0, duration_s=2.0),
                              seed=9)
        report = await stormmod.run_storm(stack, process, drain_s=30.0)
        stack.close()
        report["fault_trace"] = plan.trace()
        return report

    report = asyncio.run(one_run())
    with open(ledger_path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    total = report["slo"]["total"]
    return {
        "fingerprint": report["fingerprint"],
        "arrivals": report["arrivals"],
        "pending": report["slo"]["pending"],
        "journal_lines": len(lines),
        "outcomes": sorted(line["outcome"] for line in lines),
        "classes": sorted(report["slo"]["classes"]),
        "fault_trace": report["fault_trace"],
        **{key: total[key] for key in ("admitted", "completed", "shed", "deadline_exceeded",
                                       "failed")},
        # wall-clock dependent (latency against each class's target): held
        # to the arithmetic below, not across the two runs
        "timed": {"attainment": total["attainment"], "lines": lines},
    }


def _attainment_arithmetic(run: dict) -> None:
    """The reported attainment is both packages' ``summarize`` over the
    journal: attained over every terminal record."""
    port = sloledger.summarize([sloledger.SLORecord.from_dict(x) for x in run["timed"]["lines"]])
    jax = jax_sloledger.summarize(
        [jax_sloledger.SLORecord.from_dict(x) for x in run["timed"]["lines"]])
    assert port == jax
    attained = sum(1 for x in run["timed"]["lines"] if x["attained"])
    assert port["total"]["attainment"] == run["timed"]["attainment"]
    assert abs(run["timed"]["attainment"] - attained / len(run["timed"]["lines"])) < 1e-6


def test_synthetic_storm_ledger_matches_the_jax_package(tmp_path):
    got = _synthetic_storm(storm, ArrivalProcess, ArrivalSpec, faultinject, ConflictError,
                           OperatorConfig, str(tmp_path / "port.jsonl"), device="cpu")
    want = _synthetic_storm(jax_storm, JaxArrivalProcess, JaxArrivalSpec, jax_faultinject,
                            JaxConflictError, JaxOperatorConfig, str(tmp_path / "jax.jsonl"))
    assert got["pending"] == 0 and got["admitted"] == got["arrivals"] > 0
    assert got["journal_lines"] == got["admitted"]
    # attainment arithmetic: attained over settled, from the ledger's counts
    settled = got["completed"] + got["shed"] + got["deadline_exceeded"] + got["failed"]
    assert settled == got["admitted"]
    for run in (got, want):
        _attainment_arithmetic(run)
    assert {k: v for k, v in got.items() if k != "timed"} == {
        k: v for k, v in want.items() if k != "timed"}


@pytest.mark.parametrize("rate", [450.0, 900.0, 1800.0])
def test_overload_simulation_matches_the_jax_package(rate):
    got = storm.simulate_overload(rate, seed=0, duration_s=30.0)
    assert got == jax_storm.simulate_overload(rate, seed=0, duration_s=30.0)


def test_overload_sweep_decays_smoothly_and_never_sheds_protected():
    """``test_loadgen.py::TestOverloadSimulation``'s sweep shape on the
    port: no attainment cliff between adjacent points, the ladder engaged
    at 2x, no protected class shed, interactive never shed."""
    rows = [storm.simulate_overload(900.0 * f, seed=0, duration_s=60.0)
            for f in (0.5, 0.75, 1.0, 1.5, 2.0)]
    for prev, cur in zip(rows, rows[1:]):
        pairs = [(prev["attainment"], cur["attainment"])] + [
            (att, cur["attainment_by_class"].get(cls))
            for cls, att in prev["attainment_by_class"].items()]
        for a, b in pairs:
            if a is not None and b is not None:
                assert a - b <= 0.15, (prev, cur)
    peak = rows[-1]
    assert peak["shed_total"] or peak["degraded_total"]
    assert all(row["protected_shed"] == 0 for row in rows)
    assert "interactive" not in peak["shed_by_class"]


def test_engine_replica_storm_settles_every_arrival(tmp_path):
    engine, _ = build_serving_engine("cpu", {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16",
    })
    assert engine._supervisor is not None  # supervised, as the provider builds it
    ledger = str(tmp_path / "engine.jsonl")

    async def scenario():
        stack = await storm.build_storm_stack(
            replicas=[storm.EngineReplica("engine-0", engine, max_tokens=6)],
            ledger_path=ledger, time_scale=0.2, deadline_factor=200.0, device="cpu",
        )
        process = ArrivalProcess(ArrivalSpec(name="storm", rate_per_min=240.0, duration_s=2.0,
                                             burst_every_s=1.0, burst_len_s=0.25), seed=0)
        report = await storm.run_storm(stack, process, drain_s=60.0)
        stack.close()
        return report

    try:
        report = asyncio.run(scenario())
    finally:
        engine.close()
    total = report["slo"]["total"]
    assert report["arrivals"] > 0
    assert report["slo"]["pending"] == 0
    assert total["admitted"] == report["arrivals"] - report["cancelled_at_drain"]
    with open(ledger) as fh:
        lines = [json.loads(line) for line in fh if line.strip()]
    assert len(lines) == total["admitted"]
    assert total["completed"] > 0
    assert engine.load_report().gave_up is False


@pytest.mark.parametrize("lane,env,expect", [
    ("smoke", {}, "loadgen smoke: OK"),
    ("elastic", {"LOADGEN_ELASTIC": "1"}, "loadgen elastic: OK"),
    ("overload", {"LOADGEN_OVERLOAD": "1", "LOADGEN_OVERLOAD_DURATION_S": "20"},
     "loadgen overload: OK"),
])
def test_loadgen_cli_lanes_pass(lane, env, expect):
    proc = subprocess.run(
        [sys.executable, "-m", "operator_tpu_torch.loadgen", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, **env},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == expect


@pytest.mark.parametrize("env,expect", [
    # the ids are those of the refusals these lanes replaced (items 5b, 5d)
    pytest.param({"LOADGEN_DISAGG": "1"}, "loadgen disagg: OK", id="env0-item 5b"),
    pytest.param({"LOADGEN_GAMEDAY": "1"}, "loadgen gameday: OK", id="env1-item 5d"),
])
def test_loadgen_lanes_not_ported_refuse_naming_their_item(env, expect):
    """The disaggregation and game-day lanes (once refusals naming items
    5b and 5d) exit 0 with the reference's OK lines."""
    proc = subprocess.run(
        [sys.executable, "-m", "operator_tpu_torch.loadgen", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, **env},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == expect


def test_a_disaggregated_storm_settles_every_arrival_as_the_jax_package():
    """A disaggregated storm (once a refusal naming item 5b) settles every
    arrival, as the JAX package's does: each analysis runs as a prefill
    leg on the prefill replica and a decode leg on a decode replica."""
    spec = {"name": "disagg", "rate_per_min": 240.0, "duration_s": 2.0, "burst_factor": 3.0,
            "burst_every_s": 2.0, "burst_len_s": 0.5}

    def drive(module, process, **kw):
        async def run():
            fleet = [module.SyntheticReplica(f"d-{role}-{i}", concurrency=2, time_scale=0.2,
                                             role=role)
                     for i, role in enumerate(("prefill", "decode", "decode"))]
            stack = await module.build_storm_stack(replicas=fleet, time_scale=0.2,
                                                   disaggregate=True, **kw)
            try:
                report = await module.run_storm(stack, process, drain_s=20.0)
            finally:
                stack.close()
            return report, fleet, stack.metrics.counter("fabric_disagg_handoff")

        return asyncio.run(run())

    report, fleet, handoffs = drive(storm, ArrivalProcess(ArrivalSpec(**spec), seed=3),
                                    device="cpu")
    ref, ref_fleet, ref_handoffs = drive(
        jax_storm, JaxArrivalProcess(JaxArrivalSpec(**spec), seed=3))
    total = report["slo"]["total"]
    assert report["arrivals"] == ref["arrivals"] > 0
    assert report["fingerprint"] == ref["fingerprint"]
    assert report["slo"]["pending"] == ref["slo"]["pending"] == 0
    assert total["admitted"] == report["arrivals"] - report["cancelled_at_drain"]
    assert handoffs > 0 and ref_handoffs > 0
    prefill, *decode = fleet
    assert prefill.served_by_phase.get("prefill", 0) > 0
    assert sum(r.served_by_phase.get("decode", 0) for r in decode) > 0
    assert (report["fleet"]["fleet"]["roles"]["prefill"]["replicas"],
            report["fleet"]["fleet"]["roles"]["decode"]["replicas"]) == (1, 2)
