"""The port's game-day chaos (``operator_tpu_torch/chaos``) against the JAX
package's (``operator_tpu/chaos``), on the CPU.

Follows the game-day half of ``tests/test_chaos.py``; every scenario runs
under both packages' conductors and is held to what a run determines:

- every builtin scenario over several seeds, and the committed repro
  under ``tests/scenarios/``, has the JAX package's JSON, compiled plan and
  fingerprint;
- under the conductor: the same invariant verdicts, the same fleet
  actions and leader, and the same fired count at every seam whose
  injections are not match-scoped.  A match-scoped injection (the
  composed storm's partition of one replica) fires on the calls that
  reach that replica, which its breaker and load decide from wall-clock
  interleaving, in both packages: each package's run is held to at least
  one firing and at most its declared count.  The JAX conductor's ``depose_leader`` releases the lease under
  the old leader's live renew loop, which writes itself back before the
  standby acquires in most runs on a CPU host; its handover then times
  out after 10 s as a submit error.  The port's conductor stops that loop
  first.  Where a JAX run lost that race, only its fingerprints and fired
  counts are compared (the port's run is held to the reference test's
  expectations in full);
- a fabric holder killed mid-fetch falls back to recompute with the
  no-fabric greedy tokens, on ``tiny-test`` in both packages;
- a scale-down that kills the only prefill replica mid-handoff, and a
  leader deposed mid fetch storm (two port runs give the same
  ``fault_fingerprint``, which is the JAX package's);
- the scheduler's commit-barrier hook catches a leaked page on the port's
  scheduler as on the JAX one.

Every conductor run is bounded by a timeout of its own
(``RUN_TIMEOUT_S``).  The mutation lane and the shrinker are in
``tests/test_torch_chaos_shrink.py``.
"""

import asyncio
import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu import chaos as jax_chaos  # noqa: E402
from operator_tpu.loadgen.arrivals import ArrivalSpec as JaxArrivalSpec  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch import chaos  # noqa: E402
from operator_tpu_torch.loadgen.arrivals import ArrivalSpec  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402

#: one conductor run's own bound (a scenario drains in 2-8 s on the CPU)
RUN_TIMEOUT_S = 120.0
SCENARIOS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")


def repro_texts() -> list:
    return [open(os.path.join(SCENARIOS, name), encoding="utf-8").read()
            for name in sorted(os.listdir(SCENARIOS)) if name.endswith(".json")]


def conduct(package: str, scenario, **kw) -> "tuple[dict, object]":
    """One conductor run (port on the CPU); returns (report, metrics)."""
    if package == "jax":
        metrics, run = JaxMetricsRegistry(), jax_chaos.run_scenario
    else:
        metrics, run = MetricsRegistry(), chaos.run_scenario
        kw.setdefault("device", "cpu")

    async def bounded():
        return await asyncio.wait_for(run(scenario, metrics=metrics, **kw), RUN_TIMEOUT_S)

    return asyncio.run(bounded()), metrics


def fired(scenario, report) -> "tuple[dict, dict]":
    """(fired count per seam without match-scoped injections, fired count
    per match-scoped seam) from the declared counts less the pending."""
    declared: dict = collections.Counter()
    scoped = set()
    for inj in scenario.injections():
        declared[inj.seam] += inj.count
        if inj.match:
            scoped.add(inj.seam)
    pending = report["pending_faults"]
    counts = {seam: n - pending.get(seam, 0) for seam, n in declared.items()}
    return ({s: n for s, n in counts.items() if s not in scoped},
            {s: n for s, n in counts.items() if s in scoped})


def verdict(scenario, report) -> dict:
    """What a run determines, whichever package ran it."""
    plain, _scoped = fired(scenario, report)
    return {
        "fingerprint": report["fingerprint"],
        "violations": [(v["name"], v["at"]) for v in report["violations"]],
        "fired": plain,
        "actions": report["actions"],
        "leader": report["leader"],
        "arrivals": report["driver"]["arrivals"],
        "submit_errors": report["driver"]["submit_errors"],
        "cancelled_at_drain": report["driver"]["cancelled_at_drain"],
    }


def assert_as_the_jax_run(scenario, report, ref_scenario, ref) -> None:
    """The port's verdict is the JAX run's; where the JAX run's leader
    handover timed out (see the module docstring), its fingerprint and
    fired counts."""
    got, want = verdict(scenario, report), verdict(ref_scenario, ref)
    if want["submit_errors"] and any(
            a.kind == "depose_leader" for p in ref_scenario.phases for a in p.actions):
        got = {k: got[k] for k in ("fingerprint", "fired", "arrivals")}
        want = {k: want[k] for k in got}
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_scenario_roundtrips_and_fingerprints(seed):
    """Every builtin scenario and the committed repro: the JAX package's
    JSON, compiled plan and fingerprint; a JSON round trip and a second
    build keep the fingerprint; a reseed changes it; ``with_injections``
    keeps the phases and actions as structural context."""
    ours = chaos.builtin_scenarios(seed) + [chaos.ChaosScenario.from_json(t)
                                            for t in repro_texts()]
    theirs = jax_chaos.builtin_scenarios(seed) + [jax_chaos.ChaosScenario.from_json(t)
                                                  for t in repro_texts()]
    assert len(ours) == len(theirs) == 4
    for scen, ref in zip(ours, theirs):
        assert scen.to_json() == ref.to_json()
        assert scen.compile_plan()[1] == ref.compile_plan()[1]
        assert scen.fingerprint() == ref.fingerprint()
        assert chaos.ChaosScenario.from_json(scen.to_json()).fingerprint() == scen.fingerprint()
        thinned = scen.with_injections([0])
        assert thinned.fingerprint() == ref.with_injections([0]).fingerprint()
        assert len(thinned.injections()) == 1
        assert [p.name for p in thinned.phases] == [p.name for p in scen.phases]
        assert [p.actions for p in thinned.phases] == [p.actions for p in scen.phases]
    scen = chaos.composed_storm(2026 + seed)
    assert len(scen.injections()) >= 6
    assert chaos.composed_storm(1).fingerprint() != scen.fingerprint()
    assert chaos.builtin_scenarios(seed)[0].fingerprint() == scen.fingerprint()


def test_composed_storm_runs_clean_under_the_conductor():
    """The acceptance game day (replica kill, peer partition, leader
    depose, watch drops, a 409 storm, fetch timeouts) under both
    conductors: no violation, the same fired counts, actions and leader."""
    scen, ref_scen = chaos.composed_storm(), jax_chaos.composed_storm()
    report, metrics = conduct("port", scen)
    ref, _ = conduct("jax", ref_scen)
    assert_as_the_jax_run(scen, report, ref_scen, ref)
    got = verdict(scen, report)
    assert got["violations"] == [] and got["submit_errors"] == 0
    assert report["invariant_checks"] >= 2
    assert [a["kind"] for a in report["actions"]] == ["kill_replica", "depose_leader"]
    assert report["leader"] == "conductor-b"
    assert metrics.counter("chaos_watch_reopen") >= 1
    assert metrics.counter("fabric_fetch_timeout") >= 4
    declared = collections.Counter()
    for inj in scen.injections():
        declared[inj.seam] += inj.count
    for scenario, run in ((scen, report), (ref_scen, ref)):
        _plain, scoped = fired(scenario, run)
        assert scoped and all(1 <= n <= declared[s] for s, n in scoped.items()), scoped
    assert chaos.composed_storm().fingerprint() == report["fingerprint"]


@pytest.mark.parametrize("index", [1, 2, 3], ids=["scale-churn", "disagg-fabric", "repro"])
def test_builtin_and_committed_scenarios_under_the_conductor(index):
    """The rest of the game-day matrix (scale churn, the disaggregated
    fabric, the committed repro): every injection fires, no violation,
    and the JAX conductor's verdict."""
    ours = chaos.builtin_scenarios(0) + [chaos.ChaosScenario.from_json(t) for t in repro_texts()]
    theirs = jax_chaos.builtin_scenarios(0) + [
        jax_chaos.ChaosScenario.from_json(t) for t in repro_texts()]
    report, metrics = conduct("port", ours[index])
    ref, ref_metrics = conduct("jax", theirs[index])
    assert_as_the_jax_run(ours[index], report, theirs[index], ref)
    got = verdict(ours[index], report)
    assert report["pending_faults"] == {} and got["violations"] == []
    if ours[index].disaggregate:
        assert metrics.counter("fabric_disagg_handoff") > 0
        assert ref_metrics.counter("fabric_disagg_handoff") > 0


def test_scale_down_evicts_prefill_replica_mid_disagg_handoff():
    """A scale-down kills the only prefill replica while disaggregated
    handoffs are in flight: prefill legs fail over to the mixed replica,
    decode legs still resume from the handed-off tokens, and every
    arrival reaches one terminal outcome, in both packages."""
    def scenario(module, spec_cls):
        return module.ChaosScenario(
            name="prefill-eviction-mid-handoff", seed=41,
            arrivals=spec_cls(name="storm", rate_per_min=400.0, duration_s=4.0,
                              recall_hot_fraction=0.5),
            fleet=("prefill", "decode", "mixed"), disaggregate=True,
            phases=(
                module.Phase(name="warm", at_arrival=0, injections=(
                    module.Injection("kube.get", "jitter", count=4, seconds=0.004, low=0.001),
                )),
                module.Phase(name="scale-down", at_arrival=10, actions=(
                    module.FleetAction("kill_replica", replica="storm-replica-0"),
                )),
            ),
        )

    scen, ref_scen = scenario(chaos, ArrivalSpec), scenario(jax_chaos, JaxArrivalSpec)
    report, metrics = conduct("port", scen)
    ref, _ = conduct("jax", ref_scen)
    assert_as_the_jax_run(scen, report, ref_scen, ref)
    got = verdict(scen, report)
    assert got["violations"] == [] and report["pending_faults"] == {}
    assert report["actions"] == [
        {"kind": "kill_replica", "phase": "scale-down", "replica": "storm-replica-0"}]
    assert metrics.counter("fabric_disagg_handoff") > 0
    assert report["slo"]["total"]["completed"] > 0


def test_leader_depose_mid_fabric_fetch_storm_replays_identically():
    """The leader is deposed while fabric fetches time out: claims resume
    on the new leader, timed-out fetches fall back, and two port runs
    give the same fired-fault trace, which is the JAX package's."""
    def scenario(module, spec_cls):
        return module.ChaosScenario(
            name="depose-mid-fetch", seed=43,
            arrivals=spec_cls(name="storm", rate_per_min=400.0, duration_s=4.0,
                              recall_hot_fraction=0.8),
            fleet=("mixed", "mixed"), leadership=True,
            phases=(
                module.Phase(name="fetch-load", at_arrival=0, injections=(
                    module.Injection("fabric.fetch", "fail", error="timeout", count=3, after=2),
                )),
                module.Phase(name="handover", at_arrival=8,
                             actions=(module.FleetAction("depose_leader"),)),
            ),
        )

    scen = scenario(chaos, ArrivalSpec)
    runs = []
    for _ in range(2):
        report, metrics = conduct("port", scen)
        assert report["violations"] == [] and report["pending_faults"] == {}
        assert report["actions"] == [
            {"kind": "depose_leader", "phase": "handover", "leader": "conductor-b"}]
        assert metrics.counter("fabric_fetch_fallback") >= 1
        assert metrics.counter("fabric_fetch_ok") >= 1
        runs.append(report)
    ref_scen = scenario(jax_chaos, JaxArrivalSpec)
    ref, _ = conduct("jax", ref_scen)
    assert runs[0]["fingerprint"] == runs[1]["fingerprint"] == ref["fingerprint"]
    assert runs[0]["fault_fingerprint"] == runs[1]["fault_fingerprint"] == ref["fault_fingerprint"]
    assert_as_the_jax_run(scen, runs[0], ref_scen, ref)


# ---------------------------------------------------------------------------
# the fetch seam and the commit barrier on tiny-test engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    from operator_tpu.models import TINY_TEST, init_params
    from operator_tpu_torch.models import params_from_jax

    jax_params = init_params(TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    return {"jax": jax_params,
            "port": params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))}


def _side(package):
    """One package's generator, store, scheduler and fabric names."""
    if package == "jax":
        from operator_tpu import fabric as fab
        from operator_tpu.models import TINY_TEST
        from operator_tpu.models.tokenizer import ByteTokenizer
        from operator_tpu.ops.kv_transfer import HostKVPool
        from operator_tpu.serving.engine import BatchedGenerator, SamplingParams
        from operator_tpu.serving.kvstore import PrefixKVStore, block_hashes
        from operator_tpu.serving.sched import Scheduler
        from operator_tpu.utils import faultinject

        def generator(params):
            return BatchedGenerator(
                params, TINY_TEST, ByteTokenizer(), paged=True, max_slots=4, max_seq=128,
                page_size=16, cache_dtype=jnp.float32, metrics=JaxMetricsRegistry())
        metrics_cls, auditor_mod = JaxMetricsRegistry, jax_chaos
    else:
        from operator_tpu_torch import fabric as fab
        from operator_tpu_torch.models import TINY_TEST, ByteTokenizer
        from operator_tpu_torch.ops.kv_transfer import HostKVPool
        from operator_tpu_torch.serving.engine import Generator
        from operator_tpu_torch.serving.kvstore import PrefixKVStore, block_hashes
        from operator_tpu_torch.serving.sched import Scheduler
        from operator_tpu_torch.serving.types import SamplingParams
        from operator_tpu_torch.utils import faultinject

        def generator(params):
            return Generator(
                params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128, page_size=16,
                cache_dtype=torch.float32, device="cpu", metrics=MetricsRegistry())
        metrics_cls, auditor_mod = MetricsRegistry, chaos
    return dict(fab=fab, HostKVPool=HostKVPool, PrefixKVStore=PrefixKVStore,
                block_hashes=block_hashes, Scheduler=Scheduler, SamplingParams=SamplingParams,
                faultinject=faultinject, generator=generator, metrics=metrics_cls,
                chaos=auditor_mod)


def _drain(sched, req, limit=500):
    for _ in range(limit):
        for outcome in sched.step():
            if outcome.req_id == req:
                return outcome
    raise AssertionError("request never finished")


def _holder_killed(package, params, seed):
    """The only holder of every wanted block dies mid-page-fetch."""
    s = _side(package)
    prompt = "the quick brown fox jumps over the lazy dog " * 2
    greedy = s["SamplingParams"](max_tokens=6, temperature=0.0, stop_on_eos=False)

    def replica(mirror):
        g = s["generator"](params[package])
        store = s["PrefixKVStore"](16, host_pool=s["HostKVPool"](8), metrics=g.metrics)
        return s["Scheduler"](g, kvstore=store, fabric_mirror=mirror), g, store

    sched_a, gen_a, store_a = replica(True)
    ref = _drain(sched_a, sched_a.enqueue(prompt, greedy))
    tokens = gen_a.tokenizer.encode(prompt)
    hashes = s["block_hashes"](tokens, 16)
    index = s["fab"].FabricIndex()
    index.update("a", [h.hex() for h in hashes], url="http://a")

    async def transport(url, budget_s):
        h = bytes.fromhex(url.rsplit("/", 1)[-1])
        entry = store_a.host_pool.get(h)
        return (404, b"") if entry is None else (200, s["fab"].encode_block(h, *entry))

    fi = s["faultinject"]
    plan = fi.FaultPlan(seed=seed)
    plan.rule("fabric.fetch", fi.times(len(hashes), fi.raise_(
        lambda: ConnectionError("holder killed"), "kill")),
        match=lambda replica, block: replica == "a")
    sched_b, gen_b, store_b = replica(False)
    fetcher = s["fab"].FabricFetcher(index, transport=transport, fault_plan=plan, self_id="b",
                                     metrics=gen_b.metrics)
    adopted = asyncio.run(asyncio.wait_for(fetcher.prefetch(tokens, store=store_b),
                                           RUN_TIMEOUT_S))
    out = _drain(sched_b, sched_b.enqueue(prompt, greedy))
    acc = sched_b.page_accounting()
    assert acc["available"] + acc["row_pages"] + acc["store_pages"] + acc["prefix_pages"] \
        == acc["total"]
    assert plan.pending() == {}
    return {"adopted": adopted, "tokens": list(out.result.token_ids),
            "reference": list(ref.result.token_ids),
            "errors": gen_b.metrics.counter("fabric_fetch_error"),
            "fallbacks": gen_b.metrics.counter("fabric_fetch_fallback"),
            "trace": plan.trace()}


def test_fabric_holder_killed_mid_fetch_falls_back_to_recompute(params):
    first = _holder_killed("port", params, 29)
    assert first["adopted"] == 0
    assert first["errors"] >= 1 and first["fallbacks"] >= 1
    assert first["tokens"] == first["reference"]
    assert _holder_killed("port", params, 29) == first
    assert first == _holder_killed("jax", params, 29)


def _barrier(package, params):
    s = _side(package)
    g = s["generator"](params[package])
    auditor = s["chaos"].InvariantAuditor(metrics=s["metrics"]())
    sched = s["Scheduler"](g, audit_hook=auditor.barrier_hook(
        lambda sc: s["chaos"].GameDayView(schedulers=[sc])))
    greedy = s["SamplingParams"](max_tokens=4, temperature=0.0, stop_on_eos=False)
    _drain(sched, sched.enqueue("healthy request", greedy))
    healthy = (auditor.checks, list(auditor.violations))
    assert healthy[0] > 0 and healthy[1] == []
    g.allocator.allocate(1)  # the deliberate bug: a page behind the ledger's back
    _drain(sched, sched.enqueue("leaky request", greedy))
    assert {v.name for v in auditor.violations} == {"kv-page-conservation"}
    detail = auditor.violations[0].detail["imbalanced"][0]
    assert detail["sum"] == detail["total"] - 1
    return [healthy, [(v.name, v.at, v.detail) for v in auditor.violations], auditor.checks]


def test_scheduler_commit_barrier_hook_catches_a_leaked_page(params):
    assert _barrier("port", params) == _barrier("jax", params)
