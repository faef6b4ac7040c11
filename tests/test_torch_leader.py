"""The port's leader election and killed-leader takeover against the JAX
package's (``tests/test_leader.py``).

Every case drives both packages with the same inputs — the JAX package
on the CPU, the port with ``device="cpu"`` where it takes one — and
compares what comes out:

- ``LeaseElector``: acquire and renew on an injected wall clock
  (:class:`Wall`), a standby fenced out until expiry, a graceful
  release, a partitioned leader stepping down;
- the killed-leader takeover under a seeded ``FaultPlan`` (a 409 storm on
  the successor's status writes), run twice per package: the plan
  traces equal JAX's, and the cluster converges to one stored entry,
  one successful status write and one incident;
- the ``Operator`` wiring: control loops gated on leadership, the lease
  released on stop; a resumed claim whose analysis was already stored.

Tolerance: exact, after ``test_torch_operator.normalise`` (timestamps,
uids, trace ids become placeholders).  The resumed analysis's residual
deadline is a measured duration: its range is checked, not its value.
"""

import asyncio
import importlib
import json
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_operator import normalise  # noqa: E402

_MODULES = (
    "memory", "operator.app", "operator.claims", "operator.kubeapi", "operator.lease",
    "operator.pipeline", "operator.providers", "operator.watcher", "patterns.engine",
    "schema", "schema.analysis", "utils.config", "utils.faultinject", "utils.timing",
)


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    port = root == "operator_tpu_torch"
    return SimpleNamespace(name="port" if port else "jax", device={"device": "cpu"} if port else {},
                           **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args):
    """The scenario's result in each package: (jax, port)."""
    return tuple(run(scenario(PKGS[name], *args)) for name in ("jax", "port"))


class Wall:
    """Injectable wall clock shared by electors and ledgers in one scenario."""

    def __init__(self, start: float = 1_000_000.0) -> None:
        self.t = start

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def _elector(pkg, api, wall, identity, *, metrics=None, seed=0, **kw):
    defaults = dict(lease_name="op-lease", namespace="ns", duration_s=15.0,
                    renew_period_s=0.02, retry_period_s=0.02, kube_timeout_s=5.0)
    defaults.update(kw)
    return pkg.operator_lease.LeaseElector(
        api, identity=identity, metrics=metrics or pkg.utils_timing.MetricsRegistry(),
        wall_clock=wall, rng=random.Random(seed), **defaults,
    )


def _failed_pod(pkg, name="web-1", namespace="prod"):
    s = pkg.schema
    return s.Pod(
        metadata=s.ObjectMeta(name=name, namespace=namespace, labels={"app": "web"}),
        status=s.PodStatus(phase="Running", container_statuses=[s.ContainerStatus(
            name="app", restart_count=1,
            state=s.ContainerState(terminated=s.ContainerStateTerminated(
                exit_code=1, finished_at="2026-07-28T09:00:00Z")),
        )]),
    )


def _memory(pkg, config):
    return pkg.memory.build_incident_memory(config, **pkg.device)


# ---------------------------------------------------------------------------
# the elector
# ---------------------------------------------------------------------------


async def _acquire_and_renew(pkg) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    wall = Wall()
    metrics = pkg.utils_timing.MetricsRegistry()
    elector = _elector(pkg, api, wall, "pod-a", metrics=metrics)
    stop = asyncio.Event()
    task = asyncio.create_task(elector.run(stop))
    leading = await asyncio.wait_for(elector.wait_leading(stop), 5)
    first = (await api.get("Lease", "op-lease", "ns"))["spec"]
    wall.advance(3.0)
    parse = pkg.operator_lease.parse_micro
    for _ in range(200):
        lease = (await api.get("Lease", "op-lease", "ns"))["spec"]
        if parse(lease["renewTime"]) > parse(first["renewTime"]):
            break
        await asyncio.sleep(0.005)
    stop.set()
    await asyncio.wait_for(task, 5)
    return {"leading": leading, "first": first, "renewed": lease,
            "renew_advanced_s": parse(lease["renewTime"]) - parse(first["renewTime"]),
            "elected": metrics.counter("leader_elected"), "is_leader_after_stop": elector.is_leader}


async def _standby_waits_for_expiry(pkg) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    wall = Wall()
    leader = _elector(pkg, api, wall, "pod-a", seed=1)
    standby = _elector(pkg, api, wall, "pod-b", seed=2)
    stop_a, stop_b = asyncio.Event(), asyncio.Event()
    task_a = asyncio.create_task(leader.run(stop_a))
    assert await asyncio.wait_for(leader.wait_leading(stop_a), 5)
    task_b = asyncio.create_task(standby.run(stop_b))
    await asyncio.sleep(0.2)
    fenced_while_live = not standby.is_leader
    # "SIGKILL" the leader: its loop dies without releasing
    stop_a.set()
    await asyncio.wait_for(task_a, 5)
    await asyncio.sleep(0.1)
    fenced_before_expiry = not standby.is_leader
    wall.advance(16.0)
    took_over = await asyncio.wait_for(standby.wait_leading(stop_b), 5)
    lease = (await api.get("Lease", "op-lease", "ns"))["spec"]
    stop_b.set()
    await asyncio.wait_for(task_b, 5)
    return {"fenced_while_live": fenced_while_live, "fenced_before_expiry": fenced_before_expiry,
            "took_over": took_over, "lease": lease,
            "elections": (leader.elections, standby.elections)}


async def _graceful_release(pkg) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    wall = Wall()
    leader = _elector(pkg, api, wall, "pod-a", seed=3)
    standby = _elector(pkg, api, wall, "pod-b", seed=4)
    stop_a, stop_b = asyncio.Event(), asyncio.Event()
    task_a = asyncio.create_task(leader.run(stop_a))
    assert await asyncio.wait_for(leader.wait_leading(stop_a), 5)
    task_b = asyncio.create_task(standby.run(stop_b))
    stop_a.set()
    await asyncio.wait_for(task_a, 5)
    await leader.release()  # no wall-clock advance: no expiry wait
    took_over = await asyncio.wait_for(standby.wait_leading(stop_b), 5)
    lease = (await api.get("Lease", "op-lease", "ns"))["spec"]
    stop_b.set()
    await asyncio.wait_for(asyncio.gather(task_b, return_exceptions=True), 5)
    return {"took_over": took_over, "lease": lease}


async def _partitioned_leader_steps_down(pkg) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    wall = Wall()
    metrics = pkg.utils_timing.MetricsRegistry()
    leader = _elector(pkg, api, wall, "pod-a", metrics=metrics, seed=5)
    stop = asyncio.Event()
    task_a = asyncio.create_task(leader.run(stop))
    assert await asyncio.wait_for(leader.wait_leading(stop), 5)
    ApiError = pkg.operator_kubeapi.ApiError
    api.inject_errors("get", lambda: ApiError("partitioned", 500), times=10_000, kind="Lease")
    wall.advance(16.0)
    stepped_down = await asyncio.wait_for(leader.wait_not_leading(stop), 5)
    standby = _elector(pkg, api, wall, "pod-b", seed=6)
    api.error_hooks.clear()  # the partition heals for the standby
    task_b = asyncio.create_task(standby.run(stop))
    took_over = await asyncio.wait_for(standby.wait_leading(stop), 5)
    lease = (await api.get("Lease", "op-lease", "ns"))["spec"]
    stop.set()
    await asyncio.wait_for(asyncio.gather(task_a, task_b, return_exceptions=True), 5)
    return {"stepped_down": stepped_down, "lost": metrics.counter("leader_lost"),
            "took_over": took_over, "holder": lease["holderIdentity"],
            "transitions": lease["leaseTransitions"]}


def test_elector_acquires_and_renews_as_jax():
    ref, port = both(_acquire_and_renew)
    assert port == ref
    assert port["leading"] and port["elected"] == 1 and not port["is_leader_after_stop"]
    assert port["first"]["holderIdentity"] == "pod-a"
    assert port["first"]["leaseDurationSeconds"] == 15
    assert port["renew_advanced_s"] == pytest.approx(3.0)


def test_standby_waits_for_expiry_then_takes_over_as_jax():
    ref, port = both(_standby_waits_for_expiry)
    assert port == ref
    assert port["fenced_while_live"] and port["fenced_before_expiry"] and port["took_over"]
    assert port["lease"]["holderIdentity"] == "pod-b"
    assert port["lease"]["leaseTransitions"] == 1


def test_graceful_release_hands_over_without_the_expiry_as_jax():
    ref, port = both(_graceful_release)
    assert port == ref
    assert port["took_over"] and port["lease"]["holderIdentity"] == "pod-b"


def test_partitioned_leader_steps_down_as_jax():
    ref, port = both(_partitioned_leader_steps_down)
    assert port == ref
    assert port["stepped_down"] and port["lost"] == 1
    assert port["took_over"] and port["holder"] == "pod-b"


@pytest.mark.parametrize("stamp", [
    "2026-07-28T09:00:00.123456Z", "2026-07-28T09:00:00Z", "", None, "not-a-time",
])
def test_parse_micro_and_iso_micro_match_jax(stamp):
    ref = PKGS["jax"].operator_lease
    port = PKGS["port"].operator_lease
    assert port.parse_micro(stamp) == ref.parse_micro(stamp)
    assert port._iso_micro(1_000_000.25) == ref._iso_micro(1_000_000.25)


# ---------------------------------------------------------------------------
# killed-leader takeover (the chaos scenario)
# ---------------------------------------------------------------------------


class GatedBackend:
    """AI backend that parks until released; records each request's
    residual deadline."""

    def __init__(self, pkg) -> None:
        self.pkg = pkg
        self.gate = asyncio.Event()
        self.deadlines: list = []
        self.calls = 0

    async def generate(self, request):
        self.calls += 1
        self.deadlines.append(request.deadline_s)
        await self.gate.wait()
        return self.pkg.schema_analysis.AIResponse(explanation="Root Cause: resumed and completed.")


def _takeover_plan(pkg, seed: int):
    fi = pkg.utils_faultinject
    ConflictError = pkg.operator_kubeapi.ConflictError
    plan = fi.FaultPlan(seed=seed)
    plan.rule("kube.patch_status",
              fi.times(3, fi.raise_(lambda: ConflictError("injected conflict"), "409")),
              match=lambda kind, name: kind == "Podmortem")
    return plan


async def _takeover(pkg, seed: int, claims_path: str) -> dict:
    O, s = pkg.operator_kubeapi, pkg.schema
    plan = _takeover_plan(pkg, seed)
    wall = Wall()
    api = O.FakeKubeApi()
    config = pkg.utils_config.OperatorConfig(
        pattern_cache_directory="/nonexistent", conflict_backoff_base_s=0.001,
        analysis_deadline_s=180.0, claims_path=claims_path,
    )
    await api.create("AIProvider", s.AIProvider(
        metadata=s.ObjectMeta(name="prov", namespace="ns"),
        spec=s.AIProviderSpec(provider_id="gated", model_id="m", caching_enabled=False),
    ).to_dict())
    pm = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="ns"), spec=s.PodmortemSpec(
        pod_selector=s.LabelSelector(match_labels={"app": "web"}),
        ai_provider_ref=s.AIProviderRef(name="prov", namespace="ns"),
    ))
    await api.create("Podmortem", pm.to_dict())
    pod = _failed_pod(pkg)
    api.set_pod_log("prod", pod.metadata.name, "java.lang.OutOfMemoryError: Java heap space")
    await api.create("Pod", pod.to_dict())
    Ledger = pkg.operator_claims.ClaimLedger
    Pipeline = pkg.operator_pipeline.AnalysisPipeline
    Engine = pkg.patterns_engine.PatternEngine

    # replica A: leads, starts the analysis, is killed inside the AI leg
    stop_a = asyncio.Event()
    elector_a = _elector(pkg, api, wall, "pod-a", seed=seed)
    task_a = asyncio.create_task(elector_a.run(stop_a))
    assert await asyncio.wait_for(elector_a.wait_leading(stop_a), 5)
    backend_a = GatedBackend(pkg)
    providers_a = pkg.operator_providers.default_registry()
    providers_a.register("gated", backend_a)
    pipeline_a = Pipeline(api, Engine(), config=config, metrics=pkg.utils_timing.MetricsRegistry(),
                          providers=providers_a, memory=_memory(pkg, config),
                          claims=Ledger(claims_path, wall_clock=wall))
    ledger_b = Ledger(claims_path, wall_clock=wall)  # a warm standby's boot-time handle
    analysis_a = asyncio.create_task(pipeline_a.process_failure_group(
        pod, [pm], failure_time="2026-07-28T09:00:00Z"))
    for _ in range(500):
        if backend_a.calls:
            break
        await asyncio.sleep(0.005)
    assert backend_a.calls == 1
    pipeline_a.claims.abandon()
    analysis_a.cancel()
    stop_a.set()
    await asyncio.gather(analysis_a, task_a, return_exceptions=True)
    wall.advance(50.0)

    # replica B: takes over after expiry under the seeded 409 storm
    api.fault_plan = plan
    status_writes = []
    original_patch_status = api.patch_status

    async def spying_patch_status(kind, name, namespace, status, **kw):
        out = await original_patch_status(kind, name, namespace, status, **kw)
        if kind == "Podmortem":
            status_writes.append(status)
        return out

    api.patch_status = spying_patch_status
    stop_b = asyncio.Event()
    elector_b = _elector(pkg, api, wall, "pod-b", seed=seed + 1)
    task_b = asyncio.create_task(elector_b.run(stop_b))
    assert await asyncio.wait_for(elector_b.wait_leading(stop_b), 5)
    backend_b = GatedBackend(pkg)
    backend_b.gate.set()
    providers_b = pkg.operator_providers.default_registry()
    providers_b.register("gated", backend_b)
    metrics_b = pkg.utils_timing.MetricsRegistry()
    memory_b = pkg.memory.IncidentMemory(store=pkg.memory.IncidentStore(), **pkg.device)
    pipeline_b = Pipeline(api, Engine(), config=config, metrics=metrics_b,
                          providers=providers_b, memory=memory_b, claims=ledger_b)
    W = pkg.operator_watcher
    cache_b = W.PodmortemCache(api, resync_delay_s=0.01)
    watcher_b = W.PodFailureWatcher(api, pipeline_b, config=config, metrics=metrics_b,
                                    cache=cache_b)
    watch_stop = asyncio.Event()
    watch_task = asyncio.create_task(watcher_b.run(watch_stop))
    assert await cache_b.wait_ready(5)
    cached = [p.metadata.name for p in cache_b.all()]
    resumed = await pipeline_b.resume_pending()
    await watcher_b.drain()
    watch_stop.set()
    stop_b.set()
    api.close_watches()
    await asyncio.gather(watch_task, task_b, return_exceptions=True)
    api.fault_plan = None
    status = (await api.get("Podmortem", "pm", "ns")).get("status") or {}
    failures = status.get("recentFailures") or []
    incidents = pipeline_b.memory.store.all()
    pipeline_b.claims.close()
    return {
        "cached": cached,
        "resumed": resumed,
        "trace": plan.trace(),
        "fingerprint": plan.fingerprint(),
        "pending_faults": plan.pending(),
        "lease_holder": (await api.get("Lease", "op-lease", "ns"))["spec"]["holderIdentity"],
        "resumed_deadline_s": backend_b.deadlines,
        "failures": normalise([{k: v for k, v in f.items() if k != "traceId"} for f in failures]),
        "successful_status_writes": len([w for w in status_writes if w.get("recentFailures")]),
        "incidents": [(i.fingerprint, i.seen_count, i.explanation) for i in incidents],
        "claims_resumed_counter": metrics_b.counter("claims_resumed"),
    }


def test_killed_leader_takeover_replays_the_jax_plan_exactly_once(tmp_path):
    """Two seeded runs of the port and one of JAX: the fired-fault
    traces and fingerprints equal JAX's, and each run stores exactly one
    entry with one successful status write, resumed under the residual
    budget."""
    outs = {name: [run(_takeover(PKGS[name], 21, str(tmp_path / name / str(i) / "claims.jsonl")))
                   for i in range(runs)] for name, runs in (("jax", 1), ("port", 2))}
    for out in outs["port"] + outs["jax"]:
        deadlines = out.pop("resumed_deadline_s")
        assert len(deadlines) == 1 and 0 < deadlines[0] <= 130.0
    assert outs["port"][0] == outs["port"][1] == outs["jax"][0]
    out = outs["port"][0]
    assert out["trace"] == [("kube.patch_status", i, "<raise:409>") for i in range(3)]
    assert out["pending_faults"] == {}
    assert out["cached"] == ["pm"] and out["lease_holder"] == "pod-b"
    assert out["resumed"] == 1 and out["claims_resumed_counter"] == 1
    assert len(out["failures"]) == 1 and out["successful_status_writes"] == 1
    assert out["failures"][0]["analysisStatus"] == "Analyzed"
    assert out["failures"][0]["explanation"].startswith("Root Cause: resumed")
    assert len(out["incidents"]) == 1 and out["incidents"][0][1] == 1


# ---------------------------------------------------------------------------
# the operator's wiring
# ---------------------------------------------------------------------------


async def _operator_gated_on_leadership(pkg, claims_path: str) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    api.namespace = "podmortem-system"
    s = pkg.schema
    config = pkg.utils_config.OperatorConfig(
        pattern_cache_directory="/nonexistent", health_port=-1, leader_election=True,
        pod_name="replica-0", lease_renew_period_s=0.02, lease_retry_period_s=0.02,
        conflict_backoff_base_s=0.001, claims_path=claims_path,
    )
    operator = pkg.operator_app.Operator(api, config=config, **pkg.device)
    await api.create("Podmortem", s.Podmortem(
        metadata=s.ObjectMeta(name="pm", namespace="ns"),
        spec=s.PodmortemSpec(pod_selector=s.LabelSelector(match_labels={"app": "web"})),
    ).to_dict())
    await operator.start()
    tasks = sorted(t.get_name() for t in operator._tasks)
    leading = await asyncio.wait_for(operator.elector.wait_leading(operator._stop), 5)
    holder = (await api.get("Lease", config.lease_name, "podmortem-system"))["spec"]["holderIdentity"]
    for _ in range(500):
        if operator._control_tasks and await operator.cr_cache.wait_ready(0.01):
            break
        await asyncio.sleep(0.005)
    control = sorted(t.get_name() for t in operator._control_tasks)
    await api.create("Pod", _failed_pod(pkg).to_dict())
    for _ in range(500):
        status = (await api.get("Podmortem", "pm", "ns")).get("status") or {}
        if status.get("recentFailures"):
            break
        await asyncio.sleep(0.01)
    await operator.stop()
    released = (await api.get("Lease", config.lease_name, "podmortem-system"))["spec"]
    reloaded = pkg.operator_claims.ClaimLedger(claims_path)
    pending = reloaded.take_pending()
    reloaded.close()
    return {"tasks": tasks, "control": control, "leading": leading, "holder": holder,
            "stored": len(status.get("recentFailures") or []),
            "released_holder": released["holderIdentity"], "pending": pending}


def test_operator_gates_control_loops_on_leadership_as_jax(tmp_path):
    ref, port = (run(_operator_gated_on_leadership(PKGS[name], str(tmp_path / name / "c.jsonl")))
                 for name in ("jax", "port"))
    assert port == ref
    assert port["tasks"] == ["leader-cycle", "leader-elector", "replica-health-poll"]
    assert "patternlibrary-reconciler" in port["control"]
    assert port["leading"] and port["holder"] == "replica-0" and port["stored"] == 1
    assert port["released_holder"] == "" and port["pending"] == []


async def _resumed_claim_already_stored(pkg, claims_path: str) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    s = pkg.schema
    config = pkg.utils_config.OperatorConfig(
        pattern_cache_directory="/nonexistent", conflict_backoff_base_s=0.001,
        claims_path=claims_path,
    )
    pm = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="ns"),
                     spec=s.PodmortemSpec(pod_selector=s.LabelSelector(match_labels={"app": "web"})))
    await api.create("Podmortem", pm.to_dict())
    pod = _failed_pod(pkg)
    await api.create("Pod", pod.to_dict())
    Pipeline = pkg.operator_pipeline.AnalysisPipeline
    Engine = pkg.patterns_engine.PatternEngine

    def pipeline():
        return Pipeline(api, Engine(), config=config, metrics=pkg.utils_timing.MetricsRegistry(),
                        providers=pkg.operator_providers.default_registry(),
                        memory=_memory(pkg, config))

    first = pipeline()
    results = await first.process_failure_group(pod, [pm], failure_time="t-1")
    first.claims.close()
    # "crash" between the status store and the terminal ledger record
    with open(claims_path, encoding="utf-8") as f:
        lines = [line for line in f if '"op": "done"' not in line]
    with open(claims_path, "w", encoding="utf-8") as f:
        f.writelines(lines)
    second = pipeline()
    resumed = await second.resume_pending()
    status = (await api.get("Podmortem", "pm", "ns")).get("status") or {}
    second.claims.close()
    return {"first": [r is not None for r in results], "resumed": resumed,
            "durable_hits": second.metrics.counter("dedupe_durable_hits"),
            "stored": len(status.get("recentFailures") or []),
            "ledger": [json.loads(line)["op"] for line in lines]}


def test_resumed_claim_skips_an_already_stored_analysis_as_jax(tmp_path):
    ref, port = (run(_resumed_claim_already_stored(PKGS[name], str(tmp_path / f"{name}.jsonl")))
                 for name in ("jax", "port"))
    assert port == ref
    assert port["resumed"] == 0 and port["durable_hits"] == 1 and port["stored"] == 1
