"""The port's serverless fleet against the JAX package's
(``tests/test_autoscale.py``): the Deployment ``scale`` subresource on
the fake apiserver, the autoscaler's pure ``decide`` (wake from zero,
burst, blocked at max, a lagging SLO class, idle to zero, the floor),
``tick`` and ``run`` (a partitioned patch degrades to ``blocked``),
``endpoint_urls``, and ``EndpointDiscovery`` membership (list + watch,
the pre-warm gate, members it did not add, 410 compaction and relist).

Each case drives both packages with the same inputs and compares what
comes out, exactly, after ``test_torch_operator.normalise``.  Clocks are
injected; no case sleeps out a real idle window.
"""

import asyncio
import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_operator import normalise  # noqa: E402

SERVICE = "podmortem-serving"
_MODULES = ("operator.autoscale", "operator.kubeapi", "router", "router.core", "schema",
            "utils.timing")


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    return SimpleNamespace(name="port" if root == "operator_tpu_torch" else "jax", **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args):
    """The scenario's result in each package, normalised: (jax, port)."""
    out = []
    for name in ("jax", "port"):
        result = scenario(PKGS[name], *args)
        if asyncio.iscoroutine(result):
            result = run(result)
        out.append(normalise(result))
    return tuple(out)


async def _attempt(coro):
    try:
        return await coro
    except Exception as exc:  # noqa: BLE001 - the outcome is the observation
        return {"error": type(exc).__name__}


def _deployment(pkg, replicas=0, name=SERVICE, namespace="default"):
    s = pkg.schema
    return s.Deployment(metadata=s.ObjectMeta(name=name, namespace=namespace),
                        spec=s.DeploymentSpec(replicas=replicas))


def _endpoints(pkg, ips, name=SERVICE, namespace="default", port=8000):
    s = pkg.schema
    subsets = [s.EndpointSubset(addresses=[s.EndpointAddress(ip=ip) for ip in ips],
                                ports=[s.EndpointPort(name="http", port=port)])] if ips else []
    return s.Endpoints(metadata=s.ObjectMeta(name=name, namespace=namespace), subsets=subsets)


def _controller(pkg, api=None, **kw):
    defaults = dict(deployment=SERVICE, namespace="default", min_replicas=0, max_replicas=4,
                    target_pressure=4.0, idle_s=10.0, interval_s=0.01, kube_timeout_s=5.0,
                    metrics=pkg.utils_timing.MetricsRegistry())
    defaults.update(kw)
    api = api if api is not None else pkg.operator_kubeapi.FakeKubeApi()
    return pkg.operator_autoscale.AutoscaleController(api, **defaults)


def _decision(d) -> list:
    return [d.desired, d.action, d.reason]


# ---------------------------------------------------------------------------
# the scale subresource
# ---------------------------------------------------------------------------


async def _scale_case(pkg, case: str) -> list:
    K = pkg.operator_kubeapi
    api = K.FakeKubeApi()
    out: list = []
    if case == "round_trip":
        await api.create_obj(_deployment(pkg, replicas=3))
        out.append(await api.get_scale("Deployment", SERVICE, "default"))
    elif case == "missing":
        out.append(await _attempt(api.get_scale("Deployment", "absent", "default")))
        out.append(await _attempt(api.patch_scale("Deployment", "absent", "default", 1)))
    elif case == "notify":
        await api.create_obj(_deployment(pkg, replicas=1))
        _, rv = await api.list_rv("Deployment", "default")
        seen = []

        async def consume():
            async for event in api.watch("Deployment", "default", resource_version=rv):
                seen.append([event.type, event.object["spec"]])
                return

        task = asyncio.create_task(consume())
        await asyncio.sleep(0.01)
        out.append(await api.patch_scale("Deployment", SERVICE, "default", 4))
        await asyncio.wait_for(task, 2)
        out += [seen, await api.get_scale("Deployment", SERVICE, "default")]
    elif case == "stale_rv":
        await api.create_obj(_deployment(pkg, replicas=1))
        stale = await api.get_scale("Deployment", SERVICE, "default")
        await api.patch_scale("Deployment", SERVICE, "default", 2)
        out.append(await _attempt(api.patch_scale(
            "Deployment", SERVICE, "default", 5,
            resource_version=stale["metadata"]["resourceVersion"])))
    elif case == "kind_filter":
        await api.create_obj(_deployment(pkg, replicas=1))
        await api.create_obj(_endpoints(pkg, ["10.0.0.1"]))
        api.inject_errors("patch_scale", lambda: K.ApiError("partitioned"), times=1,
                          kind="Endpoints")
        out.append(await api.patch_scale("Deployment", SERVICE, "default", 2))
        api.inject_errors("patch_scale", lambda: K.ApiError("partitioned"), times=1,
                          kind="Deployment")
        out.append(await _attempt(api.patch_scale("Deployment", SERVICE, "default", 3)))
        out.append(await api.patch_scale("Deployment", SERVICE, "default", 3))
        out.append(await api.get_scale("Deployment", SERVICE, "default"))
    return out


@pytest.mark.parametrize("case", ["round_trip", "missing", "notify", "stale_rv", "kind_filter"])
def test_scale_subresource_matches_jax(case):
    ref, port = both(_scale_case, case)
    assert port == ref
    if case == "round_trip":
        assert port[0]["kind"] == "Scale" and port[0]["spec"]["replicas"] == 3
    if case == "notify":
        assert port[1] == [["MODIFIED", {"replicas": 4}]]
    if case == "stale_rv":
        assert port[0] == {"error": "ConflictError"}


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------


def _decide_case(pkg, case: str) -> list:
    c = lambda **kw: _controller(pkg, **kw)  # noqa: E731
    if case == "wake_from_zero":
        return [_decision(c(pending=lambda: 3, fleet=lambda: {}).decide(0, now=0.0))]
    if case == "idle_at_zero":
        return [_decision(c(pending=lambda: 0, fleet=lambda: {}).decide(0, now=0.0))]
    if case == "floor_at_zero":
        return [_decision(c(pending=lambda: 0, fleet=lambda: {}, min_replicas=2).decide(0, now=0.0))]
    if case == "pressure_burst":
        ctl = c(fleet=lambda: {"queueDepth": 6, "inflight": 2, "pressure": 5.0})
        return [_decision(ctl.decide(2, now=0.0))]
    if case == "blocked_at_max":
        ctl = c(fleet=lambda: {"queueDepth": 6, "pressure": 9.0}, max_replicas=4)
        return [_decision(ctl.decide(4, now=0.0))]
    if case == "role_burst":
        ctl = c(fleet=lambda: {"queueDepth": 1, "pressure": 1.0, "roles": {
            "prefill": {"ready": 2, "replicas": 2, "pressure": 10.0},
            "decode": {"ready": 1, "replicas": 1, "pressure": 0.0}}})
        return [_decision(ctl.decide(3, now=0.0))]
    if case == "lagging_slo":
        ctl = c(fleet=lambda: {"queueDepth": 1, "pressure": 1.0}, pending=lambda: 2,
                attainment=lambda: {"batch": 0.99, "interactive": 0.5})
        return [_decision(ctl.decide(2, now=0.0))]
    if case == "idle_to_zero":
        ctl = c(fleet=lambda: {}, pending=lambda: 0, idle_s=10.0)
        return [_decision(ctl.decide(2, now=t)) for t in (100.0, 105.0, 110.0)]
    if case == "busy_resets_idle":
        state = {"queue": 0}
        ctl = c(fleet=lambda: {"queueDepth": state["queue"]}, pending=lambda: 0, idle_s=10.0)
        out = [_decision(ctl.decide(2, now=0.0))]
        state["queue"] = 1
        out.append(_decision(ctl.decide(2, now=9.0)))
        state["queue"] = 0
        out += [_decision(ctl.decide(2, now=t)) for t in (12.0, 21.0, 23.0)]
        return out
    if case == "floor_down":
        ctl = c(fleet=lambda: {}, pending=lambda: 0, min_replicas=1, idle_s=5.0)
        return [_decision(ctl.decide(3, now=t)) for t in (0.0, 6.0)]
    raise AssertionError(case)


_DECIDE = {
    "wake_from_zero": [[1, "up", None]],
    "idle_at_zero": [[0, "hold", "idle at zero"]],
    "floor_at_zero": [[2, "up", "floor min_replicas=2"]],
    "pressure_burst": [[3, "up", None]],
    "blocked_at_max": [[4, "blocked", None]],
    "role_burst": [[4, "up", None]],
    "lagging_slo": [[3, "up", None]],
    "idle_to_zero": [[2, "hold", None], [2, "hold", None], [0, "to_zero", None]],
    "busy_resets_idle": [[2, "hold", None], [2, "hold", "busy"], [2, "hold", None],
                         [2, "hold", None], [0, "to_zero", None]],
    "floor_down": [[3, "hold", None], [1, "down", None]],
}


@pytest.mark.parametrize("case", sorted(_DECIDE))
def test_decide_matches_jax(case):
    ref, port = both(_decide_case, case)
    assert port == ref
    for got, (desired, action, reason) in zip(port, _DECIDE[case], strict=True):
        assert got[:2] == [desired, action]
        if reason is not None:
            assert got[2] == reason


# ---------------------------------------------------------------------------
# actuation
# ---------------------------------------------------------------------------


async def _tick_case(pkg, case: str) -> dict:
    K = pkg.operator_kubeapi
    api = K.FakeKubeApi()
    metrics = pkg.utils_timing.MetricsRegistry()
    out: dict = {}
    if case == "wake":
        await api.create_obj(_deployment(pkg, replicas=0))
        ctl = _controller(pkg, api, pending=lambda: 2, fleet=lambda: {}, metrics=metrics)
        out["decisions"] = [_decision(await ctl.tick())]
        out["view"] = ctl.view()
    elif case == "partition":
        await api.create_obj(_deployment(pkg, replicas=0))
        ctl = _controller(pkg, api, pending=lambda: 1, fleet=lambda: {}, metrics=metrics)
        api.inject_errors("patch_scale", lambda: K.ApiError("partitioned"), times=1,
                          kind="Deployment")
        out["decisions"] = [_decision(await ctl.tick()), _decision(await ctl.tick())]
        out["view"] = ctl.view()
    elif case == "hold":
        await api.create_obj(_deployment(pkg, replicas=2))
        ctl = _controller(pkg, api, fleet=lambda: {"queueDepth": 1, "pressure": 1.0},
                          metrics=metrics)
        before = await api.get_scale("Deployment", SERVICE, "default")
        out["decisions"] = [_decision(await ctl.tick())]
        after = await api.get_scale("Deployment", SERVICE, "default")
        out["unchanged"] = after["metadata"] == before["metadata"]
    elif case == "run_to_zero":
        await api.create_obj(_deployment(pkg, replicas=2))
        ctl = _controller(pkg, api, fleet=lambda: {}, pending=lambda: 0, idle_s=0.05,
                          interval_s=0.01, metrics=metrics)
        stop = asyncio.Event()
        task = asyncio.create_task(ctl.run(stop))
        for _ in range(300):
            await asyncio.sleep(0.01)
            if (await api.get_scale("Deployment", SERVICE, "default"))["spec"]["replicas"] == 0:
                break
        stop.set()
        await asyncio.wait_for(task, 2)
        out["view"] = {"desiredReplicas": ctl.view()["desiredReplicas"]}
    elif case == "missing_deployment":
        ctl = _controller(pkg, api, pending=lambda: 1, fleet=lambda: {}, metrics=metrics)
        out["tick"] = await _attempt(ctl.tick())
        stop = asyncio.Event()
        task = asyncio.create_task(ctl.run(stop))
        await asyncio.sleep(0.05)  # the loop outlives failing ticks
        stop.set()
        await asyncio.wait_for(task, 2)
        out["alive_until_stop"] = task.exception() is None
    out["scale"] = await _attempt(api.get_scale("Deployment", SERVICE, "default"))
    out["counters"] = {k: v for k, v in metrics.snapshot()["counters"].items()
                       if k.startswith("autoscale_")}
    return out


@pytest.mark.parametrize("case", ["wake", "partition", "hold", "run_to_zero",
                                  "missing_deployment"])
def test_tick_and_run_match_jax(case):
    ref, port = both(_tick_case, case)
    assert port == ref
    if case == "wake":
        assert port["scale"]["spec"]["replicas"] == 1 and port["counters"] == {"autoscale_up": 1}
        assert "wake-from-zero" in port["view"]["lastScaleReason"]
    if case == "partition":
        assert [d[1] for d in port["decisions"]] == ["blocked", "up"]
        assert "patch failed" in port["decisions"][0][2]
        assert port["counters"] == {"autoscale_blocked": 1, "autoscale_up": 1}
    if case == "hold":
        assert port["unchanged"] and port["counters"] == {}
    if case == "run_to_zero":
        assert port["scale"]["spec"]["replicas"] == 0
        assert port["counters"] == {"autoscale_to_zero": 1}


# ---------------------------------------------------------------------------
# endpoint urls and discovery
# ---------------------------------------------------------------------------


def _urls_case(pkg, case: str) -> dict:
    s = pkg.schema
    meta = s.ObjectMeta(name=SERVICE, namespace="default")
    if case == "named_port":
        obj = _endpoints(pkg, ["10.0.0.1", "10.0.0.2"])
    elif case == "not_ready":
        obj = s.Endpoints(metadata=meta, subsets=[s.EndpointSubset(
            addresses=[s.EndpointAddress(ip="10.0.0.1")],
            not_ready_addresses=[s.EndpointAddress(ip="10.0.0.9")],
            ports=[s.EndpointPort(name="http", port=8000)])])
    elif case == "unnamed_port":
        obj = s.Endpoints(metadata=meta, subsets=[s.EndpointSubset(
            addresses=[s.EndpointAddress(ip="10.0.0.1")], ports=[s.EndpointPort(port=9090)])])
    elif case == "ipv6":
        obj = s.Endpoints(metadata=meta, subsets=[s.EndpointSubset(
            addresses=[s.EndpointAddress(ip="fd00::1")],
            ports=[s.EndpointPort(name="http", port=8000)])])
    elif case == "portless":
        obj = s.Endpoints(metadata=meta, subsets=[s.EndpointSubset(
            addresses=[s.EndpointAddress(ip="10.0.0.1")])])
    elif case == "one_subset_per_replica":
        obj = s.Endpoints(metadata=meta, subsets=[
            s.EndpointSubset(addresses=[s.EndpointAddress(ip="127.0.0.1")],
                             ports=[s.EndpointPort(name="http", port=p)]) for p in (8001, 8002)])
    else:
        raise AssertionError(case)
    return pkg.router.endpoint_urls(obj.to_dict(), scheme="http", port_name="http")


_URLS = {
    "named_port": ["http://10.0.0.1:8000", "http://10.0.0.2:8000"],
    "not_ready": ["http://10.0.0.1:8000"],
    "unnamed_port": ["http://10.0.0.1:9090"],
    "ipv6": ["http://[fd00::1]:8000"],
    "portless": [],
    "one_subset_per_replica": ["http://127.0.0.1:8001", "http://127.0.0.1:8002"],
}


@pytest.mark.parametrize("case", sorted(_URLS))
def test_endpoint_urls_match_jax(case):
    ref, port = both(_urls_case, case)
    assert port == ref and sorted(port) == _URLS[case]


def _discovery(pkg, api, router, **kw):
    defaults = dict(service=SERVICE, namespace="default", kube_timeout_s=5.0,
                    restart_delay_s=0.01)
    defaults.update(kw)
    return pkg.router.EndpointDiscovery(api, router, **defaults)


async def _wait_len(router, n):
    for _ in range(200):
        if len(router) == n:
            return True
        await asyncio.sleep(0.01)
    return False


async def _discovery_case(pkg, case: str) -> dict:
    api = pkg.operator_kubeapi.FakeKubeApi()
    metrics = pkg.utils_timing.MetricsRegistry()
    router = pkg.router.EngineRouter([], metrics=metrics)
    out: dict = {}
    if case == "membership":
        await api.create_obj(_endpoints(pkg, ["10.0.0.1", "10.0.0.2"]))
        disc = _discovery(pkg, api, router)
        stop = asyncio.Event()
        task = asyncio.create_task(disc.run(stop))
        out["synced"] = await disc.wait_synced(2.0)
        out["listed"] = disc.members()
        await api.patch("Endpoints", SERVICE, "default",
                        {"subsets": _endpoints(pkg, ["10.0.0.1"]).to_dict()["subsets"]})
        out["scaled_in"] = [await _wait_len(router, 1), disc.members()]
        await api.delete("Endpoints", SERVICE, "default")
        out["deleted"] = [await _wait_len(router, 0), disc.members()]
        stop.set()
        api.close_watches()
        await asyncio.wait_for(task, 2)
    elif case == "prewarm":
        ready = {"ok": False}
        probed = []

        async def prewarm(replica):
            probed.append(replica.id)
            return ready["ok"]

        disc = _discovery(pkg, api, router, prewarm=prewarm)
        obj = _endpoints(pkg, ["10.0.0.1"]).to_dict()
        await disc._sync(obj)
        out["refused"] = [len(router), list(probed)]
        ready["ok"] = True
        await disc._sync(obj)
        out["joined"] = [len(router), disc.members()]

        async def exploding(replica):
            raise RuntimeError("probe refused")

        disc.prewarm = exploding
        await disc._sync(_endpoints(pkg, ["10.0.0.1", "10.0.0.2"]).to_dict())
        out["raised"] = disc.members()
    elif case == "static_seed":
        router = pkg.router.EngineRouter(
            [pkg.router_core.Replica(id="static-seed", url="http://static:8000")], metrics=metrics)
        disc = _discovery(pkg, api, router)
        await disc._sync(_endpoints(pkg, ["10.0.0.1"]).to_dict())
        out["added"] = len(router)
        await disc._sync(None)
        out["drained"] = [len(router), disc.members()]
    elif case == "compaction":
        await api.create_obj(_endpoints(pkg, []))
        disc = _discovery(pkg, api, router, restart_delay_s=0.05)
        stop = asyncio.Event()
        task = asyncio.create_task(disc.run(stop))
        out["synced"] = await disc.wait_synced(2.0)
        api.close_watches()
        await api.patch("Endpoints", SERVICE, "default", {
            "subsets": _endpoints(pkg, ["10.0.0.1", "10.0.0.2"]).to_dict()["subsets"]})
        api.compact_watch_history("Endpoints")
        out["relisted"] = [await _wait_len(router, 2), disc.members()]
        stop.set()
        api.close_watches()
        await asyncio.wait_for(task, 2)
    elif case == "created_later":
        disc = _discovery(pkg, api, router)
        stop = asyncio.Event()
        task = asyncio.create_task(disc.run(stop))
        out["synced"] = [await disc.wait_synced(2.0), len(router)]
        await api.create_obj(_endpoints(pkg, ["10.0.0.1"]))
        await api.create_obj(_endpoints(pkg, ["10.9.9.9"], name="other-svc"))
        out["joined"] = [await _wait_len(router, 1), disc.members()]
        stop.set()
        api.close_watches()
        await asyncio.wait_for(task, 2)
    out["counters"] = {k: v for k, v in metrics.snapshot()["counters"].items()
                       if k.startswith("ring_")}
    return out


@pytest.mark.parametrize("case", ["membership", "prewarm", "static_seed", "compaction",
                                  "created_later"])
def test_endpoint_discovery_matches_jax(case):
    ref, port = both(_discovery_case, case)
    assert port == ref
    if case == "membership":
        assert port["listed"] == ["http://10.0.0.1:8000", "http://10.0.0.2:8000"]
        assert port["scaled_in"] == [True, ["http://10.0.0.1:8000"]]
        assert port["deleted"] == [True, []]
        assert port["counters"] == {"ring_member_added": 2, "ring_member_removed": 2,
                                    "ring_resize": 4}
    if case == "prewarm":
        assert port["refused"] == [0, ["http://10.0.0.1:8000"]]
        assert port["raised"] == ["http://10.0.0.1:8000"]
    if case == "static_seed":
        assert port["added"] == 2 and port["drained"] == [1, []]
    if case == "compaction":
        assert port["relisted"][0]
    if case == "created_later":
        assert port["joined"] == [True, ["http://10.0.0.1:8000"]]
