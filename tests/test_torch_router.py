"""The port's router and OpenAI-compatible provider against the JAX
package's, case by case after ``tests/test_router.py``.

Every scenario runs once per package with the same inputs — the same
injected clock, the same fake ``send`` or urllib opener — and what comes
out must be equal: ring preferences and remaps, health gating and
half-open readmission, shedding, dispatch (which replicas are tried in
which order, the residual budget each attempt gets, counters and raised
messages), ``replica_set`` and ``_completions_url``, the provider's
request bodies, headers, idempotency keys and ``AIResponse``s, the
background ``/healthz`` poll and the fleet view, and ``ResumeLog``
replay from its journal.  The reference's fault-plan seam is not ported
(ROADMAP Queue 1 item 5a), so its kill scenarios fail the replica in the
fake transport instead.
"""

import asyncio
import io
import json
import random
import urllib.error
import urllib.parse
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import operator_tpu.obs as jax_obs  # noqa: E402
import operator_tpu.operator.providers as jax_providers  # noqa: E402
import operator_tpu.router as jax_router  # noqa: E402
import operator_tpu.router.health as jax_health  # noqa: E402
import operator_tpu.schema.analysis as jax_analysis  # noqa: E402
import operator_tpu.utils.deadline as jax_deadline  # noqa: E402
import operator_tpu.utils.timing as jax_timing  # noqa: E402
import operator_tpu_torch.obs as obs  # noqa: E402
import operator_tpu_torch.operator.providers as providers  # noqa: E402
import operator_tpu_torch.router as router_pkg  # noqa: E402
import operator_tpu_torch.router.health as health  # noqa: E402
import operator_tpu_torch.schema.analysis as analysis  # noqa: E402
import operator_tpu_torch.utils.deadline as deadline  # noqa: E402
import operator_tpu_torch.utils.timing as timing  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(router=jax_router, health=jax_health, providers=jax_providers,
                           analysis=jax_analysis, deadline=jax_deadline, timing=jax_timing,
                           obs=jax_obs),
    "port": SimpleNamespace(router=router_pkg, health=health, providers=providers,
                            analysis=analysis, deadline=deadline, timing=timing, obs=obs),
}
KEYS = [f"key-{i}" for i in range(300)]


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` on both packages; the results must be
    equal.  Returns the port's."""
    got = {name: scenario(pkg, *args, **kw) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _key_preferring(router, replica_id):
    for i in range(1000):
        key = f"probe-{i}"
        if router.route(key).replica.id == replica_id:
            return key
    raise AssertionError(f"no key prefers {replica_id}")


# ---------------------------------------------------------------------------
# the hash ring
# ---------------------------------------------------------------------------

def _ring(pkg, members, vnodes, change):
    ring = pkg.router.HashRing(members, vnodes=vnodes)
    before = {key: ring.preference(key) for key in KEYS}
    if change:
        verb, member = change
        getattr(ring, verb)(member)
    after = {key: ring.preference(key) for key in KEYS}
    return before, after


@pytest.mark.parametrize("members,vnodes,change", [
    (["r1", "r2", "r3"], 32, None),
    (["r1", "r2", "r3", "r4"], 64, ("remove", "r2")),
    (["r1", "r2", "r3"], 64, ("add", "r4")),
    ([f"http://serving-{i}:8000" for i in range(5)], 64, ("remove", "http://serving-3:8000")),
], ids=["three", "remove", "add", "urls"])
def test_ring_preferences_and_remaps_equal_the_jax_ring(members, vnodes, change):
    before, after = both(_ring, members, vnodes, change)
    for key in KEYS:
        assert sorted(before[key]) == sorted(members)
    if change and change[0] == "remove":
        gone = change[1]
        for key in KEYS:
            if before[key][0] != gone:  # survivors keep every key they owned
                assert after[key][0] == before[key][0]
    if change and change[0] == "add":
        moved = [k for k in KEYS if after[k][0] != before[k][0]]
        assert moved and all(after[k][0] == change[1] for k in moved)


# ---------------------------------------------------------------------------
# health gating
# ---------------------------------------------------------------------------

def _half_open(pkg):
    clock = {"t": 0.0}
    router = pkg.router.EngineRouter(["a", "b"], failure_threshold=2, reset_s=10.0,
                                     clock=lambda: clock["t"],
                                     metrics=pkg.timing.MetricsRegistry())
    key = _key_preferring(router, "a")
    seen = [router.health.observe_failure("a"), router.health.observe_failure("a")]
    seen.append(router.route(key).replica.id)
    clock["t"] += 11.0
    seen.append(router.route(key).replica.id)
    for _ in range(5):
        router.route(key)
    seen.append(router.health.breakers.for_key("a").state)

    async def send_ok(replica, attempt, budget_s):
        return replica.id

    async def send_fail(replica, attempt, budget_s):
        if replica.id == "a":
            raise RuntimeError("probe fails")
        return replica.id

    outcome = run(router.dispatch(send_fail, key=key, attempts=2))
    seen += [outcome.response, outcome.requeues, router.health.breakers.for_key("a").state,
             router.route(key).replica.id]
    clock["t"] += 11.0
    outcome = run(router.dispatch(send_ok, key=key, attempts=1))
    seen += [outcome.response, router.health.breakers.for_key("a").state,
             router.health.states()]
    return seen


def test_breaker_gated_exclusion_and_half_open_readmission():
    seen = both(_half_open)
    assert seen[:5] == [False, True, "b", "a", "open"]
    assert seen[5:9] == ["b", 1, "open", "b"]
    assert seen[9:11] == ["a", "closed"]


def _probe_and_gave_up(pkg):
    router = pkg.router.EngineRouter(["a", "b"], failure_threshold=2,
                                     metrics=pkg.timing.MetricsRegistry())
    key = _key_preferring(router, "a")
    seen = []
    for step in ("probe_down", "probe_up", "gave_up", "recovered"):
        if step == "probe_down":
            router.mark_probe("a", False)
        elif step == "probe_up":
            router.mark_probe("a", True)
        elif step == "gave_up":
            router.report_load("a", pkg.router.ReplicaLoad(gave_up=True))
        else:
            router.report_load("a", pkg.router.ReplicaLoad())
        seen.append(router.route(key).replica.id)
    for _ in range(2):
        router.health.observe_failure("a")
        router.health.observe_failure("b")
    seen.append(router.route("anything"))
    seen.append(router.fleet_pressure())
    return seen


def test_failing_probe_gave_up_and_no_healthy_replica():
    assert both(_probe_and_gave_up) == ["b", "a", "b", "a", None, None]


# ---------------------------------------------------------------------------
# shedding
# ---------------------------------------------------------------------------

SHED_CASES = {
    "owner_overloaded": (["a", "b", "c"], 4, {"a": 6, "b": 2, "c": 1}, {}),
    "owner_recovered": (["a", "b", "c"], 4, {"a": 1, "b": 2, "c": 1}, {}),
    "roofline_fit": (["a", "b"], 50, {"a": 2, "b": 0}, {"deadline_s": 40.0, "tokens": 64}),
    "roofline_no_deadline": (["a", "b"], 50, {"a": 2, "b": 0}, {"tokens": 64}),
    "all_overloaded": (["a", "b"], 2, {"a": 9, "b": 5}, {}),
}


def _shed(pkg, members, pressure, depths, route_kw):
    router = pkg.router.EngineRouter(members, shed_pressure=pressure,
                                     metrics=pkg.timing.MetricsRegistry())
    key = _key_preferring(router, "a")
    for rid, depth in depths.items():
        router.report_load(rid, pkg.router.ReplicaLoad(queue_depth=depth, decode_token_s=0.5))
    decision = router.route(key, **route_kw)
    return (decision.replica.id, decision.shed, decision.affinity_owner,
            router.fleet_pressure())


@pytest.mark.parametrize("case", sorted(SHED_CASES))
def test_shedding_decides_as_the_jax_router(case):
    replica, shed, owner, _ = both(_shed, *SHED_CASES[case])
    assert owner == "a"
    assert shed == (replica != "a")


def _verdicts(pkg):
    out = []
    for pressure in (0, 4, 12, 40):
        router = pkg.router.EngineRouter(["a", "b"], metrics=pkg.timing.MetricsRegistry())
        model = pkg.router.ValueModel({"batch": 300.0, "standard": 60.0, "interactive": 5.0})
        router.policy = pkg.router.OverloadPolicy(model, shed_pressure=8.0, degrade_pressure=4.0,
                                                  metrics=pkg.timing.MetricsRegistry())
        for rid in ("a", "b"):
            router.report_load(rid, pkg.router.ReplicaLoad(queue_depth=pressure))
        for cls, residual in (("batch", None), ("standard", 30.0), ("interactive", 2.0)):
            value = router.policy.model.value(slo_class=cls, residual_s=residual,
                                              recall_p=0.1)
            verdict = router.overload_verdict(value=value, request_id=f"{cls}-{pressure}")
            out.append((pressure, cls, verdict.action, verdict.degrade_tokens_frac))
    return out


def test_overload_verdicts_equal_the_jax_router():
    actions = {action for *_, action, _ in both(_verdicts)}
    assert {"serve", "degrade", "shed"} <= actions


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _requeue(pkg):
    clock = {"t": 0.0}
    metrics = pkg.timing.MetricsRegistry()
    router = pkg.router.EngineRouter(["a", "b"], clock=lambda: clock["t"], metrics=metrics)
    budget = pkg.deadline.Deadline.start(10.0, clock=lambda: clock["t"])
    seen = []

    async def send(replica, attempt, budget_s):
        seen.append((replica.id, attempt, round(budget_s, 3)))
        if len(seen) == 1:
            clock["t"] += 3.0  # the dying replica ate 3 s of budget
            raise RuntimeError("replica died mid-stream")
        return "ok"

    outcome = run(router.dispatch(send, key="k", deadline=budget, attempts=3))
    return (seen, outcome.response, outcome.replica_id, outcome.attempts, outcome.requeues,
            metrics.snapshot()["counters"])


def test_requeue_carries_the_residual_deadline():
    seen, response, replica_id, _, requeues, counters = both(_requeue)
    assert [b for *_, b in seen] == [10.0, 7.0] and seen[0][0] != seen[1][0]
    assert response == "ok" and requeues == 1 and replica_id == seen[1][0]
    assert counters["router_failover"] == 1 and counters["router_routed"] == 1


def _failing(pkg, members, attempts, budget_s, elapsed_s, send_kind):
    clock = {"t": 0.0}
    metrics = pkg.timing.MetricsRegistry()
    router = pkg.router.EngineRouter(members, clock=lambda: clock["t"], metrics=metrics)
    budget = None
    if budget_s is not None:
        budget = pkg.deadline.Deadline.start(budget_s, clock=lambda: clock["t"])
        clock["t"] += elapsed_s
    tried = []
    calls = {"n": 0}

    async def send(replica, attempt, budget_s):
        tried.append(replica.id)
        calls["n"] += 1
        if send_kind == "flaky" and calls["n"] >= 3:
            return "ok"
        raise RuntimeError(f"{replica.id} down")

    try:
        outcome = run(router.dispatch(send, key="k", deadline=budget, attempts=attempts,
                                      backoff_s=0.0))
        result = ("ok", outcome.response, outcome.requeues, outcome.attempts)
    except pkg.router.RouterError as exc:
        result = ("error", str(exc), exc.tried, str(exc.last_error))
    return result, tried, metrics.snapshot()["counters"]


@pytest.mark.parametrize("members,attempts,budget_s,elapsed_s,kind", [
    (["a", "b", "c"], 6, None, 0.0, "down"),
    (["a"], 1, 5.0, 6.0, "down"),
    (["solo"], 5, None, 0.0, "flaky"),
    (["a", "b"], 4, None, 0.0, "flaky"),
], ids=["one_requeue", "expired_deadline", "single_replica_retries", "flaky_pair"])
def test_dispatch_orders_and_failures_equal_the_jax_router(members, attempts, budget_s,
                                                          elapsed_s, kind):
    result, tried, counters = both(_failing, members, attempts, budget_s, elapsed_s, kind)
    if kind == "down" and budget_s is None:
        assert result[0] == "error" and "requeue" in result[1]
        assert counters["router_failover"] == 1
    if budget_s is not None:
        assert result[0] == "error" and "deadline" in result[1] and not tried


def _storm(pkg):
    metrics = pkg.timing.MetricsRegistry()
    recorder = pkg.obs.FlightRecorder(capacity=128, metrics=metrics)
    tracer = pkg.obs.Tracer(recorder=recorder)
    router = pkg.router.EngineRouter(["a", "b", "c"], shed_pressure=4, metrics=metrics)
    pressure = {"a": 0, "b": 0, "c": 0}
    rng = random.Random(42)
    served = []

    async def storm():
        for i in range(40):
            key = f"fp:{rng.randrange(6)}"

            async def send(replica, attempt, budget_s):
                pressure[replica.id] += 1
                router.report_load(replica.id,
                                   pkg.router.ReplicaLoad(queue_depth=pressure[replica.id]))
                return replica.id

            with tracer.trace(f"storm-{i}"):
                outcome = await router.dispatch(send, key=key, request_id=str(i))
            served.append((outcome.replica_id, outcome.shed))
            if i % 3 == 2:
                victim = rng.choice(["a", "b", "c"])
                pressure[victim] = max(0, pressure[victim] - 2)
                router.report_load(victim, pkg.router.ReplicaLoad(queue_depth=pressure[victim]))

    run(storm())
    spans = [s["attributes"]["replica"] for record in recorder.traces()
             for s in record.trace["spans"] if s["name"] == "router.dispatch"]
    return served, metrics.snapshot()["counters"], sorted(spans)


def test_overload_storm_sheds_as_the_jax_router():
    served, counters, spans = both(_storm)
    assert counters["router_routed"] == 40 and counters["router_shed"] > 0
    assert len(spans) == 40


def _drains(pkg):
    """A partitioned replica: every send to ``a`` dies; two kills open its
    breaker and the third request never touches it."""
    metrics = pkg.timing.MetricsRegistry()
    clock = {"t": 0.0}
    router = pkg.router.EngineRouter(["a", "b"], failure_threshold=2, reset_s=30.0,
                                     clock=lambda: clock["t"], metrics=metrics)
    key = _key_preferring(router, "a")
    served = []

    async def send(replica, attempt, budget_s):
        if replica.id == "a":
            raise urllib.error.URLError("partitioned")
        served.append(replica.id)
        return replica.id

    outcomes = [run(router.dispatch(send, key=key, attempts=3)) for _ in range(3)]
    return ([(o.replica_id, o.requeues) for o in outcomes], served,
            metrics.snapshot()["counters"], router.health.breakers.for_key("a").state)


def test_partitioned_replica_breaker_drains_follow_up_traffic():
    outcomes, served, counters, state = both(_drains)
    assert outcomes == [("b", 1), ("b", 1), ("b", 0)] and served == ["b", "b", "b"]
    assert counters["router_excluded"] == 1 and counters["router_failover"] == 2
    assert state == "open"


# ---------------------------------------------------------------------------
# the provider: URLs, request bodies, headers, responses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("api_url", [
    "http://h1:8000, https://h2/v1 http://h1:8000/", "h1:8000", "http://good, bare-host",
    "   ", "https://api.example.com/v1",
])
def test_replica_set_equals_the_jax_providers(api_url):
    def parse(pkg):
        try:
            return [(r.id, r.url) for r in pkg.providers.replica_set(api_url)]
        except pkg.providers.ProviderError as exc:
            return str(exc)

    both(parse)


@pytest.mark.parametrize("base", [
    "http://h:8000", "http://h:8000/", "https://api.openai.com/v1",
    "http://h/v1/chat/completions",
])
def test_completions_url_equals_the_jax_providers(base):
    both(lambda pkg: pkg.providers._completions_url(base))


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _opener(dead=(), text="Root Cause: ok."):
    """An OpenAI-compatible transport that records each request; netlocs
    in ``dead`` refuse connections."""
    seen = []

    def opener(req, timeout=None):
        netloc = urllib.parse.urlsplit(req.full_url).netloc
        seen.append({
            # a residual deadline is read off the wall clock: whole seconds
            "url": req.full_url, "method": req.get_method(),
            "timeout": None if timeout is None else round(timeout),
            "headers": {k.lower(): v for k, v in req.header_items()},
            "body": json.loads(req.data) if req.data else None,
        })
        if netloc in dead:
            raise urllib.error.URLError(f"{netloc} refused")
        return _Resp(json.dumps({
            "choices": [{"message": {"content": text}}],
            "usage": {"prompt_tokens": 10, "completion_tokens": 5},
        }).encode())

    opener.seen = seen
    return opener


def _request(pkg, api_url, **kw):
    a = pkg.analysis
    config = dict(provider_id="openai", api_url=api_url, model_id="m", max_retries=3,
                  auth_token="tok", max_tokens=64, temperature=0.2)
    config.update(kw.pop("config", {}))
    return a.AnalysisRequest(analysis_result=a.AnalysisResult(),
                             provider_config=a.AIProviderConfig(**config), **kw)


def _provider_case(pkg, api_url, dead, requests, traced):
    opener = _opener(dead)
    metrics = pkg.timing.MetricsRegistry()
    provider = pkg.providers.OpenAICompatProvider(opener, metrics=metrics)
    responses = []
    tracer = pkg.obs.Tracer(recorder=None)
    for kw in requests:
        if traced:
            async def traced_call(kw=kw):
                with tracer.trace("analysis"):
                    return await provider.generate(_request(pkg, api_url, **kw))

            response = run(traced_call())
        else:
            response = run(provider.generate(_request(pkg, api_url, **kw)))
        responses.append(response.to_dict())
    for call in opener.seen:
        if "traceparent" in call["headers"]:
            value = call["headers"]["traceparent"].split("-")
            call["headers"]["traceparent"] = [len(part) for part in value]
    return responses, opener.seen, {
        k: v for k, v in metrics.snapshot()["counters"].items() if k.startswith("router_")
    }


PROVIDER_CASES = {
    "one_replica": ("http://fake/v1", (), [{}, {}], False),
    "traced": ("http://fake:8000", (), [{}], True),
    "fingerprint_affinity": ("http://r1:8000,http://r2:8000,http://r3:8000", (),
                             [{"fingerprint": "deadbeef" * 8}] * 3, False),
    "prefix_affinity": ("http://r1:8000,http://r2:8000,http://r3:8000", (),
                        [{}, {"fingerprint": "f00d"}], False),
    "dead_replica_requeues": ("http://r1:8000,http://r2:8000", ("r1:8000", "r2:8000"),
                              [{"fingerprint": "cafe"}], False),
    "one_dead_of_two": ("http://r1:8000,http://r2:8000", ("r2:8000",),
                        [{"fingerprint": fp} for fp in ("a1", "b2", "c3", "d4")], False),
    "deadline": ("http://r1:8000", (), [{"deadline_s": 30.0}], False),
    "bad_url": ("backend:8000", (), [{}], False),
    "no_url": ("", (), [{}], False),
}


@pytest.mark.parametrize("case", sorted(PROVIDER_CASES))
def test_provider_requests_and_responses_equal_the_jax_providers(case):
    responses, seen, counters = both(_provider_case, *PROVIDER_CASES[case])
    if case == "one_replica":
        keys = [call["headers"]["x-podmortem-request-id"] for call in seen]
        assert keys[0] and keys[0] == keys[1]
        assert responses[0]["replicaId"] == "http://fake/v1"
        assert seen[0]["body"]["messages"][0]["role"] == "user"
        assert seen[0]["headers"]["authorization"] == "Bearer tok"
    if case == "traced":
        assert seen[0]["headers"]["traceparent"] == [2, 32, 16, 2]
    if case == "fingerprint_affinity":
        assert len({r["replicaId"] for r in responses}) == 1
    if case == "one_dead_of_two":
        assert all(r["replicaId"] == "http://r1:8000" for r in responses)
        assert any(r["requeues"] == 1 for r in responses)
    if case == "bad_url":
        assert "invalid apiUrl" in responses[0]["error"]


# ---------------------------------------------------------------------------
# the background /healthz poll and the fleet view
# ---------------------------------------------------------------------------

def _healthz_opener(payloads):
    seen = []

    def opener(req, timeout=None):
        url = req.full_url
        seen.append((url, timeout))
        payload = payloads[urllib.parse.urlsplit(url).netloc]
        if isinstance(payload, Exception):
            raise payload
        return _Resp(json.dumps(payload).encode())

    opener.seen = seen
    return opener


LOAD = {"queueDepth": 7, "inflight": 2, "decodeTokenS": 0.01, "gaveUp": False,
        "decodeMfu": 0.02, "hostGapFrac": 0.5, "occupancy": 0.25, "steps": 12,
        "sloAttainment": 1.0, "goodput": 12.5, "sloCompleted": 3,
        "sloClasses": {"default": {"queued": 0, "completed": 3, "attained": 3,
                                   "attainment": 1.0}},
        "kvPagesFree": 60, "kvPagesTotal": 64, "prefixHitRate": 0.5, "kvLookups": 4,
        "kvBlocks": ["ab" * 16], "role": "mixed", "shedTotal": 1, "degradedTotal": 0}


def _poll(pkg, sweeps):
    metrics = pkg.timing.MetricsRegistry()
    payloads = dict(sweeps[0])
    opener = _healthz_opener(payloads)
    provider = pkg.providers.OpenAICompatProvider(opener, metrics=metrics)
    router = provider.router_for([pkg.router.Replica(id=f"http://{n}/v1", url=f"http://{n}/v1")
                                  for n in sorted(payloads)])
    out = []
    for sweep in sweeps:
        payloads.update(sweep)
        polled = run(provider.poll_replica_health(timeout_s=3.0))
        out.append((polled, {rid: router.health.can_route(rid) for rid in sorted(router._replicas)},
                    router.health.states(), provider.fleet_view(), provider.fleet_pressure()))
    return out, opener.seen, metrics.snapshot()["counters"]


POLL_CASES = {
    "feeds_probe_and_load": [{
        "r1:8000": {"status": "ok", "replica": "r1", "load": LOAD},
        "r2:8000": {"status": "degraded", "load": {"queueDepth": 0, "gaveUp": True}},
        "r3:8000": urllib.error.URLError("connection refused"),
    }],
    "readmits_on_next_sweep": [
        {"r1:8000": urllib.error.URLError("down")},
        {"r1:8000": {"status": "ok", "load": {"queueDepth": 0}}},
    ],
    "foreign_bodies": [{
        "r1:8000": {"healthy": True}, "r2:8000": "ok", "r3:8000": {"status": "ok"},
    }],
}


@pytest.mark.parametrize("case", sorted(POLL_CASES))
def test_health_poll_and_fleet_view_equal_the_jax_providers(case):
    sweeps, seen, counters = both(_poll, POLL_CASES[case])
    assert all(url.endswith("/healthz") and timeout == 3.0 for url, timeout in seen)
    if case == "feeds_probe_and_load":
        polled, routable, _, fleet, _ = sweeps[0]
        assert polled == 2
        assert routable == {"http://r1:8000/v1": True, "http://r2:8000/v1": False,
                            "http://r3:8000/v1": False}
        assert fleet["replicas"]["http://r1:8000/v1"]["queueDepth"] == 7
        assert counters["router_health_poll_failed"] == 1


def test_replica_load_round_trips_as_the_jax_load():
    """``ReplicaLoad.parse(to_dict())`` is the identity in both packages,
    and the port parses the JAX report (and vice versa) to equal dicts."""
    def round_trip(pkg):
        load = pkg.router.ReplicaLoad.parse(LOAD)
        return load.to_dict(), load.pressure(), load.est_wait_s(64)

    as_dict, pressure, wait = both(round_trip)
    assert as_dict == LOAD and pressure == 9
    assert pytest.approx(wait) == 0.01 * 64 * 10


# ---------------------------------------------------------------------------
# ResumeLog replay
# ---------------------------------------------------------------------------

def _resume(pkg, path):
    log = pkg.router.ResumeLog(str(path), compact_every=4)
    out = [log.checkpoint("r1", [1, 2]), log.checkpoint("r1", [1, 2, 3]),
           log.checkpoint("r1", [9]), log.checkpoint("r2", [7])]
    log.complete("r2")
    for i in range(6):
        log.checkpoint(f"r{3 + i}", list(range(i + 1)))
    log.complete("r4")
    log.close()
    replayed = pkg.router.ResumeLog(str(path))
    state = {rid: replayed.tokens(rid) for rid in ("r1", "r2", "r3", "r4", "r8")}
    replayed.close()
    return out, state, len(replayed)


def test_resume_log_replays_as_the_jax_log(tmp_path):
    got = {name: _resume(pkg, tmp_path / f"{name}.jsonl") for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    out, state, count = got["port"]
    assert state["r1"] == [1, 2, 3] and state["r2"] is None and state["r4"] is None
