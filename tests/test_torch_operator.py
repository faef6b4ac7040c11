"""The port's operator control plane against the JAX package's.

Every test drives both packages with the same inputs — the JAX package on
the CPU as ``tests/test_operator.py`` and ``tests/test_watcher_pipeline.py``
drive it, the port with ``device="cpu"`` — and compares what comes out:

- ``FakeKubeApi``: CRUD, resource versions, 409s, selectors, watches,
  watch replay and expiry, logs and error hooks, one case per sequence;
- storage: annotations, the ``recentFailures`` ring, the 409 retry and
  storm give-up, 403, a target deleted, truncation;
- events: the three targets and the owner chase, a failing emission;
- the claim ledger and the journal: replay after a restart on a temp path;
- ``IncidentStore`` and ``IncidentMemory``: hit, near and miss decisions
  on a fixed clock, snapshot and journal restore;
- ``SLOLedger`` settlement; the circuit breaker; ``resolve_provider_config``
  with and without the Secret; the Prometheus text;
- the watcher and the pipeline: dedupe, fan-out and recall, the
  reconcilers' poll path;
- ``run_demo`` with the ``template`` provider and with ``tpu-native`` (the
  ``tiny-test-sp`` checkpoint with the committed tokenizer, greedy), with
  and without a tiny encoder checkpoint.

Tolerance: exact, for every field, after one normalisation applied the
same way to both sides (:func:`normalise`): timestamps other than the
fixtures' failure times, uids and trace ids become placeholders, events
are sorted, and measured durations (stage times, histogram buckets and
sums) are reduced to their counts, the SLO ledger's latencies and rates
are dropped.

Also here: the port refuses each unported operator feature naming ROADMAP
Queue 1 item 5a, degrades a provider whose factory raises as the reference
does, and its ``Operator`` raises without a card unless given
``device="cpu"``.  The remote path: the port's ``Operator`` with
``providerId: openai-compatible`` against the port's ``CompletionServer``
stores what the JAX ``Operator`` stores against the JAX server;
``COMPLETION_API_PORT`` serves ``/healthz`` from the operator process, and
``GET /fleet`` serves the HTTP backend's fleet view.
"""

import asyncio
import base64
import dataclasses
import functools
import importlib
import json
import os
import re
import shutil
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_provider import LONG, _long, checkpoint  # noqa: E402,F401
from test_torch_semantic import bert_checkpoint  # noqa: E402,F401

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
_MODULES = (
    "operator", "operator.app", "operator.claims", "operator.events", "operator.kubeapi",
    "operator.providers", "operator.storage", "schema", "utils.config", "utils.journal",
    "utils.timing", "memory", "memory.store", "obs", "obs.sloledger", "patterns.engine",
    "models.configs",
)


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    health = "router.health"
    mods["router_health"] = importlib.import_module(f"{root}.{health}")
    port = root == "operator_tpu_torch"
    return SimpleNamespace(name="port" if port else "jax", device={"device": "cpu"} if port else {},
                           **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args):
    """The scenario's result in each package: (jax, port)."""
    return tuple(scenario(PKGS[name], *args) for name in ("jax", "port"))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

_ISO = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)$")
_UID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")
_TRACE = re.compile(r"^[0-9a-f]{32}$")
#: the fixtures' failure times are inputs: kept as they are
_FIXTURE_DATE = "2026-07-28T"


def normalise(value):
    """Timestamps (other than the fixtures'), uids and 32-hex trace ids
    become placeholders; lists of event-like dicts are sorted."""
    if isinstance(value, dict):
        return {k: normalise(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        items = [normalise(v) for v in value]
        if items and all(isinstance(v, dict) for v in items):
            items.sort(key=repr)
        return items
    if isinstance(value, str):
        if _ISO.match(value) and not value.startswith(_FIXTURE_DATE):
            return "<time>"
        if _UID.match(value):
            return "<uid>"
        if _TRACE.match(value):
            return "<trace>"
    if isinstance(value, float) and value != int(value):
        return value
    return value


def normalise_metrics(snapshot: dict) -> dict:
    """Counters and labeled counters as they are; stages and histograms by
    count (their values are measured durations); exemplar and gauge keys."""
    out = dict(snapshot)
    out["stages"] = {k: v["count"] for k, v in snapshot.get("stages", {}).items()}
    if "histograms" in snapshot:
        out["histograms"] = {k: v["count"] for k, v in snapshot["histograms"].items()}
    if "exemplars" in snapshot:
        out["exemplars"] = sorted(snapshot["exemplars"])
    if "gauges" in snapshot:
        out["gauges"] = sorted(snapshot["gauges"])
    return normalise(out)


#: the SLO ledger's measured figures (latencies and rates over them)
_SLO_TIMES = {"p50_s", "p95_s", "p99_s", "goodput_tokens_s", "goodput_analyses_per_min",
              "elapsed_s"}


def normalise_slo(snapshot):
    """The SLO ledger's snapshot less its measured latencies and rates."""
    if isinstance(snapshot, dict):
        return {k: normalise_slo(v) for k, v in snapshot.items() if k not in _SLO_TIMES}
    return snapshot


def _pod(pkg, name="web-1", namespace="prod", labels=None, owners=None, **status):
    s = pkg.schema
    return s.Pod(metadata=s.ObjectMeta(name=name, namespace=namespace,
                                       labels=labels or {"app": "web"},
                                       owner_references=owners or []), **status)


def _failed_pod(pkg, name="web-1", namespace="prod", labels=None, exit_code=1,
                finished_at="2026-07-28T09:00:00Z", waiting="CrashLoopBackOff"):
    s = pkg.schema
    return s.Pod(
        metadata=s.ObjectMeta(name=name, namespace=namespace, labels=labels or {"app": "web"}),
        status=s.PodStatus(phase="Running", container_statuses=[s.ContainerStatus(
            name="app", restart_count=1,
            state=s.ContainerState(waiting=s.ContainerStateWaiting(reason=waiting)),
            last_state=s.ContainerState(terminated=s.ContainerStateTerminated(
                exit_code=exit_code, finished_at=finished_at)),
        )]),
    )


def _result(pkg, severity="HIGH", pattern="port-conflict", score=1.5):
    s = pkg.schema
    return s.AnalysisResult(
        analysis_id="t1",
        summary=s.AnalysisSummary(highest_severity=severity, significant_events=1,
                                  total_events=1, score=score),
        events=[s.AnalysisEvent(score=score,
                                matched_pattern=s.MatchedPattern(id=pattern, name=pattern,
                                                                 severity=severity),
                                context=s.MatchContext(line_number=3, matched_line="boom"))],
    )


def _read(name: str) -> str:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# FakeKubeApi
# ---------------------------------------------------------------------------


async def _attempt(pkg, coro):
    try:
        return ["ok", await coro]
    except pkg.operator.ApiError as exc:
        return [type(exc).__name__, exc.status]


async def _consume(api, kind, namespace=None, resource_version=None, n=None):
    events = []
    async for event in api.watch(kind, namespace, resource_version=resource_version):
        events.append([event.type, event.object["metadata"]["name"],
                       event.object["metadata"].get("resourceVersion")])
        if n is not None and len(events) == n:
            break
    return events


def _pod_dict(name, namespace="prod", labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace, "labels": labels or {"app": "web"}}}


async def _kube_case(pkg, case: str) -> list:
    api = pkg.operator.FakeKubeApi()
    out = []
    if case == "crud_rv":
        out.append(await _attempt(pkg, api.create("Pod", _pod_dict("a"))))
        out.append(await _attempt(pkg, api.patch("Pod", "a", "prod",
                                                 {"metadata": {"labels": {"x": "y"}}})))
        out.append(await _attempt(pkg, api.get("Pod", "nope", "prod")))
        out.append(await _attempt(pkg, api.create("Pod", _pod_dict("a"))))
        out.append(await _attempt(pkg, api.create("Pod", {"metadata": {"name": "n"}})))
        out.append(await _attempt(pkg, api.delete("Pod", "a", "prod")))
        out.append(await _attempt(pkg, api.get("Pod", "a", "prod")))
        out.append(await _attempt(pkg, api.delete("Pod", "a", "prod")))
    elif case == "optimistic_concurrency":
        await api.create("Pod", _pod_dict("a"))
        rv = (await api.get("Pod", "a", "prod"))["metadata"]["resourceVersion"]
        out.append(await _attempt(pkg, api.patch("Pod", "a", "prod", {"spec": {"x": 1}},
                                                 resource_version=rv)))
        out.append(await _attempt(pkg, api.patch("Pod", "a", "prod", {"spec": {"x": 2}},
                                                 resource_version=rv)))
        out.append(await _attempt(pkg, api.patch_status("Pod", "a", "prod", {"phase": "Failed"},
                                                        resource_version=rv)))
        current = (await api.get("Pod", "a", "prod"))["metadata"]["resourceVersion"]
        out.append(await _attempt(pkg, api.patch_status("Pod", "a", "prod", {"phase": "Failed"},
                                                        resource_version=current)))
    elif case == "deep_merge":
        await api.create("Podmortem", {"metadata": {"name": "pm", "namespace": "ns"},
                                       "spec": {"a": {"b": 1, "c": [1, 2]}, "d": 1}})
        out.append(await _attempt(pkg, api.patch("Podmortem", "pm", "ns",
                                                 {"spec": {"a": {"c": [3], "e": None}, "d": None}})))
        out.append(await _attempt(pkg, api.patch_status("Podmortem", "pm", "ns",
                                                        {"recentFailures": [{"x": 1}]})))
    elif case == "selectors":
        labels = [{"app": "web", "tier": "front"}, {"app": "db"}, {"app": "web"}, {"tier": "x"}]
        for i, lab in enumerate(labels):
            await api.create("Pod", _pod_dict(f"p{i}", "prod" if i % 2 == 0 else "dev", lab))
        LS, LR = pkg.schema.LabelSelector, pkg.schema.LabelSelectorRequirement
        selectors = [
            LS(), LS(match_labels={"app": "web"}),
            LS(match_expressions=[LR(key="app", operator="In", values=["db", "web"])]),
            LS(match_expressions=[LR(key="app", operator="NotIn", values=["web"])]),
            LS(match_expressions=[LR(key="tier", operator="Exists")]),
            LS(match_expressions=[LR(key="tier", operator="DoesNotExist")]),
            LS(match_expressions=[LR(key="app", operator="Bogus", values=["web"])]),
            LS(match_labels={"app": "web"},
               match_expressions=[LR(key="tier", operator="Exists")]),
        ]
        for sel in selectors:
            for ns in (None, "prod"):
                pods = await api.list("Pod", ns, label_selector=sel)
                out.append([p["metadata"]["name"] for p in pods])
    elif case == "watch_live":
        task = asyncio.create_task(_consume(api, "Pod", "prod", n=3))
        await asyncio.sleep(0.01)
        await api.create("Pod", _pod_dict("other", "dev"))
        await api.create("Pod", _pod_dict("c"))
        await api.patch("Pod", "c", "prod", {"metadata": {"labels": {"z": "1"}}})
        await api.delete("Pod", "c", "prod")
        out.append(await asyncio.wait_for(task, 2))
    elif case == "watch_close":
        task = asyncio.create_task(_consume(api, "Pod"))
        await asyncio.sleep(0.01)
        out.append(api.close_watches())
        try:
            await asyncio.wait_for(task, 2)
        except pkg.operator_kubeapi.WatchClosed as exc:
            out.append(type(exc).__name__)
    elif case == "watch_replay":
        await api.create("Pod", _pod_dict("a"))
        _, rv = await api.list_rv("Pod")
        await api.create("Pod", _pod_dict("b"))
        await api.patch("Pod", "a", "prod", {"spec": {"y": 1}})
        await api.delete("Pod", "b", "prod")
        out.append(rv)
        out.append(await _consume(api, "Pod", resource_version=rv, n=3))
    elif case == "watch_expired":
        api.WATCH_HISTORY = 2
        for name in "abcd":
            await api.create("Pod", _pod_dict(name))
        try:
            await _consume(api, "Pod", resource_version="1", n=1)
        except pkg.operator_kubeapi.WatchExpired as exc:
            out.append(type(exc).__name__)
        out.append(await _consume(api, "Pod", resource_version="2", n=2))
    elif case == "logs":
        await api.create("Pod", _pod_dict("a"))
        api.set_pod_log("prod", "a", "current\nlog\n")
        api.set_pod_log("prod", "b", "previous only", previous=True)
        out.append(await api.get_log("a", "prod"))
        out.append(await api.get_log("a", "prod", previous=True))
        out.append(await api.get_log("a", "prod", tail_bytes=4))
        out.append(await api.get_log("b", "prod", previous=True))
        await api.create("Pod", _pod_dict("c"))
        out.append(await api.get_log("c", "prod"))
        out.append(await _attempt(pkg, api.get_log("zz", "prod")))
    elif case == "error_hooks":
        await api.create("Pod", _pod_dict("a"))
        await api.create("Podmortem", {"metadata": {"name": "pm", "namespace": "prod"}})
        api.inject_errors("get", lambda: pkg.operator.ForbiddenError("no"), times=2, kind="Pod")
        api.inject_conflicts(1, op="patch")
        for _ in range(3):
            out.append(await _attempt(pkg, api.get("Pod", "a", "prod")))
        out.append(await _attempt(pkg, api.get("Podmortem", "pm", "prod")))
        out.append(await _attempt(pkg, api.patch("Pod", "a", "prod", {"spec": {}})))
        out.append(await _attempt(pkg, api.patch("Pod", "a", "prod", {"spec": {}})))
    else:
        raise ValueError(case)
    return normalise(out)


KUBE_CASES = ["crud_rv", "optimistic_concurrency", "deep_merge", "selectors", "watch_live",
              "watch_close", "watch_replay", "watch_expired", "logs", "error_hooks"]


@pytest.mark.parametrize("case", KUBE_CASES)
def test_fake_kube_api_matches_jax(case):
    """One operation sequence per case on each package's ``FakeKubeApi``:
    every outcome (objects with their resource versions, error types and
    statuses, watch events, logs) equal after normalisation."""
    ref, port = both(lambda pkg: run(_kube_case(pkg, case)))
    assert port == ref
    assert port  # every case observes something


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


async def _storage_case(pkg, case: str) -> dict:
    O = pkg.operator
    api = O.FakeKubeApi()
    config = pkg.utils_config.OperatorConfig(conflict_backoff_base_s=0.001)
    storage = O.AnalysisStorageService(api, config)
    pod = _pod(pkg)
    s = pkg.schema
    pm = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="prod"), spec=s.PodmortemSpec())
    if case != "target_deleted":
        await api.create("Pod", pod.to_dict())
        await api.create("Podmortem", pm.to_dict())
    result = _result(pkg)
    ai = s.AIResponse(explanation="Root Cause: X.\nFix: Y.", provider_id="template")
    out: dict = {}
    if case == "annotations_ring":
        for i in range(12):
            out.setdefault("stored", []).append(await storage.store_analysis_results(
                result, ai, pod, pm, failure_time=f"2026-07-28T09:14:{i:02d}Z"))
    elif case == "retry_409":
        api.inject_conflicts(3, op="patch_status")
        out["ok"] = await storage.store_to_podmortem_status(
            pm, pod, result, None, "explanation", failure_time="2026-07-28T09:00:00Z")
    elif case == "storm_give_up":
        api.inject_conflicts(99, op="patch_status")
        out["ok"] = await storage.store_to_podmortem_status(
            pm, pod, result, None, "x", failure_time="2026-07-28T09:00:00Z")
    elif case == "forbidden_403":
        calls = {"n": 0}

        def hook(op, kind, name):
            if op == "patch":
                calls["n"] += 1
                return O.ForbiddenError("rbac says no")
            return None

        api.error_hooks.append(hook)
        out["ok"] = await storage.store_to_pod_annotations(pod, result, "text")
        out["calls"] = calls["n"]
    elif case == "target_deleted":
        out["pod"] = await storage.store_to_pod_annotations(pod, result, "text")
        out["status"] = await storage.store_to_podmortem_status(
            pm, pod, result, None, "x", failure_time="2026-07-28T09:00:00Z")
    elif case == "truncation":
        long = ai.__class__(explanation="Root Cause: " + "word " * 60_000 + "\nFix: do it.",
                            provider_id="template")
        out["stored"] = await storage.store_analysis_results(
            result, long, pod, pm, failure_time="2026-07-28T09:00:00Z")
    else:
        raise ValueError(case)
    for kind, name in (("Pod", "web-1"), ("Podmortem", "pm")):
        try:
            obj = await api.get(kind, name, "prod")
        except O.NotFoundError:
            continue
        out[kind] = {"annotations": obj["metadata"].get("annotations"),
                     "status": obj.get("status"),
                     "rv": obj["metadata"]["resourceVersion"]}
    return normalise(out)


STORAGE_CASES = ["annotations_ring", "retry_409", "storm_give_up", "forbidden_403",
                 "target_deleted", "truncation"]


@pytest.mark.parametrize("case", STORAGE_CASES)
def test_storage_matches_jax(case):
    """``AnalysisStorageService``: return values, pod annotations, the
    Podmortem status ring and resource versions equal the JAX package's."""
    ref, port = both(lambda pkg: run(_storage_case(pkg, case)))
    assert port == ref
    if case == "annotations_ring":
        assert len(port["Podmortem"]["status"]["recentFailures"]) == 10
    if case == "storm_give_up":
        assert port["ok"] is False


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------


async def _events_case(pkg, case: str) -> list:
    O, s = pkg.operator, pkg.schema
    api = O.FakeKubeApi()
    pm = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="prod"))
    service = O.EventService(api)
    if case == "owner_chase":
        await api.create("Deployment", {"apiVersion": "apps/v1", "kind": "Deployment",
                                        "metadata": {"name": "web", "namespace": "prod"}})
        await api.create("ReplicaSet", {
            "apiVersion": "apps/v1", "kind": "ReplicaSet",
            "metadata": {"name": "web-abc", "namespace": "prod",
                         "ownerReferences": [{"kind": "Deployment", "name": "web"}]}})
        pod = _pod(pkg, owners=[s.OwnerReference(kind="ReplicaSet", name="web-abc")])
        await service.emit_failure_detected(pod, pm)
        await service.emit_analysis_complete(pod, pm, _result(pkg), s.AIResponse(
            explanation="Root Cause: " + "a " * 800 + "\nFix: b."))
        await service.emit_analysis_error(pod, pm, "boom")
    elif case == "bare_replicaset":
        await api.create("ReplicaSet", {"apiVersion": "apps/v1", "kind": "ReplicaSet",
                                        "metadata": {"name": "rs", "namespace": "prod"}})
        pod = _pod(pkg, owners=[s.OwnerReference(kind="ReplicaSet", name="rs")])
        await service.emit_failure_detected(pod, pm)
    elif case == "emission_failure":
        api.inject_errors("create", lambda: O.ApiError("event quota", 500), times=10)
        await service.emit_analysis_error(_pod(pkg), pm, "boom")
    else:
        raise ValueError(case)
    events = await api.list("Event")
    return normalise([{k: e.get(k) for k in ("reason", "type", "note", "regarding", "related",
                                              "reportingController", "action")}
                      for e in events])


@pytest.mark.parametrize("case", ["owner_chase", "bare_replicaset", "emission_failure"])
def test_events_match_jax(case):
    """Event targets (Pod, Podmortem and the owning Deployment through its
    ReplicaSet), reasons, types and truncated notes equal the JAX
    package's; a failing emission raises in neither."""
    ref, port = both(lambda pkg: run(_events_case(pkg, case)))
    assert port == ref
    if case == "owner_chase":
        kinds = {e["regarding"]["kind"] for e in port}
        assert kinds == {"Pod", "Podmortem", "Deployment"}


@pytest.mark.parametrize("text", [
    "short",
    "x" * 2000,
    "Intro. " * 40 + "\nRoot Cause: zombie.\nDetails: " + "blah " * 100 + "\nFix: kill it."
    + "\nAppendix: " + "junk " * 200,
])
def test_truncate_message_matches_jax(text):
    ref, port = both(lambda pkg: pkg.operator.truncate_message(text, 1024))
    assert port == ref and len(port) <= 1024


# ---------------------------------------------------------------------------
# claims and journal
# ---------------------------------------------------------------------------


def _claims_case(pkg, path: str, case: str) -> dict:
    C = pkg.operator_claims
    clock = iter(float(t) for t in range(1000, 2000))
    ledger = C.ClaimLedger(path, max_entries=4, compact_factor=2, wall_clock=lambda: next(clock))
    pod = _pod(pkg)
    keys = [C.ClaimLedger.key(_pod(pkg, name=f"p{i}"), "2026-07-28T09:00:00Z") for i in range(6)]
    out = {"claims": []}
    for i, key in enumerate(keys):
        out["claims"].append(ledger.try_claim(key, pod_name=f"p{i}", pod_namespace="prod",
                                              failure_time="2026-07-28T09:00:00Z",
                                              podmortems=["ns/pm"], deadline_total_s=180.0))
    out["again"] = ledger.try_claim(keys[-1])
    ledger.note_stage(keys[3], "analyze:ns/pm")
    ledger.mark_done(keys[4])
    if case == "release":
        ledger.release(keys[5])
    ledger.close()
    if case == "torn_tail":
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"op": "claim", "claim": {"key": "torn')
    restarted = C.ClaimLedger(path, max_entries=4, wall_clock=lambda: 1010.0)
    pending = restarted.take_pending()
    out["pending"] = [(c.key, c.stage, c.state, c.podmortems, c.deadline_total_s) for c in pending]
    out["remaining"] = [restarted.remaining_budget_s(c) for c in pending]
    out["key_of_pod"] = C.ClaimLedger.key(pod, "t")
    out["retry"] = restarted.try_claim(keys[5])
    restarted.close()
    return out


@pytest.mark.parametrize("case", ["plain", "release", "torn_tail"])
def test_claim_ledger_replays_after_restart_as_jax(tmp_path, case):
    """Claims, stage notes, terminal marks and the LRU bound journal to a
    temp file; a second ledger on the same path (the restart) finds the
    same pending claims with the same residual budgets, in both packages;
    a torn last line is skipped."""
    ref, port = (_claims_case(PKGS[name], str(tmp_path / f"{name}.jsonl"), case)
                 for name in ("jax", "port"))
    assert port == ref
    assert port["pending"]


def _journal_case(pkg, path: str) -> dict:
    J = pkg.utils_journal.Journal
    journal = J(path, label="test")
    journal.open()
    for i in range(5):
        journal.append({"op": "put", "i": i})
    journal.compact([{"op": "put", "i": 4}])
    journal.append({"op": "put", "i": 5})
    journal.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write("{not json\n")
    seen: list = []
    again = J(path, label="test")
    loaded = again.load(seen.append)
    return {"loaded": loaded, "seen": seen, "lines": again.lines}


def test_journal_compacts_and_skips_torn_lines_as_jax(tmp_path):
    ref, port = (_journal_case(PKGS[name], str(tmp_path / f"{name}.jsonl"))
                 for name in ("jax", "port"))
    assert port == ref and port["seen"] == [{"op": "put", "i": 4}, {"op": "put", "i": 5}]


# ---------------------------------------------------------------------------
# incident memory
# ---------------------------------------------------------------------------


def _memory_case(pkg, path: str) -> dict:
    """Fixture logs through each package's ``PatternEngine``, recalled on a
    fixed clock: a first sighting (miss), an insert, the same failure on
    another pod (hit), the same log with its numbers changed (near or
    miss), a weak fingerprint, another provider ref, and the store's
    snapshot and journal after a restart."""
    s = pkg.schema
    now = [1_000_000.0]
    store = pkg.memory.IncidentStore(path, max_entries=8, ttl_s=3600.0, clock=lambda: now[0])
    memory = pkg.memory.IncidentMemory(store=store, top_k=2, **pkg.device)
    engine = pkg.patterns_engine.PatternEngine()
    decisions = []

    def analyze(name, logs, pod_name):
        pod = s.Pod.parse({"metadata": {"name": pod_name, "namespace": "prod"}})
        return engine.analyze(s.PodFailureData(pod=pod, logs=logs)), pod

    oom = _read("oom_java.log")
    changed = re.sub(r"\d+", lambda m: str(int(m.group()) + 7), oom)
    for name in ("oom_java.log", "dns_failure.log", "go_panic.log"):
        result, pod = analyze(name, _read(name), name.split(".")[0].replace("_", "-"))
        decision = memory.recall(result, pod, provider_ref="ns/p")
        decisions.append((decision.kind, decision.fingerprint.digest))
        memory.insert(decision.fingerprint, result, pod, s.AIResponse(
            explanation=f"Root Cause: {name}.\nFix: restart.", provider_id="template"),
            provider_ref="ns/p", seen_recorded=decision.incident is not None)
        now[0] += 10.0
    for logs, pod_name, ref in ((oom, "oom-2", "ns/p"), (changed, "oom-3", "ns/p"),
                                (oom, "oom-4", "ns/other"), ("", "empty", "ns/p")):
        result, pod = analyze("", logs, pod_name)
        decision = memory.recall(result, pod, provider_ref=ref)
        decisions.append((decision.kind, decision.fingerprint.digest,
                          [(i.fingerprint, round(score, 5)) for i, score in decision.neighbors],
                          decision.analysis.explanation if decision.analysis else None,
                          memory.hit_probability(decision)))
        now[0] += 10.0
    now[0] += 3595.0  # the first incidents pass their TTL
    expired = store.expire()
    snapshot = store.snapshot()
    memory.close()
    restarted = pkg.memory.IncidentStore(path, max_entries=8, ttl_s=0.0, clock=lambda: now[0])
    out = {
        "decisions": decisions, "expired": expired,
        "snapshot": [line for line in snapshot.splitlines()],
        "restored": restarted.to_dicts(True, 10),
        "query": [(i.fingerprint, round(score, 5)) for i, score in memory.query_text("heap", k=2)],
    }
    restarted.close()
    return normalise(out)


def test_incident_memory_decisions_match_jax(tmp_path):
    """Hit, near and miss decisions with their neighbours and scores, the
    hit probabilities, TTL expiry, the ConfigMap snapshot and the journal
    restore equal the JAX package's (scores to 5 decimals: the index scores
    in float32 in both)."""
    ref, port = (_memory_case(PKGS[name], str(tmp_path / f"{name}.jsonl"))
                 for name in ("jax", "port"))
    assert port == ref
    kinds = [d[0] for d in port["decisions"]]
    assert kinds[:3] == ["miss"] * 3 and kinds[3] == "hit"
    assert kinds[4] in ("near", "miss") and kinds[5] != "hit"


# ---------------------------------------------------------------------------
# SLO ledger, breakers, providers, metrics
# ---------------------------------------------------------------------------


def _slo_case(pkg, path: str) -> dict:
    SL = pkg.obs_sloledger
    t = [100.0]
    metrics = pkg.utils_timing.MetricsRegistry()
    ledger = SL.SLOLedger(SL.parse_slo_classes("interactive:2,standard:30,bogus,batch:x"),
                          path=path, metrics=metrics, clock=lambda: t[0])
    plan = [("a", "interactive", 1.0, "completed"), ("b", "standard", 40.0, "completed"),
            ("c", None, 3.0, "deadline-exceeded"), ("d", "nope", 1.0, "shed"),
            ("e", "interactive", 0.5, "degraded"), ("f", "standard", 1.0, "weird")]
    for trace, cls, _, _ in plan:
        ledger.admit(trace, cls=cls)
    pending = ledger.pending_by_class()
    for trace, _, dt, outcome in plan:
        t[0] += dt
        ledger.finish(trace, outcome=outcome, tokens=7, stages={"collect": 1.0})
    again = ledger.finish("a", outcome="completed")
    ledger.close()
    return {"pending": pending, "snapshot": ledger.snapshot(),
            "attainment": ledger.attainment_by_class(), "again": again,
            "records": [r.to_dict() for r in SL.SLOLedger.load_records(path)],
            "metrics": metrics.snapshot()}


def test_slo_ledger_settles_as_jax(tmp_path):
    """Admission classes (unknown ones to the default), settlement once per
    trace, attainment, the journal and the counters equal the JAX
    package's on one fake clock."""
    ref, port = (_slo_case(PKGS[name], str(tmp_path / f"{name}.jsonl")) for name in ("jax", "port"))
    assert port == ref
    assert port["again"] is None and len(port["records"]) == 6


def _breaker_case(pkg) -> list:
    t = [0.0]
    board = pkg.router_health.BreakerBoard(failure_threshold=2, reset_s=5.0, clock=lambda: t[0])
    out = []
    for step in ("fail", "fail", "allow", "tick", "allow", "allow", "fail", "tick", "allow",
                 "ok", "allow", "fail", "can"):
        b = board.for_provider("openai")
        if step == "fail":
            out.append(("fail", b.record_failure(), b.state))
        elif step == "ok":
            b.record_success()
            out.append(("ok", b.state))
        elif step == "tick":
            t[0] += 5.0
        elif step == "can":
            out.append(("can", b.can_attempt()))
        else:
            out.append(("allow", b.allow(), b.state))
    out.append(board.states())
    return out


def test_circuit_breaker_matches_jax():
    ref, port = both(_breaker_case)
    assert port == ref


async def _provider_config_case(pkg, case: str) -> dict:
    O, s = pkg.operator, pkg.schema
    api = O.FakeKubeApi()
    auth = None
    if case != "no_secret":
        auth = s.AuthenticationRef(secret_name="ai-creds", secret_key="apiKey")
    if case == "secret":
        await api.create_obj(s.Secret(
            metadata=s.ObjectMeta(name="ai-creds", namespace="ns"),
            data={"apiKey": base64.b64encode(b"sk-test-123\n").decode()}))
    elif case == "secret_without_key":
        await api.create_obj(s.Secret(metadata=s.ObjectMeta(name="ai-creds", namespace="ns"),
                                      string_data={"other": "x"}))
    elif case == "secret_forbidden":
        api.inject_errors("get", lambda: O.ForbiddenError("no"), kind="Secret")
    provider = s.AIProvider(
        metadata=s.ObjectMeta(name="p", namespace="ns"),
        spec=s.AIProviderSpec(provider_id="openai", api_url="https://api.example.com/v1",
                              model_id="gpt-x", authentication_ref=auth, max_tokens=64,
                              temperature=0.1, additional_config={"k": "v"}))
    config = await O.resolve_provider_config(api, provider)
    return dataclasses.asdict(config)


@pytest.mark.parametrize("case", ["no_secret", "secret", "secret_without_key",
                                  "secret_missing", "secret_forbidden"])
def test_resolve_provider_config_matches_jax(case):
    """CR spec + defaults + the base64 token from the referenced Secret;
    a missing, keyless or unreadable Secret degrades to no token, in both."""
    ref, port = both(lambda pkg: run(_provider_config_case(pkg, case)))
    assert port == ref
    assert (port["auth_token"] == "sk-test-123") == (case == "secret")


def _prometheus_case(pkg) -> list:
    metrics = pkg.utils_timing.MetricsRegistry()
    metrics.record("collect", 3.0)
    metrics.record("collect", 5.0)
    metrics.incr("analyses_completed", 2)
    metrics.incr("recall_hit", exemplar="0" * 32)
    metrics.incr("router_shed", labels={"cls": "batch"})
    metrics.observe("slo_latency_milliseconds", 120.0, buckets=(100.0, 1000.0))
    metrics.set_gauge("queue_depth", 3)
    return [metrics.prometheus(), metrics.prometheus(openmetrics=True)]


def test_prometheus_text_matches_jax():
    """The ``/metrics`` exposition, classic and OpenMetrics, is the JAX
    package's text byte for byte."""
    ref, port = both(_prometheus_case)
    assert port == ref and "podmortem_analyses_completed_total 2" in port[0]


# ---------------------------------------------------------------------------
# watcher, pipeline and reconcilers
# ---------------------------------------------------------------------------


async def _pipeline_case(pkg, case: str) -> dict:
    O, s = pkg.operator, pkg.schema
    api = O.FakeKubeApi()
    config = pkg.utils_config.OperatorConfig(
        pattern_cache_directory="/nonexistent", watch_restart_delay_s=0.01,
        conflict_backoff_base_s=0.001)
    metrics = pkg.utils_timing.MetricsRegistry()
    memory = pkg.memory.build_incident_memory(config, **pkg.device)
    pipeline = O.AnalysisPipeline(api, pkg.patterns_engine.PatternEngine(), config=config,
                                  metrics=metrics, providers=O.default_registry(),
                                  memory=memory)
    cache = O.PodmortemCache(api, resync_delay_s=0.01)
    watcher = O.PodFailureWatcher(api, pipeline, config=config, metrics=metrics, cache=cache)
    await api.create_obj(s.AIProvider(metadata=s.ObjectMeta(name="tmpl", namespace="ns"),
                                      spec=s.AIProviderSpec(provider_id="template")))
    selector = s.LabelSelector(match_labels={"app": "web"})
    for name, enabled in (("pm1", True), ("pm2", False)):
        await api.create_obj(s.Podmortem(
            metadata=s.ObjectMeta(name=name, namespace="ns"),
            spec=s.PodmortemSpec(pod_selector=selector, ai_analysis_enabled=enabled,
                                 ai_provider_ref=s.AIProviderRef(name="tmpl", namespace="ns"))))
    await api.create_obj(s.Podmortem(
        metadata=s.ObjectMeta(name="pm-db", namespace="ns"),
        spec=s.PodmortemSpec(pod_selector=s.LabelSelector(match_labels={"app": "db"}))))
    await cache.prime()
    out: dict = {"launched": []}
    if case == "watcher_recall":
        for i, (log, finished) in enumerate((("oom_java.log", "2026-07-28T09:00:00Z"),
                                             ("oom_java.log", "2026-07-28T09:00:00Z"),
                                             ("oom_java.log", "2026-07-28T10:00:00Z"))):
            pod = _failed_pod(pkg, name="web-1" if i < 2 else "web-2", finished_at=finished,
                              exit_code=137)
            if i != 1:
                await api.create("Pod", pod.to_dict())
            api.set_pod_log("prod", pod.metadata.name, _read(log), previous=True)
            out["launched"].append(await watcher.handle_pod_event("MODIFIED", pod))
            await watcher.drain()
    elif case == "reconciler_poll":
        pod = _failed_pod(pkg, exit_code=1)
        await api.create("Pod", pod.to_dict())
        api.set_pod_log("prod", "web-1", _read("db_connection_refused.log"), previous=True)
        reconciler = O.PodmortemReconciler(api, pipeline, config=config, metrics=metrics)
        for name in ("pm1", "pm2"):
            raw = await api.get("Podmortem", name, "ns")
            await reconciler.reconcile(s.Podmortem.parse(raw))
        out["launched"].append(await watcher.handle_pod_event("MODIFIED", pod))
        await watcher.drain()
        aip = O.AIProviderReconciler(api, providers=O.default_registry(), config=config)
        await api.create_obj(s.AIProvider(metadata=s.ObjectMeta(name="bad", namespace="ns"),
                                          spec=s.AIProviderSpec(provider_id="nope")))
        for name in ("tmpl", "bad"):
            raw = await api.get("AIProvider", name, "ns")
            await aip.reconcile(s.AIProvider.parse(raw))
    else:
        raise ValueError(case)
    out["events"] = [{k: e.get(k) for k in ("reason", "type", "note", "regarding")}
                     for e in await api.list("Event")]
    out["pods"] = [p["metadata"].get("annotations") for p in await api.list("Pod")]
    out["podmortems"] = [p.get("status") for p in await api.list("Podmortem")]
    out["aiproviders"] = [p.get("status") for p in await api.list("AIProvider")]
    out["metrics"] = normalise_metrics(metrics.snapshot())
    out["slo"] = normalise_slo(pipeline.slo_ledger.snapshot())
    memory.close()
    pipeline.claims.close()
    return normalise(out)


@pytest.mark.parametrize("case", ["watcher_recall", "reconciler_poll"])
def test_watcher_pipeline_and_reconcilers_match_jax(case):
    """The watcher's fan-out over matching CRs and its dedupe, the
    pipeline's recall hit on a second pod, the poll path of the Podmortem
    reconciler and the AIProvider reconciler's status: events, pod
    annotations, CR statuses, counters and the SLO ledger equal the JAX
    package's."""
    ref, port = both(lambda pkg: run(_pipeline_case(pkg, case)))
    assert port == ref
    if case == "watcher_recall":
        assert port["launched"] == [2, 0, 2]
        assert port["metrics"]["counters"].get("recall_hit")


# ---------------------------------------------------------------------------
# run_demo
# ---------------------------------------------------------------------------


def _demo(pkg, provider_id: str, overrides: dict, monkeypatch) -> dict:
    app = pkg.operator_app
    metrics = pkg.utils_timing.MetricsRegistry()
    monkeypatch.setattr(app, "METRICS", metrics)
    monkeypatch.setattr(app, "OperatorConfig",
                        functools.partial(pkg.utils_config.OperatorConfig, **overrides))
    # greedy, short explanations: sampled streams differ between the
    # packages' generators by construction
    monkeypatch.setattr(pkg.schema, "AIProviderSpec",
                        functools.partial(pkg.schema.AIProviderSpec, temperature=0.0,
                                          max_tokens=12))
    summary = run(app.run_demo(None, provider_id, **pkg.device))
    summary["metrics"] = normalise_metrics(summary["metrics"])
    return normalise(summary)


@pytest.fixture(scope="module")
def sp_checkpoint(checkpoint):  # noqa: F811
    return checkpoint


DEMO_CASES = [("template", False), ("template", True), ("tpu-native", False), ("tpu-native", True)]


@pytest.mark.parametrize("provider_id,encoder", DEMO_CASES,
                         ids=[f"{p}-{'encoder' if e else 'lexical'}" for p, e in DEMO_CASES])
def test_run_demo_matches_jax(provider_id, encoder, request, monkeypatch):
    """``run_demo`` in both packages: the events (reason, type, target,
    note), the pod annotations, the Podmortem status, readiness and the
    metrics snapshot are equal after normalisation.  ``tpu-native`` serves
    the ``tiny-test-sp`` checkpoint with the committed tokenizer, greedy,
    12 tokens; the encoder case mounts a tiny BERT checkpoint as
    ``ENCODER_CHECKPOINT_DIR`` (semantic matching and neural recall)."""
    overrides: dict = {}
    if provider_id == "tpu-native":
        path = request.getfixturevalue("sp_checkpoint")
        overrides.update(checkpoint_dir=path, max_batch_size=4, kv_page_size=16)
        monkeypatch.setenv("OPERATOR_TPU_MODEL", LONG)
        monkeypatch.setitem(PKGS["port"].models_configs._REGISTRY, LONG,
                            _long(PKGS["port"].models_configs.TINY_TEST))
        monkeypatch.setitem(PKGS["jax"].models_configs._REGISTRY, LONG,
                            _long(PKGS["jax"].models_configs.TINY_TEST))
    if encoder:
        overrides["encoder_checkpoint_dir"] = request.getfixturevalue("bert_checkpoint")
    ref = _demo(PKGS["jax"], provider_id, overrides, monkeypatch)
    port = _demo(PKGS["port"], provider_id, overrides, monkeypatch)
    assert port == ref
    status = port["podmortem_status"]["recentFailures"][0]
    assert status["analysisStatus"] == "Analyzed" and status["explanation"]
    if provider_id == "tpu-native":
        assert port["metrics"]["counters"].get("provider_errors") is None
        assert status["explanation"] == port["pod_annotations"]["podmortem.io/analysis"]


# ---------------------------------------------------------------------------
# refusals and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob,value", [
    ("leader_election", True), ("autoscale_enabled", True), ("discovery_enabled", True),
])
def test_operator_refuses_unported_features_naming_item_5a(knob, value):
    port = PKGS["port"]
    config = port.utils_config.OperatorConfig(health_port=-1, **{knob: value})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 5a"):
        port.operator.Operator(port.operator.FakeKubeApi(), config=config, device="cpu")


def test_operator_refuses_pattern_library_git_sync_naming_item_5a():
    port = PKGS["port"]
    s = port.schema

    async def body():
        api = port.operator.FakeKubeApi()
        await api.create_obj(s.PatternLibrary(metadata=s.ObjectMeta(name="pl", namespace="ns")))
        operator = port.operator.Operator(
            api, config=port.utils_config.OperatorConfig(health_port=-1), device="cpu")
        with pytest.raises(NotImplementedError, match="item 5a"):
            await operator.start()

    run(body())


def test_operator_cli_without_demo_refuses_the_real_api_server(capsys):
    assert PKGS["port"].operator_app._main([]) == 2
    assert "item 5a" in capsys.readouterr().err


async def _http_provider_case(pkg, provider_id: str, message: str) -> dict:
    """A pipeline over a registry whose ``provider_id`` factory raises:
    the reference's path for a provider that fails to initialise."""
    O, s = pkg.operator, pkg.schema
    api = O.FakeKubeApi()
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory="/nonexistent")
    registry = O.default_registry()

    def factory():
        raise NotImplementedError(message)

    registry.register_factory(provider_id, factory)
    metrics = pkg.utils_timing.MetricsRegistry()
    pipeline = O.AnalysisPipeline(api, pkg.patterns_engine.PatternEngine(), config=config,
                                  metrics=metrics, providers=registry,
                                  memory=pkg.memory.build_incident_memory(config, **pkg.device))
    await api.create_obj(s.AIProvider(metadata=s.ObjectMeta(name="p", namespace="ns"),
                                      spec=s.AIProviderSpec(provider_id=provider_id,
                                                            api_url="http://llm:8000")))
    pm = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="ns"),
                     spec=s.PodmortemSpec(ai_provider_ref=s.AIProviderRef(name="p", namespace="ns")))
    await api.create_obj(pm)
    pod = _failed_pod(pkg)
    await api.create("Pod", pod.to_dict())
    api.set_pod_log("prod", "web-1", _read("dns_failure.log"), previous=True)
    result = await pipeline.process_pod_failure(pod, pm, failure_time="2026-07-28T09:00:00Z")
    pipeline.claims.close()
    return normalise({
        "result_events": len(result.events),
        "events": [{k: e.get(k) for k in ("reason", "type", "note")} for e in await api.list("Event")],
        "status": (await api.get("Podmortem", "pm", "ns")).get("status"),
        "annotations": (await api.get("Pod", "web-1", "prod"))["metadata"].get("annotations"),
        "counters": metrics.snapshot()["counters"],
    })


@pytest.mark.parametrize("provider_id", ["openai", "ollama", "openai-compatible"])
def test_http_provider_ids_degrade_as_the_reference_does_for_a_raising_factory(provider_id):
    """An HTTP providerId whose factory raises (here: an injected one)
    degrades to a pattern-only result with the error in the Event,
    exactly the JAX pipeline's result for the same factory."""
    message = "the OpenAI-compatible backend failed to initialise"
    ref, ours = (run(_http_provider_case(PKGS[name], provider_id, message))
                 for name in ("jax", "port"))
    assert ours == ref
    assert ours["result_events"] > 0  # the pattern result is kept and stored
    assert ours["annotations"]["podmortem.io/analysis"]
    assert any(message in (e["note"] or "") for e in ours["events"])


def test_operator_without_a_device_raises_without_a_card():
    """The default device is cuda, and there is no card here: the
    Operator and run_demo raise instead of sliding onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    port = PKGS["port"]
    config = port.utils_config.OperatorConfig(health_port=-1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.operator.Operator(port.operator.FakeKubeApi(), config=config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(port.operator_app.run_demo())
    port.operator.Operator(port.operator.FakeKubeApi(), config=config, device="cpu")


def test_operator_passes_its_device_and_config_to_the_engine_and_matcher(
        monkeypatch, tmp_path, bert_checkpoint):  # noqa: F811
    """The tpu-native factory builds the engine from the operator's config
    on its device; the encoder checkpoint's semantic matcher and the
    incident index share one embedder on the same device."""
    port = PKGS["port"]
    seen = {}

    def fake_provider(device, environ, *, config):
        seen.update(device=device, config=config)
        return "provider"

    import operator_tpu_torch.serving.provider as provider_module

    monkeypatch.setattr(provider_module, "build_tpu_native_provider", fake_provider)
    config = port.utils_config.OperatorConfig(health_port=-1, checkpoint_dir=str(tmp_path),
                                              encoder_checkpoint_dir=bert_checkpoint)
    operator = port.operator.Operator(port.operator.FakeKubeApi(), config=config, device="cpu")
    assert operator.providers.resolve("tpu-native") == "provider"
    assert seen["device"] == torch.device("cpu") and seen["config"] is config
    semantic = operator.engine.semantic
    assert type(semantic.embedder).__name__ == "NeuralEmbedder"
    assert semantic.device == torch.device("cpu") == operator.memory.index.device
    assert operator.memory.index.embedder is semantic.embedder


@pytest.mark.parametrize("mutated", [False, True], ids=["port", "unbudgeted_call"])
def test_port_operator_passes_gl003_deadline_propagation(tmp_path, capsys, mutated):
    """graftlint's GL003 (every kube call spends a budget at the call)
    scopes the JAX package's paths; the port's tree is checked by
    mirroring it under those paths.  The mutated copy, one kube call
    without a budget added to the port's pipeline, must be caught."""
    from operator_tpu.analysis.__main__ import main as cli_main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mirror = tmp_path / "operator_tpu"
    shutil.copytree(os.path.join(root, "operator_tpu_torch"), mirror,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.yaml", "*.json"))
    if mutated:
        with open(mirror / "operator" / "pipeline.py", "a", encoding="utf-8") as fh:
            fh.write("\n\nasync def _unbudgeted(api):\n"
                     "    return await api.get('Pod', 'x', 'ns')\n")
    baseline = tmp_path / "baseline.json"
    baseline.write_text('{"findings": []}')
    rc = cli_main(["--root", str(tmp_path), "--rules", "GL003", "--baseline", str(baseline)])
    out = capsys.readouterr().out
    assert (rc != 0) == mutated, out
    assert ("GL003" in out) == mutated and ("clean" in out) != mutated


# ---------------------------------------------------------------------------
# the remote path: the operator against serving replicas over HTTP
# ---------------------------------------------------------------------------

async def _remote_operator(pkg, url: str) -> dict:
    """The package's ``Operator`` over its fake API with ``providerId:
    openai-compatible`` naming ``url`` (its own package's serving
    replica): two failing pods, then the health poll and ``GET /fleet``."""
    import urllib.request

    O, s = pkg.operator, pkg.schema
    api = O.FakeKubeApi()
    config = pkg.utils_config.OperatorConfig(
        pattern_cache_directory="/nonexistent", health_port=0, health_host="127.0.0.1",
        incidents_api_token="tok", router_health_poll_s=0.0)
    operator = O.Operator(api, config=config, metrics=pkg.utils_timing.MetricsRegistry(),
                          **pkg.device)
    # the replica's bearer token comes from the AIProvider's Secret
    await api.create_obj(s.Secret(metadata=s.ObjectMeta(name="llm", namespace="ns"),
                                  data={"token": base64.b64encode(b"sekrit").decode()}))
    await api.create_obj(s.AIProvider(
        metadata=s.ObjectMeta(name="remote", namespace="ns"),
        spec=s.AIProviderSpec(provider_id="openai-compatible", api_url=url,
                              model_id="tiny-test", temperature=0.0, max_tokens=8,
                              authentication_ref=s.AuthenticationRef(secret_name="llm"))))
    await api.create_obj(s.Podmortem(
        metadata=s.ObjectMeta(name="pm", namespace="ns"),
        spec=s.PodmortemSpec(pod_selector=s.LabelSelector(match_labels={"app": "web"}),
                             ai_provider_ref=s.AIProviderRef(name="remote", namespace="ns"),
                             ai_analysis_enabled=True)))
    await operator.start()
    try:
        await asyncio.sleep(0.05)
        for name, log in (("web-1", "oom_java.log"), ("web-2", "dns_failure.log")):
            pod = _failed_pod(pkg, name=name)
            api.set_pod_log("prod", name, _read(log), previous=True)
            await api.create("Pod", pod.to_dict())
            await api.patch("Pod", name, "prod", {"metadata": {"labels": {"poked": "1"}}})
        await asyncio.sleep(0.1)
        await operator.watcher.drain()
        polled = await operator._http_backend.poll_replica_health(timeout_s=30.0)
        port = operator.health_server.bound_port

        def get(path, token):
            request = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
            if token:
                request.add_header("Authorization", f"Bearer {token}")
            try:
                with urllib.request.urlopen(request, timeout=30) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                return exc.code, json.loads(exc.read())

        fleet = await asyncio.to_thread(get, "/fleet", "tok")
        refused = await asyncio.to_thread(get, "/fleet", None)
        out = {
            "events": [{k: e.get(k) for k in ("reason", "type", "note", "regarding")}
                       for e in await api.list("Event")],
            "pods": [p["metadata"].get("annotations") for p in await api.list("Pod")],
            "status": (await api.get("Podmortem", "pm", "ns")).get("status"),
            "counters": {k: v for k, v in operator.metrics.snapshot()["counters"].items()
                         if k.startswith(("router_", "analyses_", "provider_"))},
            "polled": polled,
            "fleet_status": fleet[0],
            "fleet": fleet[1],
            "refused": refused[0],
        }
    finally:
        await operator.stop()
    # the fleet view: every key, and the values that do not follow the
    # engine's step timing (how the two requests met in its steps)
    stable = ("ready", "breaker", "queueDepth", "inflight", "sloCompleted", "role",
              "kvPagesTotal", "shedTotal", "degradedTotal")
    out["fleet"]["replicas"] = {
        rid: {"keys": sorted(row), **{k: row[k] for k in stable}}
        for rid, row in out["fleet"]["replicas"].items()}
    rollup = out["fleet"]["fleet"]
    out["fleet"]["fleet"] = {"keys": sorted(rollup), **{
        k: rollup[k] for k in ("replicaCount", "readyCount", "queueDepth", "inflight",
                               "kvPagesTotal", "shedTotal", "degradedTotal", "roles")}}
    # each package's replica has its own port: one placeholder for both
    return normalise(json.loads(json.dumps(out).replace(url, "<replica>")))


def test_remote_operator_stores_what_the_jax_operator_stores(torch_params_remote):
    """``providerId: openai-compatible`` in both packages, each operator
    against its own package's ``CompletionServer`` over the same weights:
    the stored statuses, pod annotations, Events and router counters are
    equal, and ``GET /fleet`` (token-gated) lists the replica with the
    same non-wall-clock fields."""
    from test_torch_completion_api import _Pair

    pair = _Pair(*torch_params_remote, "continuous")
    try:
        got = {name: run(_remote_operator(PKGS[name],
                                          f"http://127.0.0.1:{pair.ports[name]}"))
               for name in ("jax", "port")}
    finally:
        pair.close()
    assert got["port"] == got["jax"]
    port = got["port"]
    failures = port["status"]["recentFailures"]
    assert len(failures) == 2
    assert all(f["analysisStatus"] == "Analyzed" and f["explanation"] for f in failures)
    assert port["counters"]["router_routed"] == 2
    assert port["fleet_status"] == 200 and port["refused"] == 401
    assert list(port["fleet"]["replicas"]) == ["<replica>"]
    assert port["fleet"]["replicas"]["<replica>"]["ready"] is True


@pytest.fixture(scope="module")
def torch_params_remote():
    """(jax_params, torch_params) at ``tiny-test`` for the serving pair."""
    import jax.numpy as jnp
    import numpy as np

    from operator_tpu.models import TINY_TEST, init_params
    from operator_tpu_torch.models import params_from_jax

    jax_params = init_params(TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax_params, params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def test_completion_api_port_serves_from_the_operator_process(monkeypatch):
    """``COMPLETION_API_PORT=0``: the operator builds an engine on its own
    device (the CPU here, as asked), warms it (LOADING -> READY), serves
    ``/healthz`` with the load report and re-registers ``tpu-native`` on
    the same engine; stop closes both."""
    import urllib.request

    port = PKGS["port"]
    monkeypatch.setenv("OPERATOR_TPU_MODEL", "tiny-test")
    config = port.utils_config.OperatorConfig(
        health_port=-1, completion_api_port=0, completion_api_host="127.0.0.1",
        allow_random_weights=True, max_batch_size=4, kv_page_size=16,
        pattern_cache_directory="/nonexistent", serving_replica_id="op-replica")

    async def body():
        operator = port.operator.Operator(port.operator.FakeKubeApi(), config=config,
                                          device="cpu")
        await operator.start()
        try:
            assert operator.engine_warmth == "loading"
            await asyncio.wait_for(operator.completion_task, 120)
            assert operator.engine_warmth == "ready"
            readiness = await operator.readiness.check()
            server = operator.completion_server
            url = f"http://127.0.0.1:{server.bound_port}/healthz"

            def get():
                with urllib.request.urlopen(url, timeout=30) as resp:
                    return json.loads(resp.read())

            health = await asyncio.to_thread(get)  # the server is on this loop
            provider = operator.providers.resolve("tpu-native")
            return health, readiness, provider.engine is server.engine, server.engine
        finally:
            await operator.stop()

    health, readiness, shared, engine = run(body())
    assert health["status"] == "ok" and health["replica"] == "op-replica"
    assert health["load"]["steps"] > 0 and health["load"]["sloCompleted"] == 1
    assert readiness.ready and "engine warm" in readiness.reason
    assert shared
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit("after stop")
