"""The port's Kubernetes API client against the JAX package's
(``tests/test_httpapi.py``), and the deployed entry point over a stub
apiserver.

- ``HttpKubeApi``: both packages' clients make the same calls against
  the same canned stdlib apiserver (``test_httpapi._Handler``); what the
  server recorded (method, path, auth and content type, body) and what
  the call returned or raised must be equal.  Also the selector string,
  the connect timeouts, a half-open watch, in-cluster and kubeconfig
  loading.
- ``kubefacade.KubeFacade``: the port's stub apiserver (a ``FakeKubeApi``
  behind the paths ``HttpKubeApi`` builds).  Both packages' clients drive
  it through the same sequence and see the same objects and errors.
- ``python -m <package>.operator`` (no ``--demo``: ``_run_real``) in a
  subprocess with ``KUBECONFIG`` naming the stub, leader election on and
  the ``template`` provider: each package stores the failing pod's
  analysis over HTTP, exits 0 on SIGTERM, and releases its Lease; the
  stored statuses are equal.  The port exits with the stub's watch
  streams still open; the JAX package's watch threads wait for their
  streams to end, so the stub ends them for it.

Tolerance: exact, after ``test_torch_operator.normalise``.
"""

import asyncio
import base64
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("yaml")

from test_httpapi import _Handler  # noqa: E402
from test_torch_operator import normalise  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_MODULES = ("operator.httpapi", "operator.kubeapi", "schema", "schema.meta")


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    return SimpleNamespace(name="port" if root == "operator_tpu_torch" else "jax", root=root, **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}
_HEADERS = ("Authorization", "Content-Type", "Accept")


@pytest.fixture()
def canned():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.requests = []
    server.watch_events = [
        {"type": "ADDED", "object": {"metadata": {"name": "a"}}},
        {"type": "BOOKMARK", "object": {}},
        {"type": "MODIFIED", "object": {"metadata": {"name": "a"}}},
    ]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    thread.join(timeout=5)


def _client(pkg, port: int, **kw):
    H = pkg.operator_httpapi
    return H.HttpKubeApi(H.ClusterConfig(host="127.0.0.1", port=port, scheme="http",
                                         token="tok-123", namespace="default"), **kw)


async def _outcome(coro):
    try:
        result = coro if not asyncio.iscoroutine(coro) else await coro
        return {"ok": result}
    except Exception as exc:  # noqa: BLE001 - the outcome is the observation
        return {"error": type(exc).__name__, "message": str(exc)}


async def _watch_all(api, *args, **kw) -> dict:
    seen = []
    try:
        async for event in api.watch(*args, **kw):
            seen.append([event.type, event.object])
    except Exception as exc:  # noqa: BLE001 - the stream's end is the observation
        return {"events": seen, "error": type(exc).__name__}
    return {"events": seen}


def _calls(pkg, api) -> list:
    meta = pkg.schema_meta
    selector = meta.LabelSelector(match_labels={"app": "x"})
    return [
        ("list", lambda: api.list("Pod", "default", selector)),
        ("list_all", lambda: api.list("Pod")),
        ("get_missing", lambda: api.get("Podmortem", "missing", "ns1")),
        ("list_forbidden", lambda: api.list("Pod", "locked")),
        ("unknown_kind", lambda: api.get("Gizmo", "x", "ns")),
        ("get", lambda: api.get("Lease", "op-lease", "ns")),
        ("patch_status", lambda: api.patch_status("Podmortem", "pm1", "ns1", {"phase": "Ready"},
                                                  resource_version="7")),
        ("patch_conflict", lambda: api.patch("Pod", "p1", "default", {"metadata": {"labels": {}}},
                                             resource_version="stale")),
        ("patch", lambda: api.patch("Deployment", "d", "ns", {"spec": {"paused": True}})),
        ("get_scale", lambda: api.get_scale("Deployment", "serving", "ns")),
        ("patch_scale", lambda: api.patch_scale("Deployment", "serving", "ns", 3,
                                                resource_version="7")),
        ("create", lambda: api.create("Event", {"metadata": {"name": "e1"}, "note": "n"})),
        ("delete", lambda: api.delete("Lease", "op-lease", "ns")),
        ("get_log", lambda: api.get_log("crashy", "default", container="app", previous=True,
                                        tail_bytes=512)),
        ("watch", lambda: _watch_all(api, "Pod", "default", resource_version="5")),
    ]


async def _against_canned(pkg, server) -> list:
    api = _client(pkg, server.server_address[1])
    out = []
    for name, call in _calls(pkg, api):
        before = len(server.requests)
        result = await _outcome(call())
        requests = [[m, p, {h: hd.get(h) for h in _HEADERS}, b]
                    for m, p, hd, b in server.requests[before:]]
        out.append([name, result, requests])
    return out


def test_http_kube_api_requests_and_errors_match_jax(canned):
    ref, port = (normalise(asyncio.run(_against_canned(PKGS[name], canned)))
                 for name in ("jax", "port"))
    assert port == ref
    by_name = {name: (result, requests) for name, result, requests in port}
    assert by_name["get_missing"][0]["error"] == "NotFoundError"
    assert by_name["list_forbidden"][0]["error"] == "ForbiddenError"
    assert by_name["unknown_kind"][0]["error"] == "ApiError"
    assert by_name["patch_conflict"][0]["error"] == "ConflictError"
    _, [[method, path, headers, body]] = by_name["patch_status"]
    assert path == "/apis/podmortem.tpu.dev/v1alpha1/namespaces/ns1/podmortems/pm1/status"
    assert headers["Content-Type"] == "application/merge-patch+json"
    assert headers["Authorization"] == "Bearer tok-123"
    assert body == {"status": {"phase": "Ready"}, "metadata": {"resourceVersion": "7"}}
    _, [[_, path, _, body]] = by_name["patch_scale"]
    assert path == "/apis/apps/v1/namespaces/ns/deployments/serving/scale"
    assert body == {"spec": {"replicas": 3}, "metadata": {"resourceVersion": "7"}}
    assert by_name["get_log"][0] == {"ok": "line1\nline2\n"}
    watch = by_name["watch"][0]["ok"]
    assert [e[0] for e in watch["events"]] == ["ADDED", "BOOKMARK", "MODIFIED"]
    assert watch["error"] == "WatchClosed"


def test_selector_string_matches_jax():
    out = []
    for name in ("jax", "port"):
        meta, H = PKGS[name].schema_meta, PKGS[name].operator_httpapi
        selector = meta.LabelSelector(
            match_labels={"app": "payment", "tier": "api"},
            match_expressions=[
                meta.LabelSelectorRequirement(key="env", operator="In", values=["prod", "dev"]),
                meta.LabelSelectorRequirement(key="old", operator="NotIn", values=["1"]),
                meta.LabelSelectorRequirement(key="canary", operator="DoesNotExist"),
                meta.LabelSelectorRequirement(key="team", operator="Exists"),
            ],
        )
        out.append([H._selector_string(selector), H._selector_string(None),
                    H._selector_string(meta.LabelSelector())])
    assert out[0] == out[1]
    assert out[1][0] == "app=payment,tier=api,env in (prod,dev),old notin (1),!canary,team"


def test_connect_timeouts_match_jax():
    out = []
    for name in ("jax", "port"):
        api = _client(PKGS[name], 1)
        out.append([api._connect().timeout, api._connect(timeout=None).timeout,
                    api.request_timeout_s, api.watch_timeout_s])
    assert out[0] == out[1] == [30.0, None, 30.0, 300.0]


def test_half_open_watch_raises_watch_closed_as_jax(canned, monkeypatch):
    """A peer that accepts the stream then goes silent must not block the
    watcher: the socket timeout becomes WatchClosed in both packages."""
    original = canned.RequestHandlerClass.do_GET

    def hanging_get(self):
        if "watch=true" in self.path:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.flush()
            time.sleep(3.0)
        else:
            original(self)

    monkeypatch.setattr(canned.RequestHandlerClass, "do_GET", hanging_get)
    out = []
    for name in ("jax", "port"):
        H = PKGS[name].operator_httpapi
        monkeypatch.setattr(H.HttpKubeApi, "_WATCH_SOCKET_MARGIN_S", 0.3)
        api = _client(PKGS[name], canned.server_address[1], watch_timeout_s=0.2)
        started = time.perf_counter()
        result = asyncio.run(_watch_all(api, "Pod", "default"))
        out.append([result, time.perf_counter() - started < 2.5])
    assert out[0] == out[1] == [{"events": [], "error": "WatchClosed"}, True]


def test_port_watch_teardown_wakes_its_reader_thread(canned, monkeypatch):
    """Cancelling a consumer mid-stream ends the worker thread blocked in
    readline at once (the socket is shut down), so an operator's stop()
    does not wait for the server's timeoutSeconds to join its threads."""
    original = canned.RequestHandlerClass.do_GET

    def slow_get(self):
        if "watch=true" in self.path:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.flush()
            time.sleep(5.0)
        else:
            original(self)

    monkeypatch.setattr(canned.RequestHandlerClass, "do_GET", slow_get)
    api = _client(PKGS["port"], canned.server_address[1])

    async def main():
        task = asyncio.create_task(_watch_all(api, "Pod", "default"))
        await asyncio.sleep(0.3)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        started = time.perf_counter()
        # joins every worker thread, the one that was in readline too
        await asyncio.get_running_loop().shutdown_default_executor()
        return time.perf_counter() - started

    assert asyncio.run(main()) < 2.0


def test_incluster_config_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "token").write_text("sa-token\n")
    (tmp_path / "namespace").write_text("podmortem-system")
    (tmp_path / "ca.crt").write_text("fake-ca")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    out = [vars(PKGS[name].operator_httpapi.load_incluster_config(str(tmp_path)))
           for name in ("jax", "port")]
    assert out[0] == out[1]
    assert out[1]["token"] == "sa-token" and out[1]["namespace"] == "podmortem-system"
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    errors = []
    for name in ("jax", "port"):
        with pytest.raises(PKGS[name].operator_kubeapi.ApiError) as info:
            PKGS[name].operator_httpapi.load_incluster_config(str(tmp_path))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("user", ["token", "exec", "client_cert"])
def test_kubeconfig_loading_matches_jax(tmp_path, user):
    users = {
        "token": {"token": "kc-token"},
        "exec": {"exec": {"command": "aws"}},
        "client_cert": {"client-certificate-data": base64.b64encode(b"cert").decode(),
                        "client-key-data": base64.b64encode(b"key").decode()},
    }
    doc = {
        "current-context": "dev",
        "contexts": [{"name": "dev", "context": {"cluster": "c1", "user": "u1",
                                                  "namespace": "team-a"}}],
        "clusters": [{"name": "c1", "cluster": {
            "server": "https://k8s.example:6443",
            "certificate-authority-data": base64.b64encode(b"ca-bytes").decode()}}],
        "users": [{"name": "u1", "user": users[user]}],
    }
    path = tmp_path / "config"
    path.write_text(json.dumps(doc))
    out = []
    for name in ("jax", "port"):
        H = PKGS[name].operator_httpapi
        try:
            config = vars(H.load_kubeconfig(str(path)))
        except PKGS[name].operator_kubeapi.ApiError as exc:
            out.append({"error": str(exc)})
            continue
        # materialised PEM files: compare their bytes, not their temp names
        for key in ("ca_file", "client_cert_file", "client_key_file"):
            if config[key]:
                config[key] = Path(config[key]).read_bytes()
        out.append(config)
    assert out[0] == out[1]
    if user == "exec":
        assert "exec" in out[1]["error"]
    else:
        assert out[1]["host"] == "k8s.example" and out[1]["ca_file"] == b"ca-bytes"


# ---------------------------------------------------------------------------
# the stub apiserver
# ---------------------------------------------------------------------------


def test_facade_parses_the_selectors_httpapi_writes():
    from operator_tpu_torch.operator.kubefacade import parse_selector

    H, meta = PKGS["port"].operator_httpapi, PKGS["port"].schema_meta
    selector = meta.LabelSelector(
        match_labels={"app": "payment"},
        match_expressions=[
            meta.LabelSelectorRequirement(key="env", operator="In", values=["prod", "dev"]),
            meta.LabelSelectorRequirement(key="old", operator="NotIn", values=["1", "2"]),
            meta.LabelSelectorRequirement(key="canary", operator="DoesNotExist"),
            meta.LabelSelectorRequirement(key="team", operator="Exists"),
        ],
    )
    text = H._selector_string(selector)
    assert H._selector_string(parse_selector(text)) == text
    assert parse_selector("") is None


async def _facade_drive(pkg, facade) -> list:
    api = pkg.operator_httpapi.HttpKubeApi(pkg.operator_httpapi.load_kubeconfig(
        facade.write_kubeconfig(str(Path(facade.scratch) / pkg.name / "kubeconfig"))))
    ns = f"ns-{pkg.name}"
    out = [api.namespace]
    labels = {"app": "web"}
    out.append(await _outcome(api.create("Pod", {"metadata": {"name": "p1", "namespace": ns,
                                                              "labels": labels}})))
    out.append(await _outcome(api.create("Pod", {"metadata": {"name": "p1", "namespace": ns}})))
    out.append(await _outcome(api.list("Pod", ns, pkg.schema_meta.LabelSelector(
        match_labels=labels))))
    out.append(await _outcome(api.list("Pod", ns, pkg.schema_meta.LabelSelector(
        match_labels={"app": "db"}))))
    got = await api.get("Pod", "p1", ns)
    rv = got["metadata"]["resourceVersion"]
    out.append(await _outcome(api.patch("Pod", "p1", ns, {"metadata": {"labels": {"x": "1"}}},
                                        resource_version=rv)))
    out.append(await _outcome(api.patch("Pod", "p1", ns, {"metadata": {"labels": {"x": "2"}}},
                                        resource_version=rv)))
    out.append(await _outcome(api.patch_status("Pod", "p1", ns, {"phase": "Failed"})))
    out.append(await _outcome(api.get("Pod", "absent", ns)))
    facade.api.set_pod_log(ns, "p1", "line1\nline2\n", previous=True)
    out.append(await _outcome(api.get_log("p1", ns, previous=True, tail_bytes=6)))
    out.append(await _outcome(api.create("Deployment", {"metadata": {"name": "d", "namespace": ns},
                                                        "spec": {"replicas": 1}})))
    scale = await api.get_scale("Deployment", "d", ns)
    out.append(scale)
    out.append(await _outcome(api.patch_scale("Deployment", "d", ns, 2,
                                              resource_version=scale["metadata"]["resourceVersion"])))
    out.append(await _outcome(api.patch_scale("Deployment", "d", ns, 3,
                                              resource_version=scale["metadata"]["resourceVersion"])))
    _, cursor = await api.list_rv("Pod", ns)
    watched: list = []

    async def consume():
        async for event in api.watch("Pod", ns, resource_version=cursor):
            watched.append([event.type, event.object["metadata"]["name"]])
            if len(watched) == 2:
                return

    task = asyncio.create_task(consume())
    await asyncio.sleep(0.2)
    await api.create("Pod", {"metadata": {"name": "p2", "namespace": ns}})
    await api.delete("Pod", "p2", ns)
    await asyncio.wait_for(task, 10)
    out.append(watched)
    out.append(await _outcome(api.delete("Pod", "p1", ns)))
    out.append(await _outcome(api.list("Pod", ns)))
    return out


def _strip_rv(value):
    """resourceVersions count every write on the shared stub: the two
    packages' sequences interleave on one counter, so the numbers are
    dropped (their guards are what the conflicts check)."""
    if isinstance(value, dict):
        return {k: _strip_rv(v) for k, v in value.items() if k != "resourceVersion"}
    if isinstance(value, list):
        return [_strip_rv(v) for v in value]
    if isinstance(value, str):
        return value.replace("ns-jax", "ns-<pkg>").replace("ns-port", "ns-<pkg>")
    return value


def test_both_clients_drive_the_stub_apiserver_alike(tmp_path):
    from operator_tpu_torch.operator.kubefacade import KubeFacade

    facade = KubeFacade(namespace="team-a").start()
    facade.scratch = str(tmp_path)
    try:
        ref, port = (normalise(_strip_rv(asyncio.run(_facade_drive(PKGS[name], facade))))
                     for name in ("jax", "port"))
    finally:
        facade.stop()
    assert port == ref
    assert port[0] == "team-a"
    assert port[2]["error"] == "ConflictError"
    assert [p["metadata"]["name"] for p in port[3]["ok"]] == ["p1"] and port[4] == {"ok": []}
    assert port[6]["error"] == "ConflictError" and port[8]["error"] == "NotFoundError"
    assert port[9] == {"ok": "line2\n"}
    assert port[13]["error"] == "ConflictError"
    assert port[14] == [["ADDED", "p2"], ["DELETED", "p2"]]
    assert port[16] == {"ok": []}


# ---------------------------------------------------------------------------
# the deployed entry point
# ---------------------------------------------------------------------------


def _run_cli(root: str, tmp_path: Path) -> dict:
    """``python -m <root>.operator`` over a fresh stub: one failing pod,
    leader election on, then SIGTERM."""
    from operator_tpu_torch import schema as s
    from operator_tpu_torch.operator.kubefacade import KubeFacade
    from operator_tpu_torch.schema.crds import Podmortem

    facade = KubeFacade(namespace="podmortem-system").start()
    try:
        kubeconfig = facade.write_kubeconfig(str(tmp_path / root / "kubeconfig"))
        api = facade.api

        async def seed():
            await api.create_obj(s.AIProvider(
                metadata=s.ObjectMeta(name="prov", namespace="ns"),
                spec=s.AIProviderSpec(provider_id="template", model_id="m")))
            await api.create_obj(Podmortem(
                metadata=s.ObjectMeta(name="pm", namespace="ns"),
                spec=s.PodmortemSpec(pod_selector=s.LabelSelector(match_labels={"app": "web"}),
                                     ai_provider_ref=s.AIProviderRef(name="prov", namespace="ns"),
                                     ai_analysis_enabled=True)))

        facade.call(seed())
        env = {k: v for k, v in os.environ.items() if k != "KUBERNETES_SERVICE_HOST"}
        env.update(KUBECONFIG=kubeconfig, LEADER_ELECTION="true", POD_NAME="op-cli",
                   HEALTH_PORT="-1", PATTERN_CACHE_DIRECTORY=str(tmp_path / "nonexistent"),
                   CLAIMS_PATH=str(tmp_path / root / "claims.jsonl"), JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO))
        argv = [sys.executable, "-m", f"{root}.operator"]
        if root == "operator_tpu_torch":
            argv += ["--device", "cpu"]
        proc = subprocess.Popen(argv, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            pod = s.Pod(
                metadata=s.ObjectMeta(name="web-1", namespace="prod", labels={"app": "web"}),
                status=s.PodStatus(phase="Running", container_statuses=[s.ContainerStatus(
                    name="app", restart_count=1, state=s.ContainerState(
                        terminated=s.ContainerStateTerminated(
                            exit_code=1, finished_at="2026-07-28T09:00:00Z")))]))
            api.set_pod_log("prod", "web-1", (REPO / "tests/fixtures/oom_java.log").read_text(),
                            previous=True)
            facade.call(api.create_obj(pod))
            status = {}
            for _ in range(600):
                status = facade.call(api.get("Podmortem", "pm", "ns")).get("status") or {}
                if status.get("recentFailures") or proc.poll() is not None:
                    break
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            try:
                output, _ = proc.communicate(timeout=8)
                unaided = True
            except subprocess.TimeoutExpired:
                # the JAX client's watch threads stay in readline until the
                # stream ends: end the streams, as the apiserver's
                # timeoutSeconds would
                unaided = False
                facade.call(facade._close_watches())
                output, _ = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        lease = facade.call(api.get("Lease", "podmortem-tpu-operator", "podmortem-system"))
        annotations = facade.call(api.get("Pod", "web-1", "prod"))["metadata"].get("annotations")
    finally:
        facade.stop()
    failures = [{k: v for k, v in f.items() if k != "traceId"}
                for f in status.get("recentFailures") or []]
    return {"rc": proc.returncode, "unaided_exit": unaided, "failures": normalise(failures),
            "annotations": normalise(annotations), "holder": lease["spec"]["holderIdentity"],
            "transitions": lease["spec"].get("leaseTransitions"), "output": output}


def test_run_real_stores_over_http_and_releases_its_lease_as_jax(tmp_path):
    ref, port = (_run_cli(root, tmp_path) for root in ("operator_tpu", "operator_tpu_torch"))
    assert port["rc"] == 0, port["output"][-3000:]
    assert ref["rc"] == 0, ref["output"][-3000:]
    assert port["holder"] == ref["holder"] == ""
    # the port's watch threads end with their streams on stop()
    assert port["unaided_exit"]
    for key in ("failures", "annotations", "transitions"):
        assert port[key] == ref[key], key
    assert len(port["failures"]) == 1 and port["failures"][0]["analysisStatus"] == "Analyzed"
    assert "released lease" in port["output"]
