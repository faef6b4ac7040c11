"""Production Kubernetes API client — stdlib only (http.client + ssl).

The port's own copy of ``operator_tpu/operator/httpapi.py``: host code, the same names and
behaviour.

Implements the :class:`~operator_tpu_torch.operator.kubeapi.KubeApi` surface
against a real apiserver, the role the reference delegates to the fabric8
client (reference PodFailureWatcher.java:92, AnalysisStorageService.java:339).
No third-party HTTP dependency: unary calls run ``http.client`` on the
asyncio worker-thread pool (the event loop never blocks — the reference's
Mutiny worker-pool discipline, SURVEY.md §5), and watches stream JSON-lines
from a long-lived response, also read off-loop.

Auth/config resolution order (``from_env``):

1. in-cluster: ``KUBERNETES_SERVICE_HOST`` + the serviceaccount token/CA at
   ``/var/run/secrets/kubernetes.io/serviceaccount/`` (what the shipped
   deployment uses — deploy/operator-deployment.yaml);
2. kubeconfig: ``$KUBECONFIG`` or ``~/.kube/config`` — token, basic user
   client-cert, or insecure-skip-tls-verify entries (exec plugins are out
   of scope and raise a clear error).

Status-code mapping matches the fake apiserver so the retry discipline
(409 → re-fetch + retry with backoff, 403 → RBAC warning) behaves
identically in tests and production.
"""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import logging
import os
import socket
import ssl
import tempfile
import urllib.parse
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from ..schema.meta import LabelSelector
from .kubeapi import (
    ApiError,
    ConflictError,
    ForbiddenError,
    KubeApi,
    NotFoundError,
    WatchClosed,
    WatchExpired,
    WatchEvent,
)

log = logging.getLogger(__name__)

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: kind -> (api prefix, plural, namespaced)
_KINDS: dict[str, tuple[str, str, bool]] = {
    "Pod": ("/api/v1", "pods", True),
    "Secret": ("/api/v1", "secrets", True),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Endpoints": ("/api/v1", "endpoints", True),
    "Service": ("/api/v1", "services", True),
    "Event": ("/apis/events.k8s.io/v1", "events", True),
    "ReplicaSet": ("/apis/apps/v1", "replicasets", True),
    "Deployment": ("/apis/apps/v1", "deployments", True),
    "Lease": ("/apis/coordination.k8s.io/v1", "leases", True),
    "Podmortem": ("/apis/podmortem.tpu.dev/v1alpha1", "podmortems", True),
    "AIProvider": ("/apis/podmortem.tpu.dev/v1alpha1", "aiproviders", True),
    "PatternLibrary": ("/apis/podmortem.tpu.dev/v1alpha1", "patternlibraries", True),
}


def _selector_string(selector: Optional[LabelSelector]) -> Optional[str]:
    """LabelSelector -> apiserver ``labelSelector`` query value."""
    if selector is None or selector.is_empty():
        return None
    parts = [f"{k}={v}" for k, v in sorted(selector.match_labels.items())]
    for req in selector.match_expressions:
        op = (req.operator or "").lower()
        values = ",".join(req.values or [])
        if op == "in":
            parts.append(f"{req.key} in ({values})")
        elif op == "notin":
            parts.append(f"{req.key} notin ({values})")
        elif op == "exists":
            parts.append(f"{req.key}")
        elif op == "doesnotexist":
            parts.append(f"!{req.key}")
    return ",".join(parts)


def _raise_for_status(status: int, body: bytes, context: str) -> None:
    if status < 400:
        return
    try:
        message = json.loads(body).get("message", body.decode(errors="replace"))
    except (ValueError, AttributeError):
        message = body.decode(errors="replace")[:300]
    detail = f"{context}: {message}"
    if status == 404:
        raise NotFoundError(detail)
    if status == 409:
        raise ConflictError(detail)
    if status == 403:
        raise ForbiddenError(detail)
    raise ApiError(detail, status=status)


@dataclass
class ClusterConfig:
    host: str
    port: int
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    verify_tls: bool = True
    scheme: str = "https"
    namespace: str = "default"

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if self.scheme != "https":
            return None
        if self.verify_tls:
            context = ssl.create_default_context(cafile=self.ca_file)
        else:
            context = ssl._create_unverified_context()  # noqa: S323 - explicit opt-in
        if self.client_cert_file:
            context.load_cert_chain(self.client_cert_file, self.client_key_file)
        return context


def load_incluster_config(sa_dir: str = SERVICEACCOUNT_DIR) -> ClusterConfig:
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = int(os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
    if not host:
        raise ApiError("KUBERNETES_SERVICE_HOST not set: not running in-cluster")
    with open(os.path.join(sa_dir, "token")) as f:
        token = f.read().strip()
    namespace = "default"
    ns_path = os.path.join(sa_dir, "namespace")
    if os.path.exists(ns_path):
        with open(ns_path) as f:
            namespace = f.read().strip() or "default"
    ca = os.path.join(sa_dir, "ca.crt")
    return ClusterConfig(
        host=host, port=port, token=token,
        ca_file=ca if os.path.exists(ca) else None,
        namespace=namespace,
    )


def load_kubeconfig(path: Optional[str] = None) -> ClusterConfig:
    """Minimal kubeconfig support: current-context -> cluster + user with
    token / client-cert / basic fields.  Exec credential plugins raise."""
    import yaml

    path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
    with open(path) as f:
        doc = yaml.safe_load(f)
    contexts = {c["name"]: c["context"] for c in doc.get("contexts", [])}
    current = doc.get("current-context")
    if current not in contexts:
        raise ApiError(f"kubeconfig {path}: current-context {current!r} not found")
    ctx = contexts[current]
    clusters = {c["name"]: c["cluster"] for c in doc.get("clusters", [])}
    users = {u["name"]: u["user"] for u in doc.get("users", [])}
    cluster = clusters[ctx["cluster"]]
    user = users.get(ctx.get("user", ""), {})
    if "exec" in user:
        raise ApiError("kubeconfig exec credential plugins are not supported")

    url = urllib.parse.urlparse(cluster["server"])
    config = ClusterConfig(
        host=url.hostname or "localhost",
        port=url.port or (443 if url.scheme == "https" else 80),
        scheme=url.scheme or "https",
        namespace=ctx.get("namespace", "default"),
        verify_tls=not cluster.get("insecure-skip-tls-verify", False),
    )

    def materialize(data_key: str, file_key: str, source: dict) -> Optional[str]:
        if source.get(file_key):
            return source[file_key]
        if source.get(data_key):
            blob = base64.b64decode(source[data_key])
            handle = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            handle.write(blob)
            handle.close()
            return handle.name
        return None

    config.ca_file = materialize("certificate-authority-data", "certificate-authority", cluster)
    config.client_cert_file = materialize("client-certificate-data", "client-certificate", user)
    config.client_key_file = materialize("client-key-data", "client-key", user)
    config.token = user.get("token")
    return config


class HttpKubeApi(KubeApi):
    """KubeApi over HTTP(S) to a real apiserver."""

    #: slack past the server-side watch timeout before declaring the
    #: socket half-open (server close should always arrive first)
    _WATCH_SOCKET_MARGIN_S = 30.0

    def __init__(
        self,
        config: ClusterConfig,
        *,
        request_timeout_s: float = 30.0,
        watch_timeout_s: float = 300.0,
    ) -> None:
        self.config = config
        self.request_timeout_s = request_timeout_s
        self.watch_timeout_s = watch_timeout_s
        self._ssl = config.ssl_context()

    # -- construction ---------------------------------------------------
    @classmethod
    def from_env(cls) -> "HttpKubeApi":
        if os.environ.get("KUBERNETES_SERVICE_HOST"):
            return cls(load_incluster_config())
        return cls(load_kubeconfig())

    @property
    def namespace(self) -> str:
        return self.config.namespace

    # -- plumbing -------------------------------------------------------
    def _path(self, kind: str, namespace: Optional[str], name: Optional[str] = None,
              subresource: Optional[str] = None) -> str:
        try:
            prefix, plural, namespaced = _KINDS[kind]
        except KeyError:
            raise ApiError(f"unknown kind {kind!r}") from None
        path = prefix
        if namespaced and namespace:
            path += f"/namespaces/{urllib.parse.quote(namespace)}"
        path += f"/{plural}"
        if name:
            path += f"/{urllib.parse.quote(name)}"
        if subresource:
            path += f"/{subresource}"
        return path

    _UNSET: Any = object()

    def _connect(self, timeout: Any = _UNSET) -> http.client.HTTPConnection:
        # explicit None means "no timeout" (blocking socket) — what a watch
        # stream needs; only an omitted argument falls back to the default
        if timeout is HttpKubeApi._UNSET:
            timeout = self.request_timeout_s
        if self.config.scheme == "https":
            return http.client.HTTPSConnection(
                self.config.host, self.config.port, timeout=timeout, context=self._ssl
            )
        return http.client.HTTPConnection(self.config.host, self.config.port, timeout=timeout)

    def _headers(self, content_type: Optional[str] = None) -> dict[str, str]:
        headers = {"Accept": "application/json", "User-Agent": "operator-tpu"}
        if self.config.token:
            headers["Authorization"] = f"Bearer {self.config.token}"
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    def _request_sync(
        self, method: str, path: str, body: Optional[dict] = None,
        *, content_type: str = "application/json",
    ) -> tuple[int, bytes]:
        conn = self._connect()
        try:
            conn.request(
                method, path,
                body=json.dumps(body).encode() if body is not None else None,
                headers=self._headers(content_type if body is not None else None),
            )
            response = conn.getresponse()
            return response.status, response.read()
        finally:
            conn.close()

    async def _request(
        self, method: str, path: str, body: Optional[dict] = None,
        *, content_type: str = "application/json",
    ) -> dict:
        status, payload = await asyncio.to_thread(
            self._request_sync, method, path, body, content_type=content_type
        )
        _raise_for_status(status, payload, f"{method} {path}")
        return json.loads(payload) if payload else {}

    # -- KubeApi surface ------------------------------------------------
    async def get(self, kind: str, name: str, namespace: str) -> dict:
        return await self._request("GET", self._path(kind, namespace, name))

    async def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> list[dict]:
        items, _ = await self.list_rv(kind, namespace, label_selector)
        return items

    async def list_rv(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> tuple[list[dict], Optional[str]]:
        path = self._path(kind, namespace)
        selector = _selector_string(label_selector)
        if selector:
            path += "?" + urllib.parse.urlencode({"labelSelector": selector})
        body = await self._request("GET", path)
        items = body.get("items", [])
        for item in items:  # items omit kind/apiVersion; restore for callers
            item.setdefault("kind", kind)
        version = (body.get("metadata") or {}).get("resourceVersion")
        return items, version

    async def create(self, kind: str, obj: dict) -> dict:
        namespace = obj.get("metadata", {}).get("namespace") or self.config.namespace
        return await self._request("POST", self._path(kind, namespace), obj)

    async def _patch(
        self, kind: str, name: str, namespace: str, patch: dict,
        *, resource_version: Optional[str], subresource: Optional[str],
    ) -> dict:
        if resource_version is not None:
            patch = dict(patch)
            meta = dict(patch.get("metadata", {}))
            meta["resourceVersion"] = resource_version  # 409 on mismatch
            patch["metadata"] = meta
        return await self._request(
            "PATCH",
            self._path(kind, namespace, name, subresource),
            patch,
            content_type="application/merge-patch+json",
        )

    async def patch(
        self, kind: str, name: str, namespace: str, patch: dict,
        *, resource_version: Optional[str] = None,
    ) -> dict:
        return await self._patch(
            kind, name, namespace, patch,
            resource_version=resource_version, subresource=None,
        )

    async def patch_status(
        self, kind: str, name: str, namespace: str, status: dict,
        *, resource_version: Optional[str] = None,
    ) -> dict:
        return await self._patch(
            kind, name, namespace, {"status": status},
            resource_version=resource_version, subresource="status",
        )

    async def delete(self, kind: str, name: str, namespace: str) -> None:
        await self._request("DELETE", self._path(kind, namespace, name))

    async def get_scale(self, kind: str, name: str, namespace: str) -> dict:
        return await self._request(
            "GET", self._path(kind, namespace, name, "scale")
        )

    async def patch_scale(
        self,
        kind: str,
        name: str,
        namespace: str,
        replicas: int,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        patch: dict = {"spec": {"replicas": int(replicas)}}
        if resource_version is not None:
            patch["metadata"] = {"resourceVersion": resource_version}
        return await self._request(
            "PATCH",
            self._path(kind, namespace, name, "scale"),
            patch,
            content_type="application/merge-patch+json",
        )

    async def get_log(
        self,
        name: str,
        namespace: str,
        *,
        container: Optional[str] = None,
        previous: bool = False,
        tail_bytes: Optional[int] = None,
    ) -> str:
        query: dict[str, str] = {}
        if container:
            query["container"] = container
        if previous:
            query["previous"] = "true"
        if tail_bytes:
            query["limitBytes"] = str(tail_bytes)
        path = self._path("Pod", namespace, name, "log")
        if query:
            path += "?" + urllib.parse.urlencode(query)
        status, payload = await asyncio.to_thread(self._request_sync, "GET", path)
        _raise_for_status(status, payload, f"GET {path}")
        return payload.decode(errors="replace")

    # -- watch ----------------------------------------------------------
    async def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        resource_version: Optional[str] = None,
    ) -> AsyncIterator[WatchEvent]:
        """Stream ADDED/MODIFIED/DELETED/BOOKMARK events as JSON-lines.

        With ``resource_version`` the stream resumes from that point
        (list+watch: pass the list's collection resourceVersion and no
        event between the list and the watch is lost — the informer
        discipline of the fabric8 client the reference runs on,
        PodFailureWatcher.java:92).  Bookmarks are requested so callers
        can refresh their cursor from quiet streams.  A compacted cursor
        raises :class:`WatchExpired` (HTTP 410 / ERROR-410 event): relist
        before watching again.  Other server closes raise
        :class:`WatchClosed` so the caller's restart-after-5s loop engages
        (reference PodFailureWatcher.java:562-583).
        """
        # the apiserver ends the watch after timeoutSeconds (clean close ->
        # reconnect); the socket timeout is the backstop for HALF-OPEN
        # connections (node reboot, LB idle drop without FIN) which would
        # otherwise block readline in its worker thread forever and
        # silently stop failure detection — the fabric8 client the
        # reference relies on keeps watches live the same two ways
        query = {
            "watch": "true",
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(int(self.watch_timeout_s)),
        }
        if resource_version is not None:
            query["resourceVersion"] = resource_version
        path = self._path(kind, namespace) + "?" + urllib.parse.urlencode(query)
        conn = self._connect(timeout=self.watch_timeout_s + self._WATCH_SOCKET_MARGIN_S)
        #: the stream's socket, kept past http.client's own close (an
        #: HTTP/1.0 response detaches it from ``conn``) so teardown can
        #: wake a worker thread blocked in readline
        sockets: list = []

        def open_stream() -> Any:
            conn.request("GET", path, headers=self._headers())
            sockets.append(conn.sock)
            return conn.getresponse()

        try:
            try:
                response = await asyncio.to_thread(open_stream)
            except (TimeoutError, OSError) as exc:
                raise WatchClosed(f"watch open for {kind} failed: {exc}") from exc
            if response.status == 410:
                raise WatchExpired(
                    f"watch resume for {kind} at resourceVersion "
                    f"{resource_version!r} expired (410 Gone)"
                )
            if response.status >= 400:
                payload = await asyncio.to_thread(response.read)
                _raise_for_status(response.status, payload, f"WATCH {path}")
            while True:
                try:
                    line = await asyncio.to_thread(response.readline)
                except (TimeoutError, OSError) as exc:  # dead-peer socket timeout
                    raise WatchClosed(f"watch stream for {kind} timed out: {exc}") from exc
                if not line:
                    raise WatchClosed(f"watch stream for {kind} closed by server")
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    log.warning("unparseable watch line for %s: %.120r", kind, line)
                    continue
                event_type = event.get("type", "")
                if event_type == "ERROR":
                    obj = event.get("object") or {}
                    if obj.get("code") == 410:
                        # etcd compacted past the resume cursor: the
                        # caller must relist, not merely reconnect
                        raise WatchExpired(
                            f"watch resume for {kind} expired: "
                            f"{obj.get('message', '410 Gone')}"
                        )
                    raise WatchClosed(f"watch error for {kind}: {obj}")
                obj = event.get("object", {})
                obj.setdefault("kind", kind)
                # BOOKMARK events flow through: the caller refreshes its
                # resume cursor from object.metadata.resourceVersion
                yield WatchEvent(type=event_type, object=obj)
        finally:
            # a consumer that stops (cancelled on operator stop) must not
            # leave a worker thread blocked in readline until the server's
            # timeoutSeconds: shutting the socket down wakes it at once
            for sock in sockets:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            await asyncio.to_thread(conn.close)
