"""A stub apiserver: :class:`FakeKubeApi` served over the apiserver's HTTP
paths, the ones :class:`~.httpapi.HttpKubeApi` builds.

It lets the deployed entry point (``python -m operator_tpu_torch.operator``,
which talks HTTP only) run on one machine without a cluster: point
``KUBECONFIG`` at :meth:`KubeFacade.write_kubeconfig` and seed objects
through :attr:`KubeFacade.api` on :attr:`KubeFacade.loop` (see
:meth:`KubeFacade.call`).  Covered: get, list (with ``labelSelector``),
watch as JSON lines (``resourceVersion`` resume, ``timeoutSeconds``, a
410 as an ``ERROR`` event), create, merge patch with the
``resourceVersion`` guard, the ``status`` and ``scale`` subresources,
delete and pod logs.  Errors map back to the status codes
``httpapi._raise_for_status`` reads.  Plain HTTP on 127.0.0.1, no auth.

The fake lives on its own event-loop thread; each HTTP request runs on a
server thread and hands its call to that loop.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from ..schema.meta import LabelSelector, LabelSelectorRequirement
from .httpapi import _KINDS
from .kubeapi import ApiError, ConflictError, FakeKubeApi, ForbiddenError, NotFoundError, WatchExpired

__all__ = ["KubeFacade", "parse_selector"]

#: (api prefix, plural) -> kind, the inverse of httpapi's path table
_BY_PLURAL = {(prefix, plural): kind for kind, (prefix, plural, _) in _KINDS.items()}


def parse_selector(text: Optional[str]) -> Optional[LabelSelector]:
    """``labelSelector`` query value -> LabelSelector: the forms
    ``httpapi._selector_string`` writes (``k=v``, ``k in (a,b)``,
    ``k notin (a,b)``, ``k``, ``!k``)."""
    if not text:
        return None
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    labels: dict[str, str] = {}
    exprs: list[LabelSelectorRequirement] = []
    for part in (p.strip() for p in parts):
        if not part:
            continue
        for word, op in ((" notin ", "NotIn"), (" in ", "In")):
            if word in part:
                key, values = part.split(word, 1)
                exprs.append(LabelSelectorRequirement(
                    key=key.strip(), operator=op,
                    values=[v.strip() for v in values.strip().strip("()").split(",") if v.strip()],
                ))
                break
        else:
            if "=" in part:
                key, value = part.split("=", 1)
                labels[key.strip().rstrip("=")] = value.strip().lstrip("=")
            elif part.startswith("!"):
                exprs.append(LabelSelectorRequirement(key=part[1:], operator="DoesNotExist"))
            else:
                exprs.append(LabelSelectorRequirement(key=part, operator="Exists"))
    return LabelSelector(match_labels=labels, match_expressions=exprs)


def _route(path: str) -> tuple[str, Optional[str], Optional[str], Optional[str]]:
    """URL path -> (kind, namespace, name, subresource); ApiError 404 for
    a path outside the table."""
    segments = [urllib.parse.unquote(s) for s in path.strip("/").split("/")]
    if segments[:2] == ["api", "v1"]:
        prefix, rest = "/api/v1", segments[2:]
    elif segments[:1] == ["apis"] and len(segments) >= 3:
        prefix, rest = "/" + "/".join(segments[:3]), segments[3:]
    else:
        raise NotFoundError(f"no route for {path}")
    namespace = None
    if len(rest) >= 2 and rest[0] == "namespaces":
        namespace, rest = rest[1], rest[2:]
    if not rest or (prefix, rest[0]) not in _BY_PLURAL:
        raise NotFoundError(f"no route for {path}")
    kind = _BY_PLURAL[(prefix, rest[0])]
    name = rest[1] if len(rest) > 1 else None
    sub = rest[2] if len(rest) > 2 else None
    return kind, namespace, name, sub


def _status_of(exc: BaseException) -> int:
    if isinstance(exc, NotFoundError):
        return 404
    if isinstance(exc, ConflictError):
        return 409
    if isinstance(exc, ForbiddenError):
        return 403
    if isinstance(exc, ApiError):
        return exc.status or 500
    return 500


class KubeFacade:
    """Serve one :class:`FakeKubeApi` on ``127.0.0.1:<port>`` until
    :meth:`stop`."""

    def __init__(self, api: Optional[FakeKubeApi] = None, *, namespace: str = "default",
                 port: int = 0) -> None:
        self.api = api or FakeKubeApi()
        self.namespace = namespace
        #: every request, as (method, path) — what a test asserts on
        self.requests: list[tuple[str, str]] = []
        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self.loop.run_forever, name="kube-facade-loop", daemon=True
        )
        self._stopping = threading.Event()
        facade = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                facade._handle(self, "GET")

            def do_POST(self):
                facade._handle(self, "POST")

            def do_PATCH(self):
                facade._handle(self, "PATCH")

            def do_DELETE(self):
                facade._handle(self, "DELETE")

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self.server.serve_forever, name="kube-facade-http", daemon=True
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "KubeFacade":
        self._loop_thread.start()
        self._server_thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self) -> None:
        """Close every watch stream, stop serving, stop the loop."""
        self._stopping.set()
        self.call(self._close_watches())
        self.server.shutdown()
        self.server.server_close()
        self._server_thread.join(timeout=5)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join(timeout=5)
        self.loop.close()

    async def _close_watches(self) -> None:
        self.api.close_watches("stub apiserver stopping")

    def call(self, coro, timeout_s: float = 30.0) -> Any:
        """Run ``coro`` on the facade's loop from another thread."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout_s)

    def write_kubeconfig(self, path: str) -> str:
        """A kubeconfig whose current context is this stub (plain HTTP,
        no credentials, ``namespace``); returns ``path``."""
        doc = {
            "apiVersion": "v1", "kind": "Config", "current-context": "stub",
            "contexts": [{"name": "stub", "context": {
                "cluster": "stub", "user": "stub", "namespace": self.namespace}}],
            "clusters": [{"name": "stub", "cluster": {"server": self.url}}],
            "users": [{"name": "stub", "user": {}}],
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)  # JSON is YAML
        return path

    # -- requests ----------------------------------------------------------
    def _handle(self, handler: BaseHTTPRequestHandler, method: str) -> None:
        url = urllib.parse.urlparse(handler.path)
        query = {k: v[-1] for k, v in urllib.parse.parse_qs(url.query).items()}
        self.requests.append((method, handler.path))
        try:
            length = int(handler.headers.get("Content-Length") or 0)
            body = json.loads(handler.rfile.read(length)) if length else None
            kind, namespace, name, sub = _route(url.path)
            if method == "GET" and name is None and query.get("watch") == "true":
                self._stream_watch(handler, kind, namespace, query)
                return
            if method == "GET" and sub == "log":
                text = self.call(self.api.get_log(
                    name, namespace, container=query.get("container"),
                    previous=query.get("previous") == "true",
                    tail_bytes=int(query["limitBytes"]) if query.get("limitBytes") else None,
                ))
                self._send(handler, 200, text.encode(), "text/plain")
                return
            status, out = self.call(self._dispatch(method, kind, namespace, name, sub, body, query))
            self._send(handler, status, json.dumps(out).encode())
        except (ApiError, ValueError, KeyError, TypeError) as exc:
            code = _status_of(exc) if isinstance(exc, ApiError) else 400
            self._send(handler, code, json.dumps(
                {"kind": "Status", "status": "Failure", "message": str(exc), "code": code}
            ).encode())

    async def _dispatch(self, method, kind, namespace, name, sub, body, query) -> tuple[int, Any]:
        api = self.api
        rv = None
        if isinstance(body, dict):
            meta = dict(body.get("metadata") or {})
            rv = meta.pop("resourceVersion", None) if method == "PATCH" else None
            if method == "PATCH":
                body = {k: v for k, v in body.items() if k != "metadata"}
                if meta:
                    body["metadata"] = meta
        if method == "GET" and name is None:
            items, version = await api.list_rv(
                kind, namespace, parse_selector(query.get("labelSelector"))
            )
            return 200, {"kind": f"{kind}List", "items": items,
                         "metadata": {"resourceVersion": version}}
        if method == "GET" and sub == "scale":
            return 200, await api.get_scale(kind, name, namespace)
        if method == "GET":
            return 200, await api.get(kind, name, namespace)
        if method == "POST":
            body = dict(body or {})
            body["metadata"] = {**(body.get("metadata") or {}),
                                "namespace": (body.get("metadata") or {}).get("namespace")
                                or namespace}
            return 201, await api.create(kind, body)
        if method == "PATCH" and sub == "scale":
            replicas = int(((body or {}).get("spec") or {})["replicas"])
            return 200, await api.patch_scale(kind, name, namespace, replicas,
                                              resource_version=rv)
        if method == "PATCH" and sub == "status":
            return 200, await api.patch_status(kind, name, namespace,
                                               (body or {}).get("status") or {},
                                               resource_version=rv)
        if method == "PATCH":
            return 200, await api.patch(kind, name, namespace, body or {}, resource_version=rv)
        if method == "DELETE":
            await api.delete(kind, name, namespace)
            return 200, {"kind": "Status", "status": "Success"}
        raise ApiError(f"{method} not supported here", 405)

    def _stream_watch(self, handler, kind, namespace, query) -> None:
        """JSON lines until ``timeoutSeconds``, a closed stream, the
        client's disconnect or :meth:`stop`."""
        events: "queue.Queue[Optional[dict]]" = queue.Queue()

        async def pump() -> None:
            try:
                async for event in self.api.watch(kind, namespace, query.get("resourceVersion")):
                    events.put({"type": event.type, "object": event.object})
            except WatchExpired as exc:
                events.put({"type": "ERROR", "object": {
                    "kind": "Status", "code": 410, "message": str(exc)}})
            except Exception:  # noqa: BLE001 - any other close ends the stream
                pass
            finally:
                events.put(None)

        future = asyncio.run_coroutine_threadsafe(pump(), self.loop)
        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.end_headers()
        deadline = float(query.get("timeoutSeconds") or 300)
        waited = 0.0
        try:
            while not self._stopping.is_set() and waited < deadline:
                try:
                    item = events.get(timeout=0.1)
                except queue.Empty:
                    waited += 0.1
                    continue
                if item is None:
                    break
                handler.wfile.write(json.dumps(item).encode() + b"\n")
                handler.wfile.flush()
        except OSError:
            pass  # the client went away
        finally:
            future.cancel()

    @staticmethod
    def _send(handler, status: int, body: bytes, content_type: str = "application/json") -> None:
        try:
            handler.send_response(status)
            handler.send_header("Content-Type", content_type)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        except OSError:
            pass  # the client went away
