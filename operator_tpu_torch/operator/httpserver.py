"""Health + metrics HTTP endpoint (stdlib asyncio, no framework).

The reference serves MicroProfile health at ``/q/health/{live,ready}`` and
is probed by the kubelet (reference operator-deployment.yaml:61-78); it has
no metrics endpoint at all (SURVEY.md §5 tracing entry).  Here one tiny
asyncio HTTP server exposes:

- ``GET /healthz/live``  — liveness (event loop answers)
- ``GET /healthz/ready`` — readiness (pattern cache gating, health.py)
- ``GET /metrics``       — Prometheus text exposition of the per-stage
  latency registry (detect→collect→parse→prefill→decode→store), scrapeable
  by any standard collector — the observability the p50<2s SLO needs
- ``GET /metrics.json``  — the same data as a JSON snapshot
- ``GET /incidents``     — the incident-memory store, newest first
  (``?limit=N``; docs/MEMORY.md)
- ``GET /incidents/query`` — free-text similarity query over the incident
  index (``?q=...&k=N``): which remembered failures does this log line
  look like?
- ``GET /traces``        — the flight recorder's recent analysis traces
  (``?limit=N&blackbox=1``; docs/OBSERVABILITY.md)
- ``GET /traces/{id}``   — one trace: full span JSON plus the rendered
  flame-style text tree (the ``obs.view`` CLI's online twin)

Inbound W3C ``traceparent`` headers are honoured: the request handler
runs under a trace joining the caller's trace id, recorded into the same
flight recorder — a client can follow its own request into the operator.

Probe responses are JSON; failures return 503 so the kubelet treats the
pod exactly as it treats the reference's native binary.

The port's own copy of ``operator_tpu/operator/httpserver.py``, less
``GET /fleet`` (the roll-up of routed serving replicas comes with the
router).
"""

from __future__ import annotations

import asyncio
import json
import logging
import urllib.parse
from typing import TYPE_CHECKING, Callable, Optional

from ..obs import FlightRecorder, Tracer, parse_traceparent, render_tree
from ..utils.timing import METRICS, MetricsRegistry
from .health import LivenessCheck, ReadinessCheck

if TYPE_CHECKING:  # import cycle guard: memory is constructed by the app
    from ..memory import IncidentMemory

log = logging.getLogger(__name__)

_MAX_REQUEST_LINE = 8192


class HealthServer:
    """Minimal HTTP/1.1 server for kubelet probes and metrics scrapes.

    Close-delimited responses (``Connection: close``) keep the parser
    trivial: read the request line, ignore headers, answer, close.
    """

    def __init__(
        self,
        liveness: LivenessCheck,
        readiness: ReadinessCheck,
        *,
        metrics: Optional[MetricsRegistry] = None,
        memory: "Optional[IncidentMemory]" = None,
        recorder: Optional[FlightRecorder] = None,
        tracer: Optional[Tracer] = None,
        incidents_token: Optional[str] = None,
        slo: Optional[Callable[[], dict]] = None,
        host: str = "0.0.0.0",
        port: int = 8080,
    ) -> None:
        self.liveness = liveness
        self.readiness = readiness
        self.metrics = metrics or METRICS
        self.memory = memory
        #: flight recorder behind GET /traces* (None = endpoints 404)
        self.recorder = recorder
        #: tracer for inbound-traceparent request traces (None = headers
        #: accepted but ignored)
        self.tracer = tracer
        #: bearer token gating /incidents* AND /traces* (None/"" = open);
        #: probes and /metrics stay unauthenticated — incident records and
        #: trace attributes quote pod identities and evidence, which is
        #: more sensitive than latency numbers
        self.incidents_token = incidents_token or None
        #: zero-arg callable returning the SLO ledger's current state
        #: (per-class pending depth + attainment, obs/sloledger.py) —
        #: folded into GET /healthz/ready so one probe answers both
        #: "am I up" and "am I keeping my SLOs" (None = omitted)
        self.slo = slo
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def bound_port(self) -> Optional[int]:
        """The actual port (differs from ``port`` when 0 = ephemeral)."""
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        log.info("health server listening on %s:%s", self.host, self.bound_port)

    async def stop(self) -> None:
        # swap-then-act: clear the attribute before awaiting so a concurrent
        # stop() can't close the same server twice across the suspension
        server, self._server = self._server, None
        if server is not None:
            server.close()
            await server.wait_closed()

    # ------------------------------------------------------------------
    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            try:
                line = await reader.readline()
            except ValueError:
                # readline() raises ValueError past the StreamReader limit
                # (a >64 KiB request line); drop the connection quietly —
                # this catch is deliberately NARROW so ValueErrors from
                # routing/health checks/metrics still surface in logs
                return
            if len(line) > _MAX_REQUEST_LINE or not line:
                return
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, target = parts[0], parts[1]
            path, _, raw_query = target.partition("?")
            query = urllib.parse.parse_qs(raw_query)
            # drain the (bounded) header block; Authorization (the
            # /incidents* and /traces* token), traceparent (inbound W3C
            # trace context) and Accept (OpenMetrics negotiation for
            # /metrics) are the only headers consumed
            authorization = ""
            traceparent = ""
            accept = ""
            for _ in range(100):
                try:
                    header = await reader.readline()
                except ValueError:
                    return
                if not header or header in (b"\r\n", b"\n"):
                    break
                if header.lower().startswith(b"authorization:"):
                    authorization = header.split(b":", 1)[1].strip().decode("latin-1")
                elif header.lower().startswith(b"traceparent:"):
                    traceparent = header.split(b":", 1)[1].strip().decode("latin-1")
                elif header.lower().startswith(b"accept:"):
                    accept = header.split(b":", 1)[1].strip().decode("latin-1")
            remote = parse_traceparent(traceparent)
            if remote is not None and not self._authorized(authorization):
                # recording inbound request traces consumes ring slots; on
                # a token-gated deployment only token-holders may do that
                # (an unauthenticated client could otherwise churn every
                # forensic trace out of the bounded ring)
                remote = None
            # join the caller's distributed trace when one was offered: the
            # handler's work is recorded under THEIR trace id, findable via
            # GET /traces/{their-id} afterwards
            if remote is not None and self.tracer is not None:
                trace_ctx = self.tracer.trace(
                    f"http {path}", trace_id=remote[0], parent_id=remote[1],
                    attributes={"path": path},
                )
            else:
                import contextlib

                trace_ctx = contextlib.nullcontext()
            with trace_ctx:
                status, body = await self._route(
                    method, path, query, authorization=authorization,
                    accept=accept,
                )
            openmetrics = "application/openmetrics-text" in accept
            if isinstance(body, bytes):  # pre-rendered (Prometheus text)
                payload = body
                content_type = (
                    b"application/openmetrics-text; version=1.0.0; charset=utf-8"
                    if openmetrics
                    else b"text/plain; version=0.0.4; charset=utf-8"
                )
            else:
                payload = json.dumps(body).encode()
                content_type = b"application/json"
            writer.write(
                b"HTTP/1.1 %d %s\r\n"
                b"Content-Type: %s\r\n"
                b"Content-Length: %d\r\n"
                b"Connection: close\r\n\r\n"
                % (status, b"OK" if status == 200 else b"ERR", content_type, len(payload))
            )
            if method != "HEAD":  # HEAD: headers only, no body
                writer.write(payload)
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _authorized(self, authorization: str) -> bool:
        """Bearer-token check shared by the /incidents|/traces route gate
        and the inbound-traceparent gate; no token configured = open."""
        if not self.incidents_token:
            return True
        import hmac

        return hmac.compare_digest(
            authorization.encode(), f"Bearer {self.incidents_token}".encode()
        )

    async def _route(
        self,
        method: str,
        path: str,
        query: "Optional[dict[str, list[str]]]" = None,
        *,
        authorization: str = "",
        accept: str = "",
    ) -> "tuple[int, dict | bytes]":
        query = query or {}
        if method not in ("GET", "HEAD"):
            return 405, {"error": "method not allowed"}
        if (
            path.startswith("/incidents") or path.startswith("/traces")
        ) and not self._authorized(authorization):
            return 401, {"error": "missing or invalid bearer token"}
        if path in ("/healthz/live", "/livez"):
            status = await self.liveness.check()
            return (200 if status.ready else 503), {
                "status": "UP" if status.ready else "DOWN",
                "reason": status.reason,
            }
        if path in ("/healthz/ready", "/readyz"):
            status = await self.readiness.check()
            payload: dict = {
                "status": "UP" if status.ready else "DOWN",
                "reason": status.reason,
            }
            if self.slo is not None:
                # per-class admission queue depth + attainment from the
                # SLO ledger — probes ignore extra keys, operators and
                # the storm harness read them
                try:
                    payload["slo"] = self.slo()
                except Exception:  # a ledger fault must not fail probes
                    payload["slo"] = None
            return (200 if status.ready else 503), payload
        if path == "/metrics":
            # OpenMetrics only on negotiation: exemplars (trace ids on the
            # podmortem_trace_* counters) are illegal in classic text 0.0.4
            # — a mid-line '#' would fail the WHOLE legacy scrape
            openmetrics = "application/openmetrics-text" in accept
            return 200, self.metrics.prometheus(openmetrics=openmetrics).encode()
        if path == "/metrics.json":
            return 200, self.metrics.snapshot()
        if path == "/incidents":
            if self.memory is None:
                return 404, {"error": "incident memory disabled"}
            try:
                limit = int(query.get("limit", ["100"])[0])
            except ValueError:
                return 400, {"error": "limit must be an integer"}
            # serialize off-loop and only the requested page — a full-store
            # to_dict on the probe loop would stall kubelet probes
            incidents = await asyncio.to_thread(
                self.memory.store.to_dicts, True, limit
            )
            return 200, {"count": len(self.memory.store), "incidents": incidents}
        if path == "/incidents/query":
            if self.memory is None:
                return 404, {"error": "incident memory disabled"}
            text = query.get("q", [""])[0]
            if not text.strip():
                return 400, {"error": "missing query parameter q"}
            try:
                k = int(query.get("k", ["3"])[0])
            except ValueError:
                return 400, {"error": "k must be an integer"}
            # embedding runs off-loop: a neural embedder must not stall
            # probe handling on this same server
            matches = await asyncio.to_thread(self.memory.query_text, text, k)
            payload = []
            for incident, score in matches:
                # re-serialize under the store lock: the Incident is live
                data = self.memory.store.dump(incident.fingerprint)
                if data is not None:
                    payload.append({"score": round(score, 4), **data})
            return 200, {"matches": payload}
        if path == "/traces":
            if self.recorder is None:
                return 404, {"error": "flight recorder disabled"}
            try:
                limit = int(query.get("limit", ["50"])[0])
            except ValueError:
                return 400, {"error": "limit must be an integer"}
            blackbox_only = query.get("blackbox", ["0"])[0] in ("1", "true")
            records = self.recorder.traces(limit, blackbox_only=blackbox_only)
            return 200, {
                "count": len(self.recorder),
                "traces": [r.summary() for r in records],
            }
        if path.startswith("/traces/"):
            if self.recorder is None:
                return 404, {"error": "flight recorder disabled"}
            trace_id = path[len("/traces/"):]
            record = self.recorder.get(trace_id)
            if record is None:
                return 404, {"error": f"no trace {trace_id} in the ring "
                                      "(it may have been evicted)"}
            payload = record.to_dict()
            # the flame-style text tree (the obs.view CLI's rendering),
            # so a curl is readable without tooling
            payload["rendered"] = render_tree(record.trace)
            return 200, payload
        return 404, {"error": f"no route {path}"}
