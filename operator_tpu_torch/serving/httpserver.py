"""OpenAI-compatible HTTP front for the port's serving engine.

The port's own copy of ``operator_tpu/serving/httpserver.py``: the
reference's ai-interface as a service, on the same asyncio structure
(stdlib ``asyncio.start_server``, close-delimited HTTP/1.1, a drain grace
in ``stop``).  A client's disconnect cancels its handler's generation
task, which the engine reaps at its next step.

- ``GET  /healthz``              — liveness, this replica's identity and
  its load report (``router/health.py:ReplicaLoad``: queue depth, the
  roofline decode estimate, the step clock, the SLO board, the KV
  economy) for the failover router (``router/``)
- ``GET  /metrics``, ``GET /metrics.json`` — the engine's registry as
  Prometheus text (OpenMetrics under ``Accept`` negotiation) or JSON
- ``GET  /v1/models``            — the served model (+ the embedder)
- ``POST /v1/completions``       — prompt (str or list), n, max_tokens,
  temperature, top_p, stop; every prompt and replica joins the shared
  continuous batch
- ``POST /v1/chat/completions``  — messages (string or text-part content)
  rendered with the served model family's chat template
  (``serving/templates.py:template_for``), otherwise as completions
- ``POST /v1/embeddings``        — the pattern engine's embedder (MiniLM
  when an encoder checkpoint is mounted, lexical hashing otherwise)
- ``POST /api/v1/analysis/analyze`` — the reference's ai-interface
  contract: an ``AnalysisRequest`` in, an ``AIResponse`` out
- ``POST /profile?seconds=N``    — an on-demand ``torch.profiler``
  capture (CUDA activity on the card) written as a Chrome trace under the
  profile dir; 404 unless enabled (``PROFILE_ENABLED``), 409 while a
  capture runs

``stream: true`` serves Server-Sent Events: one OpenAI-format chunk per
committed scheduler step or decode block (the engine's host-sync
granularity), then ``[DONE]``; n=1 and a single prompt only, as the SDKs
use it.

Stop sequences are applied by post-truncation, logprobs are null, as in
the JAX server.  A ``model`` other than the served id answers 404, as
the reference's ``_resolve_adapter`` does for a name that is neither the
base model nor an adapter (the port registers no adapters).  The
guided-decoding fields (``guided_choice``, ``guided_regex``,
``guided_json`` and a ``response_format`` other than
``{"type": "text"}``) answer 400 naming ROADMAP Queue 1 item 9, and
``GET /kv/blocks/{hash}`` answers 404 naming item 5b (the fabric's wire).

Auth: set ``api_token`` (env OPERATOR_TPU_API_TOKEN via the CLI) to
require ``Authorization: Bearer <token>``; ``/healthz`` stays open for
probes.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile
import time
import uuid
from typing import Any, Optional

from ..obs import current_trace_id, parse_traceparent
from .engine import ServingEngine
from .templates import template_for
from .types import GenerationResult, OversizedRequest, SamplingParams

log = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 16384
_MAX_BODY_BYTES = 10 << 20
_READ_TIMEOUT_S = 30.0

#: sentinel: the handler already wrote the (SSE) response to the socket
_STREAMED = object()

#: sentinel: the bounded pre-header peek in _stream expired before the
#: first engine update — commit the SSE headers and report in-stream
_PEEK_TIMED_OUT = object()


def _content_text(content: Any) -> str:
    """Flatten OpenAI message content: plain string or content-parts list
    (``[{"type": "text", "text": ...}, ...]``; non-text parts rejected)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        texts = []
        for part in content:
            if not isinstance(part, dict) or part.get("type") != "text" \
                    or not isinstance(part.get("text"), str):
                raise ValueError("only string or text content parts are supported")
            texts.append(part["text"])
        return "".join(texts)
    raise ValueError("message content must be a string or list of text parts")


def _flatten_messages(messages: list) -> list[dict]:
    """Validate + flatten content-parts; raises ValueError on bad shape."""
    flat = []
    for msg in messages:
        if not isinstance(msg, dict) or "content" not in msg:
            raise ValueError("each message needs 'role' and 'content'")
        flat.append({
            "role": msg.get("role", "user"),
            "content": _content_text(msg["content"]),
        })
    return flat


def _earliest_stop(text: str, stop: list[str]) -> Optional[int]:
    """Index of the earliest stop-sequence occurrence, or None."""
    cut = None
    for seq in stop:
        idx = text.find(seq)
        if idx >= 0 and (cut is None or idx < cut):
            cut = idx
    return cut


def _truncate_at_stop(
    result: GenerationResult, stop: list[str]
) -> tuple[str, str]:
    """Earliest stop-sequence occurrence wins; returns (text, finish_reason)."""
    cut = _earliest_stop(result.text, stop)
    if cut is not None:
        return result.text[:cut], "stop"
    return result.text, result.finish_reason


class ApiError(Exception):
    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


def _map_engine_error(exc: BaseException) -> Optional[ApiError]:
    """The admission-error contract, shared by the streaming and
    non-streaming paths so the same engine failure can never produce
    diverging responses: OversizedRequest (prompt needs more KV pages than
    the whole cache) is a CLIENT error -> 400; RuntimeError (engine
    closed/dead) -> 503.  Other engine-internal errors (including
    ValueError) deliberately stay 5xx via the generic handler."""
    if isinstance(exc, OversizedRequest):
        return ApiError(400, str(exc))
    if isinstance(exc, RuntimeError):
        return ApiError(503, f"engine unavailable: {exc}", "server_error")
    return None


class CompletionServer:
    """Serve the shared ``ServingEngine`` over the OpenAI wire format."""

    #: how long _stream holds back the status line waiting for the first
    #: engine update (which surfaces admission failures as clean 400/503s);
    #: generous enough for an idle engine's prefill compile-hit, short
    #: enough to stay under client/ingress response-header timeouts
    stream_peek_timeout_s = 1.0

    def __init__(
        self,
        engine: ServingEngine,
        *,
        model_id: str,
        host: str = "0.0.0.0",
        port: int = 8000,
        api_token: Optional[str] = None,
        max_tokens_cap: int = 2048,
        embedder: Optional[Any] = None,  # .embed(texts)->ndarray, .dim
        embedding_model_id: str = "log-embedder",
        analysis_backend: Optional[Any] = None,  # .generate(AnalysisRequest)
        tracer: Optional[Any] = None,  # obs.Tracer for inbound traceparent
        drain_grace_s: float = 30.0,  # OperatorConfig.serving_drain_grace_s
        replica_id: Optional[str] = None,
        profile_enabled: bool = False,
        profile_dir: Optional[str] = None,
    ) -> None:
        self.engine = engine
        self.model_id = model_id
        #: this replica's stable identity in the multi-engine data plane
        #: (``router/``): surfaced on GET /healthz next to the
        #: engine's load report so the failover router can poll one
        #: endpoint for liveness, identity, and shed feedback.  The
        #: deployment injects POD_NAME; "" falls back to hostname.
        if not replica_id:
            import socket

            replica_id = socket.gethostname()
        self.replica_id = replica_id
        #: wire parity with the reference's ai-interface contract
        #: (AIInterfaceRestClient.java:37-39): when a backend is wired,
        #: POST /api/v1/analysis/analyze serves AnalysisRequest->AIResponse
        #: verbatim, so tools written against the reference's service point
        #: here unchanged
        self.analysis_backend = analysis_backend
        self.host = host
        self.port = port
        self.api_token = api_token
        self.max_tokens_cap = max_tokens_cap
        self.embedder = embedder
        self.embedding_model_id = embedding_model_id
        #: inbound W3C traceparent support: a
        #: request carrying the header runs under a trace joining the
        #: caller's trace id, and its engine spans (queue wait vs
        #: prefill/decode) land in the flight recorder.  None = header
        #: accepted but ignored.
        self.tracer = tracer
        #: POST /profile gate (OperatorConfig.profile_enabled /
        #: PROFILE_ENABLED): off by default — a capture costs device
        #: attention and disk, and must be an explicit operator decision
        self.profile_enabled = profile_enabled
        self.profile_dir = profile_dir or os.path.join(
            tempfile.gettempdir(), "operator-tpu-torch-profile"
        )
        self._profiling = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = time.time()
        # graceful drain: stop() closes the listener
        # (no new connections), then waits for in-flight handlers — their
        # active engine waves complete — up to this grace before returning
        self.drain_grace_s = drain_grace_s
        self._active_handlers = 0
        self._drained = asyncio.Event()
        self._drained.set()

    @property
    def bound_port(self) -> Optional[int]:
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self.engine.start()
        # limit= makes readuntil overrun (-> 431) at exactly the header
        # budget instead of the 64 KiB StreamReader default; readexactly
        # for bodies is unaffected by the buffer limit
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=_MAX_HEADER_BYTES
        )
        log.info("completion api listening on %s:%s", self.host, self.bound_port)

    async def stop(self) -> None:
        """Graceful: stop ACCEPTING first, then let in-flight requests —
        and the engine waves they are riding — complete within the drain
        grace.  Requests still running at the boundary are abandoned to
        the engine close that follows (operator/app.py stop ordering)."""
        # swap-then-act: detach the listener before awaiting so a concurrent
        # stop() can't close the same server twice across the suspension
        server, self._server = self._server, None
        if server is not None:
            server.close()
            try:
                # 3.12.1+ wait_closed() ALSO waits for every connection
                # handler — unbounded, a wedged streaming handler would
                # hold shutdown here forever.  close() has already stopped
                # the listener; the _drained wait below is the real
                # (grace-bounded) drain, so bound this to a beat.
                await asyncio.wait_for(server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
        if self._active_handlers:
            try:
                await asyncio.wait_for(
                    self._drained.wait(), timeout=self.drain_grace_s
                )
            except asyncio.TimeoutError:
                log.warning(
                    "%d request(s) still in flight after the %.0fs drain "
                    "grace; closing under them",
                    self._active_handlers, self.drain_grace_s,
                )

    # -- http plumbing ------------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._active_handlers += 1
        self._drained.clear()
        try:
            await self._handle_inner(reader, writer)
        finally:
            self._active_handlers -= 1
            if self._active_handlers == 0:
                self._drained.set()

    async def _handle_inner(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        status, payload = 500, {"error": {"message": "internal error"}}
        accept = ""
        try:
            method, path, headers, body = await self._read_request(reader)
            accept = headers.get("accept", "")
            auth_exempt = path.split("?", 1)[0] == "/healthz"
            if not auth_exempt:  # probes can't carry tokens
                self._check_auth(headers)
            remote = parse_traceparent(headers.get("traceparent"))
            if remote is not None and auth_exempt and self.api_token:
                # recording a trace consumes bounded flight-recorder ring
                # slots; on a token-secured server the auth-exempt probe
                # path must not let unauthenticated clients mint them
                remote = None
            # join the caller's distributed trace when one was offered:
            # the serving-side spans (engine queue wait vs prefill/decode)
            # record under THEIR trace id, inspectable via /traces
            if remote is not None and self.tracer is not None:
                trace_ctx = self.tracer.trace(
                    f"http {path.split('?', 1)[0]}",
                    trace_id=remote[0], parent_id=remote[1],
                    attributes={"path": path.split("?", 1)[0]},
                )
            else:
                import contextlib

                trace_ctx = contextlib.nullcontext()
            with trace_ctx:
                status, payload = await self._route(
                    method, path, body, writer, accept=accept, reader=reader
                )
        except ApiError as exc:
            status = exc.status
            payload = {"error": {"message": str(exc), "type": exc.err_type, "code": None}}
        except asyncio.TimeoutError:
            status = 408
            payload = {"error": {"message": "request read timed out",
                                 "type": "invalid_request_error", "code": None}}
        except (asyncio.IncompleteReadError, ConnectionResetError):
            # TCP health probes / port scans connect and hang up without a
            # full request — a normal disconnect, not an error to log
            writer.close()
            return
        except asyncio.CancelledError:
            # engine shutdown resolves in-flight futures with CancelledError
            # (BaseException: would otherwise skip the response entirely and
            # strand the client); the handler task itself is not cancelled
            # by server.close(), so answering 503 here is always safe
            status = 503
            payload = {"error": {"message": "server shutting down",
                                 "type": "server_error", "code": None}}
        except Exception:  # noqa: BLE001 - never leak a traceback to the wire
            log.exception("completion api request failed")
        if payload is _STREAMED:  # response already written chunk by chunk
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
            return
        try:
            if isinstance(payload, bytes):  # /metrics Prometheus exposition
                data = payload
                ctype = (
                    "application/openmetrics-text; version=1.0.0; charset=utf-8"
                    if "application/openmetrics-text" in accept
                    else "text/plain; version=0.0.4"
                )
            else:
                data, ctype = json.dumps(payload).encode(), "application/json"
            writer.write(
                f"HTTP/1.1 {status} {'OK' if status < 400 else 'Error'}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n"
                f"Connection: close\r\n\r\n".encode() + data
            )
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), timeout=_READ_TIMEOUT_S
            )
        except asyncio.LimitOverrunError:
            # separator not found within the StreamReader buffer limit —
            # oversized headers are a 431, not an internal error
            raise ApiError(431, "headers too large") from None
        if len(head) > _MAX_HEADER_BYTES:
            raise ApiError(431, "headers too large")
        request_line, *header_lines = head.decode("latin-1").split("\r\n")
        parts = request_line.split()
        if len(parts) != 3:
            raise ApiError(400, "malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        for line in header_lines:
            if ":" in line:
                key, value = line.split(":", 1)
                headers[key.strip().lower()] = value.strip()
        body = b""
        length = int(headers.get("content-length", "0") or "0")
        if length > _MAX_BODY_BYTES:
            raise ApiError(413, "request body too large")
        if length:
            body = await asyncio.wait_for(
                reader.readexactly(length), timeout=_READ_TIMEOUT_S
            )
        return method, path, headers, body

    def _check_auth(self, headers: dict) -> None:
        if not self.api_token:
            return
        import hmac

        supplied = headers.get("authorization", "")
        if not hmac.compare_digest(supplied, f"Bearer {self.api_token}"):
            raise ApiError(401, "missing or invalid bearer token", "authentication_error")

    # -- routing ------------------------------------------------------------

    async def _route(self, method: str, path: str, body: bytes, writer, *,
                     accept: str = "", reader=None):
        import urllib.parse

        path, _, raw_query = path.partition("?")
        query = urllib.parse.parse_qs(raw_query)
        if method == "GET" and path == "/healthz":
            # identity + load report for the data-plane router
            # (``router/``): one poll answers liveness, WHO this
            # replica is, and how loaded it is — queue depth and the
            # admission roofline's per-token estimate feed the router's
            # shed decision, gaveUp excludes a supervisor-bricked engine
            load = self.engine.load_report()
            return 200, {
                "status": "degraded" if load.gave_up else "ok",
                "uptime_s": round(time.time() - self._started, 1),
                "replica": self.replica_id,
                "load": load.to_dict(),
            }
        if method == "GET" and path == "/metrics.json":
            # per-stage latency percentiles (prefill, decode_step, ...) from
            # the engine's registry — the operator endpoint's twin for the
            # standalone server
            return 200, self.engine.generator.metrics.snapshot()
        if method == "GET" and path == "/metrics":
            # exemplars only under OpenMetrics negotiation (a mid-line '#'
            # breaks the classic text 0.0.4 parser outright)
            return 200, self.engine.generator.metrics.prometheus(
                openmetrics="application/openmetrics-text" in accept
            ).encode()
        if method == "GET" and path == "/v1/models":
            models = [{
                "id": self.model_id,
                "object": "model",
                "created": int(self._started),
                "owned_by": "operator-tpu",
            }]
            if self.embedder is not None:
                models.append({
                    "id": self.embedding_model_id,
                    "object": "model",
                    "created": int(self._started),
                    "owned_by": "operator-tpu",
                })
            return 200, {"object": "list", "data": models}
        if method == "POST" and path == "/profile":
            return await self._profile(query)
        if method == "POST" and path == "/api/v1/analysis/analyze":
            return await self._analyze(self._parse_json(body))
        if method == "POST" and path == "/v1/embeddings":
            return await self._embeddings(self._parse_json(body))
        if method == "POST" and path == "/v1/completions":
            return await self._completions(
                self._parse_json(body), chat=False, writer=writer, reader=reader
            )
        if method == "POST" and path == "/v1/chat/completions":
            return await self._completions(
                self._parse_json(body), chat=True, writer=writer, reader=reader
            )
        if method == "GET" and path.startswith("/kv/blocks/"):
            return self._kv_block(path)
        raise ApiError(404, f"no route for {method} {path}")

    @staticmethod
    def _kv_block(path: str):
        """The fleet KV fabric's peer endpoint needs the PMKV1 wire
        (``fabric/wire.py``) and ``ServingEngine.kv_block_bytes``: not
        ported yet."""
        raise ApiError(
            404,
            f"{path}: the KV fabric's /kv/blocks endpoint is not ported to "
            "operator_tpu_torch yet (ROADMAP.md Queue 1 item 5b)",
        )

    @staticmethod
    def _parse_json(body: bytes) -> dict:
        try:
            parsed = json.loads(body or b"null")
        except json.JSONDecodeError as exc:
            raise ApiError(400, f"body is not valid JSON: {exc}") from None
        if not isinstance(parsed, dict):
            raise ApiError(400, "body must be a JSON object")
        return parsed

    # -- completion handling -------------------------------------------------

    def _resolve_model(self, req: dict) -> None:
        """The served id (or no ``model``) serves; anything else is a 404
        — the port has no adapters to select."""
        model = req.get("model")
        if model is not None and model != self.model_id:
            raise ApiError(
                404, f"model {model!r} not found; available: {[self.model_id]}",
            )

    @staticmethod
    def _refuse_guided(req: dict) -> None:
        """Guided decoding is not ported: refuse its fields rather than
        answer with unconstrained text."""
        fields = [
            name for name in ("guided_choice", "guided_regex", "guided_json")
            if req.get(name) is not None
        ]
        response_format = req.get("response_format")
        if response_format is not None and not (
            isinstance(response_format, dict) and response_format.get("type") in (None, "text")
        ):
            fields.append("response_format")
        if fields:
            raise ApiError(
                400,
                f"{', '.join(fields)}: guided decoding is not ported to "
                f"operator_tpu_torch yet (ROADMAP.md Queue 1 item 9)",
            )

    async def _sampling(self, req: dict) -> tuple[SamplingParams, list[str]]:
        self._resolve_model(req)
        self._refuse_guided(req)
        max_tokens = req.get("max_tokens", 256)
        if not isinstance(max_tokens, int) or max_tokens < 1:
            raise ApiError(400, "max_tokens must be a positive integer")
        max_tokens = min(max_tokens, self.max_tokens_cap)
        temperature = req.get("temperature", 0.3)
        top_p = req.get("top_p", 0.95)
        for name, value in (("temperature", temperature), ("top_p", top_p)):
            if not isinstance(value, (int, float)) or value < 0:
                raise ApiError(400, f"{name} must be a non-negative number")
        stop = req.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
            raise ApiError(400, "stop must be a string or list of strings")
        params = SamplingParams(
            max_tokens=max_tokens, temperature=float(temperature),
            top_p=float(top_p),
            # a traceparent-carrying request's trace id rides into the
            # engine's profiler annotations (None outside a trace)
            trace_tag=current_trace_id(),
        )
        return params, stop

    async def _completions(self, req: dict, *, chat: bool, writer=None, reader=None):
        params, stop = await self._sampling(req)
        n = req.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 16:
            raise ApiError(400, "n must be an integer in [1, 16]")

        if chat:
            messages = req.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ApiError(400, "messages must be a non-empty list")
            try:
                # the loaded model family's published conversation format —
                # instruct checkpoints degrade badly on anything else
                prompts = [template_for(self.model_id)(_flatten_messages(messages))]
            except ValueError as exc:
                raise ApiError(400, str(exc)) from None
        else:
            prompt = req.get("prompt")
            if isinstance(prompt, str):
                prompts = [prompt]
            elif isinstance(prompt, list) and prompt and all(
                isinstance(p, str) for p in prompt
            ):
                prompts = prompt
            else:
                raise ApiError(400, "prompt must be a string or non-empty list of strings")

        if req.get("stream"):
            if n != 1 or len(prompts) != 1:
                raise ApiError(400, "stream=true requires n=1 and a single prompt")
            await self._stream(
                writer, prompts[0], params, stop, req, chat=chat, reader=reader
            )
            return 200, _STREAMED

        # every replica of every prompt joins the shared continuous batch
        jobs = [p for p in prompts for _ in range(n)]
        tasks = [
            asyncio.ensure_future(self.engine.generate(p, params)) for p in jobs
        ]
        try:
            results = await asyncio.gather(*tasks)
        except BaseException as exc:
            # one failed job must not leave its siblings decoding on the
            # shared engine after the response went out — cancellation
            # triggers the engine's slot/page reclamation.  EVERY sibling
            # is then AWAITED (the loop never exits early): a task that
            # already failed holds an unretrieved exception ("Task
            # exception was never retrieved" log noise at GC), and a
            # cancelled one finishes its engine-side cleanup only when
            # awaited — both must resolve before the error response is
            # written
            for task in tasks:
                if not task.done():
                    task.cancel()
            handler_cancelled = False
            for task in tasks:
                try:
                    await task
                except asyncio.CancelledError:
                    # the cancellation is OURS when it was delivered while
                    # the sibling was still running, or injected into this
                    # handler (teardown) while awaiting an already-
                    # cancelled sibling — task.cancelled() alone cannot
                    # tell the latter apart, .cancelling() (3.11+; absent
                    # on 3.10, where that rarer case is missed) can.
                    # Remember it and KEEP draining: later siblings still
                    # need their exceptions retrieved and cleanup awaited
                    current = asyncio.current_task()
                    cancelling = getattr(current, "cancelling", None)
                    if not task.cancelled() or (
                        cancelling is not None and cancelling()
                    ):
                        handler_cancelled = True
                except Exception as sibling:
                    # retrieved (silencing the GC "never retrieved" noise),
                    # but a DISTINCT internal failure co-occurring with the
                    # mapped one must still leave a trace in the logs
                    if sibling is not exc:
                        log.warning("sibling generation also failed: %r", sibling)
            if handler_cancelled:
                raise asyncio.CancelledError from None
            mapped = _map_engine_error(exc)
            if mapped is not None:
                raise mapped from None
            raise

        choices = []
        usage_prompt = usage_completion = 0
        for index, result in enumerate(results):
            text, finish = _truncate_at_stop(result, stop)
            usage_prompt += result.prompt_tokens
            usage_completion += result.completion_tokens
            if chat:
                choices.append({
                    "index": index,
                    "message": {"role": "assistant", "content": text},
                    "logprobs": None,
                    "finish_reason": finish,
                })
            else:
                choices.append({
                    "index": index,
                    "text": text,
                    "logprobs": None,
                    "finish_reason": finish,
                })
        kind = "chat.completion" if chat else "text_completion"
        prefix = "chatcmpl" if chat else "cmpl"
        return 200, {
            "id": f"{prefix}-{uuid.uuid4().hex[:24]}",
            "object": kind,
            "created": int(time.time()),
            "model": req.get("model") or self.model_id,
            "choices": choices,
            "usage": {
                "prompt_tokens": usage_prompt,
                "completion_tokens": usage_completion,
                "total_tokens": usage_prompt + usage_completion,
            },
        }


    # -- on-demand profiler capture ------------------------------------------

    async def _profile(self, query: dict):
        """Capture ``seconds`` of ``torch.profiler`` trace (CPU, plus CUDA
        activity when the engine runs on the card) into a fresh directory
        under ``profile_dir`` as a Chrome trace, and return its path.  The
        serving loop keeps running — the point is to catch the LIVE
        workload's steps.  One capture at a time (409)."""
        if not self.profile_enabled:
            raise ApiError(
                404, "profiling disabled (enable with PROFILE_ENABLED=1)"
            )
        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except ValueError:
            raise ApiError(400, "seconds must be a number") from None
        # clamp: long captures produce huge traces and hold the profiler
        # hostage; 0 would stop before the first step lands
        seconds = min(max(seconds, 0.1), 60.0)
        if self._profiling:
            raise ApiError(409, "a profile capture is already running")
        out_dir = os.path.join(
            self.profile_dir, f"profile-{int(time.time() * 1e3)}"
        )
        self._profiling = True
        try:
            # start, wait and stop on one worker thread: the capture's
            # control calls block, and the event loop must keep serving
            await asyncio.to_thread(self._capture, out_dir, seconds)
        finally:
            self._profiling = False
        return 200, {
            "object": "profile",
            "artifact": out_dir,
            "seconds": seconds,
            "replica": self.replica_id,
        }

    def _capture(self, out_dir: str, seconds: float) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.generator.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))

    # -- reference ai-interface contract -------------------------------------

    async def _analyze(self, req: dict) -> dict:
        """The reference's ai-interface route, byte-compatible: POST an
        AnalysisRequest (AnalysisResult + AIProviderConfig [+ failure
        data]), get an AIResponse back (reference
        AIInterfaceRestClient.java:37-39, AIInterfaceClient.java:45-59).
        Tools written against the reference's service point here
        unchanged; the compute is the in-process engine instead of an
        external LLM API."""
        if self.analysis_backend is None:
            raise ApiError(
                404,
                "analysis backend not wired (operator mode serves it; "
                "see CompletionServer(analysis_backend=...))",
            )
        from ..schema.analysis import AnalysisRequest

        try:
            request = AnalysisRequest.parse(req)
        except Exception as exc:  # noqa: BLE001 - schema violation -> client error
            raise ApiError(400, f"not an AnalysisRequest: {exc}") from None
        response = await self.analysis_backend.generate(request)
        return 200, response.to_dict()

    # -- embeddings ----------------------------------------------------------

    async def _embeddings(self, req: dict):
        if self.embedder is None:
            raise ApiError(404, "no embedding model is configured")
        texts = req.get("input")
        if isinstance(texts, str):
            texts = [texts]
        if (
            not isinstance(texts, list)
            or not texts
            or not all(isinstance(t, str) for t in texts)
            or len(texts) > 256
        ):
            raise ApiError(
                400, "input must be a string or list of <=256 strings"
            )
        loop = asyncio.get_running_loop()
        # neural embedders run the encoder; keep the event loop responsive
        vectors = await loop.run_in_executor(None, self.embedder.embed, texts)
        return 200, {
            "object": "list",
            "model": req.get("model") or self.embedding_model_id,
            "data": [
                {
                    "object": "embedding",
                    "index": i,
                    "embedding": [float(x) for x in row],
                }
                for i, row in enumerate(vectors)
            ],
            "usage": {
                "prompt_tokens": sum(len(t.split()) for t in texts),
                "total_tokens": sum(len(t.split()) for t in texts),
            },
        }

    # -- streaming -----------------------------------------------------------

    async def _stream(
        self,
        writer: asyncio.StreamWriter,
        prompt: str,
        params: SamplingParams,
        stop: list[str],
        req: dict,
        *,
        chat: bool,
        reader: Optional[asyncio.StreamReader] = None,
    ) -> None:
        """Write one SSE chunk per decode block, then [DONE] and close.

        Emission holds back an unstable tail so what is sent is never
        retracted: trailing U+FFFD (an incomplete UTF-8 sequence mid-block
        decodes to a replacement char that a later block may *replace* with
        the real character) and ``max(len(stop))-1`` chars (a stop sequence
        may span a block boundary; the non-streaming truncation must never
        cut below already-sent text).  Engine failures after the SSE
        headers surface as an OpenAI-style ``{"error": ...}`` event — a
        second HTTP response can never be written into an open stream.
        """
        tokenizer = self.engine.generator.tokenizer
        updates: asyncio.Queue = asyncio.Queue()
        job = asyncio.ensure_future(
            self.engine.generate(prompt, params, on_partial=updates.put_nowait)
        )

        def _on_done(t: asyncio.Task) -> None:
            if not t.cancelled():
                t.exception()  # mark retrieved: the early-exit paths
                # (peek cancellation, client OSError, finally-cancel) never
                # await the job, and an unretrieved failure would log GC
                # "Task exception was never retrieved" noise
            updates.put_nowait(None)  # wake the loop

        job.add_done_callback(_on_done)

        # the client closing its socket ends the stream at once: EOF on
        # the request side cancels the generation, so its row and pages
        # return at the engine's next step instead of after the next
        # chunk write fails (close-delimited HTTP: nothing else arrives)
        client_gone = False

        def _on_eof(t: asyncio.Task) -> None:
            nonlocal client_gone
            if t.cancelled():
                return
            if t.exception() is not None or t.result() == b"":
                client_gone = True
                job.cancel()

        eof_watch = None
        if reader is not None:
            eof_watch = asyncio.ensure_future(reader.read(1))
            eof_watch.add_done_callback(_on_eof)

        ident = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = req.get("model") or self.model_id
        kind = "chat.completion.chunk" if chat else "text_completion"
        stop_holdback = max((len(s) for s in stop), default=0)
        stop_holdback = stop_holdback - 1 if stop_holdback else 0

        def chunk(delta_text: Optional[str], finish: Optional[str]) -> bytes:
            if chat:
                delta: dict = {}
                if delta_text is not None:
                    delta = {"role": "assistant", "content": delta_text}
                choice = {"index": 0, "delta": delta, "finish_reason": finish}
            else:
                choice = {"index": 0, "text": delta_text or "",
                          "logprobs": None, "finish_reason": finish}
            event = {"id": ident, "object": kind, "created": created,
                     "model": model, "choices": [choice]}
            return f"data: {json.dumps(event)}\n\n".encode()

        def stable_prefix(text: str) -> str:
            """Strip the tail that a later block might rewrite."""
            end = len(text)
            while end > 0 and text[end - 1] == "�":
                end -= 1  # incomplete multi-byte sequence still in flight
            return text[: max(0, end - stop_holdback)]

        # peek at the FIRST engine update before committing to the 200/SSE
        # headers: admission-time failures (OversizedRequest, engine down)
        # resolve the job before any partial arrives, and they must surface
        # as the same 400/503 the non-streaming path returns — not as a 200
        # with an in-stream error event.  The peek is BOUNDED: a healthy
        # request queued behind a long prefill may take many seconds to its
        # first block, and holding back the status line that long would trip
        # client/ingress response-header timeouts — on timeout, commit the
        # headers and fall back to in-stream error reporting (the pre-fix
        # behavior), keeping the 400 mapping for the fast failure case
        try:
            first = await asyncio.wait_for(
                updates.get(), self.stream_peek_timeout_s
            )
        except asyncio.TimeoutError:
            first = _PEEK_TIMED_OUT
        except BaseException:
            job.cancel()
            raise
        if first is None and job.done():
            try:
                job.result()
            except asyncio.CancelledError:
                raise ApiError(503, "server shutting down", "server_error") from None
            except BaseException as exc:
                mapped = _map_engine_error(exc)
                if mapped is not None:
                    raise mapped from None
                raise
            # success with no partials (or an unexpected failure -> the
            # outer 500 mapping, matching non-streaming): fall through and
            # emit the final text below

        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        sent_text = ""
        stopped = False
        try:
            await writer.drain()
            token_ids = (
                await updates.get() if first is _PEEK_TIMED_OUT else first
            )
            while token_ids is not None:
                if stopped:
                    token_ids = await updates.get()
                    continue  # drain remaining deltas past a stop match
                text = tokenizer.decode(token_ids)
                cut = _earliest_stop(text, stop)
                if cut is not None:
                    text, stopped = text[:cut], True
                else:
                    text = stable_prefix(text)
                if len(text) > len(sent_text) and text.startswith(sent_text):
                    writer.write(chunk(text[len(sent_text):], None))
                    await writer.drain()
                    sent_text = text
                token_ids = await updates.get()
            try:
                result = await job
            except asyncio.CancelledError:
                if not job.done():
                    raise  # this handler task was cancelled, not the engine
                if client_gone:
                    return  # nobody is listening
                # engine shutdown resolved the future with CancelledError
                writer.write(
                    b'data: {"error": {"message": "server shutting down", '
                    b'"type": "server_error", "code": null}}\n\n'
                    b"data: [DONE]\n\n"
                )
                await writer.drain()
                return
            except Exception as exc:  # engine failure mid-stream
                log.exception("stream generation failed")
                event = {"error": {"message": str(exc) or type(exc).__name__,
                                   "type": "server_error", "code": None}}
                writer.write(
                    f"data: {json.dumps(event)}\n\ndata: [DONE]\n\n".encode()
                )
                await writer.drain()
                return
            text, finish = _truncate_at_stop(result, stop)
            if len(text) > len(sent_text) and text.startswith(sent_text):
                writer.write(chunk(text[len(sent_text):], None))
            writer.write(chunk(None, "stop" if stopped else finish))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except OSError:  # client went away mid-stream (reset/abort/pipe)
            job.cancel()
        finally:
            if not job.done():
                job.cancel()
            if eof_watch is not None:
                eof_watch.cancel()


async def serve_forever(
    engine: ServingEngine,
    *,
    model_id: str,
    host: str = "0.0.0.0",
    port: int = 8000,
    api_token: Optional[str] = None,
    embedder: Optional[Any] = None,
    analysis_backend: Optional[Any] = None,
    replica_id: Optional[str] = None,
    profile_enabled: bool = False,
    profile_dir: Optional[str] = None,
) -> None:
    """Run the completion API until cancelled (SIGINT/SIGTERM via CLI)."""
    server = CompletionServer(
        engine, model_id=model_id, host=host, port=port, api_token=api_token,
        embedder=embedder, analysis_backend=analysis_backend,
        replica_id=replica_id, profile_enabled=profile_enabled,
        profile_dir=profile_dir,
    )
    await server.start()
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop()
        await asyncio.to_thread(engine.close)
