"""OpenAI-compatible HTTP front for the port's serving engine.

A subset of ``operator_tpu/serving/httpserver.py`` in its wire format:

- ``GET  /healthz``         — liveness, this replica's identity and its
  load report (``status``, ``uptime_s``, ``replica``, ``load``)
- ``POST /v1/completions``  — prompt (str or list), n, max_tokens,
  temperature, top_p, stop; every prompt and replica joins the shared
  continuous batch.  Non-streaming only: ``stream: true`` is refused.
  A ``model`` other than the served id answers 404, as the reference's
  ``_resolve_adapter`` does for a name that is neither the base model nor
  an adapter (the port registers no adapters).  The guided-decoding
  fields (``guided_choice``, ``guided_regex``, ``guided_json`` and a
  ``response_format`` other than ``{"type": "text"}``) answer 400 naming
  ROADMAP Queue 1 item 9 until guided decoding is ported.

Stop sequences are applied by post-truncation, logprobs are null, as in
the JAX server.  The server is the standard library's threading HTTP
server: each request's handler thread submits to the engine and waits on
its futures; the engine's one worker thread does all device work.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .engine import ServingEngine
from .types import GenerationResult, OversizedRequest, SamplingParams

log = logging.getLogger(__name__)

__all__ = ["CompletionServer"]

_MAX_BODY_BYTES = 10 << 20


class ApiError(Exception):
    def __init__(self, status: int, message: str, err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type


def _truncate_at_stop(result: GenerationResult, stop: list[str]) -> tuple[str, str]:
    """Earliest stop-sequence occurrence wins; returns (text, finish_reason)."""
    cut = None
    for seq in stop:
        idx = result.text.find(seq)
        if idx >= 0 and (cut is None or idx < cut):
            cut = idx
    if cut is not None:
        return result.text[:cut], "stop"
    return result.text, result.finish_reason


class CompletionServer:
    """Serve one ``ServingEngine`` over the OpenAI completions wire format."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        model_id: str,
        host: str = "0.0.0.0",
        port: int = 8000,
        max_tokens_cap: int = 2048,
        replica_id: Optional[str] = None,
    ) -> None:
        self.engine = engine
        self.model_id = model_id
        self.max_tokens_cap = max_tokens_cap
        self.replica_id = replica_id or socket.gethostname()
        self._started = time.time()
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def bound_port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self.engine.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="completion-api", daemon=True
        )
        self._thread.start()
        log.info("completion api listening on port %s", self.bound_port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(10.0)

    # -- routes ----------------------------------------------------------

    def _healthz(self) -> dict:
        load = self.engine.load_report()
        return {
            "status": "degraded" if load["gaveUp"] else "ok",
            "uptime_s": round(time.time() - self._started, 1),
            "replica": self.replica_id,
            "load": load,
        }

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

    def _sampling(self, req: dict) -> tuple[SamplingParams, list[str]]:
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
            max_tokens=max_tokens, temperature=float(temperature), top_p=float(top_p),
        )
        return params, stop

    def _completions(self, req: dict) -> dict:
        params, stop = self._sampling(req)
        n = req.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 16:
            raise ApiError(400, "n must be an integer in [1, 16]")
        if req.get("stream"):
            raise ApiError(400, "stream=true is not supported by this server")
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            prompts = [prompt]
        elif isinstance(prompt, list) and prompt and all(isinstance(p, str) for p in prompt):
            prompts = prompt
        else:
            raise ApiError(400, "prompt must be a string or non-empty list of strings")
        try:
            futures = [
                self.engine.submit(p, params) for p in prompts for _ in range(n)
            ]
            results = [future.result() for future in futures]
        except OversizedRequest as exc:
            raise ApiError(400, str(exc)) from None
        except RuntimeError as exc:
            raise ApiError(503, f"engine unavailable: {exc}", "server_error") from None
        choices = []
        usage_prompt = usage_completion = 0
        for index, result in enumerate(results):
            text, finish = _truncate_at_stop(result, stop)
            usage_prompt += result.prompt_tokens
            usage_completion += result.completion_tokens
            choices.append({
                "index": index,
                "text": text,
                "logprobs": None,
                "finish_reason": finish,
            })
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_id,
            "choices": choices,
            "usage": {
                "prompt_tokens": usage_prompt,
                "completion_tokens": usage_completion,
                "total_tokens": usage_prompt + usage_completion,
            },
        }

    def _route(self, method: str, path: str, body: bytes) -> tuple[int, Any]:
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/healthz":
            return 200, self._healthz()
        if method == "POST" and path == "/v1/completions":
            try:
                req = json.loads(body or b"null")
            except json.JSONDecodeError as exc:
                raise ApiError(400, f"body is not valid JSON: {exc}") from None
            if not isinstance(req, dict):
                raise ApiError(400, "body must be a JSON object")
            return 200, self._completions(req)
        raise ApiError(404, f"no route for {method} {path}")

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self, method: str) -> None:
                status, payload = 500, {"error": {"message": "internal error"}}
                try:
                    length = int(self.headers.get("content-length") or 0)
                    if length > _MAX_BODY_BYTES:
                        raise ApiError(413, "request body too large")
                    body = self.rfile.read(length) if length else b""
                    status, payload = server._route(method, self.path, body)
                except ApiError as exc:
                    status = exc.status
                    payload = {"error": {
                        "message": str(exc), "type": exc.err_type, "code": None,
                    }}
                except Exception:  # noqa: BLE001 - never leak a traceback to the wire
                    log.exception("completion api request failed")
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)
                self.close_connection = True

            def do_GET(self) -> None:  # noqa: N802 - http.server's naming
                self._serve("GET")

            def do_POST(self) -> None:  # noqa: N802 - http.server's naming
                self._serve("POST")

            def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
                log.debug("%s " + format, self.address_string(), *args)

        return Handler
