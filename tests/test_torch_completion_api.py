"""The port's ``CompletionServer`` against the JAX package's, over the wire.

Both servers run on one event loop at ``tiny-test`` over the same f32
weights (the JAX ``init_params`` bridged through numpy), each with its
own package's ``HashingEmbedder(dim=64)`` and ``TPUNativeProvider`` as
the analysis backend, as ``tests/test_completion_api.py`` runs the JAX
server.  The same requests go to both; the bodies must be equal after
the per-response ``id`` and ``created`` are blanked:

- completions, chat and content parts, fan-out, stop sequences (one that
  spans decode blocks too), the guided fields (served on the wave
  engine, refused by the continuous scheduler) and the error surface;
- ``stream: true``: the SSE chunk texts, chunk for chunk, on the
  continuous scheduler and on the wave engine; fan-out refused in a
  stream; an oversized request answered 400 before the headers;
- auth, ``/v1/models``, ``/metrics``, ``/metrics.json`` and
  ``/v1/embeddings``;
- the reference's analyze route: the contract, auth and a malformed body;
- ``/healthz``: the ``load`` report has the JAX server's keys and, apart
  from wall-clock readings, its values.

Also: ``resume_tokens`` continue as in the JAX engine (continuous mode;
the wave engine refuses them in both).  The port alone: a client that
disconnects mid-stream releases its row and pages on both loops; a
closed engine answers "server shutting down" to a plain request and in a
stream; ``/kv/blocks`` serves a mirrored block; ``/profile`` captures a
``torch.profiler`` trace.  Every network call has its own timeout.
"""

import asyncio
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.patterns.engine import PatternEngine as JaxPatternEngine  # noqa: E402
from operator_tpu.patterns.semantic import HashingEmbedder as JaxHashingEmbedder  # noqa: E402
from operator_tpu.schema import analysis as jax_analysis  # noqa: E402
from operator_tpu.serving import kvstore as jax_kvstore  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from operator_tpu.serving.httpserver import CompletionServer as JaxCompletionServer  # noqa: E402
from operator_tpu.serving.provider import TPUNativeProvider as JaxProvider  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.patterns.semantic import HashingEmbedder  # noqa: E402
from operator_tpu_torch.serving import kvstore  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.provider import TPUNativeProvider  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402
from test_torch_engine import event_loop_thread  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TOKEN = "sekrit"
#: every network call's own bound: a hung stream fails, never holds the suite
TIMEOUT_S = 60.0
SHAPE = dict(max_slots=4, max_seq=128, page_size=16)
#: load-report keys that are wall-clock readings (rates and shares of time)
WALL_CLOCK = {"decodeTokenS", "decodeMfu", "hostGapFrac", "goodput"}


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _jax_engine(params, mode, *, store, **shape):
    generator = BatchedGenerator(
        params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True, cache_dtype=jnp.float32,
        metrics=JaxMetricsRegistry(), decode_block=2 if mode == "wave" else 1,
        pipeline_depth=2 if mode == "wave" else 1, **{**SHAPE, **shape},
    )
    sched = None
    if mode == "continuous":
        st = jax_kvstore.PrefixKVStore(generator.page_size, metrics=generator.metrics) \
            if store else None
        sched = JaxScheduler(generator, chunk=16, token_budget=32, pipeline_depth=2,
                             kvstore=st)
    return JaxServingEngine(generator, admission_wait_s=0.005, scheduler=sched)


def _port_engine(params, mode, *, store, **shape):
    generator = Generator(
        params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32, device="cpu",
        metrics=MetricsRegistry(), decode_block=2 if mode == "wave" else 1,
        pipeline_depth=2 if mode == "wave" else 1, **{**SHAPE, **shape},
    )
    sched = None
    if mode == "continuous":
        st = kvstore.PrefixKVStore(generator.page_size, metrics=generator.metrics) \
            if store else None
        sched = Scheduler(generator, chunk=16, token_budget=32, pipeline_depth=2,
                          kvstore=st)
    return ServingEngine(generator, sched, admission_wait_s=0.005)


def _server(cls, engine, provider_cls, embedder, **kw):
    return cls(engine, model_id="tiny-test", host="127.0.0.1", port=0, api_token=TOKEN,
               embedder=embedder,
               analysis_backend=provider_cls(engine, model_id="tiny-test",
                                             register_template_prefixes=False), **kw)


class _Pair:
    """Both packages' engines and servers, started on one loop thread."""

    def __init__(self, jax_params, torch_params, mode, *, store=True, **shape):
        self.mode = mode
        self._cm = event_loop_thread()
        self.run = self._cm.__enter__()

        async def start():
            jax_engine = _jax_engine(jax_params, mode, store=store, **shape)
            port_engine = _port_engine(torch_params, mode, store=store, **shape)
            self.servers = {
                "jax": _server(JaxCompletionServer, jax_engine, JaxProvider,
                               JaxHashingEmbedder(dim=64)),
                "port": _server(CompletionServer, port_engine, TPUNativeProvider,
                                HashingEmbedder(dim=64)),
            }
            for server in self.servers.values():
                await server.start()

        self.run(start())
        self.ports = {name: s.bound_port for name, s in self.servers.items()}

    @property
    def port_engine(self):
        return self.servers["port"].engine

    def close(self):
        async def stop():
            for server in self.servers.values():
                await server.stop()
            await self.servers["jax"].engine.close()

        try:
            self.run(stop())
        finally:
            self.port_engine.close()
            self._cm.__exit__(None, None, None)

    def both(self, method, path, body=None, **kw):
        return {name: call(port, method, path, body, **kw) for name, port in self.ports.items()}


@pytest.fixture(scope="module", params=["continuous", "wave"])
def pair(request, jax_params, torch_params):
    pair = _Pair(jax_params, torch_params, request.param)
    yield pair
    pair.close()


async def _exchange(port, method, path, body, token, raw_body, headers):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = raw_body if raw_body is not None else (
        json.dumps(body).encode() if body is not None else b""
    )
    lines = [f"{method} {path} HTTP/1.1", "Host: t"]
    if token is not None:
        lines.append(f"Authorization: Bearer {token}")
    lines.extend(f"{k}: {v}" for k, v in (headers or {}).items())
    if payload:
        lines.append(f"Content-Length: {len(payload)}")
    writer.write("\r\n".join(lines).encode() + b"\r\n\r\n" + payload)
    await writer.drain()
    response = await reader.read()
    writer.close()
    return response


def call(port, method, path, body=None, *, token=TOKEN, raw_body=None, headers=None):
    """Plain-socket HTTP exchange (close-delimited); returns (status,
    headers text, body bytes)."""
    raw = asyncio.run(asyncio.wait_for(
        _exchange(port, method, path, body, token, raw_body, headers), TIMEOUT_S))
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head.decode("latin-1"), data


def _json(data):
    body = json.loads(data)
    if isinstance(body, dict):
        for key in ("id", "created"):
            if key in body:
                body[key] = "<ignored>"
    return body


def _events(data):
    """The SSE payloads of a stream body, ids and timestamps blanked."""
    events = []
    for line in data.decode().split("\n"):
        if line.startswith("data: "):
            raw = line[len("data: "):]
            events.append(None if raw == "[DONE]" else _json(raw))
    return events


def _equal_json(answers):
    got = {name: (status, _json(data)) for name, (status, _, data) in answers.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# completions, chat and the error surface
# ---------------------------------------------------------------------------

GREEDY = {"max_tokens": 6, "temperature": 0.0}
GUIDED_SCHEMA = {"type": "object", "properties": {
    "severity": {"enum": ["CRITICAL", "LOW"]}, "confident": {"type": "boolean"}}}
COMPLETION_CASES = {
    "completion": ("/v1/completions", {"prompt": "pod failed with exit code 137", **GREEDY}),
    "prompt_list": ("/v1/completions", {"prompt": ["oom", "crash loop"], **GREEDY}),
    "n_2": ("/v1/completions", {"prompt": "oom", "n": 2, **GREEDY}),
    "served_model": ("/v1/completions", {"prompt": "x", "model": "tiny-test", **GREEDY}),
    "stop_str": ("/v1/completions", {"prompt": "stop me", "stop": "e", **GREEDY}),
    "stop_list": ("/v1/completions", {"prompt": "stop me", "stop": ["a", "\x00"], **GREEDY}),
    "chat": ("/v1/chat/completions",
             {"messages": [{"role": "system", "content": "be brief"},
                           {"role": "user", "content": "why did my pod crash?"}], **GREEDY}),
    "content_parts": ("/v1/chat/completions",
                      {"messages": [{"role": "user", "content": [
                          {"type": "text", "text": "OOM"}, {"type": "text", "text": "Killed"}]}],
                       **GREEDY}),
    "missing_prompt": ("/v1/completions", {}),
    "bad_n": ("/v1/completions", {"prompt": "x", "n": 0}),
    "bad_max_tokens": ("/v1/completions", {"prompt": "x", "max_tokens": 0}),
    "bad_temperature": ("/v1/completions", {"prompt": "x", "temperature": -1}),
    "bad_stop": ("/v1/completions", {"prompt": "x", "stop": [1]}),
    "empty_messages": ("/v1/chat/completions", {"messages": []}),
    "image_part": ("/v1/chat/completions",
                   {"messages": [{"role": "user", "content": [{"type": "image_url"}]}]}),
    "unknown_model": ("/v1/completions", {"prompt": "x", "model": "nope"}),
    "not_an_object": ("/v1/completions", [1, 2]),
    # guided decoding: served on the wave engine, refused by the
    # continuous scheduler, with the JAX server's answers either way
    "guided_choice": ("/v1/completions",
                      {"prompt": "severity?", "guided_choice": ["CRITICAL", "LOW"], **GREEDY}),
    "guided_regex": ("/v1/completions",
                     {"prompt": "how many?", "guided_regex": r"\d{1,3} errors",
                      "max_tokens": 16, "temperature": 0.0}),
    "guided_json": ("/v1/completions",
                    {"prompt": "classify", "guided_json": GUIDED_SCHEMA,
                     "max_tokens": 40, "temperature": 0.0}),
    "response_format_schema": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "classify"}], "max_tokens": 40,
        "temperature": 0.0,
        "response_format": {"type": "json_schema", "json_schema": {"schema": GUIDED_SCHEMA}}}),
    "json_object": ("/v1/completions",
                    {"prompt": "x", "response_format": {"type": "json_object"}}),
    "bad_guided_choice": ("/v1/completions", {"prompt": "x", "guided_choice": "yes"}),
    "bad_guided_regex": ("/v1/completions", {"prompt": "x", "guided_regex": r"(?i)x"}),
    "guided_exclusive": ("/v1/completions",
                         {"prompt": "x", "guided_regex": "a", "guided_choice": ["b"]}),
}


@pytest.mark.parametrize("case", sorted(COMPLETION_CASES))
def test_completions_answer_as_the_jax_server(pair, case):
    path, body = COMPLETION_CASES[case]
    status, payload = _equal_json(pair.both("POST", path, body))
    if status == 200:
        assert payload["usage"]["completion_tokens"] > 0


@pytest.mark.parametrize("method,path,raw", [
    ("POST", "/v1/completions", b"{nope"),
    ("GET", "/v2/oops", None),
    ("PUT", "/v1/completions", b"{}"),
])
def test_malformed_requests_answer_as_the_jax_server(pair, method, path, raw):
    _equal_json(pair.both(method, path, raw_body=raw))


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def _stream(pair, path, body):
    answers = pair.both("POST", path, {**body, "stream": True})
    for status, head, _ in answers.values():
        assert status == 200 and "text/event-stream" in head
    events = {name: _events(data) for name, (_, _, data) in answers.items()}
    assert events["port"] == events["jax"]
    assert events["port"][-1] is None  # [DONE]
    return events["port"][:-1]


def _text(chunks, chat):
    if chat:
        return "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    return "".join(c["choices"][0]["text"] for c in chunks)


@pytest.mark.parametrize("case", ["completion", "chat", "stop_spanning_blocks"])
def test_streamed_chunks_equal_the_jax_servers(pair, case):
    chat = case == "chat"
    path = "/v1/chat/completions" if chat else "/v1/completions"
    base = {"max_tokens": 12, "temperature": 0.0}
    if chat:
        base["messages"] = [{"role": "user", "content": "stream me"}]
    else:
        base["prompt"] = "crash loop" if case == "stop_spanning_blocks" else "stream me"
    if case == "stop_spanning_blocks":
        full = _json(call(pair.ports["port"], "POST", path, base)[2])["choices"][0]["text"]
        # a two-character stop sequence first seen from the fourth
        # character on: it spans two committed steps (or decode blocks)
        at = next(k for k in range(3, len(full) - 1)
                  if full.find(full[k:k + 2]) == k and "\ufffd" not in full[k:k + 2])
        base["stop"] = full[at:at + 2]
    _, _, data = call(pair.ports["port"], "POST", path, base)
    choice = _json(data)["choices"][0]
    want = choice["message"]["content"] if chat else choice["text"]
    chunks = _stream(pair, path, base)
    assert len(chunks) >= 2
    assert chunks[-1]["choices"][0]["finish_reason"] == choice["finish_reason"]
    assert _text(chunks, chat) == want


@pytest.mark.parametrize("body", [
    {"prompt": ["a", "b"], "stream": True},
    {"prompt": "a", "n": 2, "stream": True},
], ids=["prompt_list", "n_2"])
def test_streaming_rejects_fanout(pair, body):
    status, payload = _equal_json(pair.both("POST", "/v1/completions", body))
    assert status == 400 and "stream" in payload["error"]["message"]


@pytest.fixture(scope="module", params=["continuous", "wave"])
def small_pair(request, jax_params, torch_params):
    """KV pools of four pages: a 100-byte prompt can never fit."""
    pair = _Pair(jax_params, torch_params, request.param, store=False, kv_pages=5)
    yield pair
    pair.close()


@pytest.mark.parametrize("stream", [False, True], ids=["plain", "stream"])
def test_oversized_request_is_a_400_before_the_headers(small_pair, stream):
    body = {"prompt": "x" * 100, "max_tokens": 8, "stream": stream}
    answers = small_pair.both("POST", "/v1/completions", body)
    for _, head, _ in answers.values():
        assert "event-stream" not in head
    status, payload = _equal_json(answers)
    assert status == 400 and "KV pages" in payload["error"]["message"]


# ---------------------------------------------------------------------------
# auth, models, metrics, embeddings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,path,token", [
    ("GET", "/v1/models", None),
    ("GET", "/v1/models", "wrong"),
    ("GET", "/metrics", None),
    ("POST", "/v1/embeddings", None),
    ("POST", "/api/v1/analysis/analyze", None),
    ("GET", "/healthz", None),
])
def test_auth_answers_as_the_jax_server(pair, method, path, token):
    answers = pair.both(method, path, {"input": "x"} if method == "POST" else None,
                        token=token)
    if path == "/healthz":  # probes carry no token
        assert {name: a[0] for name, a in answers.items()} == {"jax": 200, "port": 200}
        return
    status, payload = _equal_json(answers)
    assert status == 401 and payload["error"]["type"] == "authentication_error"


def test_models_list_the_embedder_as_the_jax_server(pair):
    status, payload = _equal_json(pair.both("GET", "/v1/models"))
    assert [m["id"] for m in payload["data"]] == ["tiny-test", "log-embedder"]


@pytest.mark.parametrize("body", [
    {"input": ["OOMKilled exit 137", "ImagePullBackOff"]},
    {"input": "OOMKilled exit 137", "model": "mine"},
    {"input": []},
    {"input": [1]},
    {"input": ["x"] * 257},
], ids=["list", "one", "empty", "not_str", "too_many"])
def test_embeddings_answer_as_the_jax_server(pair, body):
    answers = pair.both("POST", "/v1/embeddings", body)
    got = {name: (status, _json(data)) for name, (status, _, data) in answers.items()}
    assert got["port"][0] == got["jax"][0]
    if got["port"][0] != 200:
        assert got["port"] == got["jax"]
        return
    port, ref = got["port"][1], got["jax"][1]
    for mine, theirs in zip(port["data"], ref["data"]):
        np.testing.assert_allclose(mine["embedding"], theirs["embedding"], atol=1e-6)
        mine["embedding"] = theirs["embedding"] = None
    assert port == ref


def _families(text):
    return sorted({line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")})


def _parse_prometheus(text):
    """Every sample line is ``name{labels} value`` with a float value."""
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, _, value = line.rpartition(" ")
        float(value)
        assert name_labels and " " not in name_labels.split("{")[0]
        samples += 1
    return samples


@pytest.fixture(scope="module", params=["continuous", "wave"])
def quiet_pair(request, jax_params, torch_params):
    """A pair that serves one request at a time: which metrics exist then
    follows the requests alone, not how concurrent ones met in a step."""
    pair = _Pair(jax_params, torch_params, request.param)
    for prompt in ("warm metrics", "OOMKilled " * 3):
        pair.both("POST", "/v1/completions", {"prompt": prompt, "max_tokens": 4})
    yield pair
    pair.close()


@pytest.mark.parametrize("accept", ["", "application/openmetrics-text"])
def test_metrics_answer_as_the_jax_server(quiet_pair, accept):
    pair = quiet_pair
    answers = pair.both("GET", "/metrics", headers={"Accept": accept} if accept else None)
    ctypes = {name: [h for h in head.split("\r\n") if h.startswith("Content-Type")]
              for name, (_, head, _) in answers.items()}
    assert ctypes["port"] == ctypes["jax"]
    text = {name: data.decode() for name, (_, _, data) in answers.items()}
    assert _parse_prometheus(text["port"]) > 0
    assert _families(text["port"]) == _families(text["jax"])
    stats = {name: json.loads(data) for name, (_, _, data)
             in pair.both("GET", "/metrics.json").items()}
    for section in ("stages", "counters", "histograms"):
        assert sorted(stats["port"][section]) == sorted(stats["jax"][section]), section
    assert "prefill" in stats["port"]["stages"]


# ---------------------------------------------------------------------------
# the reference's ai-interface contract
# ---------------------------------------------------------------------------

def _analysis_body():
    with open(os.path.join(FIXTURES, "oom_java.log"), encoding="utf-8") as fh:
        logs = fh.read()[-2000:]
    failure = jax_analysis.PodFailureData(logs=logs)
    return jax_analysis.AnalysisRequest(
        analysis_result=JaxPatternEngine().analyze(failure),
        provider_config=jax_analysis.AIProviderConfig(
            provider_id="tpu-native", model_id="tiny-test", max_tokens=8, temperature=0.0),
        failure_data=failure,
    ).to_dict()


def test_analyze_route_serves_the_reference_contract(pair):
    status, payload = _equal_json(pair.both("POST", "/api/v1/analysis/analyze",
                                            _analysis_body()))
    assert status == 200
    assert payload["providerId"] == "tpu-native" and payload["modelId"] == "tiny-test"
    assert payload.get("explanation") or payload.get("error")


@pytest.mark.parametrize("body", [{"analysisResult": "not-an-object"}, [1]],
                         ids=["bad_field", "not_an_object"])
def test_analyze_route_rejects_a_body_that_is_not_a_request(pair, body):
    answers = pair.both("POST", "/api/v1/analysis/analyze", body)
    statuses = {name: a[0] for name, a in answers.items()}
    assert statuses == {"jax": 400, "port": 400}


def test_analyze_route_without_a_backend_is_a_404(torch_params):
    engine = _port_engine(torch_params, "continuous", store=False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    with event_loop_thread() as run:
        run(server.start())
        try:
            status, _, data = call(server.bound_port, "POST", "/api/v1/analysis/analyze",
                                   _analysis_body())
        finally:
            run(server.stop())
            engine.close()
    assert status == 404 and "analysis backend" in json.loads(data)["error"]["message"]


# ---------------------------------------------------------------------------
# /healthz: the load report (the repair of the port's five-key report)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_healthz_load_report_matches_the_jax_server(jax_params, torch_params, mode):
    """After the same two requests, each server's ``/healthz`` ``load``
    has the same keys, and equal values wherever they are not wall-clock
    readings; the roofline decode estimate the router sheds on is there."""
    pair = _Pair(jax_params, torch_params, mode)
    try:
        for prompt in ("pod crashed with exit code 137", "OOMKilled " * 4):
            pair.both("POST", "/v1/completions",
                      {"prompt": prompt, "max_tokens": 5, "temperature": 0.0})
        answers = pair.both("GET", "/healthz", token=None)
    finally:
        pair.close()
    health = {name: json.loads(data) for name, (_, _, data) in answers.items()}
    load = {name: h["load"] for name, h in health.items()}
    assert sorted(load["port"]) == sorted(load["jax"])
    for key in WALL_CLOCK:
        assert load["port"][key] is not None and load["jax"][key] is not None, key
    assert load["port"]["decodeTokenS"] > 0
    same = {name: {k: v for k, v in report.items() if k not in WALL_CLOCK}
            for name, report in load.items()}
    assert same["port"] == same["jax"]
    assert same["port"]["sloCompleted"] == 2 and same["port"]["steps"] > 0
    assert health["port"]["status"] == health["jax"]["status"] == "ok"


# ---------------------------------------------------------------------------
# the port alone: cancel on disconnect, /kv/blocks, /profile
# ---------------------------------------------------------------------------

def _busy(engine):
    sched = engine.scheduler
    if sched is not None:
        return sched.total_work, sched.steps
    g = engine.generator
    return g.num_active + len(g._inflight_blocks), g.blocks_dispatched


async def _stream_then_close(port, body):
    """Open a stream, read until the first chunk, close the socket."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps({**body, "stream": True}).encode()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\nAuthorization: Bearer {TOKEN}"
                 f"\r\nContent-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    seen = b""
    while b"data: " not in seen:
        chunk = await reader.read(4096)
        assert chunk, seen
        seen += chunk
    writer.close()
    await writer.wait_closed()


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_disconnect_cancels_the_request_and_returns_its_pages(torch_params, mode):
    engine = _port_engine(torch_params, mode, store=False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0,
                              api_token=TOKEN)
    g = engine.generator
    with event_loop_thread() as run:
        run(server.start())
        try:
            asyncio.run(asyncio.wait_for(_stream_then_close(
                server.bound_port,
                {"prompt": "keep going", "max_tokens": 100, "temperature": 0.0},
            ), TIMEOUT_S))
            _, closed_at = _busy(engine)
            deadline = time.monotonic() + TIMEOUT_S
            while _busy(engine)[0] and time.monotonic() < deadline:
                time.sleep(0.01)
            work, released_at = _busy(engine)
            status, _, data = call(server.bound_port, "GET", "/healthz", token=None)
        finally:
            run(server.stop())
            engine.close()
    assert work == 0
    # released within a few steps of the close, far short of 100 tokens
    steps_per_token = 1 if mode == "continuous" else 1 / g.decode_block
    assert released_at - closed_at <= 4
    assert released_at < 100 * steps_per_token
    assert g.allocator.available == g.allocator.num_pages - 1
    assert len(g.free_slots()) == g.max_slots
    if engine.scheduler is not None:
        accounting = engine.scheduler.page_accounting()
        assert accounting["row_pages"] == 0
    assert status == 200 and json.loads(data)["load"]["inflight"] == 0


def test_kv_blocks_route_names_its_roadmap_item(torch_params):
    """The fabric's peer route (once a refusal naming item 5b) serves a
    pooled block: a mirrored prompt block answers 200 with its PMKV1
    bytes, which the JAX package decodes to the pooled page; a block not
    pooled here answers 404 (``tests/test_torch_fabric.py`` holds the
    route to the JAX server)."""
    from operator_tpu.fabric import decode_block as jax_decode_block
    from operator_tpu_torch.fabric import encode_block
    from operator_tpu_torch.ops.kv_transfer import HostKVPool
    from operator_tpu_torch.serving.types import SamplingParams

    generator = Generator(
        torch_params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32, device="cpu",
        metrics=MetricsRegistry(), **SHAPE,
    )
    store = kvstore.PrefixKVStore(16, host_pool=HostKVPool(8), metrics=generator.metrics)
    engine = ServingEngine(generator, Scheduler(generator, kvstore=store, fabric_mirror=True))
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    prompt = "the quick brown fox jumps over the lazy dog " * 2
    with event_loop_thread() as run:
        run(server.start())
        try:
            run(engine.generate(prompt, SamplingParams(max_tokens=2, temperature=0.0)))
            h = kvstore.block_hashes(generator.tokenizer.encode(prompt), 16)[0]
            status, head, data = call(server.bound_port, "GET", f"/kv/blocks/{h.hex()}")
            missing, _, miss_body = call(server.bound_port, "GET", "/kv/blocks/" + "0" * 32)
        finally:
            run(server.stop())
            engine.close()
    k, v = store.host_pool.get(h)
    assert status == 200 and "application/octet-stream" in head
    assert data == encode_block(h, k, v)
    got_hash, jk, jv = jax_decode_block(data)
    assert got_hash == h and np.array_equal(jk, k.numpy()) and np.array_equal(jv, v.numpy())
    assert missing == 404 and "not pooled here" in json.loads(miss_body)["error"]["message"]
    assert generator.metrics.counter("fabric_serve_hit") == 1
    assert generator.metrics.counter("fabric_serve_miss") == 1


def test_profile_writes_a_trace_and_guards_its_window(torch_params, tmp_path):
    engine = _port_engine(torch_params, "continuous", store=False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0,
                              profile_enabled=True, profile_dir=str(tmp_path))
    closed = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    out = SimpleNamespace()
    with event_loop_thread() as run:
        run(server.start())
        run(closed.start())
        try:
            async def overlapping():
                first = asyncio.ensure_future(asyncio.to_thread(
                    call, server.bound_port, "POST", "/profile?seconds=0.5"))
                await asyncio.sleep(0.2)
                second = await asyncio.to_thread(
                    call, server.bound_port, "POST", "/profile?seconds=0.5")
                return await first, second

            (out.first, out.busy) = asyncio.run(asyncio.wait_for(overlapping(), TIMEOUT_S))
            out.short = call(server.bound_port, "POST", "/profile?seconds=0")
            out.off = call(closed.bound_port, "POST", "/profile?seconds=1")
        finally:
            run(server.stop())
            run(closed.stop())
            engine.close()
    status, _, data = out.first
    body = json.loads(data)
    assert status == 200 and body["seconds"] == 0.5
    assert os.path.exists(os.path.join(body["artifact"], "trace.json"))
    assert out.busy[0] == 409
    assert out.short[0] == 200 and json.loads(out.short[2])["seconds"] == 0.1
    assert out.off[0] == 404


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_profile_starts_and_stops_on_the_worker_between_steps(torch_params, tmp_path, mode):
    """The capture's start and stop run on the engine's worker between
    steps (never beside a graph replay), in either loop."""
    engine = _port_engine(torch_params, mode, store=False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0,
                              profile_enabled=True, profile_dir=str(tmp_path))
    submit = engine.store_executor.submit
    threads = []

    def recorded(fn, *args, **kwargs):
        return submit(lambda: (threads.append(threading.current_thread().name),
                               fn(*args, **kwargs))[1])

    engine.store_executor.submit = recorded
    with event_loop_thread() as run:
        run(server.start())
        try:
            status, _, data = call(server.bound_port, "POST", "/profile?seconds=0.2")
        finally:
            run(server.stop())
            engine.close()
    assert status == 200
    assert os.path.exists(os.path.join(json.loads(data)["artifact"], "trace.json"))
    assert threads == [engine._thread.name] * 2


# ---------------------------------------------------------------------------
# the engine's resume and close, as the server sees them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_resume_tokens_continue_as_the_jax_engine(jax_params, torch_params, mode):
    """``resume_tokens`` re-prefill a failed-over stream's tokens after
    the prompt and the result carries only the continuation (continuous
    mode); the wave engine refuses them.  Both packages alike."""
    from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams
    from operator_tpu_torch.serving.types import SamplingParams

    resume = [100, 101, 102, 103]

    async def drive(engine, params):
        try:
            result = await asyncio.wait_for(
                engine.generate("pod crashed", params, resume_tokens=resume), TIMEOUT_S)
            return ["ok", result.token_ids, result.prompt_tokens]
        except ValueError as exc:
            return ["refused", str(exc)]

    async def jax_side():
        engine = _jax_engine(jax_params, mode, store=True)
        try:
            return await drive(engine, JaxSamplingParams(max_tokens=5, temperature=0.0))
        finally:
            await engine.close()

    async def port_side():
        engine = _port_engine(torch_params, mode, store=True)
        try:
            return await drive(engine, SamplingParams(max_tokens=5, temperature=0.0))
        finally:
            engine.close()

    ref, got = asyncio.run(jax_side()), asyncio.run(port_side())
    assert got == ref
    assert got[0] == ("ok" if mode == "continuous" else "refused")


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_engine_close_answers_server_shutting_down(torch_params, mode):
    """``engine.close()`` fails what is outstanding with
    ``asyncio.CancelledError("serving engine closed")``: a plain request
    in flight answers 503 "server shutting down", a stream ends with that
    error event, as the reference's server answers."""
    import threading

    engine = _port_engine(torch_params, mode, store=False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    answers: dict = {}
    body = {"prompt": "keep going", "max_tokens": 100, "temperature": 0.0}

    def plain():
        answers["plain"] = call(server.bound_port, "POST", "/v1/completions", body)

    first_chunk = threading.Event()

    async def read_stream():
        reader, writer = await asyncio.open_connection("127.0.0.1", server.bound_port)
        payload = json.dumps({**body, "stream": True}).encode()
        writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        await writer.drain()
        seen = b""
        while chunk := await reader.read(4096):
            seen += chunk
            if b"data: " in seen:
                first_chunk.set()
        writer.close()
        return seen

    def stream():
        raw = asyncio.run(asyncio.wait_for(read_stream(), TIMEOUT_S))
        head, _, data = raw.partition(b"\r\n\r\n")
        answers["stream"] = (int(head.split()[1]), head.decode("latin-1"), data)

    with event_loop_thread() as run:
        run(server.start())
        try:
            threads = [threading.Thread(target=f, daemon=True) for f in (plain, stream)]
            for thread in threads:
                thread.start()
            # both in flight: the stream past its headers, the plain one
            # handed to the engine
            assert first_chunk.wait(TIMEOUT_S)
            deadline = time.monotonic() + TIMEOUT_S
            while len(engine._pending) < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            engine.close()
            for thread in threads:
                thread.join(TIMEOUT_S)
            assert not any(thread.is_alive() for thread in threads)
        finally:
            run(server.stop())
            engine.close()
    status, _, data = answers["plain"]
    assert status == 503 and json.loads(data)["error"]["message"] == "server shutting down"
    status, _, data = answers["stream"]
    events = _events(data)
    assert status == 200 and events[-1] is None
    assert events[-2] == {"error": {"message": "server shutting down",
                                    "type": "server_error", "code": None}}
