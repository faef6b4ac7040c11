"""The port's ``build_serving_engine`` and ``tpu-native`` provider against
the JAX package's.

- Every serving knob the reference reads resolves to the same setting in
  both, through each package's ``OperatorConfig.from_env``; a knob whose
  feature is not ported is refused with a message naming its ROADMAP
  Queue 1 item.
- With ``CHECKPOINT_DIR`` (a tiny ``transformers`` Llama checkpoint with
  the committed SentencePiece-style tokenizer, at ``tiny-test``'s widths
  with a 2,048-token context so the default prompt template fits) both
  packages serve the same greedy tokens, and ``TPUNativeProvider`` gives
  the same ``AIResponse`` (explanation, token counts, deadline outcome,
  error) for the default, a custom and a broken prompt template, prior
  incidents, an expired and a generous deadline, and a closed engine.
- ``build_prompt``, the prompt helpers and ``template_for`` give the JAX
  package's strings; ``/v1/chat/completions`` and ``/v1/models`` answer as
  the JAX server does.
"""

import asyncio
import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from operator_tpu import obs as jax_obs  # noqa: E402
from operator_tpu.models import configs as jax_configs  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.patterns.engine import PatternEngine as JaxPatternEngine  # noqa: E402
from operator_tpu.schema import analysis as jax_analysis  # noqa: E402
from operator_tpu.schema.kube import Pod as JaxPod  # noqa: E402
from operator_tpu.serving import prompts as jax_prompts  # noqa: E402
from operator_tpu.serving import provider as jax_provider  # noqa: E402
from operator_tpu.serving import templates as jax_templates  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.httpserver import CompletionServer as JaxCompletionServer  # noqa: E402
from operator_tpu.utils.config import OperatorConfig as JaxOperatorConfig  # noqa: E402
from operator_tpu_torch import obs  # noqa: E402
from operator_tpu_torch.models import configs  # noqa: E402
from operator_tpu_torch.models.quant import is_quantized  # noqa: E402
from operator_tpu_torch.models.tokenizer import HFTokenizer  # noqa: E402
from operator_tpu_torch.schema.analysis import AnalysisRequest  # noqa: E402
from operator_tpu_torch.serving import prompts, templates  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.provider import (  # noqa: E402
    build_serving_engine,
    build_tpu_native_provider,
)
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.config import OperatorConfig  # noqa: E402
from test_torch_loader import hf_checkpoint  # noqa: E402
from test_torch_tokenizer import LLAMA_SP  # noqa: E402

BASE = {
    "OPERATOR_TPU_MODEL": "tiny-test",
    "ALLOW_RANDOM_WEIGHTS": "true",
    "MAX_BATCH_SIZE": "4",
    "KV_PAGE_SIZE": "16",
}


def _weights(params, quantized) -> str:
    if quantized:
        return "int8"
    leaf = params["embed"]
    return str(leaf.dtype).replace("torch.", "")


def _resolved(engine, sched, params_dtype) -> dict:
    g = engine.generator
    store = sched._kvstore if sched is not None else None
    return {
        "num_pages": g.allocator.num_pages,
        "sample_top_k": g.sample_top_k,
        "weights": params_dtype,
        "ring_capacity": g.step_clock.ring.capacity,
        "page_size": g.page_size,
        "max_slots": g.max_slots,
        "continuous": sched is not None,
        "role": engine.replica_role,
        "spec_k": sched.spec_k if sched is not None else None,
        "chunk": sched.chunk if sched is not None else None,
        "depth": sched.depth if sched is not None else None,
        "prefix_cache": store is not None,
        "host_pool_bytes": (
            store.host_pool.capacity_bytes
            if store is not None and store.host_pool is not None else None
        ),
    }


def _port(env) -> dict:
    engine, model_id = build_serving_engine("cpu", env)
    try:
        params = engine.generator.params
        dtype = _weights(params, is_quantized(params))
        return {"model": model_id, **_resolved(engine, engine.scheduler, dtype)}
    finally:
        engine.close()


def _jax(env, monkeypatch) -> dict:
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    engine, model_id = jax_provider.build_serving_engine(JaxOperatorConfig.from_env(env))
    params = engine.generator.params
    dtype = "int8" if jax_quant.is_quantized(params) else str(params["embed"].dtype)
    return {"model": model_id, **_resolved(engine, engine._sched, dtype)}


@pytest.mark.parametrize("knob,value", [
    (None, None),  # the defaults: int8, prefix cache on, no host pool
    ("SPEC_LOOKUP_K", "1"),
    ("SAMPLE_TOP_K", "8"),
    ("KV_PAGES", "9"),
    ("WEIGHT_DTYPE", "bf16"),
    ("SERVING_DTYPE", "bf16"),
    ("KV_PREFIX_CACHE", "false"),
    ("KV_HOST_POOL_MB", "64"),
    ("STEP_RING_CAPACITY", "7"),
    ("SCHED_CHUNK", "32"),
    ("SCHED_PIPELINE_DEPTH", "1"),
    ("SPEC_DECODE", "false"),
    ("SCHED_MODE", "wave"),
    ("REPLICA_ROLE", "Prefill"),
])
def test_provider_knob_resolves_as_the_jax_package(knob, value, monkeypatch):
    env = dict(BASE)
    if knob is not None:
        env[knob] = value
    port_config = dataclasses.asdict(OperatorConfig.from_env(env))
    assert port_config == dataclasses.asdict(JaxOperatorConfig.from_env(env))
    got = _port(env)
    assert got == _jax(env, monkeypatch)
    pins = {
        "SPEC_LOOKUP_K": ("spec_k", 1),
        "SAMPLE_TOP_K": ("sample_top_k", 8),
        "KV_PAGES": ("num_pages", 9),
        "WEIGHT_DTYPE": ("weights", "bfloat16"),
        "KV_PREFIX_CACHE": ("prefix_cache", False),
        "KV_HOST_POOL_MB": ("host_pool_bytes", 64 << 20),
        "STEP_RING_CAPACITY": ("ring_capacity", 7),
        "REPLICA_ROLE": ("role", "prefill"),
    }
    if knob in pins:
        key, want = pins[knob]
        assert got[key] == want
    if knob is None:
        assert got["weights"] == "int8" and got["prefix_cache"]
        assert got["host_pool_bytes"] is None


def test_weight_dtype_wins_over_serving_dtype():
    got = _port({**BASE, "WEIGHT_DTYPE": "int8", "SERVING_DTYPE": "bf16"})
    assert got["weights"] == "int8"


@pytest.mark.parametrize("knob,value,item", [
    ("PREFILL_CHUNK", "32", "item 7"),
    ("SERVING_MESH", "tp=2", "item 11"),
    ("LORA_DIR", "/nonexistent/adapters", "item 9"),
    ("AOT_CACHE_PATH", "/nonexistent/aot", "item 10"),
    ("KV_FABRIC", "true", "item 5b"),
    ("KV_CACHE_MODE", "contiguous", "item 8"),
])
def test_provider_refuses_unported_knobs_naming_their_item(knob, value, item):
    for mode in ("continuous", "wave"):
        with pytest.raises(NotImplementedError, match=item) as info:
            build_serving_engine("cpu", {**BASE, "SCHED_MODE": mode, knob: value})
        assert knob in str(info.value)


def test_provider_leaves_the_overload_ladder_to_the_caller():
    engine, _ = build_serving_engine("cpu", {**BASE, "SCHED_QUEUE_LIMIT": "3"})
    try:
        assert engine.scheduler.queue_limit == 0
        assert engine.scheduler.overload_policy is None
        assert engine.generator.overload_policy is None
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# serving a checkpoint: the provider, prompts, templates and HTTP routes
# ---------------------------------------------------------------------------

#: ``tiny-test`` with room for the fixture tokenizer's 1,405 ids and a
#: 2,048-token context: the default template's prompts of the fixture logs
#: are 791 to 1,414 of its tokens
LONG = "tiny-test-sp"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CUSTOM_TEMPLATE = "Pod {pod_name} ({namespace}) failed: {patterns}\nTail:\n{log_tail}\nCause:"
BROKEN_TEMPLATE = "Pod {pod_name} failed on {node_name}: explain"


def _long(config):
    return dataclasses.replace(config, name=LONG, vocab_size=1536, max_seq_len=2048)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = hf_checkpoint(tmp_path_factory.mktemp("checkpoint") / "tiny", dtype=torch.bfloat16,
                         cfg=_long(configs.TINY_TEST))
    for name in os.listdir(LLAMA_SP):
        shutil.copy(os.path.join(LLAMA_SP, name), path)
    return path


@pytest.fixture(scope="module")
def served(checkpoint):
    """Both packages' providers and HTTP servers over one checkpoint, both
    servers on one event loop of their own (the port's engine keeps its
    worker thread)."""
    env = {"OPERATOR_TPU_MODEL": LONG, "CHECKPOINT_DIR": checkpoint,
           "MAX_BATCH_SIZE": "4", "KV_PAGE_SIZE": "16"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(configs._REGISTRY, LONG, _long(configs.TINY_TEST))
        mp.setitem(jax_configs._REGISTRY, LONG, _long(jax_configs.TINY_TEST))
        for key, value in env.items():
            mp.setenv(key, value)
        port = build_tpu_native_provider("cpu", env)
        ref = jax_provider.build_tpu_native_provider(JaxOperatorConfig.from_env(env))
        ref.register_template_prefixes = False  # no wave-engine shared prefix
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()

        def on_jax(coro, timeout: float = 300.0):
            return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

        jax_server = JaxCompletionServer(ref.engine, model_id=LONG, host="127.0.0.1", port=0)
        on_jax(jax_server.start())
        port_server = CompletionServer(port.engine, model_id=LONG, host="127.0.0.1", port=0)
        on_jax(port_server.start())
        try:
            yield SimpleNamespace(
                port=port, ref=ref, on_jax=on_jax,
                urls={"port": f"http://127.0.0.1:{port_server.bound_port}",
                      "jax": f"http://127.0.0.1:{jax_server.bound_port}"},
            )
        finally:
            on_jax(port_server.stop())
            port.engine.close()
            on_jax(jax_server.stop())
            on_jax(ref.engine.close())
            loop.call_soon_threadsafe(loop.stop)
            thread.join(10)


def _analysis(name: str):
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
        logs = fh.read()
    result = JaxPatternEngine().analyze(jax_analysis.PodFailureData(logs=logs))
    pod = JaxPod.parse({"metadata": {"name": name.split(".")[0].replace("_", "-"),
                                     "namespace": "prod"}})
    return result, jax_analysis.PodFailureData(pod=pod, logs=logs)


def _requests() -> dict:
    """JAX ``AnalysisRequest``s by case; the port's are parsed from their
    wire dicts."""
    config = jax_analysis.AIProviderConfig
    oom = _analysis("oom_java.log")
    dns = _analysis("dns_failure.log")
    prior = jax_analysis.PriorIncident(
        fingerprint="f00d", score=0.91, seen_count=3, severity="HIGH",
        last_seen="2026-10-01T00:00:00Z",
        explanation="Root Cause: heap limit below the working set.\nFix: raise -Xmx.")

    def make(analysis, **kw):
        result, failure = analysis
        provider = config(provider_id="tpu-native", max_tokens=8, temperature=0.0,
                          **kw.pop("config", {}))
        return jax_analysis.AnalysisRequest(
            analysis_result=result, failure_data=failure, provider_config=provider, **kw)

    return {
        "default": make(oom),
        "custom_template": make(dns, config={"prompt_template": CUSTOM_TEMPLATE}),
        "broken_template": make(dns, config={"prompt_template": BROKEN_TEMPLATE}),
        "prior_incidents": make(oom, prior_incidents=[prior, jax_analysis.PriorIncident(
            score=0.5, explanation="")]),
        "deadline_expired": make(oom, deadline_s=0.0),
        "deadline_generous": make(dns, deadline_s=3600.0),
        "logs_only": jax_analysis.AnalysisRequest(
            failure_data=dns[1], provider_config=config(max_tokens=6, temperature=0.0)),
    }


def _port_request(request) -> AnalysisRequest:
    return AnalysisRequest.parse(json.loads(json.dumps(request.to_dict())))


def _generate_all(provider, requests: list, run) -> list:
    async def all_at_once():
        return await asyncio.gather(*(provider.generate(r) for r in requests))

    return [r.to_dict() for r in run(all_at_once())]


def test_build_prompt_and_helpers_match_jax():
    for name, request in _requests().items():
        assert prompts.build_prompt(_port_request(request)) == jax_prompts.build_prompt(request), name
        assert prompts.prior_incident_section(_port_request(request)) == \
            jax_prompts.prior_incident_section(request)
    empty = jax_analysis.AnalysisRequest()
    assert prompts.build_prompt(_port_request(empty)) == jax_prompts.build_prompt(empty)
    assert prompts.build_warmup_prompt() == jax_prompts.build_warmup_prompt()
    for template in (prompts.DEFAULT_TEMPLATE, CUSTOM_TEMPLATE, BROKEN_TEMPLATE, "", "  ",
                     "{pod_name.x}", "no placeholders"):
        assert prompts.template_preamble(template) == jax_prompts.template_preamble(template)
    blocks = ["a" * 700, "", "  b  ", "c" * 2000, "d"]
    for budget in (0, 5, 700, 1600, 5000):
        assert prompts.pack_blocks(blocks, budget) == jax_prompts.pack_blocks(blocks, budget)


@pytest.mark.parametrize("model", [
    "tinyllama-1.1b", "llama-3-8b", "llama-3.1-8b", "mistral-7b", "qwen2.5-7b", "tiny-test", "",
])
def test_template_for_matches_jax(model):
    conversations = [
        [{"role": "user", "content": "why did my pod crash?"}],
        [{"role": "system", "content": "You are terse."},
         {"role": "user", "content": "exit 137"},
         {"role": "assistant", "content": "OOMKilled."},
         {"role": "user", "content": "fix?"}],
        [{"role": "system", "content": "system only"}],
        [{"content": "no role"}],
    ]
    for messages in conversations:
        assert templates.template_for(model)(messages) == jax_templates.template_for(model)(messages)


def test_checkpoint_engine_serves_the_jax_greedy_tokens(served):
    g = served.port.engine.generator
    assert isinstance(g.tokenizer, HFTokenizer)
    assert is_quantized(g.params)  # SERVING_DTYPE int8 by default
    logs = [open(os.path.join(FIXTURES, n), encoding="utf-8").read()
            for n in ("oom_java.log", "go_panic.log", "eviction.log", "tls_cert.log")]
    got = served.port.engine.generate_batch(logs, SamplingParams(max_tokens=10, temperature=0.0))

    async def reference():
        params = JaxSamplingParams(max_tokens=10, temperature=0.0)
        return await asyncio.gather(*(served.ref.engine.generate(p, params) for p in logs))

    want = served.on_jax(reference())
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.prompt_tokens for r in got] == [r.prompt_tokens for r in want]
    assert all(r.completion_tokens > 0 for r in got)


def test_provider_answers_as_the_jax_provider(served):
    cases = _requests()
    want = _generate_all(served.ref, list(cases.values()), served.on_jax)
    got = _generate_all(served.port, [_port_request(r) for r in cases.values()], asyncio.run)
    for name, g, w in zip(cases, got, want):
        assert g == w, name
    by_case = dict(zip(cases, got))
    assert by_case["deadline_expired"]["deadlineOutcome"] == "deadline-exceeded"
    assert by_case["deadline_generous"]["deadlineOutcome"] == "completed"
    for name in cases:
        if name != "deadline_expired":
            assert "error" not in by_case[name] and by_case[name]["completionTokens"] > 0, name


def test_provider_reports_an_engine_error_as_the_jax_provider(checkpoint):
    env = {"OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
           "MAX_BATCH_SIZE": "2", "KV_PAGE_SIZE": "16"}
    port = build_tpu_native_provider("cpu", env)
    port.engine.close()
    request = jax_analysis.AnalysisRequest(
        provider_config=jax_analysis.AIProviderConfig(max_tokens=4, temperature=0.0))

    async def traced(provider, tracer, req):
        with tracer.trace("analysis") as root:
            response = await provider.generate(req)
        return response, root.attributes

    got, got_root = asyncio.run(traced(port, obs.Tracer(), _port_request(request)))
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        ref = jax_provider.build_tpu_native_provider(JaxOperatorConfig.from_env(env))

    async def closed_reference():
        await ref.engine.close()
        return await traced(ref, jax_obs.Tracer(), request)

    want, want_root = asyncio.run(closed_reference())
    assert got.to_dict() == want.to_dict()
    assert got.error == "serving engine is closed"
    assert got_root == want_root == {"blackbox": "engine-error"}


def test_provider_refuses_guided_and_lora_configs_naming_item_9():
    port = build_tpu_native_provider("cpu", {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "MAX_BATCH_SIZE": "2", "KV_PAGE_SIZE": "16"})
    try:
        for extra in ({"guided_regex": "[a-z]+"}, {"guided_json": '{"type": "string"}'},
                      {"lora_adapter": "sre"}):
            request = AnalysisRequest.parse({"providerConfig": {"additionalConfig": extra}})
            response = asyncio.run(port.generate(request))
            assert response.explanation is None and "Queue 1 item 9" in response.error
            assert next(iter(extra)) in response.error
    finally:
        port.engine.close()


def _call(url: str, body=None) -> tuple:
    data = None if body is None else json.dumps(body).encode()
    request = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_models_route_answers_as_the_jax_server(served):
    answers = {side: _call(url + "/v1/models") for side, url in served.urls.items()}
    for side, (status, payload) in answers.items():
        assert status == 200 and payload["object"] == "list", side
        for model in payload["data"]:
            model.pop("created")
    assert answers["port"] == answers["jax"]
    assert [m["id"] for m in answers["port"][1]["data"]] == [LONG]


@pytest.mark.parametrize("case,body", [
    ("chat", {"messages": [
        {"role": "system", "content": "You are a Kubernetes failure analyst."},
        {"role": "user", "content": "The pod exited with code 137. Why?"}],
        "max_tokens": 6, "temperature": 0.0}),
    ("content_parts", {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "OOMKilled "}, {"type": "text", "text": "again"}]}],
        "max_tokens": 5, "temperature": 0.0, "n": 2, "model": LONG}),
    ("stop", {"messages": [{"role": "user", "content": "connection refused"}],
              "max_tokens": 6, "temperature": 0.0, "stop": ["e"]}),
    ("no_messages", {"messages": [], "max_tokens": 4}),
    ("image_part", {"messages": [{"role": "user", "content": [{"type": "image_url"}]}]}),
    ("no_content", {"messages": [{"role": "user"}]}),
    ("unknown_model", {"messages": [{"role": "user", "content": "hi"}], "model": "gpt-9"}),
    ("bad_n", {"messages": [{"role": "user", "content": "hi"}], "n": 0}),
])
def test_chat_completions_answer_as_the_jax_server(served, case, body):
    answers = {side: _call(url + "/v1/chat/completions", body)
               for side, url in served.urls.items()}
    (status, got), (want_status, want) = answers["port"], answers["jax"]
    assert status == want_status, (got, want)
    if status != 200:
        assert got["error"]["type"] == want["error"]["type"]
        assert case == "unknown_model" or got["error"]["message"] == want["error"]["message"]
        return
    for payload in (got, want):
        payload.pop("id")
        payload.pop("created")
    assert got == want
    assert got["object"] == "chat.completion" and got["usage"]["completion_tokens"] > 0
