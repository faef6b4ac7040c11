"""The port's ``build_serving_engine`` and ``tpu-native`` provider against
the JAX package's.

- Every serving knob the reference reads (the fleet KV fabric's
  ``KV_FABRIC*`` too) resolves to the same setting in both, through each
  package's ``OperatorConfig.from_env``, ``KV_CACHE_MODE=contiguous``
  included; ``SERVING_MESH=auto`` serves a one-rank mesh on the wave
  engine as JAX's one-device mesh does, and a mesh wider than the
  process group raises JAX's device-count message.
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
import re
import shutil
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
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
from operator_tpu_torch.parallel.lora import init_lora, save_lora  # noqa: E402
from operator_tpu_torch.schema.analysis import AnalysisRequest  # noqa: E402
from operator_tpu_torch.serving import prompts, templates  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.provider import (  # noqa: E402
    build_serving_engine,
    build_tpu_native_provider,
)
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.config import PORT_FIELDS, OperatorConfig  # noqa: E402
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
    policy = engine._supervisor
    fetcher, poller = engine.fabric, engine.fabric_poller
    return {
        "supervisor": dataclasses.asdict(policy) if policy is not None else None,
        "fabric": None if fetcher is None else {
            "timeout_s": fetcher.timeout_s, "concurrency": fetcher._sem._value,
            "self_id": fetcher.self_id, "api_token": fetcher.api_token,
            "index_empty": fetcher.index.empty(),
        },
        "fabric_poller": None if poller is None else {
            "peers": poller.peers, "poll_s": poller.poll_s, "timeout_s": poller.timeout_s,
            "self_id": poller.self_id, "same_index": poller.index is fetcher.index,
        },
        "fabric_mirror": sched._fabric_mirror if sched is not None else None,
        "adapters": g.adapter_names,
        "paged": g.paged,
        # a contiguous generator has no allocator (JAX's has no attribute)
        "num_pages": g.allocator.num_pages if getattr(g, "allocator", None) else None,
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
        "prefill_chunk": g.prefill_chunk,
        # the wave engine's primed shared prefix (the default template's)
        "prefix_held_pages": g.prefix_held_pages,
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
    ("PREFILL_CHUNK", "32"),
    ("REPLICA_ROLE", "Prefill"),
    ("SUPERVISOR_STALL_S", "7.5"),
    ("SUPERVISOR_JOIN_GRACE_S", "2.5"),
    ("ENGINE_SUPERVISOR", "false"),
    # the fleet KV fabric (each case adds KV_FABRIC=true and its extras)
    ("KV_FABRIC", "true"),
    ("KV_FABRIC_FETCH_TIMEOUT_S", "0.75"),
    ("KV_FABRIC_CONCURRENCY", "9"),
    ("KV_FABRIC_MIRROR", "false"),
    ("KV_FABRIC_PEERS", "http://peer-a:8000, http://peer-b:8000"),
    ("KV_FABRIC_POLL_S", "0.5"),
    ("SERVING_REPLICA_ID", "replica-7"),
    ("KV_FABRIC_WAVE", "wave"),
    # multi-LoRA: a directory with one adapter (the continuous default
    # falls back to the wave engine), and a missing one (a warning)
    ("LORA_DIR", "sre"),
    ("LORA_DIR", "/nonexistent/adapters"),
])
def test_provider_knob_resolves_as_the_jax_package(knob, value, monkeypatch, tmp_path):
    env = dict(BASE)
    if knob == "LORA_DIR" and value == "sre":
        gen = torch.Generator().manual_seed(0)
        save_lora(init_lora(configs.TINY_TEST, gen, rank=4, device="cpu"),
                  str(tmp_path / "sre.safetensors"))
        value = str(tmp_path)
    if knob is not None and knob.startswith(("KV_FABRIC", "SERVING_REPLICA_ID")):
        # the fabric's knobs, with a host pool for the mirror to land in
        env.update({"KV_FABRIC": "true", "KV_HOST_POOL_MB": "8", "POD_NAME": "pod-3",
                    "OPERATOR_TPU_API_TOKEN": "tok", "KV_FABRIC_PEERS": "http://peer:8000"})
        if knob == "KV_FABRIC_WAVE":
            env["SCHED_MODE"] = value
        elif knob != "KV_FABRIC":
            env[knob] = value
    elif knob is not None:
        env[knob] = value
    port_config = dataclasses.asdict(OperatorConfig.from_env(env))
    # the port's own fields (a row's positions; 0: the reference's cap),
    # unset by every knob here
    assert {name: port_config.pop(name) for name in PORT_FIELDS} == {"serving_max_seq": 0}
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
        "SUPERVISOR_STALL_S": ("supervisor", {
            "stall_timeout_s": 7.5, "join_grace_s": 10.0, "max_requeues": 1}),
        "SUPERVISOR_JOIN_GRACE_S": ("supervisor", {
            "stall_timeout_s": 120.0, "join_grace_s": 2.5, "max_requeues": 1}),
        "ENGINE_SUPERVISOR": ("supervisor", None),
        "PREFILL_CHUNK": ("prefill_chunk", 32),
    }
    if knob == "LORA_DIR":
        adapters = ["sre"] if value == str(tmp_path) else []
        assert got["adapters"] == adapters and got["continuous"] == (not adapters)
    if knob in pins:
        key, want = pins[knob]
        assert got[key] == want
    if env.get("KV_FABRIC") and env.get("SCHED_MODE") != "wave":
        assert got["fabric"]["self_id"] == env.get("SERVING_REPLICA_ID", "pod-3")
        assert got["fabric"]["index_empty"] and got["fabric_poller"]["same_index"]
        assert got["fabric_mirror"] == (knob != "KV_FABRIC_MIRROR")
    elif env.get("KV_FABRIC"):
        assert got["fabric"] is None  # the wave engine has no fabric, as in JAX
    if knob is None:
        assert got["weights"] == "int8" and got["prefix_cache"]
        assert got["fabric"] is None and got["fabric_mirror"] is False
        assert got["host_pool_bytes"] is None
        assert got["supervisor"] == {
            "stall_timeout_s": 120.0, "join_grace_s": 10.0, "max_requeues": 1}


@pytest.mark.parametrize("mode", ["continuous", "wave"])
@pytest.mark.parametrize("enabled", [None, "true", "false"])
@pytest.mark.parametrize("stall,grace", [(None, None), ("3", None), (None, "0.5"), ("3", "0.5")])
def test_supervisor_policy_resolves_as_the_jax_package(mode, enabled, stall, grace, monkeypatch):
    """Every combination of ``ENGINE_SUPERVISOR``, ``SUPERVISOR_STALL_S``
    and ``SUPERVISOR_JOIN_GRACE_S`` gives the engine the reference's
    ``SupervisorPolicy`` (or none), in both loops."""
    env = {**BASE, "SCHED_MODE": mode}
    for key, value in (("ENGINE_SUPERVISOR", enabled), ("SUPERVISOR_STALL_S", stall),
                       ("SUPERVISOR_JOIN_GRACE_S", grace)):
        if value is not None:
            env[key] = value
    got = _port(env)["supervisor"]
    assert got == _jax(env, monkeypatch)["supervisor"]
    assert (got is None) == (enabled == "false")


def test_weight_dtype_wins_over_serving_dtype():
    got = _port({**BASE, "WEIGHT_DTYPE": "int8", "SERVING_DTYPE": "bf16"})
    assert got["weights"] == "int8"


@pytest.mark.parametrize("knob,value,item", [
    ("PREFILL_CHUNK", "32", None),  # ported: the knob reaches the engine
    # ported (item 11): one process serves a one-rank mesh on the wave
    # engine; a mesh wider than the process group raises JAX's message
    ("SERVING_MESH", "auto", "needs 2 devices, found 1"),
    # ported (item 8): a contiguous wave engine in both modes, the
    # continuous one through the reference's fallback warning
    ("KV_CACHE_MODE", "contiguous", None),
])
def test_provider_serves_the_once_refused_knobs_as_the_jax_package(knob, value, item,
                                                                    monkeypatch, caplog):
    for mode in ("continuous", "wave"):
        env = {**BASE, "SCHED_MODE": mode, knob: value}
        if knob == "KV_CACHE_MODE":
            caplog.clear()
            got = _port(env)
            assert not got["paged"] and not got["continuous"]
            assert got["num_pages"] is None and got["prefix_held_pages"] == 0
            fell_back = [r.getMessage() for r in caplog.records
                         if r.name.startswith("operator_tpu_torch")
                         and "falling back to the wave engine" in r.getMessage()]
            assert len(fell_back) == (mode == "continuous"), fell_back
            if fell_back:
                assert "paged=False" in fell_back[0]
            assert got == _jax(env, monkeypatch)
            continue
        if knob == "SERVING_MESH":
            made = not torch.distributed.is_initialized()
            try:
                caplog.clear()
                got = _port(env)
                fell_back = [r.getMessage() for r in caplog.records
                             if r.name.startswith("operator_tpu_torch")
                             and "falling back to the wave engine" in r.getMessage()]
                assert len(fell_back) == (mode == "continuous"), fell_back
                if fell_back:
                    assert "mesh=True" in fell_back[0]
                # JAX's auto would plan its eight virtual devices: its
                # one-device mesh is dp=1,tp=1
                assert got == _jax({**env, knob: "dp=1,tp=1"}, monkeypatch)
                with pytest.raises(ValueError, match=item):
                    build_serving_engine("cpu", {**env, knob: "tp=2"})
            finally:
                if made and torch.distributed.is_initialized():
                    torch.distributed.destroy_process_group()
            continue
        if item is None:
            engine, _ = build_serving_engine("cpu", env)
            try:
                assert engine.generator.prefill_chunk == int(value)
            finally:
                engine.close()
            # the chunk reaches a contiguous engine too
            engine, _ = build_serving_engine("cpu", {**env, "KV_CACHE_MODE": "contiguous"})
            try:
                g = engine.generator
                assert g.prefill_chunk == int(value) and not g.paged
            finally:
                engine.close()
            continue
        with pytest.raises(NotImplementedError, match=item) as info:
            build_serving_engine("cpu", env)
        assert knob in str(info.value)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_aot_cache_path_resolves_as_the_jax_package(mode, tmp_path, monkeypatch):
    """``AOT_CACHE_PATH`` gives the generator an ``AotCache`` under the
    path, keyed by a fingerprint payload with the JAX provider's keys and
    its values for every engine-shaping knob (the model's dataclass and
    the runtime facts are each package's own)."""
    env = {**BASE, "SCHED_MODE": mode, "AOT_CACHE_PATH": str(tmp_path / "aot")}
    engine, _ = build_serving_engine("cpu", env)
    try:
        aot = engine.generator._aot
        assert aot is not None and aot.dir.startswith(str(tmp_path / "aot"))
        assert aot.metrics is engine.generator.metrics
        payload = aot.payload
    finally:
        engine.close()
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jax_engine, _ = jax_provider.build_serving_engine(JaxOperatorConfig.from_env(env))
    want = jax_engine.generator._aot.payload
    assert set(payload) == set(want)
    for key in set(want) - {"model", "runtime"}:
        assert payload[key] == want[key], key
    assert payload["model"]["name"] == want["model"]["name"]


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


#: a root cause shaped like the card drive's (kept short for tiny-test)
_CAUSE = {"type": "object", "properties": {
    "reason": {"enum": ["OOMKilled", "Error"]}, "confidence": {"type": "integer"}},
    "required": ["reason", "confidence"]}

_EXTRAS = [
    {"lora_adapter": "incident"},
    {"guided_regex": r"exit code [0-9]{1,3}"},
    {"guided_json": json.dumps(_CAUSE)},
    {"guided_json": _CAUSE, "lora_adapter": "incident"},
    {"guided_regex": "x" * 1025},
    {"guided_regex": "a", "guided_json": json.dumps(_CAUSE)},
    {"guided_json": '{"type": "object"}'},
    {"lora_adapter": "nope"},
]


def test_provider_serves_guided_and_lora_configs_as_the_jax_provider():
    """Once a refusal naming ROADMAP item 9, now the parity of the
    AIProvider's three ``additionalConfig`` keys with the JAX
    ``TPUNativeProvider`` on one wave engine's weights and adapters:
    ``lora_adapter`` selects an adapter, ``guided_regex`` and
    ``guided_json`` (text or an object) constrain the explanation, and a
    long pattern, both keys at once, a schema that cannot be lowered and
    an unknown adapter answer the same errors."""
    import jax.numpy as jnp

    from operator_tpu.models import init_params as jax_init_params
    from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
    from operator_tpu.parallel import init_lora as jax_init_lora
    from operator_tpu.serving.engine import BatchedGenerator
    from operator_tpu.serving.engine import ServingEngine as JaxServingEngine
    from operator_tpu.serving.provider import TPUNativeProvider as JaxProvider
    from operator_tpu_torch.models import ByteTokenizer, params_from_jax
    from operator_tpu_torch.serving.engine import Generator, ServingEngine
    from operator_tpu_torch.serving.provider import TPUNativeProvider

    jax_params = jax_init_params(jax_configs.TINY_TEST, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    base = jax_init_lora(jax_configs.TINY_TEST, jax.random.PRNGKey(1), rank=4,
                         dtype=jnp.float32)
    jax_adapter = {n: {"a": f["a"], "b": jax.random.normal(
        jax.random.PRNGKey(7), f["b"].shape, jnp.float32) * 0.2} for n, f in base.items()}

    def port(tree):
        return params_from_jax(jax.tree_util.tree_map(np.array, tree))

    shape = {"max_slots": 2, "max_seq": 256, "page_size": 16, "decode_block": 2}
    port_engine = ServingEngine(Generator(
        port(jax_params), configs.TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
        device="cpu", lora_adapters={"incident": port(jax_adapter)}, **shape))
    ours = TPUNativeProvider(port_engine, model_id="tiny-test",
                             register_template_prefixes=False)
    ref = JaxProvider(JaxServingEngine(BatchedGenerator(
        jax_params, jax_configs.TINY_TEST, JaxByteTokenizer(), paged=True,
        cache_dtype=jnp.float32, lora_adapters={"incident": jax_adapter}, **shape),
        admission_wait_s=0.005), model_id="tiny-test", register_template_prefixes=False)

    async def both():
        answers = []
        for extra in _EXTRAS:
            request = jax_analysis.AnalysisRequest.parse({"providerConfig": {
                "maxTokens": 64, "temperature": 0.0, "additionalConfig": extra}})
            answers.append((await ours.generate(_port_request(request)),
                            await ref.generate(request)))
        await ref.engine.close()
        return answers

    try:
        answers = asyncio.run(both())
    finally:
        port_engine.close()
    for extra, (got, want) in zip(_EXTRAS, answers):
        assert got.to_dict() == want.to_dict(), extra
    texts = [got.explanation for got, _ in answers]
    assert re.fullmatch(r"exit code [0-9]{1,3}", texts[1])
    assert json.loads(texts[2])["reason"] in ("OOMKilled", "Error")
    assert json.loads(texts[3])["reason"] in ("OOMKilled", "Error")
    errors = [got.error for got, _ in answers[4:]]
    assert errors[0] == "additionalConfig.guided_regex must be a string of <=1024 chars"
    assert "mutually exclusive" in errors[1] and "guided_json" in errors[2]
    assert "unknown LoRA adapter 'nope'" in errors[3]


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
