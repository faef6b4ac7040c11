"""The port's fault-injection harness (``utils/faultinject.py``) against
the JAX package's, at every seam the port consults it:

- the plan itself: ``rule`` with ``after``/``match``, ``times``,
  ``bernoulli`` and ``jitter`` drawn from ``random.Random(seed)``,
  ``apply``/``apply_async`` and their returned delays, ``pending``;
- ``FakeKubeApi``: ``kube.<op>`` (the scale subresource's too),
  ``kube.watch_open.<kind>`` and ``kube.watch.<kind>``;
- ``engine.step`` on the wave generator and on the continuous scheduler,
  a simulated device error mid-drive;
- the pipeline's black-box dump, which names the api seam's plan (seed,
  fired count, fingerprint).

The git seam is held in ``test_torch_patternsync.py``, ``http.provider``
and ``router.dispatch`` in ``test_torch_router.py``.  For the same seed
and the same calls, ``trace()``, ``fingerprint()`` and ``pending()`` equal
JAX's exactly.
"""

import asyncio
import importlib
import urllib.error
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_operator import normalise  # noqa: E402

_MODULES = ("memory", "obs.record", "obs.span", "operator.kubeapi", "operator.pipeline",
            "operator.providers", "patterns.engine", "schema", "utils.config",
            "utils.faultinject", "utils.timing")


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    port = root == "operator_tpu_torch"
    return SimpleNamespace(name="port" if port else "jax", device={"device": "cpu"} if port else {},
                           **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


def run(coro):
    return asyncio.run(coro)


def _plan_record(plan) -> dict:
    return {"trace": plan.trace(), "fingerprint": plan.fingerprint(), "pending": plan.pending()}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _unit(pkg, seed: int) -> dict:
    fi = pkg.utils_faultinject
    plan = fi.FaultPlan(seed=seed)
    plan.rule("kube.*", plan.bernoulli(6, 0.5, fi.raise_(lambda: RuntimeError("coin"), "coin")))
    plan.rule("http.provider", plan.jitter(3, 0.01, 0.2), after=1)
    plan.rule("engine.step", [fi.OK, fi.sleep_(0.0), fi.delay_(0.125)],
              match=lambda active: active > 1)
    plan.rule("git.clone", fi.times(2, fi.raise_(lambda: OSError("disk"), "")))
    plan.rule("never.*", fi.times(4, fi.OK))
    calls = [("kube.get", {"kind": "Pod"}), ("kube.patch", {"kind": "Pod"})] * 4 + [
        ("http.provider", {"attempt": i}) for i in range(5)] + [
        ("engine.step", {"active": a}) for a in (1, 2, 3, 2, 2)] + [
        ("git.clone", {})] * 3
    outcomes = []
    for site, ctx in calls:
        try:
            outcomes.append(["ok", plan.apply(site, **ctx)])
        except Exception as exc:  # noqa: BLE001 - the outcome is the observation
            outcomes.append([type(exc).__name__, str(exc)])

    async def async_calls():
        for site in ("http.provider", "kube.delete"):
            try:
                await plan.apply_async(site, attempt=9, kind="Pod")
                outcomes.append(["async-ok", site])
            except Exception as exc:  # noqa: BLE001
                outcomes.append([type(exc).__name__, site])

    run(async_calls())
    return {"outcomes": outcomes, "reprs": [repr(a) for a in (fi.OK, fi.sleep_(0.5),
                                                             fi.delay_(1 / 3))],
            **_plan_record(plan)}


@pytest.mark.parametrize("seed", [0, 1, 21, 12345])
def test_plan_draws_and_traces_as_jax(seed):
    ref, port = (_unit(PKGS[name], seed) for name in ("jax", "port"))
    assert port == ref
    assert port["trace"] and port["pending"]["never.*"] == 4


# ---------------------------------------------------------------------------
# the fake apiserver
# ---------------------------------------------------------------------------


async def _kube_seams(pkg, seed: int) -> dict:
    K, fi, s = pkg.operator_kubeapi, pkg.utils_faultinject, pkg.schema
    api = K.FakeKubeApi()
    plan = fi.FaultPlan(seed=seed)
    plan.rule("kube.patch_status", fi.times(2, fi.raise_(lambda: K.ConflictError("storm"), "409")),
              match=lambda kind, name: kind == "Podmortem")
    plan.rule("kube.get", [fi.OK, fi.raise_(lambda: K.ApiError("blip", 503), "503")], after=1)
    plan.rule("kube.get_scale", plan.jitter(2, 0.001, 0.002))
    plan.rule("kube.patch_scale", fi.raise_(lambda: K.ApiError("partitioned"), "partition"),
              match=lambda kind, name: kind == "Deployment")
    plan.rule("kube.watch_open.Pod", fi.raise_(lambda: K.WatchExpired("410"), "410"), after=1)
    plan.rule("kube.watch.Pod", fi.raise_(lambda: K.WatchClosed("dropped"), "drop"), after=2)
    await api.create_obj(s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="ns")))
    await api.create_obj(s.Deployment(metadata=s.ObjectMeta(name="d", namespace="ns"),
                                      spec=s.DeploymentSpec(replicas=1)))
    api.fault_plan = plan
    out = []

    async def attempt(coro):
        try:
            result = await coro
            out.append(["ok", (result or {}).get("kind") if isinstance(result, dict) else None])
        except Exception as exc:  # noqa: BLE001 - the outcome is the observation
            out.append([type(exc).__name__, str(exc)])

    for _ in range(3):
        await attempt(api.patch_status("Podmortem", "pm", "ns", {"phase": "x"}))
    for _ in range(4):
        await attempt(api.get("Podmortem", "pm", "ns"))
    for _ in range(2):
        await attempt(api.get_scale("Deployment", "d", "ns"))
    for _ in range(2):
        await attempt(api.patch_scale("Deployment", "d", "ns", 2))
    _, cursor = await api.list_rv("Pod", "prod")
    for i in range(3):
        await api.create("Pod", {"metadata": {"name": f"p{i}", "namespace": "prod"}})

    async def consume(resource_version):
        seen = []
        try:
            async for event in api.watch("Pod", "prod", resource_version=resource_version):
                seen.append([event.type, event.object["metadata"]["name"]])
        except Exception as exc:  # noqa: BLE001 - the stream's end is the observation
            seen.append(type(exc).__name__)
        return seen

    out.append(await consume(cursor))
    out.append(await consume(cursor))
    api.fault_plan = None
    return {"out": out, **_plan_record(plan)}


@pytest.mark.parametrize("seed", [3, 21])
def test_kube_seams_trace_as_jax(seed):
    ref, port = (normalise(run(_kube_seams(PKGS[name], seed))) for name in ("jax", "port"))
    assert port == ref
    assert port["pending"] == {}
    sites = [site for site, _, _ in port["trace"]]
    assert {"kube.patch_status", "kube.get", "kube.get_scale", "kube.patch_scale",
            "kube.watch_open.Pod", "kube.watch.Pod"} <= set(sites)
    assert port["out"][-2] == [["ADDED", "p0"], ["ADDED", "p1"], "WatchClosed"]
    assert port["out"][-1] == ["WatchExpired"]


# ---------------------------------------------------------------------------
# engine.step
# ---------------------------------------------------------------------------


PROMPTS = ["pod crashed with exit code 137", "a much longer prompt " * 5, "OOMKilled OOMKilled"]


@pytest.fixture(scope="module")
def params():
    from operator_tpu.models import TINY_TEST as JAX_TINY_TEST
    from operator_tpu.models import init_params as jax_init_params
    from operator_tpu_torch.models import params_from_jax

    jax_params = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    return {"jax": jax_params,
            "port": params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))}


def _generator(name, params, **kw):
    shape = dict(max_slots=4, max_seq=128, page_size=16, **kw)
    if name == "jax":
        from operator_tpu.models import TINY_TEST
        from operator_tpu.models.tokenizer import ByteTokenizer
        from operator_tpu.serving.engine import BatchedGenerator
        from operator_tpu.utils.timing import MetricsRegistry

        return BatchedGenerator(params, TINY_TEST, ByteTokenizer(), paged=True,
                                cache_dtype=jnp.float32, metrics=MetricsRegistry(), **shape)
    from operator_tpu_torch.models import TINY_TEST, ByteTokenizer
    from operator_tpu_torch.serving.engine import Generator

    return Generator(params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
                     device="cpu", **shape)


def _sampling(name):
    if name == "jax":
        from operator_tpu.serving.engine import SamplingParams
    else:
        from operator_tpu_torch.serving.types import SamplingParams
    return SamplingParams(max_tokens=8, temperature=0.0)


def _step_plan(name, fail_at: int):
    fi = PKGS[name].utils_faultinject
    plan = fi.FaultPlan(seed=fail_at)
    plan.rule("engine.step", fi.times(fail_at, fi.OK) + [
        fi.raise_(lambda: RuntimeError("simulated device error"), "device")],
        match=lambda active: active >= 1)
    return plan


def _drive_wave(name, params, fail_at: int) -> dict:
    generator = _generator(name, params, decode_block=2, pipeline_depth=1)
    plan = _step_plan(name, fail_at)
    generator.fault_plan = plan
    slots = generator.admit(PROMPTS, [_sampling(name)] * len(PROMPTS))
    finished, error = {}, None
    for _ in range(200):
        try:
            for slot, result in generator.step():
                finished[slot] = result.token_ids
        except RuntimeError as exc:
            error = str(exc)
            break
        if len(finished) == len(slots):
            break
    return {"finished": finished, "error": error, **_plan_record(plan)}


def _drive_scheduler(name, params, fail_at: int) -> dict:
    if name == "jax":
        from operator_tpu.serving.sched import Scheduler
    else:
        from operator_tpu_torch.serving.sched import Scheduler
    generator = _generator(name, params)
    plan = _step_plan(name, fail_at)
    generator.fault_plan = plan
    sched = Scheduler(generator, chunk=16, token_budget=32, pipeline_depth=1)
    ids = [sched.enqueue(p, _sampling(name)) for p in PROMPTS]
    finished, error = {}, None
    for _ in range(300):
        try:
            for outcome in sched.step():
                finished[ids.index(outcome.req_id)] = outcome.result.token_ids
        except RuntimeError as exc:
            error = str(exc)
            break
        if len(finished) == len(ids):
            break
    return {"finished": finished, "error": error, **_plan_record(plan)}


@pytest.mark.parametrize("loop", ["wave", "continuous"])
@pytest.mark.parametrize("fail_at", [2, 1000])
def test_engine_step_seam_traces_as_jax(params, loop, fail_at):
    drive = _drive_wave if loop == "wave" else _drive_scheduler
    ref, port = (drive(name, params[name], fail_at) for name in ("jax", "port"))
    assert port == ref
    if fail_at == 2:
        assert port["error"] == "simulated device error"
        # the continuous loop's first step plans with no row active yet:
        # the rule's match skips it, so its per-site index starts at 1
        assert [(site, action) for site, _, action in port["trace"]] == [
            ("engine.step", "<ok:ok>"), ("engine.step", "<ok:ok>"),
            ("engine.step", "<raise:device>")]
    else:
        assert port["error"] is None and len(port["finished"]) == len(PROMPTS)
        steps = len(port["trace"])
        assert {(site, action) for site, _, action in port["trace"]} == {
            ("engine.step", "<ok:ok>")}
        assert port["pending"] == {"engine.step": 1001 - steps}


# ---------------------------------------------------------------------------
# the pipeline's black box
# ---------------------------------------------------------------------------


def _failing_opener(req, timeout=None):  # pragma: no cover - never reached
    raise AssertionError("the fault plan fires before the transport")


async def _deadline_exceeded(pkg, seed: int) -> dict:
    s, fi = pkg.schema, pkg.utils_faultinject
    plan = fi.FaultPlan(seed=seed)
    plan.rule("http.provider", fi.times(
        6, fi.raise_(lambda: urllib.error.URLError("injected backend down"), "down")))
    api = pkg.operator_kubeapi.FakeKubeApi()
    api.fault_plan = plan
    config = pkg.utils_config.OperatorConfig(pattern_cache_directory="/nonexistent")
    metrics = pkg.utils_timing.MetricsRegistry()
    recorder = pkg.obs_record.FlightRecorder(metrics=metrics)
    providers = pkg.operator_providers.default_registry()
    backend = pkg.operator_providers.OpenAICompatProvider(opener=_failing_opener)
    backend.fault_plan = plan
    providers.register("openai", backend)
    pipeline = pkg.operator_pipeline.AnalysisPipeline(
        api, pkg.patterns_engine.PatternEngine(), config=config, metrics=metrics,
        providers=providers, tracer=pkg.obs_span.Tracer(recorder=recorder),
        memory=pkg.memory.build_incident_memory(config, **pkg.device))
    await api.create_obj(s.AIProvider(
        metadata=s.ObjectMeta(name="ai", namespace="prod"),
        spec=s.AIProviderSpec(provider_id="openai", api_url="http://backend", model_id="m",
                              timeout_seconds=1)))
    podmortem = s.Podmortem(metadata=s.ObjectMeta(name="pm", namespace="prod"), spec=s.PodmortemSpec(
        pod_selector=s.LabelSelector(match_labels={"app": "web"}),
        ai_provider_ref=s.AIProviderRef(name="ai", namespace="prod"), analysis_deadline="1"))
    await api.create_obj(podmortem)
    pod = s.Pod(metadata=s.ObjectMeta(name="web-1", namespace="prod", labels={"app": "web"}),
                status=s.PodStatus(phase="Running", container_statuses=[s.ContainerStatus(
                    name="app", restart_count=1, state=s.ContainerState(
                        terminated=s.ContainerStateTerminated(
                            exit_code=1, finished_at="2026-07-28T09:00:00Z")))]))
    await api.create_obj(pod)
    api.set_pod_log("prod", "web-1", "java.lang.OutOfMemoryError: Java heap space\n")
    await pipeline.process_pod_failure(pod, podmortem, failure_time="2026-07-28T09:00:00Z")
    entry = (await api.get("Podmortem", "pm", "prod"))["status"]["recentFailures"][0]
    record = recorder.get(entry["traceId"])
    pipeline.claims.close()
    return {"status": entry["analysisStatus"], "blackbox": record.blackbox,
            "reason": record.reason, "extra": record.extra,
            "plan_at_dump": plan, "trace": plan.trace()}


def test_black_box_names_the_api_seams_plan_as_jax():
    """A deadline-exceeded analysis under a seeded plan: the dump's
    ``fault_plan`` entry carries the seed, and a fired count and
    fingerprint that match the plan's own trace at the dump."""
    out = {}
    for name in ("jax", "port"):
        result = run(_deadline_exceeded(PKGS[name], 7))
        plan_info = result["extra"]["fault_plan"]
        fired = plan_info["fired"]
        assert 0 < fired <= len(result["trace"])
        prefix = PKGS[name].utils_faultinject.FaultPlan(seed=7)
        prefix._trace = result["trace"][:fired]
        assert plan_info["fingerprint"] == prefix.fingerprint()
        assert set(result["trace"]) <= {("http.provider", i, "<raise:down>") for i in range(6)}
        out[name] = {"status": result["status"], "blackbox": result["blackbox"],
                     "reason": result["reason"], "seed": plan_info["seed"],
                     "deadline_total_s": result["extra"]["deadline"]["total_s"]}
    assert out["port"] == out["jax"] == {"status": "deadline-exceeded", "blackbox": True,
                                         "reason": "deadline-exceeded", "seed": 7,
                                         "deadline_total_s": 1.0}
