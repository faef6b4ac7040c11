"""The PyTorch port's serving engine against the JAX continuous scheduler.

Greedy token ids of ``operator_tpu_torch``'s ``ServingEngine`` on the CPU
(plain attention) must be byte-identical to the JAX ``BatchedGenerator`` +
``Scheduler`` on the same ``TINY_TEST`` f32 weights, solo and co-batched,
at pipeline depth 1 and 2, with prompt-lookup speculation on and off.
Also: no slot or page leaks, the HTTP front answers, and the port imports
nothing of JAX or of the JAX package.
"""

import ast
import asyncio
import contextlib
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.httpserver import CompletionServer  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.device import resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: what neither the port nor ``chip_smoke.py`` may import: the port
#: depends on PyTorch alone and keeps its own copies
FORBIDDEN = ("jax", "jaxlib", "operator_tpu", "safetensors", "transformers", "tokenizers",
             "ml_dtypes")

PROMPTS = [
    "pod crashed with exit code 137",
    "a much longer prompt " * 8,  # chunked over several steps
    "OOMKilled OOMKilled OOMKilled",  # repeated n-grams: drafts get proposed
]
MAX_TOKENS = 10


@contextlib.contextmanager
def event_loop_thread():
    """An event loop on a thread of its own; yields ``run(coro,
    timeout)``, which runs a coroutine there and waits for its result."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    try:
        yield run
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


@contextlib.contextmanager
def serving(server):
    """Run a port ``CompletionServer`` (asyncio ``start``/``stop``) on a
    loop thread of its own while the test talks to it over urllib; the
    engine closes with it."""
    try:
        with event_loop_thread() as run:
            run(server.start())
            try:
                yield run
            finally:
                run(server.stop())
    finally:
        server.engine.close()


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _drive(sched, sampling):
    """Enqueue every prompt, step the scheduler until all finish; returns
    the greedy ids per prompt and the plan trace of every step.  Both
    packages' schedulers take the same calls."""
    sched.plan_log = []
    ids = {sched.enqueue(p, sampling): p for p in PROMPTS}
    done = {}
    for _ in range(300):
        for outcome in sched.step():
            done[outcome.req_id] = outcome
        if len(done) == len(ids):
            break
    return {ids[r]: done[r].result.token_ids for r in ids}, sched.plan_log


@pytest.fixture(scope="module")
def jax_reference(jax_params):
    """JAX (tokens, plan trace) per (depth, spec): co-batched runs of all
    prompts.  The JAX scheduler's own tests hold co-batched == solo, so
    the solo cases of the port compare against these tokens too."""
    cache = {}

    def get(depth, spec):
        if (depth, spec) not in cache:
            generator = BatchedGenerator(
                jax_params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
                cache_dtype=jnp.float32, metrics=MetricsRegistry(),
                max_slots=4, max_seq=128, page_size=16,
            )
            sched = JaxScheduler(
                generator, chunk=16, token_budget=32, pipeline_depth=depth,
                spec_decode=spec,
            )
            cache[(depth, spec)] = _drive(
                sched, JaxSamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
            )
        return cache[(depth, spec)]

    return get


def _engine(torch_params, depth, spec):
    generator = Generator(
        torch_params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=128,
        page_size=16, cache_dtype=torch.float32, device="cpu",
    )
    sched = Scheduler(
        generator, chunk=16, token_budget=32, pipeline_depth=depth,
        spec_decode=spec,
    )
    return ServingEngine(generator, sched)


def _assert_no_leaks(engine):
    generator = engine.generator
    assert len(generator.free_slots()) == generator.max_slots
    assert generator.allocator.available == generator.allocator.num_pages - 1
    accounting = engine.scheduler.page_accounting()
    assert accounting["row_pages"] == 0
    assert accounting["available"] == accounting["total"]


@pytest.mark.parametrize("mode", ["solo", "cobatched"])
@pytest.mark.parametrize("depth,spec", [(1, False), (2, False), (1, True), (2, True)])
def test_greedy_tokens_match_jax_scheduler(torch_params, jax_reference, mode, depth, spec):
    want, _ = jax_reference(depth, spec)
    engine = _engine(torch_params, depth, spec)
    sampling = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
    try:
        if mode == "solo":
            got = {p: engine.generate_batch([p], sampling)[0].token_ids for p in PROMPTS}
        else:
            results = engine.generate_batch(PROMPTS, sampling)
            got = {p: r.token_ids for p, r in zip(PROMPTS, results)}
        for prompt in PROMPTS:
            assert got[prompt] == want[prompt], prompt
        _assert_no_leaks(engine)
        if spec:
            assert engine.scheduler.stats()["spec_decode"]["verify_rounds"] > 0
    finally:
        engine.close()


@pytest.mark.parametrize("depth,spec", [(1, False), (2, True)])
def test_scheduler_plans_match_jax(torch_params, jax_reference, depth, spec):
    """Step by step, the port's scheduler plans the same ragged waves as
    the JAX one: every row's slot, flat offset, token count, kind,
    position, drafts and chaining."""
    want_tokens, want_plans = jax_reference(depth, spec)
    engine = _engine(torch_params, depth, spec)
    try:
        tokens, plans = _drive(
            engine.scheduler, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0)
        )
        _assert_no_leaks(engine)
    finally:
        engine.close()
    assert len(plans) == len(want_plans) > 0
    assert plans == want_plans
    assert tokens == want_tokens


def test_sampled_requests_finish_without_leaks(torch_params):
    engine = _engine(torch_params, 2, True)
    try:
        results = engine.generate_batch(
            PROMPTS, SamplingParams(max_tokens=MAX_TOKENS, temperature=0.8, top_p=0.9)
        )
        for result in results:
            assert 1 <= len(result.token_ids) <= MAX_TOKENS
            assert all(0 <= t < TINY_TEST.vocab_size for t in result.token_ids)
        _assert_no_leaks(engine)
    finally:
        engine.close()


def test_http_server_answers_healthz_and_completions(torch_params):
    engine = _engine(torch_params, 2, True)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    with serving(server):
        base = f"http://127.0.0.1:{server.bound_port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok"
        assert {"queueDepth", "inflight", "gaveUp"} <= set(health["load"])
        body = json.dumps({
            "prompt": ["pod crashed", "OOMKilled"], "max_tokens": 6,
            "temperature": 0.0,
        }).encode()
        request = urllib.request.Request(
            f"{base}/v1/completions", data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(request, timeout=60) as resp:
            payload = json.loads(resp.read())
        assert payload["object"] == "text_completion"
        assert [c["index"] for c in payload["choices"]] == [0, 1]
        assert payload["usage"]["completion_tokens"] > 0
        assert payload["usage"]["total_tokens"] == (
            payload["usage"]["prompt_tokens"] + payload["usage"]["completion_tokens"]
        )


def _post_status(url, body):
    request = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(request, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("extra,status,needle", [
    ({"model": "tiny-test"}, 200, None),
    ({"model": "no-such-model"}, 404, "no-such-model"),
    ({"model": "an-adapter"}, 404, "not found"),
    ({"guided_choice": ["yes", "no"]}, 400, "item 9"),
    ({"guided_regex": "[a-z]+"}, 400, "item 9"),
    ({"guided_json": {"type": "object"}}, 400, "item 9"),
    ({"response_format": {"type": "json_schema", "json_schema": {"schema": {}}}}, 400, "item 9"),
    ({"response_format": {"type": "json_object"}}, 400, "item 9"),
    ({"response_format": {"type": "text"}}, 200, None),
])
def test_http_server_answers_model_and_guided_fields_as_the_reference(
    torch_params, extra, status, needle
):
    """An unknown ``model`` is a 404 (the reference's ``_resolve_adapter``);
    guided decoding is not ported, so its fields are refused, naming the
    ROADMAP item, instead of answered with unconstrained text."""
    engine = _engine(torch_params, 1, False)
    server = CompletionServer(engine, model_id="tiny-test", host="127.0.0.1", port=0)
    with serving(server):
        code, payload = _post_status(
            f"http://127.0.0.1:{server.bound_port}/v1/completions",
            {"prompt": "pod crashed", "max_tokens": 3, "temperature": 0.0, **extra},
        )
        assert code == status, payload
        if status == 200:
            assert payload["model"] == "tiny-test"
            assert payload["usage"]["completion_tokens"] > 0
        else:
            assert needle in payload["error"]["message"]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import operator_tpu_torch, operator_tpu_torch.serving.engine\n"
        "import operator_tpu_torch.serving.httpserver, operator_tpu_torch.serving.provider\n"
        "import operator_tpu_torch.serving.sched.mixed, operator_tpu_torch.ops._build\n"
        "import operator_tpu_torch.serving.admission, operator_tpu_torch.serving.programs\n"
        "import operator_tpu_torch.ops.flash_prefill, operator_tpu_torch.ops.paged_attention\n"
        "import operator_tpu_torch.models.llama, operator_tpu_torch.models.encoder\n"
        "import operator_tpu_torch.ops.similarity, operator_tpu_torch.schema\n"
        "import operator_tpu_torch.patterns.engine, operator_tpu_torch.patterns.semantic\n"
        "import operator_tpu_torch.patterns.loader, operator_tpu_torch.patterns.windows\n"
        "import operator_tpu_torch.patterns.matcher, operator_tpu_torch.patterns.prefilter\n"
        "import operator_tpu_torch.memory.index, operator_tpu_torch.memory.fingerprint\n"
        "import operator_tpu_torch.memory.store, operator_tpu_torch.native\n"
        "import operator_tpu_torch.utils.config, operator_tpu_torch.utils.timing\n"
        "import operator_tpu_torch.utils.deadline, operator_tpu_torch.serving.kvstore\n"
        "import operator_tpu_torch.ops.kv_transfer, operator_tpu_torch.router.value\n"
        "import operator_tpu_torch.obs.steptrace, operator_tpu_torch.serving.perf\n"
        "import operator_tpu_torch.models.loader, operator_tpu_torch.models.tokenizer\n"
        "import operator_tpu_torch.models.bpe, operator_tpu_torch.models.wordpiece\n"
        "import operator_tpu_torch.obs.span, operator_tpu_torch.serving.prompts\n"
        "import operator_tpu_torch.serving.templates, operator_tpu_torch.models.quant\n"
        "operator_tpu_torch.patterns.loader.load_builtin_library()\n"
        "operator_tpu_torch.models.tokenizer.load_tokenizer('tests/torch_tokenizers/llama_sp')\n"
        "operator_tpu_torch.models.bpe.load_builtin_bpe()\n"
        "import operator_tpu_torch.operator, operator_tpu_torch.operator.app\n"
        "import operator_tpu_torch.obs.record, operator_tpu_torch.obs.sloledger\n"
        "import operator_tpu_torch.memory.recall, operator_tpu_torch.router.health\n"
        "import operator_tpu_torch.utils.journal, operator_tpu_torch.schema.crds\n"
        "import importlib, pkgutil, asyncio\n"
        "for info in pkgutil.walk_packages(operator_tpu_torch.__path__, 'operator_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "asyncio.run(operator_tpu_torch.operator.app.run_demo(device='cpu'))\n"
        f"roots = {sorted(FORBIDDEN)!r}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _forbidden_imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in FORBIDDEN:
                found.append(f"{path.relative_to(REPO)}: {name}")
    return found


def test_no_jax_import_in_port_sources():
    files = sorted((REPO / "operator_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [hit for path in files for hit in _forbidden_imports(path)]
    assert not bad, bad


def test_resolve_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
