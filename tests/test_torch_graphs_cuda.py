"""The serving programs as CUDA graphs, on the card (``serving/graphs.py``).

Each program replayed from its captured graph gives what its eager
function gives on the same inputs: the continuous scheduler's mixed step,
the wave engine's plain, guided and LoRA decode blocks and its prefill
buckets, and the analysis encoder's bucket.  A replay makes no host sync
(PyTorch's sync debug mode set to error); the kernels' launch counts stay
exact under replay; sampled rows draw anew on every replay from their
distribution; a reset captures nothing again, unless it runs under a
worker still wedged, which leaves with the old graphs and pool.  A small int8 engine
(``TINY_TEST``, bf16 activations).  Skips without a card (``cuda``
marker); this file imports no JAX::

    python -m pytest tests/test_torch_graphs_cuda.py -q
"""

import gc
import importlib
import time

import pytest

torch = pytest.importorskip("torch")

from operator_tpu_torch.models import (  # noqa: E402
    ENCODER_TINY_TEST,
    TINY_TEST,
    ByteTokenizer,
    encode,
    init_encoder_params,
    init_params,
)
from operator_tpu_torch.ops import flash_prefill, ragged_attention  # noqa: E402

# the module: the package's ``paged_attention`` is the function, as in JAX
paged_attention = importlib.import_module("operator_tpu_torch.ops.paged_attention")
from operator_tpu_torch.parallel.lora import init_lora  # noqa: E402
from operator_tpu_torch.patterns.semantic import NeuralEmbedder  # noqa: E402
from operator_tpu_torch.serving.engine import (  # noqa: E402
    Generator,
    ServingEngine,
    SupervisorPolicy,
)
from operator_tpu_torch.serving.graphs import GraphSet  # noqa: E402
from operator_tpu_torch.serving.sampling import sample  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.faultinject import OK, FaultPlan, sleep_  # noqa: E402

PROMPTS = ["pod crashed", "exit code 137 " * 6, "OOMKilled " * 20, "x"]
GREEDY = SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _params():
    gen = torch.Generator(device="cuda").manual_seed(0)
    return init_params(TINY_TEST, gen, torch.bfloat16, device="cuda", quantize=True)


def _adapters(gen):
    adapters = {}
    for name in ("incident", "verbose"):
        adapter = init_lora(TINY_TEST, gen, rank=8, device="cuda")
        for factors in adapter.values():
            factors["b"] = (torch.randn(factors["b"].shape, generator=gen, device="cuda")
                            * 0.2).to(torch.bfloat16)
        adapters[name] = adapter
    return adapters


def _generator(params, **kw):
    return Generator(params, TINY_TEST, ByteTokenizer(), max_slots=4, max_seq=256,
                     page_size=16, decode_block=4, pipeline_depth=2, device="cuda", **kw)


def _eager(g):
    """The same generator's programs, un-captured: the raw functions."""

    def prefill(*args, key=None, variant=None):
        return g._prefill(*args)

    g._prefill_program = prefill

    def decode(*args, key=None):
        return g._decode_block_paged(*args)

    g._decode_program = g._decode_guided_program = decode
    return g


def _drain(g, waves):
    out = []
    for prompts, params in waves:
        slots = g.admit(prompts, params)
        results = {}
        while g.num_active or g._inflight_blocks:
            for slot, result in g.step():
                results[slot] = result.token_ids
        out.append([results[s] for s in slots])
    return out


def _sched_drive(sched, prompts, params):
    ids = [sched.enqueue(p, params) for p in prompts]
    results = {}
    while len(results) < len(ids):
        for outcome in sched.step():
            assert outcome.error is None, outcome.error
            results[outcome.req_id] = outcome.result.token_ids
    return [results[i] for i in ids]


@pytest.mark.cuda
def test_mixed_step_replays_as_the_eager_step(cuda):
    params = _params()
    runs = {}
    for mode in ("graph", "eager"):
        g = _generator(params)
        sched = Scheduler(g, chunk=32, pipeline_depth=2, spec_decode=True)
        if mode == "eager":
            step = sched._mixed_fn()
            sched._fn = lambda *args, key=None: step(*args)
        ragged_attention.launches = 0
        runs[mode] = _sched_drive(sched, PROMPTS, GREEDY)
        steps = sched.steps
        assert ragged_attention.launches == TINY_TEST.num_layers * steps
        if mode == "graph":
            assert g.graphs.captures == 1 and g.graphs.replays == steps - 1
            # the replay syncs nothing
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                sched.enqueue("one more", GREEDY)
                sched._inflight.append(sched._dispatch(sched._schedule([])))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    assert runs["graph"] == runs["eager"]


@pytest.mark.cuda
@pytest.mark.parametrize("flash", ["0", "1"])
def test_wave_blocks_and_prefill_buckets_replay_as_eager(cuda, flash, monkeypatch):
    monkeypatch.setenv("OPERATOR_TPU_FLASH_PREFILL", flash)
    params = _params()
    gen = torch.Generator(device="cuda").manual_seed(1)
    adapters = _adapters(gen)
    choice = dict(guided_choice=("CrashLoopBackOff", "OOMKilled"))
    waves = [
        (PROMPTS[:2], [GREEDY] * 2),                       # plain
        (PROMPTS[:2], [GREEDY] * 2),                       # the same bucket: replay
        (PROMPTS[2:], [SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False,
                                      adapter="incident"),
                       SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False,
                                      **choice)]),           # adapted + guided
        (PROMPTS[2:], [SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False,
                                      adapter="verbose", **choice)] * 2),
    ]
    runs, counts = {}, {}
    for mode in ("graph", "eager"):
        g = _generator(params, lora_adapters=adapters)
        if mode == "eager":
            _eager(g)
        paged_attention.launches = flash_prefill.launches = 0
        runs[mode] = _drain(g, waves)
        counts[mode] = (paged_attention.launches, flash_prefill.launches, g.blocks_dispatched,
                        g.prefill_waves)
        if mode == "graph":
            assert g._decode_program.keys() and g._decode_guided_program.keys()
            assert g.graphs.replays > 0
    assert runs["graph"] == runs["eager"]
    assert counts["graph"] == counts["eager"]
    k2, k4, blocks, waves_run = counts["graph"]
    assert k2 == TINY_TEST.num_layers * 4 * blocks
    assert (k4 > 0) == (flash == "1") and k4 % TINY_TEST.num_layers == 0


@pytest.mark.cuda
def test_reset_captures_nothing_again(cuda):
    g = _generator(_params())
    wave = [(PROMPTS[:2], [GREEDY] * 2)]
    first = _drain(g, wave)
    captures = g.graphs.captures
    g.reset()
    assert _drain(g, wave) == first
    assert g.graphs.captures == captures


@pytest.mark.cuda
def test_a_fresh_reset_captures_again_into_a_new_pool(cuda):
    """The reset under a worker still wedged (``fresh``): the graphs go,
    the pool is new, each program is captured again at its next use, and
    the answers stay the same."""
    g = _generator(_params())
    wave = [(PROMPTS[:2], [GREEDY] * 2)]
    first = _drain(g, wave)
    captures, pool = g.graphs.captures, g.paged_cache.k_pages
    g.reset(fresh=True)
    assert g.paged_cache.k_pages is not pool and g.graphs.drops == 1
    assert _drain(g, wave) == first
    assert g.graphs.captures > captures


@pytest.mark.cuda
def test_a_stall_past_the_grace_serves_on_fresh_graphs(cuda):
    """The continuous engine under its supervisor: a step wedged past the
    stall budget and the grace; the reset under the orphan takes fresh
    graphs and a fresh pool, the requeued requests' greedy answers equal
    an unstalled run's, and K1 counts one launch per layer per step."""
    params = _params()

    def run(stall):
        g = _generator(params)
        policy = SupervisorPolicy(stall_timeout_s=60.0, join_grace_s=0.05)
        engine = ServingEngine(g, Scheduler(g, chunk=32, pipeline_depth=2),
                               supervisor=policy)
        engine.start()
        engine.submit("warm", GREEDY).result(timeout=120)
        sched, drops = engine.scheduler, g.graphs.drops
        if stall:
            policy.stall_timeout_s = 1.0
            plan = FaultPlan(seed=5)
            plan.rule("engine.step", [OK, OK, sleep_(3.0)])
            g.fault_plan = plan
        ragged_attention.launches = 0
        steps = sched.steps
        futures = [engine.submit(p, GREEDY) for p in PROMPTS]
        answers = [f.result(timeout=120).token_ids for f in futures]
        g.fault_plan = None
        while sched.total_work or sched._inflight:
            time.sleep(0.01)
        launches, steps = ragged_attention.launches, sched.steps - steps
        restarts = g.metrics.counter("supervisor_restart")
        engine.close()
        return answers, g.graphs.drops - drops, restarts, launches, steps

    answers, drops, restarts, launches, steps = run(stall=True)
    assert (drops, restarts) == (1, 1)
    assert launches == TINY_TEST.num_layers * steps and steps > 0
    assert answers == run(stall=False)[0]


@pytest.mark.cuda
def test_encoder_bucket_replays_as_eager(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_encoder_params(ENCODER_TINY_TEST, gen, device="cuda")
    embedder = NeuralEmbedder(params, ENCODER_TINY_TEST, lambda t: [b % 512 for b in t.encode()],
                              max_tokens=64, batch_size=8, device="cuda")
    texts = [f"line {i}: " + "error " * (i % 9) for i in range(20)]
    got = embedder.embed(texts)  # three buckets: capture, then two replays
    again = embedder.embed(texts)
    assert embedder.graphs.captures == 1 and embedder.graphs.replays == 5
    want = []
    for lo in range(0, len(texts), 8):
        ids = torch.zeros((8, 64), dtype=torch.int64)
        mask = torch.zeros((8, 64), dtype=torch.int64)
        for row, text in enumerate(texts[lo:lo + 8]):
            toks = [b % 512 for b in text.encode()][:64]
            ids[row, :len(toks)] = torch.tensor(toks)
            mask[row, :len(toks)] = 1
        want.append(encode(params, ENCODER_TINY_TEST, ids.cuda(), mask.cuda())[:len(texts[lo:lo + 8])])
    want = torch.cat(want).cpu().numpy()
    assert abs(got - want).max() < 1e-5
    assert (got == again).all()


@pytest.mark.cuda
def test_sampled_rows_draw_anew_on_each_replay_from_their_distribution(cuda):
    rng = torch.Generator(device="cuda").manual_seed(3)
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05], device="cuda")
    logits = probs.log()[None].repeat(4096, 1)
    temp = torch.ones(4096, device="cuda")
    top_p = torch.ones(4096, device="cuda")
    graphs = GraphSet("cuda")
    program = graphs.program("sampler", lambda lg, t, p: sample(lg, rng, t, p, 4),
                             generators=(rng,))
    draws = [program(logits, temp, top_p, key="s").clone() for _ in range(4)]
    assert graphs.captures == 1 and graphs.replays == 3
    for a, b in zip(draws[1:], draws[2:]):
        assert (a != b).any(), "a replay repeated the previous replay's draws"
    counts = torch.bincount(torch.cat(draws[1:]).long(), minlength=4).float()
    freq = (counts / counts.sum()).cpu()
    assert (freq - probs.cpu()).abs().max() < 0.02


@pytest.mark.cuda
def test_a_cycle_that_dies_during_a_capture_is_not_collected_inside_it(cuda):
    """A program captured while another program's last holder becomes a
    garbage cycle, with automatic collection at every allocation: the
    capture succeeds and replays as eager (a collection inside it would
    free the old program and destroy its graph there, which CUDA forbids
    during a capture), and the old program goes at the next
    collection."""
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    old = GraphSet("cuda")
    old_program = old.program("old", lambda t: t * 2)
    old_program(x, key="o")
    old_program(x, key="o")
    holder = [old_program]
    del old_program
    graphs = GraphSet("cuda")

    def step(t):
        if torch.cuda.is_current_stream_capturing() and holder:
            box = [holder.pop()]
            box.append(box)  # the old program's last holder: a cycle
            del box
            [[] for _ in range(100)]  # allocations that would collect it
        return t + 1

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        program = graphs.program("new", step)
        first = program(x, key="n")
        again = program(x, key="n")
    finally:
        gc.set_threshold(*threshold)
    assert graphs.captures == 1 and graphs.replays == 1
    assert torch.equal(first, x + 1) and torch.equal(again, x + 1)
    gc.collect()
    assert not old.programs
