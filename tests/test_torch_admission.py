"""The port's admission against the JAX package's: the deadline policy,
EDF order, expiry sweeps, ``queue_limit`` shedding, the wave's deadline
clamp, the overload ladder (``router/value.py``) and the step clock
(``obs/steptrace.py``, ``serving/perf.py``).

Every case runs the same calls, on the same injected clocks and measured
step times, through both packages and compares what comes out.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from operator_tpu.obs import steptrace as jax_steptrace  # noqa: E402
from operator_tpu.router import value as jax_value  # noqa: E402
from operator_tpu.serving import perf as jax_perf  # noqa: E402
from operator_tpu.serving import types as jax_types  # noqa: E402
from operator_tpu.serving.engine import BatchedGenerator  # noqa: E402
from operator_tpu.serving.sched import Scheduler as JaxScheduler  # noqa: E402
from operator_tpu.utils import deadline as jax_deadline  # noqa: E402
from operator_tpu.utils.timing import MetricsRegistry as JaxMetricsRegistry  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, params_from_jax  # noqa: E402
from operator_tpu_torch.obs import steptrace  # noqa: E402
from operator_tpu_torch.router import value  # noqa: E402
from operator_tpu_torch.serving import perf  # noqa: E402
from operator_tpu_torch.serving import types  # noqa: E402
from operator_tpu_torch.serving.engine import Generator, ServingEngine  # noqa: E402
from operator_tpu_torch.serving.sched import Scheduler  # noqa: E402
from operator_tpu_torch.utils import deadline  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402

CLASSES = {"interactive": 2.0, "standard": 30.0, "batch": 120.0}


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


class FakeClock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


class _Side:
    """One package: its generator, scheduler, params and value module."""

    def __init__(self, name, params):
        self.name = name
        self.params = params
        jax_side = name == "jax"
        self.types = jax_types if jax_side else types
        self.value = jax_value if jax_side else value
        self.metrics_cls = JaxMetricsRegistry if jax_side else MetricsRegistry

    def generator(self, **kw):
        kw.setdefault("max_slots", 4)
        kw.setdefault("max_seq", 128)
        kw.setdefault("page_size", 16)
        if self.name == "jax":
            return BatchedGenerator(
                self.params, JAX_TINY_TEST, JaxByteTokenizer(), paged=True,
                cache_dtype=jnp.float32, metrics=JaxMetricsRegistry(), **kw,
            )
        return Generator(
            self.params, TINY_TEST, ByteTokenizer(), cache_dtype=torch.float32,
            device="cpu", **kw,
        )

    def sched(self, clock, **kw):
        generator = self.generator()
        generator._clock = clock
        cls = JaxScheduler if self.name == "jax" else Scheduler
        sched = cls(generator, **kw)
        sched.plan_log = []
        return sched, generator

    def params_(self, **kw):
        return self.types.SamplingParams(**kw)

    def policy(self, attainment=None, **kw):
        model = self.value.ValueModel(CLASSES, attainment=attainment)
        return self.value.OverloadPolicy(model, metrics=self.metrics_cls(), **kw)


@pytest.fixture(scope="module")
def sides(jax_params, torch_params):
    return {"jax": _Side("jax", jax_params), "torch": _Side("torch", torch_params)}


@pytest.fixture(scope="module")
def generators(sides):
    """One generator per package for the policy grids (state is set per
    case: clock, roofline, measured step times, overload policy)."""
    return {name: side.generator() for name, side in sides.items()}


def _fields(params):
    return (params.max_tokens, params.deadline_clamped, params.degraded, params.deadline)


# ---------------------------------------------------------------------------
# deadline_policy over a grid
# ---------------------------------------------------------------------------

DEADLINE_GRID = list(itertools.product(
    [None, -1.0, 0.0, 0.0005, 0.05, 0.4, 3.0, 60.0],  # residual seconds
    [None, 0.0, 0.004],  # roofline seconds per token
    [(), (2.0,), (5.0, 9.0, 11.0)],  # measured decode_step ms
    [None, 1, 5, 9, 40],  # pressure
    [None, "interactive", "batch"],  # slo class
))


def _policy_outcomes(side, generator):
    out = []
    for residual, roofline, steps, pressure, cls in DEADLINE_GRID:
        generator.metrics = side.metrics_cls()
        for ms in steps:
            generator.metrics.record("decode_step", ms)
        generator.roofline_token_s = roofline
        clock = FakeClock(50.0)
        generator._clock = clock
        generator.overload_policy = side.policy(shed_pressure=8.0) if pressure else None
        params = side.params_(
            max_tokens=64,
            deadline=None if residual is None else clock.now + residual,
            slo_class=cls, recall_p=0.5 if cls == "batch" else 0.0,
        )
        clamped, outcome = generator.deadline_policy(params, pressure=pressure)
        out.append((outcome, _fields(clamped), generator.decode_token_estimate_s()))
        # an explicit `now` wins over the clock
        _, later = generator.deadline_policy(params, now=clock.now + 1000.0)
        out.append(later)
    generator.overload_policy = None
    return out


def test_deadline_policy_matches_reference_over_a_grid(sides, generators):
    want = _policy_outcomes(sides["jax"], generators["jax"])
    got = _policy_outcomes(sides["torch"], generators["torch"])
    assert got == want
    outcomes = {o[0] for o in want if isinstance(o, tuple)}
    assert outcomes == {"ok", "truncated", "rejected", "degraded", "shed"}


def _clamp_wave(side, generator):
    generator.metrics = side.metrics_cls()
    generator.roofline_token_s = 0.01
    generator._clock = FakeClock(10.0)
    generator.overload_policy = None
    wave = [
        side.params_(max_tokens=50, deadline=None),
        side.params_(max_tokens=50, deadline=10.2),  # fits 20
        side.params_(max_tokens=5, deadline=11.0),  # fits
        side.params_(max_tokens=50, deadline=9.0),  # expired: one token
        side.params_(max_tokens=50, deadline=10.005),  # under one token
    ]
    clamped = generator._deadline_clamp_wave(wave)
    return [_fields(p) for p in clamped], generator.metrics.counter(
        "admission_deadline_truncated"
    )


def test_deadline_clamp_wave_matches_reference(sides, generators):
    want = _clamp_wave(sides["jax"], generators["jax"])
    got = _clamp_wave(sides["torch"], generators["torch"])
    assert got == want
    assert want[1] == 3


# ---------------------------------------------------------------------------
# the scheduler's admission: EDF, sweeps, the ladder, queue_limit
# ---------------------------------------------------------------------------

QUEUE = [  # (prompt, priority, residual deadline or None, slo class)
    ("req a", 0, None, None),
    ("req b", 0, 30.0, "standard"),
    ("req c", 1, None, "batch"),
    ("req d", 0, 5.0, "interactive"),
    ("req e", 1, 60.0, None),
    ("req f", 0, 5.0, None),
    ("req g", -1, 1.0, "interactive"),
]


def _edf_order(side):
    clock = FakeClock(100.0)
    sched, _ = side.sched(clock)
    for prompt, priority, residual, cls in QUEUE:
        sched.enqueue(prompt, side.params_(
            max_tokens=4, deadline=None if residual is None else clock.now + residual,
            slo_class=cls,
        ), priority=priority)
    order = []
    while sched._queue:
        head = sched._edf_head()
        order.append(sched._queue[head][0])
        del sched._queue[head]
    return order


def test_edf_head_order_matches_reference(sides):
    want = _edf_order(sides["jax"])
    assert _edf_order(sides["torch"]) == want
    assert want[:2] == [5, 3]  # the priority-1 class first, its deadline first


def _sweep(side):
    clock = FakeClock(100.0)
    sched, generator = side.sched(clock)
    ids = [
        sched.enqueue(prompt, side.params_(
            max_tokens=4, deadline=None if residual is None else clock.now + residual,
            slo_class=cls,
        ), priority=priority)
        for prompt, priority, residual, cls in QUEUE
    ]
    clock.now += 6.0  # d, f and g have expired
    outcomes = []
    sched._sweep_expired(outcomes)
    swept = [(o.req_id, type(o.error).__name__, str(o.error)) for o in outcomes]
    left = [entry[0] for entry in sched._queue]
    return swept, left, ids, generator.metrics.counter("admission_deadline_rejected")


def test_sweep_expired_matches_reference(sides):
    want = _sweep(sides["jax"])
    got = _sweep(sides["torch"])
    assert got == want
    assert [s[0] for s in want[0]] == [4, 6, 7] and want[3] == 3


def _drive_deadlines(side):
    """Deadline-carrying requests through the whole scheduler on an
    injected clock and a fixed per-token estimate."""
    clock = FakeClock(100.0)
    sched, generator = side.sched(clock)
    generator.roofline_token_s = 0.01
    results = {}
    reqs = {
        sched.enqueue("fits its budget", side.params_(
            max_tokens=6, temperature=0.0, stop_on_eos=False, deadline=clock.now + 1.0,
        )): "fits",
        sched.enqueue("clamped to three tokens", side.params_(
            max_tokens=20, temperature=0.0, stop_on_eos=False, deadline=clock.now + 0.035,
        )): "clamped",
        sched.enqueue("no deadline at all", side.params_(
            max_tokens=5, temperature=0.0, stop_on_eos=False,
        )): "free",
        sched.enqueue("expires in the queue", side.params_(
            max_tokens=5, temperature=0.0, stop_on_eos=False, deadline=clock.now - 1.0,
        )): "expired",
    }
    for _ in range(200):
        for outcome in sched.step():
            if outcome.error is not None:
                results[reqs[outcome.req_id]] = type(outcome.error).__name__
            else:
                r = outcome.result
                results[reqs[outcome.req_id]] = (list(r.token_ids), r.finish_reason)
        if len(results) == len(reqs):
            break
    counters = {
        name: generator.metrics.counter(name)
        for name in ("admission_deadline_truncated", "admission_deadline_rejected")
    }
    return results, sched.plan_log, counters


def test_scheduler_deadlines_match_reference(sides):
    want = _drive_deadlines(sides["jax"])
    got = _drive_deadlines(sides["torch"])
    assert got == want
    results = want[0]
    assert results["expired"] == "DeadlineExceeded"
    assert results["clamped"][1] == "deadline" and len(results["clamped"][0]) == 3
    assert results["fits"][1] == "length" and results["free"][1] == "length"


def _queue_limit(side):
    """A queue at its limit sheds the lowest-value request: the arrival
    itself (raised) or a queued one (an outcome at the next step)."""
    clock = FakeClock(100.0)
    policy = side.policy(shed_pressure=100.0)
    sched, generator = side.sched(clock, queue_limit=3, overload_policy=policy)
    arrivals = [
        ("standard", None, 0.0), ("batch", None, 0.0), ("interactive", 1.0, 0.0),
        ("batch", None, 0.9), ("standard", 20.0, 0.0), ("batch", None, 0.0),
        ("interactive", None, 0.0),
    ]
    raised, ids = [], []
    for i, (cls, residual, recall) in enumerate(arrivals):
        params = side.params_(
            max_tokens=3, temperature=0.0, slo_class=cls, recall_p=recall,
            deadline=None if residual is None else clock.now + residual,
        )
        try:
            ids.append(sched.enqueue(f"arrival {i}", params))
        except side.types.ShedLowValue as exc:
            raised.append((i, str(exc)))
    queued = [entry[0] for entry in sched._queue]
    evicted = []
    done = {}
    for _ in range(200):
        for outcome in sched.step():
            if outcome.error is not None:
                evicted.append((outcome.req_id, str(outcome.error)))
            else:
                done[outcome.req_id] = list(outcome.result.token_ids)
        if not sched.total_work:
            break
    return {
        "raised": raised, "queued": queued, "evicted": evicted, "done": done,
        "log": policy.log.lines(), "counter": generator.metrics.counter("sched_queue_evicted"),
    }


def test_queue_limit_sheds_the_same_requests(sides):
    want = _queue_limit(sides["jax"])
    got = _queue_limit(sides["torch"])
    assert got == want
    assert want["raised"] and want["evicted"]
    assert want["counter"] == len(want["raised"]) + len(want["evicted"])


def _admission_ladder(side):
    """An overload policy on the generator: the admission ladder degrades
    (finish "degraded") and sheds under pressure."""
    clock = FakeClock(100.0)
    sched, generator = side.sched(clock)
    generator.overload_policy = side.policy(shed_pressure=4.0, degrade_pressure=2.0)
    reqs = {}
    for i, cls in enumerate(["batch", "standard", "batch", "interactive", "batch"]):
        reqs[sched.enqueue(f"storm {i}", side.params_(
            max_tokens=8, temperature=0.0, stop_on_eos=False, slo_class=cls,
        ))] = cls
    out = {}
    for _ in range(200):
        for outcome in sched.step():
            if outcome.error is not None:
                out[outcome.req_id] = type(outcome.error).__name__
            else:
                r = outcome.result
                out[outcome.req_id] = (len(r.token_ids), r.finish_reason)
        if len(out) == len(reqs):
            break
    return out, generator.metrics.counter("admission_shed"), sched.plan_log


def test_admission_ladder_matches_reference(sides):
    want = _admission_ladder(sides["jax"])
    got = _admission_ladder(sides["torch"])
    assert got == want
    outcomes = set(want[0].values())
    assert "ShedLowValue" in outcomes
    assert any(isinstance(o, tuple) and o[1] == "degraded" for o in outcomes)


def _jax_engine_refusal(sides, clock, params):
    """The JAX ``ServingEngine``'s submit-time verdict on the continuous
    scheduler (its ``generate`` raises before queueing)."""
    import asyncio

    from operator_tpu.serving.engine import ServingEngine as JaxServingEngine

    jax_sched, jax_gen = sides["jax"].sched(clock)
    engine = JaxServingEngine(jax_gen, scheduler=jax_sched)

    async def verdict():
        try:
            with pytest.raises(ValueError) as info:
                await engine.generate("guided", params)
            return str(info.value)
        finally:
            await engine.close()

    return asyncio.run(verdict()), jax_sched


def test_engine_submit_refuses_an_expired_budget_and_guided_requests(sides):
    """The continuous engine refuses guided and LoRA requests at submit
    with the JAX engine's words (an adapter that is not registered is an
    unknown adapter first), the scheduler with the JAX scheduler's ("use
    the wave engine"); the wave engine serves a guided choice."""
    side = sides["torch"]
    clock = FakeClock(100.0)
    sched, generator = side.sched(clock)
    generator.roofline_token_s = 0.01
    engine = ServingEngine(generator, sched)
    try:
        with pytest.raises(types.DeadlineExceeded):
            engine.submit("too late", side.params_(deadline=clock.now - 1.0))
        with pytest.raises(types.DeadlineExceeded):
            engine.submit("under one token", side.params_(deadline=clock.now + 0.001))
        for field, val in (("guided_choice", ("a", "b")), ("guided_regex", "a+"),
                           ("adapter", "ops")):
            want, jax_sched = _jax_engine_refusal(
                sides, clock, sides["jax"].params_(**{field: val}))
            with pytest.raises(ValueError) as got:
                engine.submit("guided", side.params_(**{field: val}))
            assert str(got.value) == want
            with pytest.raises(ValueError, match="use the wave engine") as got:
                sched.enqueue("guided", side.params_(**{field: val}))
            with pytest.raises(ValueError) as ref:
                jax_sched.enqueue("guided", sides["jax"].params_(**{field: val}))
            assert str(got.value) == str(ref.value)
        wave = ServingEngine(side.generator(decode_block=2))
        try:
            chosen = wave.submit("pick one", side.params_(
                max_tokens=8, temperature=0.0, guided_choice=("a", "b"))).result(timeout=120)
            assert chosen.text in ("a", "b")
        finally:
            wave.close()
        result = engine.submit("in budget", side.params_(
            max_tokens=30, temperature=0.0, stop_on_eos=False, deadline=clock.now + 0.055,
        )).result(timeout=120)
        assert result.finish_reason == "deadline" and result.completion_tokens == 5
        assert generator.metrics.counter("admission_deadline_rejected") == 2
    finally:
        engine.close()


def _wave_deadlines(side):
    """The wave engine's admission clamps by the same policy."""
    generator = side.generator()
    generator._clock = FakeClock(100.0)
    generator.roofline_token_s = 0.01
    params = [
        side.params_(max_tokens=12, temperature=0.0, stop_on_eos=False,
                     deadline=100.0 + 0.045),
        side.params_(max_tokens=6, temperature=0.0, stop_on_eos=False),
    ]
    slots = generator.admit(["wave clamp", "wave free"], params)
    done = {}
    for _ in range(100):
        for slot, result in generator.step():
            done[slot] = (list(result.token_ids), result.finish_reason)
        if len(done) == len(slots):
            break
    return [done[s] for s in slots]


def test_wave_deadline_clamp_matches_reference(sides):
    want = _wave_deadlines(sides["jax"])
    assert _wave_deadlines(sides["torch"]) == want
    assert want[0][1] == "deadline" and len(want[0][0]) == 4


# ---------------------------------------------------------------------------
# the value model and the ladder
# ---------------------------------------------------------------------------


def _ladder(side):
    attainment = {"interactive": 0.5, "standard": 0.95, "batch": None}
    out = []
    for att in (None, lambda: attainment, lambda: {"interactive": 0.2, "standard": 0.1}):
        policy = side.policy(attainment=att, shed_pressure=8.0, degrade_tokens_frac=0.5)
        model = policy.model
        out.append((model.weights, sorted(model.protected_classes())))
        for cls, residual, recall, pressure in itertools.product(
            [None, "interactive", "standard", "batch", "unknown"],
            [None, 0.0, 1.0, 15.0, 500.0], [0.0, 0.6, 1.0], [1, 4, 8, 16, 64],
        ):
            v = model.value(slo_class=cls, residual_s=residual, recall_p=recall)
            verdict = policy.decide(v, pressure, site="test", request_id=f"{cls}-{pressure}")
            out.append((dataclasses.astuple(v), v.score, verdict.action, verdict.reason,
                        verdict.cutoff, verdict.degrade_tokens_frac))
        candidates = [
            (f"r{i}", model.value(slo_class=c, residual_s=r, recall_p=p))
            for i, (c, r, p) in enumerate([
                ("batch", None, 0.0), ("batch", None, 0.9), ("standard", 3.0, 0.0),
                ("interactive", 1.0, 0.0), (None, None, 0.0),
            ])
        ]
        out.append(policy.pick_eviction(candidates))
        policy.record_eviction("r0", candidates[0][1], pressure=12.0)
        out.append((policy.log.lines(), policy.metrics.snapshot()))
    return out


def test_value_model_and_overload_policy_match_reference(sides):
    want = _ladder(sides["jax"])
    got = _ladder(sides["torch"])
    assert repr(got) == repr(want)


@pytest.mark.parametrize("total,fraction,floor,cap", [
    (10.0, 0.2, 0.0, None), (3.0, 0.9, 2.0, 1.5), (1.0, 0.5, 5.0, None),
])
def test_deadline_budget_matches_reference(total, fraction, floor, cap):
    out = []
    for module in (jax_deadline, deadline):
        clock = FakeClock(0.0)
        budget = module.Deadline.start(total, clock=clock)
        clock.now = 0.4
        out.append((budget.elapsed(), budget.remaining(), budget.expired,
                    budget.slice(fraction, floor_s=floor, cap_s=cap)))
        clock.now = total + 1.0
        out.append((budget.remaining(), budget.expired, budget.slice(fraction)))
    assert out[:2] == out[2:]


# ---------------------------------------------------------------------------
# the step clock
# ---------------------------------------------------------------------------

RECORDS = [
    dict(kind="prefill", tokens=300, slots=3, host_gap_ms=0.0, device_ms=40.0,
         sample_xfer_ms=0.0, cached_tokens=128),
    dict(kind="mixed", tokens=64, slots=4, host_gap_ms=1.5, device_ms=12.0,
         sample_xfer_ms=0.3, accepted=3, cached_tokens=0),
    dict(kind="decode", tokens=4, slots=4, host_gap_ms=0.7, device_ms=6.0,
         sample_xfer_ms=0.2, accepted=5),
    dict(kind="decode", tokens=4, slots=2, host_gap_ms=4.0, device_ms=6.5,
         sample_xfer_ms=0.1, accepted=4, cached_tokens=None),
    dict(kind="mixed", tokens=40, slots=3, host_gap_ms=0.2, device_ms=9.0,
         sample_xfer_ms=0.4, cached_tokens=640),
]


def _ring(module, capacity):
    ring = module.StepRing(capacity)
    for rec in RECORDS:
        ring.append(occupancy=rec["slots"] / 4, mfu=0.01 * rec["tokens"], **rec)
    return ring


@pytest.mark.parametrize("capacity", [2, 3, 512])
def test_step_ring_and_attribution_match_reference(capacity):
    ring, jax_ring = _ring(steptrace, capacity), _ring(jax_steptrace, capacity)
    assert [r.to_dict() for r in ring.records()] == [r.to_dict() for r in jax_ring.records()]
    assert ring.decode_cum_ms == jax_ring.decode_cum_ms
    for last in (None, 2):
        for kw in ({}, {"flops_per_token": 2.2e9, "peak_tflops": 989.5}):
            got = steptrace.attribution(ring.records(last), **kw)
            want = jax_steptrace.attribution(jax_ring.records(last), **kw)
            assert got == want
    restored = steptrace.StepRecord.from_dict(ring.records()[0].to_dict())
    assert restored == ring.records()[0]


def test_step_clock_matches_reference_and_carries_h100_peaks(monkeypatch):
    monkeypatch.delenv("PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    # NVIDIA H100 SXM5 data sheet, dense: bf16 989.5, FP32 67; the port's
    # int8 GEMMs run in bf16
    assert perf.peak_tflops("bf16") == perf.peak_tflops("bfloat16") == 989.5
    assert perf.peak_tflops("int8") == 989.5
    assert perf.peak_tflops("float32") == 67.0
    monkeypatch.setenv("PEAK_TFLOPS", "756")
    assert perf.peak_tflops("bf16") == 756.0
    monkeypatch.delenv("PEAK_TFLOPS")
    for config in (TINY_TEST,):
        assert perf.flops_per_token(config) == jax_perf.flops_per_token(JAX_TINY_TEST)
        assert perf.matmul_param_count(config) == jax_perf.matmul_param_count(JAX_TINY_TEST)
    clocks = [
        module.StepClock(capacity=8, flops_per_token=1e9, peak_tflops=100.0, max_slots=4,
                         metrics=registry())
        for module, registry in ((perf, MetricsRegistry), (jax_perf, JaxMetricsRegistry))
    ]
    for clock in clocks:
        for i, rec in enumerate(RECORDS):
            clock.observe(commit_t=float(i), **rec)
    assert clocks[0].summary() == clocks[1].summary()
    assert clocks[0].host_gap_ms(10.0) == clocks[1].host_gap_ms(10.0)
    assert clocks[0].summary()["cached_tokens"] == 768


def test_generator_step_clock_uses_the_serving_dtype_peak(sides):
    generator = sides["torch"].generator()
    assert generator.step_clock.peak_tflops == perf.peak_tflops("float32")
    assert generator.step_clock.flops_per_token == perf.flops_per_token(TINY_TEST)


def test_wave_engine_fails_requests_that_expire_while_waiting(sides):
    """The wave loop's sweep (the reference's ``_sweep_batch``): a waiting
    request whose deadline has passed fails with ``DeadlineExceeded``
    before it takes a slot; the others stay in line, in order."""
    import concurrent.futures

    from operator_tpu_torch.serving.engine import _Submission

    side = sides["torch"]
    generator = side.generator()
    clock = FakeClock(100.0)
    generator._clock = clock
    engine = ServingEngine(generator)
    waiting = []
    for i, residual in enumerate([None, 1.0, 5.0, 0.5]):
        params = side.params_(deadline=None if residual is None else clock.now + residual)
        waiting.append(_Submission(f"prompt {i}", params, 0.0, 0, concurrent.futures.Future()))
    engine._waiting.extend(waiting)
    clock.now += 2.0
    engine._sweep_waiting()
    assert [item.prompt for item in engine._waiting] == ["prompt 0", "prompt 2"]
    for i in (1, 3):
        with pytest.raises(types.DeadlineExceeded):
            waiting[i].future.result(timeout=1)
    assert generator.metrics.counter("admission_deadline_rejected") == 2
    engine.close()
