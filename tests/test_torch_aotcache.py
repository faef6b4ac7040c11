"""The port's AOT cache (``operator_tpu_torch/serving/aotcache.py``)
against the JAX package's (``tests/test_aotcache.py`` mirrored): the
fingerprint's payload keys and key discipline, the record round trip, a
counted miss, a loud corrupt entry, a format bump, the warm-boot contract
(no capture after the warmup grid, every capture a hit) and a supervised
restart that captures nothing again.

All on the TINY_TEST model on the CPU, where a graph program runs eagerly
and records each key's first use as its capture — the contract under test
is "a warm boot captures only what its records name, and only during
precompile", which the ``CompileWatcher`` makes observable on any device.
The compile watch and the kernel build directory (``ops/_build.py``) are
tested here too, with a stand-in for ``nvcc``.
"""

import asyncio
import logging
import os
import pickle
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.serving import aotcache as jax_aotcache  # noqa: E402
from operator_tpu_torch.models import TINY_TEST, ByteTokenizer, init_params  # noqa: E402
from operator_tpu_torch.obs import FlightRecorder  # noqa: E402
from operator_tpu_torch.ops import _build  # noqa: E402
from operator_tpu_torch.serving.aotcache import (  # noqa: E402
    CACHE_FORMAT,
    AotCache,
    fingerprint_digest,
    generator_fingerprint,
    serving_compile_events,
)
from operator_tpu_torch.serving.engine import Generator, ServingEngine, SupervisorPolicy  # noqa: E402
from operator_tpu_torch.serving.graphs import GraphSet  # noqa: E402
from operator_tpu_torch.serving.types import SamplingParams  # noqa: E402
from operator_tpu_torch.utils.compilewatch import CompileWatcher  # noqa: E402
from operator_tpu_torch.utils.faultinject import OK, FaultPlan, sleep_  # noqa: E402
from operator_tpu_torch.utils.timing import MetricsRegistry  # noqa: E402

GREEDY = SamplingParams(max_tokens=6, temperature=0.0, stop_on_eos=False)


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return init_params(TINY_TEST, gen, torch.float32, device="cpu")


def _generator(params, cache_dir, **kw):
    defaults = dict(
        max_slots=2, max_seq=128, cache_dtype=torch.float32, page_size=16,
        decode_block=2, device="cpu",
    )
    defaults.update(kw)
    return Generator(params, TINY_TEST, ByteTokenizer(), aot_cache=str(cache_dir), **defaults)


# ---------------------------------------------------------------- fingerprint
class TestFingerprint:
    BASE = dict(
        config=TINY_TEST, weight_dtype="bfloat16", max_slots=2, max_seq=128,
        cache_dtype=torch.float32, paged=True, page_size=16, decode_block=2,
    )
    JAX_BASE = {**BASE, "config": JAX_TINY_TEST, "cache_dtype": jnp.float32}

    def test_payload_has_the_jax_packages_keys(self):
        ours = generator_fingerprint(**self.BASE)
        theirs = jax_aotcache.generator_fingerprint(**self.JAX_BASE)
        assert set(ours) == set(theirs)
        for key in set(theirs) - {"model", "runtime"}:
            assert ours[key] == theirs[key], key
        assert set(ours["model"]) >= {"name", "vocab_size", "num_layers", "max_seq_len"}

    def test_digest_is_stable(self):
        a = fingerprint_digest(generator_fingerprint(**self.BASE))
        b = fingerprint_digest(generator_fingerprint(**self.BASE))
        assert a == b

    @pytest.mark.parametrize(
        "change",
        [
            {"max_slots": 4},                 # shape grid
            {"max_seq": 64},                  # shape grid
            {"page_size": 32},                # paging geometry
            {"paged": False},                 # cache layout
            {"decode_block": 4},              # decode program shape
            {"weight_dtype": "int8"},         # dtype
            {"cache_dtype": torch.bfloat16},  # dtype
            {"lora_names": ("sre-triage",)},  # stacked-adapter axis
        ],
    )
    def test_every_program_shaping_input_changes_the_key(self, change):
        base = fingerprint_digest(generator_fingerprint(**self.BASE))
        varied = fingerprint_digest(generator_fingerprint(**{**self.BASE, **change}))
        assert varied != base, f"fingerprint ignored {change}"

    def test_salt_forces_a_fresh_key(self, monkeypatch):
        base = fingerprint_digest(generator_fingerprint(**self.BASE))
        monkeypatch.setenv("AOT_CACHE_SALT", "fake-driver-2.0")
        salted = fingerprint_digest(generator_fingerprint(**self.BASE))
        assert salted != base

    def test_runtime_keys_the_kernel_sources(self):
        runtime = generator_fingerprint(**self.BASE)["runtime"]
        assert runtime["kernels"] == _build.sources_digest()
        assert {"torch", "cuda", "driver", "device", "capability", "salt"} <= set(runtime)


# ---------------------------------------------------------------- round-trip
class TestRoundTrip:
    RECORD = {"program": "prefill_fn", "key": (2, 64, False), "inputs": [((2, 64), "torch.int32")]}

    def _cache(self, tmp_path):
        payload = generator_fingerprint(config=TINY_TEST, weight_dtype="bfloat16", max_slots=2)
        return AotCache(str(tmp_path), payload, metrics=MetricsRegistry())

    def test_put_get_round_trip(self, tmp_path):
        cache = self._cache(tmp_path)
        assert cache.put("prefill_fn-x", self.RECORD)
        assert os.path.exists(os.path.join(cache.dir, "fingerprint.json"))
        fresh = self._cache(tmp_path)
        assert fresh.dir == cache.dir  # same payload -> same directory
        loaded = fresh.get("prefill_fn-x")
        assert loaded is not None and fresh.hits == 1
        assert loaded["key"] == (2, 64, False) and loaded["inputs"] == self.RECORD["inputs"]
        assert fresh.metrics.snapshot()["counters"].get("aot_cache_hit") == 1
        assert [r["key"] for r in fresh.records()] == [(2, 64, False)]

    def test_miss_is_counted_not_raised(self, tmp_path):
        cache = self._cache(tmp_path)
        assert cache.get("never-stored") is None
        assert cache.misses == 1 and cache.errors == 0

    def test_corrupt_entry_falls_back_loudly(self, tmp_path, caplog):
        cache = self._cache(tmp_path)
        cache.put("prog", self.RECORD)
        path = os.path.join(cache.dir, "prog.aotx")
        with open(path, "wb") as f:
            f.write(b"\x80garbage not a cache record")
        fresh = self._cache(tmp_path)
        with caplog.at_level(logging.WARNING, "operator_tpu_torch.serving.aotcache"):
            assert fresh.get("prog") is None
        assert fresh.errors == 1
        assert any("failed to deserialize" in r.message for r in caplog.records)
        assert not os.path.exists(path), "corrupt entry must be discarded"

    def test_format_bump_reads_as_corrupt(self, tmp_path):
        cache = self._cache(tmp_path)
        os.makedirs(cache.dir, exist_ok=True)
        with open(os.path.join(cache.dir, "old.aotx"), "wb") as f:
            pickle.dump({"format": CACHE_FORMAT + 1, "payload": b""}, f)
        assert cache.get("old") is None and cache.errors == 1


# ---------------------------------------------------------------- warm boot
class TestWarmBoot:
    def test_warm_precompile_captures_only_recorded_keys(self, params, tmp_path):
        """Boot #2 against the same directory captures every key its
        records name, each a hit, stores nothing, and the compile watcher
        sees no serving-program capture after the grid."""
        cold = _generator(params, tmp_path)
        cold.precompile_grid("serving")
        cold_stats = cold._aot.stats()
        assert cold_stats["stored"] > 0 and cold_stats["live_compiles"] == cold_stats["stored"]
        cold_tokens = cold.generate("pod crashed exit 137", GREEDY).token_ids

        watcher = CompileWatcher()
        try:
            warm = _generator(params, tmp_path)
            report = warm.precompile_grid("serving")
            watcher.mark()
            tokens = warm.generate("pod crashed exit 137", GREEDY).token_ids
            after = serving_compile_events(watcher.events_since_mark())
        finally:
            watcher.close()
        stats = warm._aot.stats()
        assert stats["fingerprint"] == cold_stats["fingerprint"]
        assert stats["live_compiles"] == 0 and stats["stored"] == 0
        assert stats["hits"] == cold_stats["stored"] == len(warm._aot.records())
        assert report["aot"]["hits"] == stats["hits"]
        assert after == [], f"warm boot captured: {[e[1] for e in after]}"
        assert tokens == cold_tokens

    def test_changed_shape_grid_is_a_miss(self, params, tmp_path):
        first = _generator(params, tmp_path)
        first.generate("warm the cache", GREEDY)
        assert first._aot.stats()["stored"] > 0
        other = _generator(params, tmp_path, decode_block=4)
        other.generate("warm the cache", GREEDY)
        stats = other._aot.stats()
        assert other._aot.dir != first._aot.dir
        assert stats["hits"] == 0 and stats["live_compiles"] > 0

    def test_salt_env_forces_a_cold_boot(self, params, tmp_path, monkeypatch):
        first = _generator(params, tmp_path)
        first.generate("salted", GREEDY)
        monkeypatch.setenv("AOT_CACHE_SALT", "simulated-upgrade")
        upgraded = _generator(params, tmp_path)
        upgraded.generate("salted", GREEDY)
        stats = upgraded._aot.stats()
        assert upgraded._aot.dir != first._aot.dir
        assert stats["hits"] == 0 and stats["live_compiles"] > 0

    def test_corrupt_generator_entry_recovers_and_restores(self, params, tmp_path, caplog):
        cold = _generator(params, tmp_path)
        want = cold.generate("probe timeout on node", GREEDY).token_ids
        aot = cold._aot
        stored = sorted(f for f in os.listdir(aot.dir) if f.endswith(".aotx"))
        assert stored
        with open(os.path.join(aot.dir, stored[0]), "r+b") as f:
            f.truncate(16)
        with caplog.at_level(logging.WARNING, "operator_tpu_torch.serving.aotcache"):
            warm = _generator(params, tmp_path)
            got = warm.generate("probe timeout on node", GREEDY).token_ids
        stats = warm._aot.stats()
        assert got == want
        assert stats["errors"] == 1 and stats["live_compiles"] == 1
        assert any("falling back" in r.message for r in caplog.records)
        # the discarded entry was re-stored for the NEXT boot
        assert os.path.exists(os.path.join(aot.dir, stored[0]))


# ---------------------------------------------------------------- chaos
def test_supervised_restart_reuses_the_captured_programs(params, tmp_path):
    """A stall forces a supervised restart: the engine comes back without
    a single new capture (the reset zeroes the decode state in place, so
    the programs' fixed inputs keep their addresses), its black-box record
    carries the cache's stats, and a fresh boot on the same directory
    captures only recorded keys."""
    metrics = MetricsRegistry()
    generator = _generator(params, tmp_path, metrics=metrics)
    pages = generator.paged_cache.k_pages.data_ptr()
    policy = SupervisorPolicy(stall_timeout_s=60.0, join_grace_s=5.0)
    engine = ServingEngine(generator, admission_wait_s=0.002, supervisor=policy)
    engine.recorder = FlightRecorder(capacity=16, metrics=metrics)

    async def scenario():
        await engine.generate(
            "warm", SamplingParams(max_tokens=2, temperature=0.0, stop_on_eos=False)
        )
        captures_before = generator.graphs.captures
        policy.stall_timeout_s = 0.4
        plan = FaultPlan(seed=5)
        plan.rule("engine.step", [OK, sleep_(1.5)])  # the 2nd step wedges
        generator.fault_plan = plan
        result = await asyncio.wait_for(
            engine.generate(
                "stalled mid-decode then requeued",
                SamplingParams(max_tokens=12, temperature=0.0, stop_on_eos=False),
            ),
            30,
        )
        generator.fault_plan = None
        assert result.completion_tokens == 12
        return captures_before

    try:
        captures_before = asyncio.run(scenario())
    finally:
        engine.close()
    assert metrics.snapshot()["counters"].get("supervisor_restart") == 1
    assert generator.paged_cache.k_pages.data_ptr() == pages
    stats = generator._aot.stats()
    assert stats["stored"] > 0
    dumps = [r for r in engine.recorder.traces() if r.blackbox]
    assert len(dumps) == 1 and dumps[0].extra["aot_cache"]["stored"] > 0
    # the prompt after the restart is another prefill bucket, the only
    # programs it may capture; the decode block is never captured again
    new = generator.graphs.log[captures_before:]
    assert all(name == "prefill_fn" for name, _key, _s in new), new

    fresh = _generator(params, tmp_path, metrics=MetricsRegistry())
    fresh.generate("warm", SamplingParams(max_tokens=2, temperature=0.0, stop_on_eos=False))
    fresh_stats = fresh._aot.stats()
    assert fresh_stats["hits"] > 0 and fresh_stats["live_compiles"] == 0


# ---------------------------------------------------------------- compile watch
def test_compile_watcher_counts_first_uses_and_builds(tmp_path, monkeypatch):
    """Graph programs report each key's first use (the CPU's capture) and
    the kernel build reports each ``nvcc`` run; a second call at a key
    reports nothing."""
    watcher = CompileWatcher()
    try:
        graphs = GraphSet("cpu")
        double = graphs.program("mixed_fn", lambda x: x * 2)
        x = torch.ones(4)
        double(x, key=("a",))
        double(x, key=("a",))
        double(torch.ones(8), key=("b",))
        names = [name for _t, name, _s in watcher.events()]
        assert names == ["mixed_fn('a',)", "mixed_fn('b',)"]
        assert graphs.captures == 2 and graphs.stats()["programs"]["mixed_fn"] == [
            "('a',)", "('b',)"]
        watcher.mark()

        class FakeNvcc:  # a finished nvcc run that wrote its library
            returncode = 0

            def communicate(self):
                return "", ""

        monkeypatch.setattr(_build, "_dir_override", None)
        monkeypatch.setattr(_build, "_loaded", {})
        _build.set_build_dir(tmp_path / "kernels")
        tmp = tmp_path / "lib.tmp"
        tmp.write_bytes(b"\x7fELF")
        target = _build.library_path("similarity")
        target.parent.mkdir(parents=True)
        _build._finish_build("similarity", FakeNvcc(), tmp, target, time.monotonic())
        assert target.is_file()
        since = watcher.events_since_mark()
        assert [name for _t, name, _s in since] == ["nvcc:similarity"]
        assert serving_compile_events(since) == []
    finally:
        watcher.close()
        _build._dir_override = None
    # a closed watcher hears nothing more
    graphs.program("prefill_fn", lambda x: x)(x, key=(1, 64, False))
    assert len(watcher.events()) == 3


def test_the_build_dir_moves_only_before_a_library_loads(tmp_path, monkeypatch):
    """The process's kernels come from one directory: ``set_build_dir``
    after a library is loaded from another one raises, and the directory
    stays where it was."""
    monkeypatch.setattr(_build, "_dir_override", None)
    monkeypatch.setattr(_build, "_loaded", {})
    _build.set_build_dir(tmp_path / "a")
    assert _build.build_dir() == tmp_path / "a"
    _build._loaded["similarity"] = object()
    _build.set_build_dir(tmp_path / "a")  # the same directory: nothing moves
    with pytest.raises(RuntimeError, match="before the first kernel runs"):
        _build.set_build_dir(tmp_path / "b")
    assert _build.build_dir() == tmp_path / "a"


def test_a_launch_under_capture_counts_on_the_device_at_each_replay(monkeypatch):
    """``LaunchCounter``: an eager launch adds one on the host; a launch
    under CUDA-graph capture adds nothing on the host and captures a device
    add, which each replay runs (here the add runs at once, as one replay
    would); a capture before any eager launch raises.  A kernel module's
    ``launches`` reads and sets its counter."""
    from operator_tpu_torch.ops import ragged_attention

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    device = torch.device("cpu")
    counter = _build.LaunchCounter()
    capturing[0] = True
    with pytest.raises(RuntimeError, match="before its first eager launch"):
        counter.launched(device)
    capturing[0] = False
    counter.launched(device)
    assert counter.host == 1 and counter.value() == 1
    capturing[0] = True
    counter.launched(device)
    counter.launched(device)
    assert counter.host == 1 and counter.value() == 3
    counter.set(0)
    assert counter.value() == 0

    monkeypatch.setattr(ragged_attention, "_launch_counter", counter)
    capturing[0] = False
    counter.launched(device)
    assert ragged_attention.launches == 1
    ragged_attention.launches = 0
    assert counter.value() == 0 and ragged_attention.launches == 0


def test_outgrown_ticket_counters_are_retired_not_freed(monkeypatch):
    """A captured graph keeps the ticket buffer's address: a larger request
    swaps in a new buffer and keeps the old one alive."""
    monkeypatch.setattr(_build, "_counters", {})
    monkeypatch.setattr(_build, "_retired", [])
    device = torch.device("cpu")
    small = _build.ticket_counters(device, 7, 16)
    assert _build.ticket_counters(device, 7, 200) is small
    large = _build.ticket_counters(device, 7, 1000)
    assert large is not small and large.numel() >= 1000
    assert _build._retired == [small]


def test_metrics_route_carries_the_cache_counters(tmp_path):
    """``/metrics`` renders the generator's registry, which the provider's
    cache counts into: ``podmortem_aot_cache_{miss,store}_total`` after a
    cold grid, as the JAX server's exposition does."""
    from operator_tpu_torch.serving.httpserver import CompletionServer
    from operator_tpu_torch.serving.provider import build_serving_engine

    engine, model_id = build_serving_engine("cpu", {
        "OPERATOR_TPU_MODEL": "tiny-test", "ALLOW_RANDOM_WEIGHTS": "true",
        "MAX_BATCH_SIZE": "2", "KV_PAGE_SIZE": "16", "SCHED_MODE": "wave",
        "AOT_CACHE_PATH": str(tmp_path),
    })
    try:
        report = asyncio.run(engine.precompile("serving"))
        server = CompletionServer(engine, model_id=model_id, host="127.0.0.1", port=0)
        status, body = asyncio.run(server._route("GET", "/metrics", b"", None))
    finally:
        engine.close()
    text = body.decode()
    stored = report["aot"]["stored"]
    assert status == 200 and stored > 0
    assert f"podmortem_aot_cache_store_total {stored}" in text
    assert f"podmortem_aot_cache_miss_total {report['aot']['misses']}" in text


def test_platform_points_the_kernel_build_dir(tmp_path, monkeypatch):
    """``enable_persistent_compilation_cache`` moves the kernel build
    directory (a path that cannot be made disables it, as JAX's does; an
    explicit ``OPERATOR_TPU_TORCH_BUILD_DIR`` wins)."""
    from operator_tpu_torch.utils.platform import enable_persistent_compilation_cache

    monkeypatch.setattr(_build, "_dir_override", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.delenv("OPERATOR_TPU_TORCH_BUILD_DIR", raising=False)
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert enable_persistent_compilation_cache(str(blocker / "sub")) is None
    assert _build._dir_override is None
    path = str(tmp_path / "kernels")
    assert enable_persistent_compilation_cache(path) == path
    assert _build.build_dir() == tmp_path / "kernels"
    monkeypatch.setattr(_build, "_dir_override", None)
    monkeypatch.setenv("OPERATOR_TPU_TORCH_BUILD_DIR", str(tmp_path / "explicit"))
    assert enable_persistent_compilation_cache(path) == str(tmp_path / "explicit")
    assert _build._dir_override is None


def test_the_operator_cli_keeps_the_kernels_beside_the_aot_cache(tmp_path, monkeypatch):
    """The operator's entry point, with ``AOT_CACHE_PATH``, builds the
    kernels into the cache's ``kernels/`` before anything else (here it
    then exits 2: no cluster)."""
    from operator_tpu_torch.operator.app import _main

    monkeypatch.setattr(_build, "_dir_override", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.delenv("OPERATOR_TPU_TORCH_BUILD_DIR", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    monkeypatch.setenv("AOT_CACHE_PATH", str(tmp_path / "aot"))
    assert _main([]) == 2
    assert _build.build_dir() == tmp_path / "aot" / "kernels"
