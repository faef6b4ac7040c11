"""The port's public names against the JAX package's, and its native
literal scanner.

- Every name of the public API that the JAX package exports from a
  module or a package ``__init__`` imports from the port at the same
  place (``register_config``, ``param_count``, ``dense_init``; the
  ``ops``, ``serving``, ``utils`` and ``obs`` re-exports), and agrees with
  the JAX one: ``param_count`` on the same tree, f32 and int8;
  ``register_config`` makes a config ``get_config`` returns;
  ``build_prompt`` gives the same prompt; ``render_steps`` the same table;
  the dataclasses the same fields; ``dense_init`` a fan-in scale.
- ``native/logscan.cpp`` built by ``g++`` (the port's build directory)
  and the Python sweep find the same hits as the JAX scanner, and give
  the literal prefilter the same candidates as the JAX prefilter, on the
  builtin library over every fixture log and over a generated
  33,000-line log.  The built half skips only where ``g++`` is absent.
"""

import dataclasses
import importlib
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from operator_tpu import native as jax_native  # noqa: E402
from operator_tpu.models import TINY_TEST as JAX_TINY_TEST  # noqa: E402
from operator_tpu.models import init_params as jax_init_params  # noqa: E402
from operator_tpu.models import quant as jax_quant  # noqa: E402
from operator_tpu.patterns.loader import load_builtin_library as jax_builtin  # noqa: E402
from operator_tpu.patterns.prefilter import LiteralPrefilter as JaxPrefilter  # noqa: E402
from operator_tpu_torch import native  # noqa: E402
from operator_tpu_torch.models import params_from_jax  # noqa: E402
from operator_tpu_torch.ops import _build  # noqa: E402
from operator_tpu_torch.patterns import prefilter  # noqa: E402
from operator_tpu_torch.patterns.loader import load_builtin_library  # noqa: E402
from operator_tpu_torch.utils.config import PORT_FIELDS  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LONG_LOG_LINES = 33_000

#: (module, name) of every straggler: the JAX package exports each there
STRAGGLERS = [
    ("models.configs", "register_config"),
    ("models.llama", "param_count"),
    ("models.llama", "dense_init"),
    ("ops", "PagedKVCache"),
    ("ops", "paged_attention"),
    ("ops", "ragged_paged_attention"),
    ("ops", "paged_attention_reference"),
    ("ops", "ragged_attention_reference"),
    ("serving", "DEFAULT_TEMPLATE"),
    ("serving", "build_prompt"),
    ("utils", "OperatorConfig"),
    ("utils", "Deadline"),
    ("utils", "FaultAction"),
    ("utils", "FaultPlan"),
    ("utils", "METRICS"),
    ("utils", "MetricsRegistry"),
    ("utils", "StageStats"),
    ("obs", "render_steps"),
]


def _both(module: str, name: str):
    ours = getattr(importlib.import_module(f"operator_tpu_torch.{module}"), name)
    theirs = getattr(importlib.import_module(f"operator_tpu.{module}"), name)
    return ours, theirs


@pytest.mark.parametrize("module,name", STRAGGLERS, ids=[n for _, n in STRAGGLERS])
def test_straggler_imports_from_both_packages(module, name):
    ours, theirs = _both(module, name)
    package = importlib.import_module(f"operator_tpu_torch.{module}")
    if hasattr(package, "__all__"):
        assert name in package.__all__
    assert type(ours).__name__ == type(theirs).__name__
    if isinstance(ours, str):
        assert ours == theirs
    elif dataclasses.is_dataclass(ours):
        # OperatorConfig: the reference's fields, in order, then the port's own
        own = list(PORT_FIELDS) if name == "OperatorConfig" else []
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)] + own
    elif isinstance(ours, type):
        assert ours.__name__ == theirs.__name__
    else:
        assert callable(ours) or type(ours).__name__ == "MetricsRegistry"


def test_importing_ops_builds_no_kernel():
    """The ``ops`` re-exports stay import-light: nothing is built or
    loaded when the package is imported."""
    import subprocess
    import sys

    code = ("import operator_tpu_torch.ops, operator_tpu_torch.ops._build as b, sys; "
            "print(len(b._loaded), 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(FIXTURES)))
    assert out.stdout.split() == ["0", "False"]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_param_count_agrees_on_the_same_tree(quantized):
    ours, theirs = _both("models.llama", "param_count")
    tree = jax_init_params(JAX_TINY_TEST, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantized:
        tree = jax_quant.quantize_params(tree, JAX_TINY_TEST)
    port_tree = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert ours(port_tree) == theirs(tree) > 0


def test_register_config_makes_a_config_get_config_returns():
    from operator_tpu.models import configs as jax_configs
    from operator_tpu_torch.models import configs

    name = "tiny-registered"
    for module in (configs, jax_configs):
        config = dataclasses.replace(module.TINY_TEST, name=name, num_layers=1)
        try:
            module.register_config(config)
            assert module.get_config(name) is config
        finally:
            module._REGISTRY.pop(name, None)
        with pytest.raises(KeyError):
            module.get_config(name)


def test_dense_init_scales_by_fan_in():
    ours, theirs = _both("models.llama", "dense_init")
    gen = torch.Generator().manual_seed(0)
    for shape, fan_in in (((256, 128), 256), ((4096,), 64)):
        got = ours(gen, shape, 64, torch.float32, "cpu")
        want = theirs(jax.random.PRNGKey(0), shape, 64, jnp.float32)
        assert tuple(got.shape) == tuple(want.shape) == shape
        assert got.dtype == torch.float32
        for values in (got.numpy(), np.asarray(want)):
            assert abs(values.std() * fan_in ** 0.5 - 1.0) < 0.05


def test_build_prompt_gives_the_same_prompt():
    from operator_tpu.schema import analysis as jax_analysis
    from operator_tpu_torch.schema import analysis

    ours, theirs = _both("serving", "build_prompt")
    with open(os.path.join(FIXTURES, "oom_java.log"), encoding="utf-8") as fh:
        logs = fh.read()
    got, want = (fn(module.AnalysisRequest(
        failure_data=module.PodFailureData(logs=logs),
        provider_config=module.AIProviderConfig(provider_id="tpu-native", max_tokens=64),
    )) for module, fn in ((analysis, ours), (jax_analysis, theirs)))
    assert got == want and len(got) > 100


def test_render_steps_renders_the_same_table():
    from operator_tpu.obs import steptrace as jax_steptrace
    from operator_tpu_torch.obs import steptrace

    ours, theirs = _both("obs", "render_steps")
    fields = [dict(seq=i, kind=("prefill", "decode", "mixed")[i % 3], tokens=8 * i + 1,
                   slots=i + 1, occupancy=0.25 * (i % 4), host_gap_ms=0.5 * i,
                   device_ms=3.25 + i, sample_xfer_ms=0.125, mfu=0.01 * i if i % 2 else None)
              for i in range(6)]
    assert ours([steptrace.StepRecord(**f) for f in fields]) == theirs(
        [jax_steptrace.StepRecord(**f) for f in fields])


def test_utils_metrics_are_each_packages_registry():
    ours, theirs = _both("utils", "METRICS")
    registry, jax_registry = _both("utils", "MetricsRegistry")
    assert isinstance(ours, registry) and isinstance(theirs, jax_registry)
    plan, jax_plan = _both("utils", "FaultPlan")
    assert plan(seed=3).pending() == jax_plan(seed=3).pending() == {}


# ---------------------------------------------------------------------------
# the native literal scanner
# ---------------------------------------------------------------------------


def _fixture_logs() -> dict:
    logs = {}
    for name in sorted(os.listdir(FIXTURES)):
        if name.endswith(".log"):
            with open(os.path.join(FIXTURES, name), encoding="utf-8") as fh:
                logs[name] = fh.read()
    return logs


def _long_log() -> str:
    """33,000 lines cycling through every fixture's lines, each with its
    own line number (distinct text, the same literals)."""
    lines = [line for text in _fixture_logs().values() for line in text.splitlines()]
    return "\n".join(f"{i:06d} {lines[i % len(lines)]}" for i in range(LONG_LOG_LINES))


@pytest.fixture(params=["built", "python"])
def scanner_kind(request, monkeypatch):
    """The prefilter's scanner: the built automaton, or the sweep."""
    if request.param == "built":
        if shutil.which("g++") is None:
            pytest.skip("no g++: the built scanner cannot be built here")
        return request.param
    monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def _literals() -> list:
    engine = prefilter.LiteralPrefilter(load_builtin_library().patterns)
    return [*engine._cs.literals, *(engine._ci.literals if engine._ci else [])]


def test_scanner_finds_the_jax_scanners_hits(scanner_kind):
    literals = _literals() + [b"OOM", b"Killed", b"OOMKilled", b"ill"]  # overlapping ones
    ours = native.MultiPatternScanner(literals)
    assert ours.native == (scanner_kind == "built")
    if ours.native:
        assert native.library_path().parent == _build.build_dir()
        assert native.library_path().is_file()
    theirs = jax_native.MultiPatternScanner(literals)
    for text in [*_fixture_logs().values(), _long_log()]:
        data = text.encode("utf-8", "surrogateescape")
        for case in (data, data.lower()):
            got = ours.scan(case)
            assert sorted(got) == sorted(theirs.scan(case)) and len(set(got)) == len(got)
    # a full hit buffer retries, never drops
    data = b"ill " * 5000
    assert len(ours.scan(data, max_hits=16)) == len(theirs.scan(data)) == 5000


def test_prefilter_candidates_match_jax(scanner_kind):
    ours = prefilter.LiteralPrefilter(load_builtin_library().patterns)
    theirs = JaxPrefilter(jax_builtin().patterns)
    assert ours.native == (scanner_kind == "built")
    assert ours.full_scan_ids == theirs.full_scan_ids
    for text in [*_fixture_logs().values(), _long_log()]:
        lines = text.splitlines()
        assert ours.candidate_lines(lines) == theirs.candidate_lines(lines)


def test_scanner_falls_back_without_a_compiler(monkeypatch, tmp_path, caplog):
    """No ``g++`` on the path: the build is skipped, logged once at INFO
    as the JAX package logs it, and the sweep scans."""
    import logging

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_dir_override", tmp_path / "build")
    with caplog.at_level(logging.INFO, logger="operator_tpu_torch.native"):
        first = native.MultiPatternScanner([b"OOM"])
        second = native.MultiPatternScanner([b"OOM"])
    assert not first.native and not second.native
    skipped = [r for r in caplog.records if r.getMessage().startswith("native scanner build skipped")]
    assert len(skipped) == 1 and skipped[0].levelno == logging.INFO
    assert first.scan(b"pod OOMKilled, OOM again") == [(0, 6), (0, 17)]
