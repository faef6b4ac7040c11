"""The port's command-line tools against the JAX package's:

- ``schema.crdgen``: ``render_all()`` is byte-equal to JAX's,
  ``check_manifest`` holds for the committed ``deploy/crds`` manifest
  (and fails on a drifted or missing one), and ``python -m
  ...schema.crdgen`` prints, checks and exits alike;
- ``obs.view``: the summary list, one full tree, ``--all``,
  ``--blackbox``, ``--steps`` and ``--slo`` print the same text on the
  same dumps, with the same exit codes on a missing file or trace;
  ``steptrace.render_steps`` renders the same table;
- the patterns CLI (``python -m ...patterns``): the same YAML on the
  fixture logs, with and without the built-in library and ``--top``.

Tolerance: exact text, with the package's name replaced by one
placeholder where a message names the module to run.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("yaml")

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
MANIFEST = "deploy/crds/podmortem-crds.yaml"
_MODULES = ("obs.record", "obs.sloledger", "obs.span", "obs.steptrace", "obs.view",
            "patterns.engine", "schema.crdgen", "utils.timing")


def _package(root: str) -> SimpleNamespace:
    mods = {name.replace(".", "_"): importlib.import_module(f"{root}.{name}") for name in _MODULES}
    return SimpleNamespace(root=root, **mods)


PKGS = {"jax": _package("operator_tpu"), "port": _package("operator_tpu_torch")}


# ---------------------------------------------------------------------------
# crdgen
# ---------------------------------------------------------------------------


def test_render_all_is_byte_equal_to_jax():
    port = PKGS["port"].schema_crdgen
    assert port.render_all() == PKGS["jax"].schema_crdgen.render_all()
    assert [c["metadata"]["name"] for c in port.all_crds()] == [
        c["metadata"]["name"] for c in PKGS["jax"].schema_crdgen.all_crds()]
    for name in ("podmortem_crd", "aiprovider_crd", "patternlibrary_crd"):
        assert getattr(port, name)() == getattr(PKGS["jax"].schema_crdgen, name)()


def test_check_manifest_holds_for_the_committed_crds(tmp_path):
    port = PKGS["port"].schema_crdgen
    assert port.check_manifest(str(REPO / MANIFEST))
    drifted = tmp_path / "drifted.yaml"
    drifted.write_text((REPO / MANIFEST).read_text().replace("Podmortem", "Postmortem", 1))
    assert not port.check_manifest(str(drifted))
    assert not port.check_manifest(str(tmp_path / "absent.yaml"))
    assert PKGS["jax"].schema_crdgen.check_manifest(str(drifted)) is False


@pytest.mark.parametrize("args", [[], ["--check"], ["--check", "drifted"], ["--check", "absent"]],
                         ids=["print", "check", "drifted", "absent"])
def test_crdgen_command_line_matches_jax(tmp_path, args):
    drifted = tmp_path / "drifted.yaml"
    drifted.write_text((REPO / MANIFEST).read_text().replace("Podmortem", "Postmortem", 1))
    argv = [{"drifted": str(drifted), "absent": str(tmp_path / "absent.yaml")}.get(a, a)
            for a in args]
    out = []
    for name in ("jax", "port"):
        root = PKGS[name].root
        proc = subprocess.run([sys.executable, "-m", f"{root}.schema.crdgen", *argv],
                              cwd=REPO, capture_output=True, text=True, timeout=120,
                              env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                                   "JAX_PLATFORMS": "cpu"})
        out.append([proc.returncode, proc.stdout, proc.stderr.replace(root, "<package>")])
    assert out[0] == out[1]
    assert out[1][0] == {"print": 0, "check": 0, "drifted": 1, "absent": 2}[
        args[-1] if args and args[-1] != "--check" else ("check" if args else "print")]


# ---------------------------------------------------------------------------
# the obs viewer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One trace journal with a black-boxed trace, one step journal, one
    SLO-ledger journal — written once, by the JAX package, and read by
    both viewers."""
    root = tmp_path_factory.mktemp("dumps")
    jax = PKGS["jax"]
    metrics = jax.utils_timing.MetricsRegistry()
    recorder = jax.obs_record.FlightRecorder(path=str(root / "traces.jsonl"), metrics=metrics)
    tracer = jax.obs_span.Tracer(recorder=recorder)
    ids = []
    for name in ("analysis", "analysis", "http /v1/completions"):
        with tracer.trace(name) as trace_root:
            with tracer.span("collect"):
                with tracer.span("logs"):
                    pass
            with tracer.span("explain") as span:
                span.set(outcome="ok")
        ids.append(trace_root.trace_id)
    recorder.black_box(ids[1], "deadline-exceeded", {"deadline": {"total_s": 1.0}})
    recorder.flush()
    StepRecord = jax.obs_steptrace.StepRecord
    steps = [
        StepRecord(seq=0, kind="prefill", tokens=16, slots=1, occupancy=0.25, host_gap_ms=0.5,
                   device_ms=9.0, sample_xfer_ms=0.25),
        StepRecord(seq=1, kind="decode", tokens=4, slots=4, occupancy=1.0, host_gap_ms=0.125,
                   device_ms=2.5, sample_xfer_ms=0.0625, mfu=0.0123, accepted=4),
        StepRecord(seq=2, kind="mixed", tokens=9, slots=3, occupancy=0.75, host_gap_ms=0.0,
                   device_ms=3.0, sample_xfer_ms=0.5, cached_tokens=64),
    ]
    blackbox = {"recordedAt": 1.0, "reason": "stall", "extra": {"steps": [
        steps[2].to_dict()]}}
    (root / "steps.jsonl").write_text(
        "\n".join(json.dumps(s.to_dict()) for s in steps[:2]) + "\nnot json\n42\n"
        + json.dumps(blackbox) + "\n")
    (root / "empty.jsonl").write_text("")
    SL = jax.obs_sloledger
    t = [100.0]
    ledger = SL.SLOLedger(SL.parse_slo_classes("interactive:2,standard:30"),
                          path=str(root / "slo.jsonl"), clock=lambda: t[0])
    plan = [("a" * 32, "interactive", 1.0, "completed"), ("b" * 32, "standard", 40.0, "completed"),
            ("c" * 32, None, 3.0, "deadline-exceeded"), ("d" * 32, "interactive", 0.5, "shed"),
            ("e" * 32, "interactive", 5.0, "completed")]
    for trace, cls, _, _ in plan:
        ledger.admit(trace, cls=cls)
    for trace, _, dt, outcome in plan:
        t[0] += dt
        ledger.finish(trace, outcome=outcome, tokens=7,
                      stages={"collect": 12.5, "explain": 900.0 * dt})
    ledger.close()
    return SimpleNamespace(root=root, ids=ids, steps=steps)


_VIEW_CASES = {
    "summary": lambda d: [str(d.root / "traces.jsonl")],
    "one_tree": lambda d: [str(d.root / "traces.jsonl"), d.ids[0][:12]],
    "all": lambda d: [str(d.root / "traces.jsonl"), "--all"],
    "blackbox": lambda d: [str(d.root / "traces.jsonl"), "--blackbox"],
    "blackbox_all": lambda d: [str(d.root / "traces.jsonl"), "--blackbox", "--all"],
    "steps": lambda d: ["--steps", str(d.root / "steps.jsonl")],
    "steps_empty": lambda d: ["--steps", str(d.root / "empty.jsonl")],
    "slo": lambda d: ["--slo", str(d.root / "slo.jsonl")],
    "slo_worst_1": lambda d: ["--slo", str(d.root / "slo.jsonl"), "--worst", "1"],
    "missing_file": lambda d: [str(d.root / "absent.jsonl")],
    "unknown_trace": lambda d: [str(d.root / "traces.jsonl"), "deadbeef"],
    "empty_journal": lambda d: [str(d.root / "empty.jsonl")],
}


@pytest.mark.parametrize("case", sorted(_VIEW_CASES))
def test_obs_view_prints_what_jax_prints(dumps, capsys, case):
    argv = _VIEW_CASES[case](dumps)
    out = []
    for name in ("jax", "port"):
        rc = PKGS[name].obs_view.main(list(argv))
        captured = capsys.readouterr()
        out.append([rc, captured.out, captured.err])
    assert out[0] == out[1]
    rc, text, _ = out[1]
    assert rc == {"missing_file": 2, "unknown_trace": 1}.get(case, 0)
    if case == "blackbox":
        assert "BLACK BOX: deadline-exceeded" in text and text.count("spans=") == 1
    if case == "steps":
        assert "3 steps" in text and "mixed" in text
    if case == "slo":
        assert "interactive" in text and "worst offenders" in text


def test_render_steps_matches_jax(dumps):
    jax_steps = dumps.steps
    port_steps = [PKGS["port"].obs_steptrace.StepRecord.from_dict(s.to_dict()) for s in jax_steps]
    text = PKGS["port"].obs_steptrace.render_steps(port_steps)
    assert text == PKGS["jax"].obs_steptrace.render_steps(jax_steps)
    lines = text.splitlines()
    assert lines[0].split() == ["seq", "kind", "tok", "slots", "occ", "gap_ms", "dev_ms",
                                "xfer_ms", "total", "mfu"]
    assert len(lines) == 2 + len(jax_steps) and "0.0123" in lines[3]


# ---------------------------------------------------------------------------
# the patterns CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["oom_java.log"],
    ["crashloop_quarkus.log", "dns_failure.log", "--top", "2"],
    ["go_panic.log", "tls_cert.log", "--no-builtin"],
    ["db_connection_refused.log", "absent.log"],
], ids=["one", "two_top2", "no_builtin", "missing"])
def test_patterns_cli_prints_what_jax_prints(capsys, args):
    argv = [str(FIXTURES / a) if a.endswith(".log") else a for a in args]
    out = []
    for name in ("jax", "port"):
        rc = PKGS[name].patterns_engine._main(list(argv))
        captured = capsys.readouterr()
        out.append([rc, captured.out, captured.err])
    assert out[0] == out[1]
    assert out[1][0] == (2 if "absent.log" in args else 0)
    if args == ["oom_java.log"]:
        assert "source:" in out[1][1] and "pattern:" in out[1][1]


def test_patterns_module_entry_point_matches_jax():
    out = []
    for name in ("jax", "port"):
        proc = subprocess.run([sys.executable, "-m", f"{PKGS[name].root}.patterns",
                               str(FIXTURES / "eviction.log"), "--top", "3"],
                              cwd=REPO, capture_output=True, text=True, timeout=120,
                              env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                                   "JAX_PLATFORMS": "cpu"})
        out.append([proc.returncode, proc.stdout])
    assert out[0] == out[1] and out[1][0] == 0 and out[1][1].startswith("source:")
