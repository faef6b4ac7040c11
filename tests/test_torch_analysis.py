"""graftlint for the port (operator_tpu_torch/analysis) — rule fixtures,
baseline, pragmas, and the port's linter held to the JAX package's.

Four parts:

- mirrors of tests/test_analysis.py for every ported rule, on fixtures under
  operator_tpu_torch/ (GL008 has no counterpart); GL001/GL002 on
  PyTorch fixtures, one per CUDA-graph root form the port uses, one negative
  case per sanitiser, and the step loop's deliberate syncs left unflagged;
- parity: the same host-code fixture under operator_tpu/ for the JAX rule and
  under operator_tpu_torch/ for the port's, with equal findings;
- the port's gate: one whole run over the repo with
  analysis-baseline-torch.json is clean;
- a mutation: an ``.item()`` added to the mixed step is flagged by GL001.

Fixtures are strings written under tmp_path, never literal ``Injection(...)``
calls: the JAX package's gate reads tests/ for seam names.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from operator_tpu_torch.analysis import (
    Baseline,
    load_baseline,
    run_analysis,
    rules_by_id,
    write_baseline,
)
from operator_tpu_torch.analysis.__main__ import main as cli_main
from operator_tpu_torch.analysis.jitgraph import JitGraph
from operator_tpu_torch.analysis.runner import collect_context
from operator_tpu_torch.analysis.rules.gl005_drift import undocumented_metrics

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_RULES = (
    "GL001", "GL002", "GL003", "GL004", "GL005", "GL006",
    "GL007", "GL009", "GL010", "GL011", "GL012", "GL013",
)


def make_ctx(tmp_path: Path, files: dict[str, str]):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text), encoding="utf-8")
    return collect_context(tmp_path)


def run_rule(tmp_path, rule_id: str, files: dict[str, str]):
    ctx = make_ctx(tmp_path, files)
    findings, pragma_errors = run_analysis(ctx, rules_by_id([rule_id]))
    return findings, pragma_errors


@pytest.fixture(scope="module")
def repo_gate():
    """One whole run of the port's gate over the repo (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main([
            "--root", str(REPO_ROOT),
            "--baseline", str(REPO_ROOT / "analysis-baseline-torch.json"),
        ])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def repo_graph():
    """The program graph over the port's compute tree in the repo."""
    ctx = collect_context(REPO_ROOT, [REPO_ROOT / "operator_tpu_torch"])
    rule = rules_by_id(["GL001"])[0]
    return JitGraph.for_modules(ctx, ctx.in_scope(rule.scope))


# ---------------------------------------------------------------------------
# GL001 host-sync-in-hot-path
# ---------------------------------------------------------------------------


def test_gl001_positive_host_sync_reachable_from_program(tmp_path):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/foo.py": """
            import numpy as np
            import torch

            def entry(x):
                return helper(x)

            def helper(x):
                y = np.asarray(x)      # host copy inside a graph program
                return y.item()        # and an explicit sync

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    messages = [f.message for f in findings]
    assert any("np.asarray" in m for m in messages)
    assert any(".item()" in m for m in messages)
    assert all(f.rule == "GL001" for f in findings)
    assert all(f.path == "operator_tpu_torch/ops/foo.py" for f in findings)


def test_gl001_negative_host_code_and_static_float(tmp_path):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/foo.py": """
            import numpy as np
            import torch

            def entry(x, xs):
                scale = float(len(xs))   # host arithmetic on a static length
                return x * scale

            def host_orchestrator(x):
                # captured by no program: host syncs are its job
                return np.asarray(x).item()

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert findings == []


def test_gl001_positive_float_on_tensor(tmp_path):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/foo.py": """
            def entry(x):
                return float(x + 1)

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1
    assert "float() on a device tensor" in findings[0].message


def test_gl001_reaches_through_self_methods_and_aot_wrap_form(tmp_path):
    # self._aot_wrap(name, self._step) + self-method resolution
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/serving/eng.py": """
            class Gen:
                def __init__(self):
                    self._fn = self._aot_wrap("step", self._step, fixed_args=(0,))

                def _step(self, cache, tok):
                    return self._inner(cache, tok)

                def _inner(self, cache, tok):
                    return cache.cpu(), tok
        """,
    })
    assert len(findings) == 1
    assert ".cpu()" in findings[0].message
    assert findings[0].symbol == "Gen._inner"


# ---------------------------------------------------------------------------
# GL002 implicit bool() of a device tensor
# ---------------------------------------------------------------------------


def test_gl002_positive_if_and_while_on_tensor(tmp_path):
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/models/m.py": """
            def entry(x):
                if x > 0:
                    x = x - 1
                while x < 10:
                    x = x + 1
                assert x != 3
                return x

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 3
    assert any("`if`" in f.message for f in findings)
    assert any("`while`" in f.message for f in findings)
    assert any("assert" in f.message for f in findings)


def test_gl002_negative_static_idioms(tmp_path):
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/models/m.py": """
            import torch

            def entry(x, mask=None, flag: bool = False):
                if flag:                      # host scalar: part of the key
                    x = x * 2
                if mask is not None:          # None dispatch
                    x = torch.where(mask, x, 0)
                if x.shape[0] > 8:            # shape metadata is host data
                    x = x[:8]
                for _ in range(x.ndim):       # static iteration
                    x = x[None]
                return x

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert findings == []


def test_gl002_program_lambda_body_checked(tmp_path):
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/ops/l.py": """
            def build(graphs):
                return graphs.program("f", lambda x: 1 if x > 0 else 0)
        """,
    })
    assert len(findings) == 1
    assert "conditional expression" in findings[0].message


def test_gl002_cuda_graph_block_body_checked(tmp_path):
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/serving/k.py": """
            import torch

            def capture(graph, x):
                with torch.cuda.graph(graph):
                    v = torch.sum(x)
                    if v > 0:
                        x.add_(1)
        """,
    })
    assert len(findings) == 1
    assert findings[0].symbol == "capture"


def test_gl002_nested_def_locals_do_not_leak_into_outer_scope(tmp_path):
    """A nested helper's tainted local must not pollute the enclosing
    function's taint env (scopes are separate), and host control flow on
    an identically-named outer local stays legal."""
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/models/m.py": """
            import torch

            def entry(x):
                def helper(y):
                    val = torch.sum(y)
                    return val

                val = 2
                if val > 1:          # host int named like helper's local
                    return helper(x)
                return x

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert findings == []


def test_gl001_nested_called_def_reports_exactly_once(tmp_path):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/foo.py": """
            def entry(x):
                def helper(y):
                    return y.item()

                return helper(x)

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1
    assert findings[0].symbol == "entry.helper"


def test_gl001_gl002_trace_annotations_are_inert(tmp_path):
    """torch.profiler.record_function / torch.cuda.nvtx.range / obs span
    context managers inside (or around) graph programs are trace-inert:
    not host syncs, not implicit bool()s, and their results carry no
    taint (the serving engine wraps its prefill/decode dispatches in
    exactly these)."""
    files = {
        "operator_tpu_torch/serving/annotated.py": """
            import torch
            from operator_tpu_torch.obs import span

            def entry(x):
                with torch.profiler.record_function("podmortem.decode"):
                    y = torch.exp(x)
                with torch.cuda.nvtx.range("attn"):
                    z = y * 2
                return z

            def host_step(self, x):
                # host orchestration: the span result is a host value
                with span("engine.generate") as sp:
                    if sp:
                        pass
                return entry(x)

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    }
    for rule in ("GL001", "GL002"):
        findings, _ = run_rule(tmp_path, rule, dict(files))
        assert findings == [], (rule, [f.render() for f in findings])


def test_gl001_host_sync_inside_annotation_still_flagged(tmp_path):
    """An annotation context must not mask a real host sync inside it."""
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/serving/annotated.py": """
            import torch

            def entry(x):
                with torch.profiler.record_function("blk"):
                    return x.item()

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1
    assert ".item()" in findings[0].message


def test_torch_trace_is_not_trace_inert(tmp_path):
    """``torch.trace`` is the MATRIX trace (a tensor op) — the trace-inert
    carve-out must not sanitize it: branching on its result inside a graph
    program is still an implicit bool()."""
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/serving/annotated.py": """
            import torch

            def entry(x):
                if torch.trace(x) > 0:
                    return x
                return -x

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1


# ---------------------------------------------------------------------------
# GL001/GL002 on the port's CUDA-graph root forms
# ---------------------------------------------------------------------------

#: form -> (files, {(path, symbol)} the injected sync must be reported at)
_ROOT_FORMS = {
    "program_def": ({
        "operator_tpu_torch/patterns/enc.py": """
            def entry(params, ids):
                return ids.item()

            def build(graphs):
                return graphs.program("encoder", entry, fixed_args=(0,))
        """,
    }, {("operator_tpu_torch/patterns/enc.py", "entry")}),
    "program_lambda": ({
        "operator_tpu_torch/patterns/semantic.py": """
            from ..models.encoder import encode

            class NeuralEmbedder:
                def __init__(self, graphs, config):
                    self._encode = graphs.program(
                        "encoder",
                        lambda params, ids, mask: encode(params, config, ids, mask),
                        fixed_args=(0,),
                    )
        """,
        "operator_tpu_torch/models/encoder.py": """
            def encode(params, config, ids, mask):
                return mask.tolist()
        """,
    }, {("operator_tpu_torch/models/encoder.py", "encode")}),
    "aot_wrap_bound_method": ({
        "operator_tpu_torch/serving/engine.py": """
            class Generator:
                def __init__(self):
                    self._prefill_program = self._aot_wrap(
                        "prefill_fn", self._prefill, fixed_args=(0, 7, 9)
                    )

                def _prefill(self, params, cache, token_ids):
                    return token_ids.cpu()
        """,
    }, {("operator_tpu_torch/serving/engine.py", "Generator._prefill")}),
    "tuple_unpacked_local": ({
        "operator_tpu_torch/serving/engine.py": """
            class Generator:
                def __init__(self, paged):
                    if paged:
                        decode_fn, decode_fixed = self._decode_block_paged, (0, 6, 8)
                    else:
                        decode_fn, decode_fixed = self._decode_block, (0, 3, 7, 9)
                    self._decode_program = self._aot_wrap(
                        "_decode_block", decode_fn, fixed_args=decode_fixed
                    )

            class ProgramBuilderMixin:
                def _decode_block_paged(self, params, paged, tokens):
                    return tokens.numpy()

                def _decode_block(self, params, cache, tokens):
                    return tokens.to("cpu")
        """,
    }, {
        ("operator_tpu_torch/serving/engine.py",
         "ProgramBuilderMixin._decode_block_paged"),
        ("operator_tpu_torch/serving/engine.py",
         "ProgramBuilderMixin._decode_block"),
    }),
    "factory_closure": ({
        "operator_tpu_torch/serving/sched/scheduler.py": """
            class Scheduler:
                def _mixed_fn(self):
                    from .mixed import make_mixed_step

                    step = make_mixed_step(self.config, chunk=self.chunk)

                    def mixed_fn(params, paged, ints):
                        ids, rows = ints.split(2)
                        return step(params, paged, ids, rows)

                    return mixed_fn

                def _get_fn(self):
                    g = self.generator
                    self._fn = g._aot_wrap("mixed_fn", self._mixed_fn(), fixed_args=(0,))
                    return self._fn
        """,
        "operator_tpu_torch/serving/sched/mixed.py": """
            import torch

            def make_mixed_step(config, *, chunk):
                chunk_steps = torch.arange(chunk)

                def step(params, paged, ids, rows):
                    if ids.sum() > 0:
                        return rows
                    return paged

                return step
        """,
    }, {("operator_tpu_torch/serving/sched/mixed.py", "make_mixed_step.step")}),
    "cuda_graph_block": ({
        "operator_tpu_torch/serving/graphs.py": """
            import torch

            class GraphProgram:
                def _capture(self, graph, static_args):
                    with torch.cuda.graph(graph, pool=self.pool):
                        captured = self.fn(*static_args)
                        torch.cuda.synchronize()
                    return captured
        """,
    }, {("operator_tpu_torch/serving/graphs.py", "GraphProgram._capture")}),
    "functools_partial": ({
        "operator_tpu_torch/ops/k.py": """
            import functools

            def kernel_body(x, scale):
                return bool(x.any())

            def build(graphs):
                return graphs.program("k", functools.partial(kernel_body, scale=2))
        """,
    }, {("operator_tpu_torch/ops/k.py", "kernel_body")}),
}


@pytest.mark.parametrize("form", sorted(_ROOT_FORMS))
def test_every_root_form_reaches_its_function(tmp_path, form):
    """Each way the port registers a CUDA-graph program resolves to its
    function: the sync injected there is reported (GL002 for the mixed
    step's `if`, GL001 for the rest), and only there."""
    files, expected = _ROOT_FORMS[form]
    ctx = make_ctx(tmp_path, files)
    findings, _ = run_analysis(ctx, rules_by_id(["GL001", "GL002"]))
    assert {(f.path, f.symbol) for f in findings} == expected, [
        f.render() for f in findings
    ]


def test_an_unregistered_function_is_no_program(tmp_path):
    """A method nobody registers — the step loop's own — may sync."""
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/serving/engine.py": """
            class Generator:
                def __init__(self):
                    self._prefill_program = self._aot_wrap("prefill_fn", self._prefill)

                def _prefill(self, params, cache, token_ids):
                    return token_ids + 1

                def _finish(self, first_tokens, end):
                    first_np = first_tokens.cpu().numpy()  # the ONE host sync
                    end.synchronize()
                    return first_np
        """,
    })
    assert findings == []


#: expression -> it is host data inside a program (no sync, no implicit bool)
_SANITISERS = [
    "x.shape[0] > 1",
    "x.ndim == 2",
    "x.dtype == torch.float16",
    "x.device.type == 'cuda'",
    "x.is_cuda",
    "x.requires_grad and torch.is_grad_enabled()",
    "x.size(0) > 1",
    "x.dim() == 2",
    "x.numel() > 0",
    "len(x) > 1",
    "x.data_ptr() % 16",
    "x.stride(0) > 1",
    "x.is_contiguous()",
    "x.element_size() == 2",
    "flag",
    "k > 0",
    "x is None",
    "'wq' in lora",
    "isinstance(n, int) and n > 0",
    "not isinstance(n, int) or n != 0",
    "torch.cuda.is_current_stream_capturing()",
]


@pytest.mark.parametrize("expr", _SANITISERS)
def test_sanitiser_is_not_a_sync(tmp_path, expr):
    ctx = make_ctx(tmp_path, {
        "operator_tpu_torch/models/m.py": f"""
            import torch

            def entry(x, n, lora, flag: bool = False, k: "Optional[int]" = 0):
                if {expr}:
                    x = x + 1
                y = bool({expr})
                return x, y

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    findings, _ = run_analysis(ctx, rules_by_id(["GL001", "GL002"]))
    assert findings == [], [f.render() for f in findings]


#: statement in a program -> the message fragment GL001 reports it with
_SYNCS = [
    ("x.item()", ".item()"),
    ("x.tolist()", ".tolist()"),
    ("x.cpu()", ".cpu()"),
    ("x.numpy()", ".numpy()"),
    ("x.to('cpu')", ".to('cpu')"),
    ("x.to(device='cpu')", ".to('cpu')"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("torch.cuda.Event().synchronize()", ".synchronize()"),
    ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
    ("np.asarray(x)", "np.asarray() of a device tensor"),
    ("np.array(x * 2)", "np.array() of a device tensor"),
    ("np.copy(torch.exp(n))", "np.copy() of a device tensor"),
    ("float(x)", "float() on a device tensor"),
    ("int(x.sum())", "int() on a device tensor"),
    ("bool(x.any())", "bool() on a device tensor"),
]


@pytest.mark.parametrize("stmt,fragment", _SYNCS, ids=[s for s, _ in _SYNCS])
def test_sync_is_flagged_in_a_program(tmp_path, stmt, fragment):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/s.py": f"""
            import numpy as np
            import torch

            def entry(x, n: int):
                y = {stmt}
                return x

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1, [f.render() for f in findings]
    assert fragment in findings[0].message
    assert "CUDA-graph program" in findings[0].message


def test_host_values_in_a_program_are_not_syncs(tmp_path):
    findings, _ = run_rule(tmp_path, "GL001", {
        "operator_tpu_torch/ops/s.py": """
            import numpy as np
            import torch

            def entry(x, n: int):
                table = np.asarray([1, 2, 3])      # host constant
                rows = int(x.shape[0])              # metadata
                half = x.to(torch.float16)          # stays on the device
                moved = x.to("cuda")
                return half, moved, float(n), table, rows

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert findings == []


def test_gl002_implicit_bool_of_an_ops_wrapper_result(tmp_path):
    """A call through the port's ops package returns a device tensor even
    when the wrapper is outside the analysed set."""
    findings, _ = run_rule(tmp_path, "GL002", {
        "operator_tpu_torch/models/m.py": """
            from ..ops.ragged_attention import ragged_paged_attention

            def entry(q, pages):
                out = ragged_paged_attention(q, pages)
                assert out.isfinite().all()
                return out

            def build(graphs):
                return graphs.program("entry", entry)
        """,
    })
    assert len(findings) == 1
    assert "`assert`" in findings[0].message


# ---------------------------------------------------------------------------
# GL001/GL002 over the repo's own programs
# ---------------------------------------------------------------------------

#: every program registration of the port: form -> (file, def or lambda
#: marker, finding symbol).  An ``.item()`` is injected at each in a copy.
_REPO_ROOTS = {
    "tuple_unpacked_paged": (
        "serving/programs.py", "def _decode_block_paged(",
        "ProgramBuilderMixin._decode_block_paged"),
    "tuple_unpacked_contiguous": (
        "serving/programs.py", "def _decode_block(",
        "ProgramBuilderMixin._decode_block"),
    "bound_method_prefill": (
        "serving/programs.py", "def _prefill(", "ProgramBuilderMixin._prefill"),
    "bound_method_prefix_build": (
        "serving/programs.py", "def _prefix_build(",
        "ProgramBuilderMixin._prefix_build"),
    "bound_method_chunk": (
        "serving/programs.py", "def _prefill_chunk(",
        "ProgramBuilderMixin._prefill_chunk"),
    "bound_method_finish": (
        "serving/programs.py", "def _prefill_finish(",
        "ProgramBuilderMixin._prefill_finish"),
    "bound_method_prefixed": (
        "serving/programs.py", "def _prefill_paged_prefixed(",
        "ProgramBuilderMixin._prefill_paged_prefixed"),
    "factory_closure": (
        "serving/sched/scheduler.py", "def mixed_fn(",
        "Scheduler._mixed_fn.mixed_fn"),
    "encoder_lambda": (
        "patterns/semantic.py",
        "lambda params, ids, mask: encode(params, config, ids, mask)",
        "NeuralEmbedder.__init__"),
    "capture_block": (
        "serving/graphs.py", "with torch.cuda.graph(",
        "GraphProgram._capture"),
}

_PROBE = "_graftlint_probe"


def _inject_probe(path: Path, marker: str) -> None:
    """Add ``<probe>.item()`` as the first statement of the def (or
    ``with`` block) whose header holds ``marker``; into the expression of
    a lambda marker."""
    text = path.read_text(encoding="utf-8")
    if marker.startswith("lambda "):
        head, expr = marker.split(": ", 1)
        assert text.count(marker) == 1
        path.write_text(
            text.replace(marker, f"{head}: ({_PROBE}.item(), {expr})[1]"),
            encoding="utf-8",
        )
        return
    lines = text.splitlines(keepends=True)
    header = next(i for i, line in enumerate(lines, 1) if marker in line)
    node = next(
        n for n in ast.walk(ast.parse(text))
        if isinstance(n, (ast.FunctionDef, ast.With)) and n.lineno == header
    )
    first = node.body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
        first = node.body[1]  # after the docstring
    lines.insert(first.lineno - 1, f"{' ' * first.col_offset}{_PROBE}.item()\n")
    path.write_text("".join(lines), encoding="utf-8")


@pytest.fixture(scope="module")
def probed_repo(tmp_path_factory):
    """GL001 over a copy of the port's compute tree with a probe sync
    injected at every program registration of :data:`_REPO_ROOTS`."""
    root = tmp_path_factory.mktemp("probed")
    for sub in ("ops", "serving", "models", "patterns"):
        shutil.copytree(
            REPO_ROOT / "operator_tpu_torch" / sub, root / "operator_tpu_torch" / sub,
            ignore=shutil.ignore_patterns("__pycache__", "csrc", "builtin"),
        )
    for rel, marker, _symbol in _REPO_ROOTS.values():
        _inject_probe(root / "operator_tpu_torch" / rel, marker)
    ctx = collect_context(root)
    findings, _ = run_analysis(ctx, rules_by_id(["GL001"]))
    return findings


@pytest.mark.parametrize("form", sorted(_REPO_ROOTS))
def test_repo_program_registration_reaches_its_function(probed_repo, form):
    rel, _marker, symbol = _REPO_ROOTS[form]
    hits = [
        f for f in probed_repo
        if f.path == f"operator_tpu_torch/{rel}" and f.symbol == symbol
        and ".item()" in f.message
    ]
    assert len(hits) == 1, [f.render() for f in probed_repo]


def test_repo_probes_are_the_only_findings(probed_repo):
    assert len(probed_repo) == len(_REPO_ROOTS), [f.render() for f in probed_repo]


#: the step loop's deliberate host syncs and the launch counter's reader:
#: (file, text on the line, enclosing function)
_DELIBERATE_SYNCS = {
    "prefill_job_fetch": (
        "serving/engine.py", "# the job's ONE host sync", "_advance_prefill"),
    "decode_block_fetch": (
        "serving/engine.py", "# the block's ONE host sync", "_process_block"),
    "mixed_step_wait": (
        "serving/sched/scheduler.py", "entry.end.synchronize()", "_wait"),
    "launch_counter_value": (
        "ops/_build.py", "total += int(counter.item())", "value"),
}


@pytest.mark.parametrize("site", sorted(_DELIBERATE_SYNCS))
def test_deliberate_step_loop_syncs_stay_unflagged(repo_graph, repo_gate, site):
    rel, text, func = _DELIBERATE_SYNCS[site]
    module = repo_graph.ctx.module(f"operator_tpu_torch/{rel}")
    line = next(i for i, src in enumerate(module.lines, 1) if text in src)
    calls = [
        n for n in ast.walk(module.tree)
        if isinstance(n, ast.Call) and n.lineno == line
    ]
    gl001 = rules_by_id(["GL001"])[0]
    # the line IS a sync GL001 would report inside a program...
    assert any(
        gl001._sync_message(repo_graph, call, {"counter"}, module) for call in calls
    )
    # ...but its function is no program and no program reaches it
    owner = next(
        n for n in ast.walk(module.tree)
        if isinstance(n, ast.FunctionDef) and n.name == func
        and n.lineno <= line <= n.end_lineno
    )
    assert not repo_graph.info(owner).reachable
    rc, out = repo_gate
    assert f"operator_tpu_torch/{rel}:{line}:" not in out


def test_mixed_step_item_mutation_is_flagged(tmp_path):
    """A copy of serving/sched/mixed.py with an ``.item()`` in the mixed
    step's body: the factory closure the scheduler registers reaches it."""
    port = tmp_path / "operator_tpu_torch"
    for sub in ("ops", "serving", "models"):
        shutil.copytree(
            REPO_ROOT / "operator_tpu_torch" / sub, port / sub,
            ignore=shutil.ignore_patterns("__pycache__", "csrc"),
        )
    mixed = port / "serving/sched/mixed.py"
    text = mixed.read_text(encoding="utf-8")
    anchor = "        toks = flat_toks.reshape(max_slots, width)\n"
    assert text.count(anchor) == 1
    mixed.write_text(
        text.replace(anchor, anchor + "        first = toks[0, 0].item()\n"),
        encoding="utf-8",
    )
    findings, _ = run_analysis(collect_context(tmp_path), rules_by_id(["GL001"]))
    assert len(findings) == 1, [f.render() for f in findings]
    assert findings[0].path == "operator_tpu_torch/serving/sched/mixed.py"
    assert findings[0].symbol == "make_mixed_step.step"
    assert ".item()" in findings[0].message


# ---------------------------------------------------------------------------
# GL003 deadline propagation
# ---------------------------------------------------------------------------


def test_gl003_positive_unbudgeted_kube_call(tmp_path):
    findings, _ = run_rule(tmp_path, "GL003", {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")
        """,
    })
    assert len(findings) == 1
    assert "self.api.get" in findings[0].message
    assert findings[0].symbol == "P.fetch"


def test_gl003_negative_budgeted_calls(tmp_path):
    findings, _ = run_rule(tmp_path, "GL003", {
        "operator_tpu_torch/operator/pipeline.py": """
            import asyncio

            class P:
                async def threads_deadline(self, name, *, deadline=None):
                    return await asyncio.wait_for(
                        self.api.get("Pod", name, "ns"),
                        timeout=deadline.remaining(),
                    )

                async def keyword(self, req):
                    return await self.api.watch("Pod", timeout=30.0)

                async def internal_await(self, queue):
                    # not external: plain queue get never flags
                    return await queue.get()
        """,
    })
    assert findings == []


def test_gl003_positive_unspent_deadline_parameter(tmp_path):
    """A deadline parameter the function never spends bounds nothing —
    the call itself must carry the budget."""
    findings, _ = run_rule(tmp_path, "GL003", {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, name, *, deadline=None):
                    return await self.api.get("Pod", name, "ns")
        """,
    })
    assert len(findings) == 1


def test_gl003_positive_literal_none_timeout_is_not_a_budget(tmp_path):
    findings, _ = run_rule(tmp_path, "GL003", {
        "operator_tpu_torch/operator/pipeline.py": """
            import asyncio

            class P:
                async def kwarg_none(self, name):
                    return await self.api.get("Pod", name, "ns", timeout=None)

                async def wait_for_none(self, name):
                    return await asyncio.wait_for(
                        self.api.get("Pod", name, "ns"), timeout=None
                    )
        """,
    })
    assert len(findings) == 2


def test_gl003_scope_excludes_other_modules(tmp_path):
    # same code outside the eight control-plane files is not in scope
    findings, _ = run_rule(tmp_path, "GL003", {
        "operator_tpu_torch/operator/health.py": """
            class S:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")
        """,
    })
    assert findings == []


def test_gl003_widened_scope_covers_storage_events_watcher_app(tmp_path):
    """GL003 reaches beyond the four analysis-path modules:
    storage/events/watcher/app kube calls must spend kube_call_timeout_s
    at the call."""
    files = {
        f"operator_tpu_torch/operator/{name}.py": """
            class S:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")
        """
        for name in ("storage", "events", "watcher", "app")
    }
    findings, _ = run_rule(tmp_path, "GL003", files)
    assert len(findings) == 4
    assert {f.path.split("/")[-1] for f in findings} == {
        "storage.py", "events.py", "watcher.py", "app.py"
    }


# ---------------------------------------------------------------------------
# GL004 lock discipline
# ---------------------------------------------------------------------------

_GL004_POSITIVE = {
    "operator_tpu_torch/memory/state.py": """
        import threading

        class Store:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = {}

            def put(self, key, value):
                with self._lock:
                    self._items[key] = value

            def get(self, key):
                return self._items.get(key)   # unguarded read
    """,
}


def test_gl004_positive_unguarded_read(tmp_path):
    findings, _ = run_rule(tmp_path, "GL004", dict(_GL004_POSITIVE))
    assert len(findings) == 1
    assert "self._items" in findings[0].message
    assert findings[0].symbol == "Store.get"


def test_gl004_positive_container_mutation_is_a_write(tmp_path):
    """`self._queue.append(...)` under the lock puts _queue in the guard
    set; an unlocked .pop() elsewhere is the race the rule exists for."""
    findings, _ = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            import threading

            class Q:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._queue = []

                def push(self, item):
                    with self._lock:
                        self._queue.append(item)

                def steal(self):
                    return self._queue.pop()
        """,
    })
    assert len(findings) == 1
    assert findings[0].symbol == "Q.steal"
    assert "write" in findings[0].message


def test_gl004_bare_name_lock_import_is_detected(tmp_path):
    findings, _ = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            from threading import Lock

            class Store:
                def __init__(self):
                    self._lock = Lock()
                    self._items = {}

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value

                def get(self, key):
                    return self._items.get(key)
        """,
    })
    assert len(findings) == 1
    assert findings[0].symbol == "Store.get"


def test_gl004_closure_access_counts_as_lock_free(tmp_path):
    """A closure defined under the lock may run on another thread after
    the lock is released (executor.submit) — its accesses are lock-free."""
    findings, _ = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = {}

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value

                def flush(self, pool):
                    with self._lock:
                        def work():
                            self._items.clear()
                        pool.submit(work)
        """,
    })
    assert len(findings) == 1
    assert findings[0].symbol == "Store.flush.work"
    assert "write" in findings[0].message


def test_gl004_negative_locked_helpers_and_init(tmp_path):
    findings, _ = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = {}
                    self._restore()            # init-only helper

                def _restore(self):
                    self._items["boot"] = 1

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value
                        self._evict_locked()

                def _evict_locked(self):       # *_locked convention
                    while len(self._items) > 4:
                        self._items.popitem()

                def get(self, key):
                    with self._lock:
                        return self._items.get(key)

                def flush(self):
                    with self._lock:
                        self._flush_inner()

                def _flush_inner(self):        # every call site holds the lock
                    self._items.clear()
        """,
    })
    assert findings == []


# ---------------------------------------------------------------------------
# GL005 generated-artifact drift
# ---------------------------------------------------------------------------


def test_gl005_positive_undocumented_metric(tmp_path):
    findings, _ = run_rule(tmp_path, "GL005", {
        "operator_tpu_torch/mod.py": """
            def tick(metrics):
                metrics.incr("special_events")
        """,
        "docs/METRICS.md": "# Metrics\n\nnothing documented here\n",
    })
    assert len(findings) == 1
    assert "podmortem_special_events_total" in findings[0].message


def test_gl005_negative_documented_metric(tmp_path):
    findings, _ = run_rule(tmp_path, "GL005", {
        "operator_tpu_torch/mod.py": """
            def tick(metrics):
                metrics.incr("special_events")
        """,
        "docs/METRICS.md": "# Metrics\n\n`podmortem_special_events_total` — ticks.\n",
    })
    assert findings == []


def test_gl005_metric_docs_clean_on_repo():
    """Every podmortem_* metric the port can emit is documented under
    docs/ or README.md."""
    missing = undocumented_metrics(REPO_ROOT)
    assert missing == []


def test_gl005_crd_manifest_in_sync_with_crdgen():
    from operator_tpu_torch.schema.crdgen import render_all

    manifest = (REPO_ROOT / "deploy/crds/podmortem-crds.yaml").read_text()
    assert manifest.strip() == render_all().strip()


# ---------------------------------------------------------------------------
# GL006 event-loop-blocking
# ---------------------------------------------------------------------------


def test_gl006_positive_blocking_reachable_from_async(tmp_path):
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/operator/loop.py": """
            import time

            async def tick():
                _refresh()

            def _refresh():
                time.sleep(0.5)          # blocks the loop via tick()
                data = open("state.json").read()
                return data
        """,
    })
    messages = [f.message for f in findings]
    assert any("time.sleep" in m for m in messages)
    assert any("open(...)" in m for m in messages)
    # findings are attributed to the async entry that reaches them
    assert all("async `tick`" in m for m in messages)


def test_gl006_negative_offload_escape_hatch(tmp_path):
    """A function reference handed to to_thread runs OFF the loop — the
    sanctioned fix — so its body must not be walked."""
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/operator/loop.py": """
            import asyncio
            import time

            async def tick():
                await asyncio.to_thread(_refresh)

            def _refresh():
                time.sleep(0.5)  # fine: writer-thread side

            def sync_only_caller():
                _refresh()       # fine: never async-reachable
        """,
    })
    assert findings == []


def test_gl006_journal_modes(tmp_path):
    """Writer-thread journals enqueue and stay quiet; sync-mode appends
    and wait= (not constant-False) appends block and are flagged."""
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/operator/ledger.py": """
            from operator_tpu_torch.utils.journal import Journal

            class Ledger:
                def __init__(self, path):
                    self._fast = Journal(path, async_writes=True)
                    self._slow = Journal(path)

                async def handle(self, rec):
                    self._fast.append(rec)             # enqueue: quiet
                    self._slow.append(rec)             # sync-mode: flagged
                    self._fast.append(rec, wait=True)  # flush wait: flagged
        """,
    })
    messages = [f.message for f in findings]
    assert len(findings) == 2
    assert any("sync-mode Journal IO `self._slow.append(...)`" in m
               for m in messages)
    assert any("wait=True" in m for m in messages)


def test_gl006_done_guarded_result_is_allowed(tmp_path):
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/obs/peek.py": """
            async def drain(fut):
                if fut.done():
                    return fut.result()  # non-blocking by construction
                return None

            async def bad(fut):
                return fut.result()      # flagged: can block the loop
        """,
    })
    assert len(findings) == 1
    assert "`.result()`" in findings[0].message
    assert "async `bad`" in findings[0].message


def test_gl006_pragma_suppresses_with_reason(tmp_path):
    findings, pragma_errors = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/operator/boot.py": """
            async def start():
                cfg = open("boot.cfg").read()  # graftlint: disable=GL006 reason=startup-once read before the loop serves traffic
                return cfg
        """,
    })
    assert findings == []
    assert pragma_errors == []


# ---------------------------------------------------------------------------
# GL007 replay-determinism
# ---------------------------------------------------------------------------


def test_gl007_positive_wall_clock_and_unseeded_randomness(tmp_path):
    findings, _ = run_rule(tmp_path, "GL007", {
        "operator_tpu_torch/loadgen/storm.py": """
            import random
            import time

            def next_arrival(last):
                now = time.time()              # forks the replay
                jitter = random.random()       # global entropy
                return now + jitter
        """,
    })
    messages = [f.message for f in findings]
    assert len(findings) == 2
    assert any("time.time()" in m for m in messages)
    assert any("random.random" in m for m in messages)


def test_gl007_negative_seams_and_seeded_generators(tmp_path):
    """Uncalled clock references are seams (replay injects through them);
    perf_counter is measurement-only; seeded generators are sanctioned."""
    findings, _ = run_rule(tmp_path, "GL007", {
        "operator_tpu_torch/loadgen/storm.py": """
            import random
            import time

            import numpy as np

            class Storm:
                def __init__(self, seed, clock=None):
                    self._clock = clock or time.monotonic  # seam: uncalled
                    self._rng = random.Random(seed)
                    self._np_rng = np.random.default_rng(seed)

                def step(self):
                    started = time.perf_counter()  # measurement-only: fine
                    now = self._clock()            # through the seam: fine
                    return now, self._rng.random(), started
        """,
    })
    assert findings == []


# ---------------------------------------------------------------------------
# GL009 resource-release
# ---------------------------------------------------------------------------


def test_gl009_positive_early_return_leak(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/serving/kvstore.py": """
            class Pool:
                def admit(self, n):
                    pages = self.allocator.allocate(n)
                    if n > 4:
                        return None       # pages dropped: leak
                    self.rows.append(pages)
                    return pages
        """,
    })
    assert len(findings) == 1
    assert "early return" in findings[0].message
    assert "`pages`" in findings[0].message


def test_gl009_positive_raise_voids_allocation(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/serving/sched/slots.py": """
            class Slots:
                def reserve(self, n):
                    lane = self.lanes.acquire()
                    if n > self.cap:
                        raise ValueError("over capacity")  # lane in flight
                    return lane
        """,
    })
    assert len(findings) == 1
    assert "void-in-flight" in findings[0].message


def test_gl009_negative_try_finally_release(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/serving/kvstore.py": """
            class Pool:
                def fill(self, n):
                    pages = self.allocator.allocate(n)
                    try:
                        self.copy_in(pages)
                    finally:
                        self.allocator.free(pages)
        """,
    })
    assert findings == []


def test_gl009_negative_branch_release_and_transfer(tmp_path):
    """Releasing on one branch and transferring ownership (returning the
    handle) on the other discharges on every path."""
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/serving/engine.py": """
            class Engine:
                async def grant(self, n):
                    pages = await self.allocator.allocate(n)
                    if n == 0:
                        self.allocator.free(pages)
                        return None
                    return pages
        """,
    })
    assert findings == []


def test_gl009_cfg_scope_excludes_other_modules(tmp_path):
    """The CFG pass runs only over the resource economy — an `.acquire()`
    on a lock in the operator control plane is not a tracked handle."""
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/operator/lease.py": """
            class Lease:
                def renew(self):
                    token = self.lock.acquire()
                    return None
        """,
    })
    assert findings == []


def test_gl009_append_open_outside_journal(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/obs/adhoc.py": """
            def log_line(path, line):
                with open(path, "a") as fh:
                    fh.write(line)
        """,
        "operator_tpu_torch/utils/journal.py": """
            def _open_tail(path):
                return open(path, "ab")  # the one sanctioned append site
        """,
    })
    assert len(findings) == 1
    assert findings[0].path == "operator_tpu_torch/obs/adhoc.py"
    assert "append-mode open" in findings[0].message


# ---------------------------------------------------------------------------
# GL010 config-env-doc-drift
# ---------------------------------------------------------------------------

_GL010_CONFIG = """
    from dataclasses import dataclass

    @dataclass
    class OperatorConfig:
        poll_interval_s: float = 5.0
        secret_token: str = ""
"""


def test_gl010_positive_all_three_drift_directions(tmp_path):
    findings, _ = run_rule(tmp_path, "GL010", {
        "operator_tpu_torch/utils/config.py": _GL010_CONFIG,
        "README.md": """
            | env | meaning |
            |-----|---------|
            | `POLL_INTERVAL_S` | poll cadence |
            | `GHOST_KNOB` | documented but nothing reads it |
        """,
        "deploy/operator.yaml": """
            env:
              - name: POLL_INTERVAL_S
              - name: OLD_RENAMED_KNOB
        """,
    })
    symbols = {f.symbol for f in findings}
    assert len(findings) == 3
    # an undocumented field is an invisible knob
    assert "OperatorConfig.secret_token" in symbols
    # a deploy row nothing reads is a silently-dead setting
    assert "OLD_RENAMED_KNOB" in symbols
    # a README row nothing reads documents a knob that does not exist
    assert "GHOST_KNOB" in symbols
    by_symbol = {f.symbol: f for f in findings}
    assert by_symbol["OLD_RENAMED_KNOB"].path == "deploy/operator.yaml"
    assert by_symbol["GHOST_KNOB"].path == "README.md"


def test_gl010_negative_round_trip(tmp_path):
    """Fields documented, deploy rows consumed (by a field AND by a raw
    os.environ read), README rows backed — clean."""
    findings, _ = run_rule(tmp_path, "GL010", {
        "operator_tpu_torch/utils/config.py": _GL010_CONFIG,
        "operator_tpu_torch/obs/exporter.py": """
            import os

            ENDPOINT = os.environ.get("TRACE_ENDPOINT", "")
        """,
        "README.md": """
            | env | meaning |
            |-----|---------|
            | `POLL_INTERVAL_S` | poll cadence |
            | `SECRET_TOKEN` | provider credential |
            | `TRACE_ENDPOINT` | exporter target |
        """,
        "deploy/operator.yaml": """
            env:
              - name: POLL_INTERVAL_S
              - name: TRACE_ENDPOINT
        """,
    })
    assert findings == []


def test_gl010_an_overlays_delete_row_is_no_dead_setting(tmp_path):
    """A strategic-merge row that deletes a base entry sets nothing: it
    is how an overlay drops a setting the code never reads.  A row that
    sets a value nothing reads is still flagged, also in an overlay."""
    findings, _ = run_rule(tmp_path, "GL010", {
        "operator_tpu_torch/utils/config.py": _GL010_CONFIG,
        "README.md": """
            | env | meaning |
            |-----|---------|
            | `POLL_INTERVAL_S` | poll cadence |
            | `SECRET_TOKEN` | provider credential |
        """,
        "deploy/overlays/gpu/patch.yaml": """
            env:
              # dropped: nothing reads it
              - name: OLD_RENAMED_KNOB
                $patch: delete
              - name: OTHER_DEAD_KNOB
                value: "1"
              - name: POLL_INTERVAL_S
                value: "5"
        """,
    })
    assert [(f.symbol, f.path) for f in findings] == [
        ("OTHER_DEAD_KNOB", "deploy/overlays/gpu/patch.yaml")]


# ---------------------------------------------------------------------------
# GL011 await-atomicity
# ---------------------------------------------------------------------------


def test_gl011_positive_check_then_act_across_await(tmp_path):
    findings, _ = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/router/pool.py": """
            class Pool:
                async def evict(self, replica):
                    if replica in self._members:        # read
                        await self.probe(replica)       # world moves on
                        self._members.discard(replica)  # act on the stale check

                async def probe(self, replica):
                    return replica
        """,
    })
    assert len(findings) == 1
    assert "self._members" in findings[0].message
    assert "check-then-act" in findings[0].message
    assert findings[0].symbol == "Pool.evict"


def test_gl011_positive_async_for_step_taints_derived_write(tmp_path):
    """An ``async for`` step suspends before each body run; a write
    derived (through a local) from a pre-loop read is stale."""
    findings, _ = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/operator/watchpump.py": """
            class Pump:
                async def run(self, stream):
                    cursor = self._cursor
                    async for event in stream:
                        self._cursor = cursor + 1
        """,
    })
    assert len(findings) == 1
    assert "self._cursor" in findings[0].message


def test_gl011_negative_revalidation_after_await(tmp_path):
    """Re-reading the state after the await clears staleness — the write
    is then based on the current world (the sanctioned membership
    revalidation idiom, router/discovery.py's shape)."""
    findings, _ = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/router/pool.py": """
            class Pool:
                async def evict(self, replica):
                    if replica in self._members:
                        await self.probe(replica)
                        if replica in self._members:   # revalidate
                            self._members.discard(replica)

                async def probe(self, replica):
                    return replica
        """,
    })
    assert findings == []


def test_gl011_negative_write_under_held_lock(tmp_path):
    """A write inside ``async with`` on an inferred lock attribute is
    serialized against competing coroutines (GL004's guard discipline)."""
    findings, _ = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/router/pool.py": """
            import asyncio

            class Pool:
                def __init__(self):
                    self._lock = asyncio.Lock()
                    self._members = set()

                async def evict(self, replica):
                    async with self._lock:
                        if replica in self._members:
                            await self.probe(replica)
                            self._members.discard(replica)

                async def probe(self, replica):
                    return replica
        """,
    })
    assert findings == []


def test_gl011_negative_atomic_rmw_re_reads_at_the_write(tmp_path):
    """``self.n += 1`` re-reads the location at the write with no
    interleaving point between — not a TOCTOU even after an await."""
    findings, _ = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/operator/counterd.py": """
            class Counter:
                async def bump(self):
                    if self._count < self._limit:
                        await self.flush()
                        self._count += 1

                async def flush(self):
                    return None
        """,
    })
    assert findings == []


def test_gl011_pragma_with_reason_suppresses(tmp_path):
    findings, pragma_errors = run_rule(tmp_path, "GL011", {
        "operator_tpu_torch/operator/cursord.py": """
            class Watcher:
                async def advance(self, stream):
                    version = self._cursor
                    await self.drain(stream)
                    # graftlint: disable=GL011 reason=cursor advance is single-writer; monotonic overwrite is the informer discipline
                    self._cursor = version + 1

                async def drain(self, stream):
                    return stream
        """,
    })
    assert findings == []
    assert pragma_errors == []


# ---------------------------------------------------------------------------
# GL012 chaos-seam coverage
# ---------------------------------------------------------------------------


def test_gl012_positive_uncovered_external_call(tmp_path):
    """An external call no registered seam governs: chaos tests cannot
    inject its failure."""
    findings, _ = run_rule(tmp_path, "GL012", {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")
        """,
    })
    assert len(findings) == 1
    assert "reachable from no registered fault seam" in findings[0].message
    assert findings[0].path == "operator_tpu_torch/operator/pipeline.py"


def test_gl012_positive_seam_named_by_no_test(tmp_path):
    findings, _ = run_rule(tmp_path, "GL012", {
        "operator_tpu_torch/operator/gitops.py": """
            class Git:
                def push(self):
                    self.fault_plan.apply("git.push")
        """,
    })
    assert len(findings) == 1
    assert "named by no chaos/loadgen test" in findings[0].message
    assert "`git.push`" in findings[0].message


def test_gl012_covered_round_trip_emits_clean_map(tmp_path):
    """Seam on the call path (f-string widened to a glob) + a test
    naming a concrete site under the glob -> no findings, and the
    audit map records full coverage."""
    ctx = make_ctx(tmp_path, {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, op, name):
                    self.fault_plan.apply(f"kube.{op}")
                    return await self.api.get("Pod", name, "ns")
        """,
        "tests/test_torch_chaos_fixture.py": """
            SEAMS = ["kube.patch_status"]
        """,
    })
    findings, _ = run_analysis(ctx, rules_by_id(["GL012"]))
    assert findings == []
    coverage = ctx.caches["seam_coverage"]
    assert coverage["schema"] == 1
    assert coverage["uncovered_sites"] == 0
    assert coverage["unnamed_seams"] == 0
    [seam] = coverage["seams"]
    assert seam["pattern"] == "kube.*"
    assert seam["tests"] == ["tests/test_torch_chaos_fixture.py"]
    [site] = coverage["external_call_sites"]
    assert site["path"] == "operator_tpu_torch/operator/pipeline.py"
    assert site["seams"] == ["kube.*"]


def test_gl012_seam_in_caller_governs_helper_site(tmp_path):
    """Reachability runs the callgraph in both directions: a seam firing
    in the caller governs the raw call inside the helper it descends
    into."""
    findings, _ = run_rule(tmp_path, "GL012", {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, name):
                    self.fault_plan.apply("kube.get")
                    return await self._raw(name)

                async def _raw(self, name):
                    return await self.api.get("Pod", name, "ns")
        """,
        "tests/test_torch_chaos_fixture.py": """
            SEAM = "kube.get"
        """,
    })
    assert findings == []


def test_gl012_map_is_byte_deterministic_across_runs(tmp_path):
    """The seam-coverage artifact must diff meaningfully in CI: two runs
    over an unchanged tree serialize to identical bytes."""
    files = {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, op, name):
                    self.fault_plan.apply(f"kube.{op}")
                    return await self.api.get("Pod", name, "ns")

                async def push(self):
                    self.fault_plan.apply("git.push")
        """,
        "tests/test_torch_chaos_fixture.py": """
            SEAMS = ["kube.patch_status", "git.push"]
        """,
    }

    def run_once():
        ctx = make_ctx(tmp_path, files)
        run_analysis(ctx, rules_by_id(["GL012"]))
        return json.dumps(
            ctx.caches["seam_coverage"], indent=2, sort_keys=True
        )

    assert run_once() == run_once()


def test_gl012_async_seam_registers(tmp_path):
    """``await fault_plan.apply_async(...)`` is the async idiom of the
    same seam registration — it must govern its call path and count as
    a registered pattern (the sync->async seam migration must not
    silently empty the registry)."""
    findings, _ = run_rule(tmp_path, "GL012", {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def fetch(self, op, name):
                    await self.fault_plan.apply_async(f"kube.{op}")
                    return await self.api.get("Pod", name, "ns")
        """,
        "tests/test_torch_chaos_fixture.py": """
            SEAM = "kube.get"
        """,
    })
    assert findings == []


def test_gl012_scenario_file_counts_as_seam_naming(tmp_path):
    """A committed game-day scenario (tests/scenarios/*.json) naming a
    seam rehearses it: no `named by no test` finding, and the audit map
    lists the scenario file as the naming source."""
    ctx = make_ctx(tmp_path, {
        "operator_tpu_torch/operator/gitops.py": """
            class Git:
                def push(self):
                    self.fault_plan.apply("git.push")
        """,
        "tests/scenarios/repro-git.json": """
            {
              "name": "repro-git",
              "phases": [
                {"name": "p", "injections": [
                  {"seam": "git.push", "kind": "fail", "error": "timeout"}
                ]}
              ]
            }
        """,
    })
    findings, _ = run_analysis(ctx, rules_by_id(["GL012"]))
    assert findings == []
    coverage = ctx.caches["seam_coverage"]
    [seam] = coverage["seams"]
    assert seam["tests"] == ["tests/scenarios/repro-git.json"]
    assert coverage["scenario_files"] == {
        "tests/scenarios/repro-git.json": ["git.push"],
    }


def test_gl012_scenario_unknown_seam_is_flagged(tmp_path):
    """A scenario naming a seam no fault_plan.apply registers is dead
    chaos — the game day would queue an injection nothing fires."""
    ctx = make_ctx(tmp_path, {
        "operator_tpu_torch/mod.py": "X = 1\n",
        "tests/scenarios/bad.json": """
            {
              "name": "bad",
              "phases": [
                {"name": "p", "injections": [
                  {"seam": "kube.reboot", "kind": "fail", "error": "timeout"}
                ]}
              ]
            }
        """,
    })
    findings, _ = run_analysis(ctx, rules_by_id(["GL012"]))
    assert len(findings) == 1
    assert findings[0].path == "tests/scenarios/bad.json"
    assert "unknown fault seam `kube.reboot`" in findings[0].message
    assert findings[0].symbol == "bad"


def test_gl012_python_injection_unknown_seam_is_flagged(tmp_path):
    """Literal Injection("<seam>", ...) construction in test python is
    held to the same known-seam bar as JSON scenario files."""
    findings, _ = run_rule(tmp_path, "GL012", {
        "operator_tpu_torch/mod.py": "X = 1\n",
        "tests/test_torch_gameday_fixture.py": """
            from operator_tpu_torch.chaos import Injection

            BAD = Injection("kube.reboot", "fail", error="timeout")
        """,
    })
    assert len(findings) == 1
    assert findings[0].path == "tests/test_torch_gameday_fixture.py"
    assert "unknown fault seam `kube.reboot`" in findings[0].message


# ---------------------------------------------------------------------------
# GL013 mesh-axis consistency
# ---------------------------------------------------------------------------


def test_gl013_positive_undeclared_collective_axis(tmp_path):
    findings, _ = run_rule(tmp_path, "GL013", {
        "operator_tpu_torch/parallel/comm.py": """
            import torch.distributed._functional_collectives as funcol
            from torch.distributed.device_mesh import init_device_mesh

            def build():
                return init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"))

            def allreduce(x, mesh):
                return funcol.all_reduce(x, "sum", (mesh, "model"))
        """,
    })
    assert len(findings) == 1
    assert "collective all_reduce" in findings[0].message
    assert "axis 'model'" in findings[0].message
    assert "dp" in findings[0].message and "tp" in findings[0].message


def test_gl013_positive_spec_axis_not_in_mesh(tmp_path):
    findings, _ = run_rule(tmp_path, "GL013", {
        "operator_tpu_torch/parallel/shard.py": """
            from torch.distributed.device_mesh import init_device_mesh

            from operator_tpu_torch.parallel.mesh import P

            AXES = ("dp", "tp")

            def specs():
                mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
                return mesh, P(None, "model")
        """,
    })
    assert len(findings) == 1
    assert "spec P(...)" in findings[0].message
    assert "axis 'model'" in findings[0].message


def test_gl013_nested_mesh_shadowing(tmp_path):
    """The nearest enclosing ``with DeviceMesh(...)`` SHADOWS the module
    environment: an inner pipeline mesh redefines the axis world, so an
    outer-mesh axis looked up inside it is a finding."""
    findings, _ = run_rule(tmp_path, "GL013", {
        "operator_tpu_torch/parallel/pipe.py": """
            from torch.distributed import _functional_collectives as funcol
            from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

            def run(stage_ranks, x):
                mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"))
                with DeviceMesh("cuda", stage_ranks, mesh_dim_names=("stage",)):
                    group = mesh.get_group("tp")
                return funcol.all_reduce(x, "sum", group=(mesh, "dp")), group
        """,
    })
    assert len(findings) == 1
    assert "get_group" in findings[0].message
    assert "axis 'tp'" in findings[0].message
    assert "stage" in findings[0].message


def test_gl013_negative_declared_axes_and_meshless_module(tmp_path):
    """group= keyword, bare funcol imports, mesh[...] lookups, AXES
    constants resolved cross-module, and a module that declares NO mesh
    (empty environment: skipped, its specs are checked where a mesh is
    in scope)."""
    findings, _ = run_rule(tmp_path, "GL013", {
        "operator_tpu_torch/parallel/mesh.py": """
            AXES = ("dp", "tp")

            class P(tuple):
                pass
        """,
        "operator_tpu_torch/parallel/good.py": """
            from torch.distributed._functional_collectives import all_reduce
            from torch.distributed.device_mesh import init_device_mesh

            from operator_tpu_torch.parallel.mesh import AXES, P

            def reduce(x):
                with init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES) as mesh:
                    return (all_reduce(x, "sum", group=(mesh, "dp")), P("dp", None),
                            mesh["tp"], mesh["dp", "tp"], mesh.get_local_rank("dp"))
        """,
        "operator_tpu_torch/serving/layout.py": """
            from operator_tpu_torch.parallel.mesh import P

            def spec():
                return P(None, "model")
        """,
    })
    assert findings == []


def test_gl013_mesh_subscript_of_an_undeclared_axis(tmp_path):
    findings, _ = run_rule(tmp_path, "GL013", {
        "operator_tpu_torch/serving/sharded.py": """
            from torch.distributed.device_mesh import init_device_mesh

            def tp_group():
                device_mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("tp",))
                return device_mesh["dp", "tp"], {"dp": 1}["dp"]
        """,
    })
    assert len(findings) == 1
    assert "mesh lookup" in findings[0].message and "axis 'dp'" in findings[0].message


def test_gl013_holds_the_ports_mesh_module(tmp_path):
    """The port's own parallel/ modules are clean, and a mistyped axis
    added to parallel/mesh.py's specs is caught."""
    files = {rel: (REPO_ROOT / rel).read_text() for rel in (
        "operator_tpu_torch/parallel/mesh.py", "operator_tpu_torch/parallel/train.py",
        "operator_tpu_torch/parallel/lora.py")}
    findings, _ = run_rule(tmp_path / "clean", "GL013", files)
    assert findings == []
    files["operator_tpu_torch/parallel/mesh.py"] = files[
        "operator_tpu_torch/parallel/mesh.py"].replace('"wo": P(None, "tp", f)',
                                                       '"wo": P(None, "tpp", f)')
    findings, _ = run_rule(tmp_path / "mutated", "GL013", files)
    assert len(findings) == 1 and "axis 'tpp'" in findings[0].message


# ---------------------------------------------------------------------------
# widened scopes: router/discovery.py + operator/autoscale.py
# ---------------------------------------------------------------------------


def test_gl006_widened_scope_discovery_positive(tmp_path):
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/router/discovery.py": """
            import time

            class Discovery:
                async def _sync(self):
                    time.sleep(0.1)
        """,
    })
    assert len(findings) == 1
    assert "time.sleep" in findings[0].message


def test_gl006_widened_scope_autoscale_negative_offload(tmp_path):
    findings, _ = run_rule(tmp_path, "GL006", {
        "operator_tpu_torch/operator/autoscale.py": """
            import asyncio
            import time

            class Autoscaler:
                async def tick(self):
                    await asyncio.to_thread(self._measure)

                def _measure(self):
                    time.sleep(0.1)
        """,
    })
    assert findings == []


def test_gl007_widened_scope_autoscale_positive(tmp_path):
    findings, _ = run_rule(tmp_path, "GL007", {
        "operator_tpu_torch/operator/autoscale.py": """
            import random
            import time

            def decide(depth):
                return time.time() + random.random() * depth
        """,
    })
    messages = [f.message for f in findings]
    assert len(findings) == 2
    assert any("time.time()" in m for m in messages)
    assert any("random.random" in m for m in messages)


def test_gl007_widened_scope_autoscale_negative_injected_clock(tmp_path):
    findings, _ = run_rule(tmp_path, "GL007", {
        "operator_tpu_torch/operator/autoscale.py": """
            import random
            import time

            class Autoscaler:
                def __init__(self, seed, clock=None):
                    self._clock = clock or time.monotonic  # seam: uncalled
                    self._rng = random.Random(seed)

                def decide(self):
                    return self._clock() + self._rng.random()
        """,
    })
    assert findings == []


def test_gl009_widened_scope_discovery_positive(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/router/discovery.py": """
            class Ring:
                def join(self, n):
                    lease = self.leases.acquire()
                    if n > 8:
                        return None       # lease dropped: leak
                    self.members.append(lease)
                    return lease
        """,
    })
    assert len(findings) == 1
    assert "early return" in findings[0].message
    assert "`lease`" in findings[0].message


def test_gl009_widened_scope_autoscale_negative_finally(tmp_path):
    findings, _ = run_rule(tmp_path, "GL009", {
        "operator_tpu_torch/operator/autoscale.py": """
            class Autoscaler:
                def scale(self, n):
                    lease = self.leases.acquire()
                    try:
                        self.commit(n)
                    finally:
                        self.leases.free(lease)
        """,
    })
    assert findings == []


# ---------------------------------------------------------------------------
# pragmas
# ---------------------------------------------------------------------------


def test_pragma_suppresses_with_reason(tmp_path):
    findings, pragma_errors = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = {}

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value

                def get(self, key):
                    # graftlint: disable=GL004 reason=lock-free snapshot is deliberate here
                    return self._items.get(key)
        """,
    })
    assert findings == []
    assert pragma_errors == []


def test_pragma_without_reason_does_not_suppress(tmp_path):
    source = _GL004_POSITIVE["operator_tpu_torch/memory/state.py"].replace(
        "return self._items.get(key)   # unguarded read",
        "return self._items.get(key)  # graftlint" + ": disable=GL004",
    )
    findings, pragma_errors = run_rule(
        tmp_path, "GL004", {"operator_tpu_torch/memory/state.py": source}
    )
    assert len(findings) == 1  # still reported
    assert len(pragma_errors) == 1
    assert pragma_errors[0].rule == "GL000"
    assert "reason=" in pragma_errors[0].message


def test_pragma_inside_string_literal_is_inert(tmp_path):
    """Pragma-shaped text in docstrings/strings (rule docs, fixtures)
    must neither suppress findings nor trip the GL000 malformed check."""
    files = dict(_GL004_POSITIVE)
    files["operator_tpu_torch/memory/state.py"] = files[
        "operator_tpu_torch/memory/state.py"
    ].replace(
        "def get(self, key):",
        'def get(self, key):\n'
        '                """docs say: graftlint: disable=GL004"""',
    )
    findings, pragma_errors = run_rule(tmp_path, "GL004", files)
    assert len(findings) == 1  # the unguarded read is still reported
    assert pragma_errors == []  # and no malformed-pragma noise


def test_pragma_on_def_line_covers_whole_function(tmp_path):
    findings, _ = run_rule(tmp_path, "GL004", {
        "operator_tpu_torch/memory/state.py": """
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = {}

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value

                def get(self, key):  # graftlint: disable=GL004 reason=snapshot reader
                    first = self._items.get(key)
                    return first or self._items.get("default")
        """,
    })
    assert findings == []


# ---------------------------------------------------------------------------
# baseline round-trip
# ---------------------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    ctx = make_ctx(tmp_path, dict(_GL004_POSITIVE))
    findings, _ = run_analysis(ctx, rules_by_id(["GL004"]))
    assert findings

    baseline_path = tmp_path / "analysis-baseline-torch.json"
    write_baseline(baseline_path, findings)
    baseline = load_baseline(baseline_path)

    # same findings -> all absorbed, nothing new, nothing stale
    new, stale = baseline.filter(findings)
    assert new == [] and stale == []

    # identity survives line drift: shift the file down three lines
    shifted = "\n\n\n" + (tmp_path / "operator_tpu_torch/memory/state.py").read_text()
    (tmp_path / "operator_tpu_torch/memory/state.py").write_text(shifted)
    ctx2 = collect_context(tmp_path)
    findings2, _ = run_analysis(ctx2, rules_by_id(["GL004"]))
    new2, stale2 = baseline.filter(findings2)
    assert new2 == [] and stale2 == []

    # debt paid -> the entry turns stale, the gate stays green
    new3, stale3 = baseline.filter([])
    assert new3 == [] and len(stale3) == 1


def test_baseline_counts_absorb_exact_multiplicity(tmp_path):
    ctx = make_ctx(tmp_path, {
        "operator_tpu_torch/operator/pipeline.py": """
            class P:
                async def one(self, name):
                    return await self.api.get("Pod", name, "ns")
        """,
    })
    findings, _ = run_analysis(ctx, rules_by_id(["GL003"]))
    baseline = Baseline.from_findings(findings)
    # a second identical finding in the same symbol is NOT absorbed
    doubled = findings + findings
    new, _ = baseline.filter(doubled)
    assert len(new) == len(findings)


# ---------------------------------------------------------------------------
# the repo gate (acceptance: the committed tree is clean)
# ---------------------------------------------------------------------------


def test_repo_gate_is_clean(repo_gate):
    rc, out = repo_gate
    assert rc == 0, f"graftlint found new issues:\n{out}"
    assert "clean" in out


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in PORT_RULES:
        assert rule_id in out
    # no counterpart: Mosaic lowerability (CUDA C++ kernels)
    assert "GL008" not in out


def test_cli_unknown_rule_is_usage_error(capsys):
    assert cli_main(["--rules", "GL999"]) == 2


@pytest.mark.parametrize("rule_id", ["GL008"])
def test_cli_jax_only_rules_are_unknown(capsys, rule_id):
    assert cli_main(["--rules", rule_id]) == 2
    assert f"unknown rule id(s): {rule_id}" in capsys.readouterr().err


def test_cli_partial_rules_run_does_not_report_other_rules_stale(tmp_path, capsys):
    """`--rules GL001` cannot vouch for GL003 entries — they are
    unchecked, not stale, and must not be reported for deletion."""
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    (tmp_path / "operator_tpu_torch/operator/pipeline.py").write_text(
        "class P:\n"
        "    async def fetch(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    bl = tmp_path / "bl.json"
    assert cli_main([
        "--root", str(tmp_path), "--baseline", str(bl), "--write-baseline",
    ]) == 0
    rc = cli_main([
        "--root", str(tmp_path), "--rules", "GL001", "--baseline", str(bl),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "stale" not in out


def test_cli_write_baseline_refuses_partial_runs(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    rc = cli_main([
        "--root", str(tmp_path), "--rules", "GL003",
        "--baseline", str(tmp_path / "bl.json"), "--write-baseline",
    ])
    assert rc == 2
    assert "FULL analysis" in capsys.readouterr().err
    assert not (tmp_path / "bl.json").exists()


def test_cli_nonexistent_baseline_is_usage_error(tmp_path, capsys):
    """A moved/typo'd baseline must not re-present grandfathered debt as
    new regressions — fail loudly instead."""
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    rc = cli_main([
        "--root", str(tmp_path),
        "--baseline", str(tmp_path / "moved-elsewhere.json"),
    ])
    assert rc == 2
    assert "no such baseline file" in capsys.readouterr().err


def test_cli_nonexistent_path_is_usage_error_not_clean(tmp_path, capsys):
    """A typo'd path must fail loudly, never 'clean — 0 file(s)'."""
    rc = cli_main([
        "--root", str(tmp_path), str(tmp_path / "no_such_dir"),
    ])
    assert rc == 2
    assert "no such path" in capsys.readouterr().err


def test_cli_out_of_root_path_is_usage_error(tmp_path, capsys):
    outside = tmp_path / "outside.py"
    outside.write_text("x = 1\n")
    inside = tmp_path / "repo"
    inside.mkdir()
    rc = cli_main(["--root", str(inside), str(outside)])
    assert rc == 2
    assert "outside the analysis root" in capsys.readouterr().err


def test_cli_json_format(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    (tmp_path / "operator_tpu_torch/operator/pipeline.py").write_text(
        "class P:\n"
        "    async def fetch(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    rc = cli_main(["--root", str(tmp_path), "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["findings"][0]["rule"] == "GL003"


def test_cli_github_format_emits_workflow_commands(tmp_path, capsys):
    """--format github prints one ::error annotation per finding (the
    Actions runner turns these into inline PR comments) and keeps the
    hard-fail exit code."""
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    (tmp_path / "operator_tpu_torch/operator/pipeline.py").write_text(
        "class P:\n"
        "    async def fetch(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    rc = cli_main(["--root", str(tmp_path), "--format", "github"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "::error file=operator_tpu_torch/operator/pipeline.py,line=" in out
    assert "title=GL003" in out


def test_cli_github_format_escapes_newlines_and_percent(capsys):
    from operator_tpu_torch.analysis.__main__ import _github_line
    from operator_tpu_torch.analysis.core import Finding

    line = _github_line(Finding(
        rule="GL001", path="a.py", line=3,
        message="100% sync\nsecond line",
    ))
    assert "%25" in line and "%0A" in line
    assert "\n" not in line


def test_cli_timings_prints_per_rule_wall_time(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    rc = cli_main(["--root", str(tmp_path), "--timings"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "timing: GL001" in out
    assert "timing: GL010" in out
    assert "ms" in out


def _git(tmp_path, *argv):
    import subprocess

    subprocess.run(
        [
            "git", "-C", str(tmp_path),
            "-c", "user.email=lint@test", "-c", "user.name=lint",
            *argv,
        ],
        check=True, capture_output=True,
    )


def test_cli_changed_only_lints_only_the_diff(tmp_path, capsys):
    """--changed-only REF analyses files differing from REF (plus
    untracked) — a pre-existing finding in an UNCHANGED file must not
    block the pre-commit run."""
    import shutil

    if shutil.which("git") is None:
        pytest.skip("git not available")
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    dirty = tmp_path / "operator_tpu_torch/operator/pipeline.py"
    dirty.write_text(
        "class P:\n"
        "    async def fetch(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-q", "-m", "seed")
    # the committed tree has a finding; the changed set is empty
    rc = cli_main(["--root", str(tmp_path), "--changed-only", "HEAD"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "no .py files differ" in out
    # an untracked file with a finding IS in the changed set
    extra = tmp_path / "operator_tpu_torch/operator/providers.py"
    extra.write_text(
        "class Q:\n"
        "    async def probe(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    rc = cli_main(["--root", str(tmp_path), "--changed-only", "HEAD"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "providers.py" in out
    assert "pipeline.py" not in out


def test_cli_changed_only_bad_ref_is_usage_error(tmp_path, capsys):
    import shutil

    if shutil.which("git") is None:
        pytest.skip("git not available")
    (tmp_path / "operator_tpu_torch").mkdir()
    _git(tmp_path, "init", "-q")
    rc = cli_main([
        "--root", str(tmp_path), "--changed-only", "no-such-ref",
    ])
    assert rc == 2


def test_cli_changed_only_excludes_explicit_paths(tmp_path, capsys):
    rc = cli_main([
        "--root", str(tmp_path), "--changed-only", "HEAD", "some/path.py",
    ])
    assert rc == 2
    assert "mutually exclusive" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# baseline round-trip for the v3 rule ids
# ---------------------------------------------------------------------------

_V3_POSITIVES = {
    "operator_tpu_torch/router/pool.py": """
        class Pool:
            async def evict(self, replica):
                if replica in self._members:
                    await self.probe(replica)
                    self._members.discard(replica)

            async def probe(self, replica):
                return replica
    """,
    "operator_tpu_torch/operator/pipeline.py": """
        class P:
            async def fetch(self, name):
                return await self.api.get("Pod", name, "ns")
    """,
}


def test_baseline_round_trip_new_rule_ids(tmp_path):
    """GL011/GL012 findings absorb, survive line drift in identity, and
    turn stale (not new) when the debt is paid — same contract as the
    other rules."""
    ctx = make_ctx(tmp_path, dict(_V3_POSITIVES))
    findings, _ = run_analysis(ctx, rules_by_id(["GL011", "GL012"]))
    assert {f.rule for f in findings} == {"GL011", "GL012"}

    baseline_path = tmp_path / "bl.json"
    write_baseline(baseline_path, findings)
    baseline = load_baseline(baseline_path)
    new, stale = baseline.filter(findings)
    assert new == [] and stale == []

    new2, stale2 = baseline.filter([])
    assert new2 == [] and len(stale2) == len(findings)


# ---------------------------------------------------------------------------
# SARIF output
# ---------------------------------------------------------------------------


def test_cli_sarif_schema_and_findings(tmp_path, capsys):
    """--format sarif prints a SARIF 2.1.0 document on stdout: driver
    metadata for the full catalogue, one result per finding with a
    %SRCROOT%-relative physical location."""
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    (tmp_path / "operator_tpu_torch/operator/pipeline.py").write_text(
        "class P:\n"
        "    async def fetch(self, name):\n"
        "        return await self.api.get('Pod', name, 'ns')\n"
    )
    rc = cli_main(["--root", str(tmp_path), "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    driver = doc["runs"][0]["tool"]["driver"]
    assert driver["name"] == "graftlint"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert len(rule_ids) == len(set(rule_ids))
    assert set(rule_ids) == set(PORT_RULES)
    assert all(r["shortDescription"]["text"] for r in driver["rules"])
    results = doc["runs"][0]["results"]
    assert results, "expected at least the GL003 finding"
    for result in results:
        assert result["level"] == "error"
        assert result["message"]["text"]
        location = result["locations"][0]["physicalLocation"]
        assert location["artifactLocation"]["uriBaseId"] == "%SRCROOT%"
        assert location["region"]["startLine"] >= 1
    assert any(
        r["ruleId"] == "GL003"
        and r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"]
        == "operator_tpu_torch/operator/pipeline.py"
        for r in results
    )


def test_cli_sarif_clean_run_exits_zero(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    rc = cli_main(["--root", str(tmp_path), "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["runs"][0]["results"] == []


def test_cli_sarif_gl000_gets_a_driver_rule_entry(tmp_path, capsys):
    """Framework findings (malformed pragma) are outside the catalogue —
    the SARIF driver must still declare their ruleId."""
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text(
        "X = 1  # graftlint: disable=GL003\n"  # missing reason=
    )
    rc = cli_main(["--root", str(tmp_path), "--format", "sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    driver_ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    result_ids = {r["ruleId"] for r in doc["runs"][0]["results"]}
    assert result_ids <= driver_ids


# ---------------------------------------------------------------------------
# --jobs / --seam-coverage / --timings-budget
# ---------------------------------------------------------------------------


def test_cli_jobs_output_is_byte_identical_to_serial(tmp_path, capsys):
    """--jobs N shares the context memo across threads and merges results
    in catalogue order: stdout must match the serial run exactly."""
    ctx_files = dict(_V3_POSITIVES)
    for rel, text in ctx_files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text), encoding="utf-8")
    rc_serial = cli_main(["--root", str(tmp_path)])
    out_serial = capsys.readouterr().out
    rc_parallel = cli_main(["--root", str(tmp_path), "--jobs", "4"])
    out_parallel = capsys.readouterr().out
    assert rc_serial == rc_parallel == 1
    assert out_serial == out_parallel


def test_cli_seam_coverage_writes_deterministic_map(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch/operator").mkdir(parents=True)
    (tmp_path / "operator_tpu_torch/operator/pipeline.py").write_text(
        textwrap.dedent("""
            class P:
                async def fetch(self, op, name):
                    self.fault_plan.apply(f"kube.{op}")
                    return await self.api.get("Pod", name, "ns")
        """),
    )
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests/test_torch_chaos_fixture.py").write_text(
        'SEAM = "kube.get"\n'
    )
    out_path = tmp_path / "seam-coverage.json"
    rc = cli_main([
        "--root", str(tmp_path), "--rules", "GL012",
        "--seam-coverage", str(out_path),
    ])
    capsys.readouterr()
    assert rc == 0
    first = out_path.read_bytes()
    payload = json.loads(first)
    assert payload["schema"] == 1
    assert payload["uncovered_sites"] == 0
    assert payload["unnamed_seams"] == 0
    rc = cli_main([
        "--root", str(tmp_path), "--rules", "GL012",
        "--seam-coverage", str(out_path),
    ])
    capsys.readouterr()
    assert rc == 0
    assert out_path.read_bytes() == first


def test_cli_seam_coverage_requires_gl012(tmp_path, capsys):
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    rc = cli_main([
        "--root", str(tmp_path), "--rules", "GL001",
        "--seam-coverage", str(tmp_path / "map.json"),
    ])
    assert rc == 2
    assert "GL012" in capsys.readouterr().err
    assert not (tmp_path / "map.json").exists()


def test_cli_timings_budget_gate(tmp_path, capsys):
    """--timings-budget folds a wall-time ceiling into the exit code —
    the CI guard that a rule has not grown quadratic."""
    (tmp_path / "operator_tpu_torch").mkdir()
    (tmp_path / "operator_tpu_torch/mod.py").write_text("X = 1\n")
    assert cli_main([
        "--root", str(tmp_path), "--timings-budget", "3600",
    ]) == 0
    capsys.readouterr()
    rc = cli_main(["--root", str(tmp_path), "--timings-budget", "0"])
    captured = capsys.readouterr()
    assert rc == 1
    assert "exceeds" in captured.err
    assert "clean" in captured.out  # findings-wise the run is still clean


# ---------------------------------------------------------------------------
# parity: the port's host rules against the JAX package's
# ---------------------------------------------------------------------------

#: rule -> host-code fixture, ``{pkg}`` standing for the package directory
#: (and import root); each holds positives and the legal idioms beside them
_PARITY_FIXTURES = {
    "GL003": {
        "{pkg}/operator/pipeline.py": """
            import asyncio

            class P:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")

                async def budgeted(self, name, *, deadline=None):
                    return await asyncio.wait_for(
                        self.api.get("Pod", name, "ns"),
                        timeout=deadline.remaining(),
                    )

                async def none_budget(self, name):
                    return await self.api.get("Pod", name, "ns", timeout=None)
        """,
        "{pkg}/operator/storage.py": """
            class S:
                async def fetch(self, name, *, deadline=None):
                    return await self.api.get("Pod", name, "ns")
        """,
    },
    "GL004": {
        "{pkg}/memory/state.py": """
            import threading

            class Store:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = {}
                    self._queue = []

                def put(self, key, value):
                    with self._lock:
                        self._items[key] = value
                        self._queue.append(key)

                def get(self, key):
                    return self._items.get(key)

                def steal(self):
                    return self._queue.pop()

                def locked_get(self, key):
                    with self._lock:
                        return self._items.get(key)
        """,
    },
    "GL005": {
        "{pkg}/mod.py": """
            def tick(metrics, hit):
                metrics.incr("special_events")
                metrics.incr("cache_hits" if hit else "cache_misses")
                metrics.observe("lookup_seconds", 0.1)
                metrics.incr("documented_events", labels={"reason": "x"})
        """,
        "docs/METRICS.md": "# Metrics\n\n`podmortem_documented_events_total`\n",
    },
    "GL006": {
        "{pkg}/operator/loop.py": """
            import asyncio
            import time

            async def tick():
                _refresh()
                await asyncio.to_thread(_offloaded)

            def _refresh():
                time.sleep(0.5)
                return open("state.json").read()

            def _offloaded():
                time.sleep(0.5)
        """,
        "{pkg}/obs/peek.py": """
            async def drain(fut):
                if fut.done():
                    return fut.result()
                return None

            async def bad(fut):
                return fut.result()
        """,
    },
    "GL007": {
        "{pkg}/loadgen/storm.py": """
            import random
            import time

            class Storm:
                def __init__(self, seed, clock=None):
                    self._clock = clock or time.monotonic
                    self._rng = random.Random(seed)

                def next_arrival(self, last):
                    started = time.perf_counter()
                    return time.time() + random.random() + self._clock(), started
        """,
    },
    "GL009": {
        "{pkg}/serving/kvstore.py": """
            class Pool:
                def admit(self, n):
                    pages = self.allocator.allocate(n)
                    if n > 4:
                        return None
                    self.rows.append(pages)
                    return pages

                def fill(self, n):
                    pages = self.allocator.allocate(n)
                    try:
                        self.copy_in(pages)
                    finally:
                        self.allocator.free(pages)
        """,
        "{pkg}/obs/adhoc.py": """
            def log_line(path, line):
                with open(path, "a") as fh:
                    fh.write(line)
        """,
        "{pkg}/utils/journal.py": """
            def _open_tail(path):
                return open(path, "ab")
        """,
    },
    "GL010": {
        "{pkg}/utils/config.py": """
            from dataclasses import dataclass

            @dataclass
            class OperatorConfig:
                poll_interval_s: float = 5.0
                secret_token: str = ""
        """,
        "{pkg}/obs/exporter.py": """
            import os

            ENDPOINT = os.environ.get("TRACE_ENDPOINT", "")
        """,
        "README.md": """
            | env | meaning |
            |-----|---------|
            | `POLL_INTERVAL_S` | poll cadence |
            | `TRACE_ENDPOINT` | exporter target |
            | `GHOST_KNOB` | documented but nothing reads it |
        """,
        "deploy/operator.yaml": """
            env:
              - name: POLL_INTERVAL_S
              - name: TRACE_ENDPOINT
              - name: OLD_RENAMED_KNOB
        """,
    },
    "GL011": {
        "{pkg}/router/pool.py": """
            class Pool:
                async def evict(self, replica):
                    if replica in self._members:
                        await self.probe(replica)
                        self._members.discard(replica)

                async def revalidated(self, replica):
                    if replica in self._members:
                        await self.probe(replica)
                        if replica in self._members:
                            self._members.discard(replica)

                async def probe(self, replica):
                    return replica
        """,
        "{pkg}/operator/watchpump.py": """
            class Pump:
                async def run(self, stream):
                    cursor = self._cursor
                    async for event in stream:
                        self._cursor = cursor + 1
        """,
    },
    "GL012": {
        "{pkg}/operator/pipeline.py": """
            class P:
                async def fetch(self, name):
                    return await self.api.get("Pod", name, "ns")

                async def covered(self, op, name):
                    self.fault_plan.apply(f"kube.{op}")
                    return await self.api.get("Pod", name, "ns")

                def push(self):
                    self.fault_plan.apply("git.push")
        """,
        "tests/test_torch_chaos_fixture.py": """
            SEAMS = ["kube.patch_status"]
        """,
        "tests/scenarios/bad.json": """
            {
              "name": "bad",
              "phases": [
                {"name": "p", "injections": [
                  {"seam": "kube.reboot", "kind": "fail", "error": "timeout"}
                ]}
              ]
            }
        """,
    },
}


def _normalised(findings, pkg: str) -> list[tuple]:
    return sorted(
        (f.rule, f.path.replace(pkg, "<pkg>"), f.line,
         f.symbol.replace(pkg, "<pkg>"), f.message.replace(pkg, "<pkg>"))
        for f in findings
    )


@pytest.mark.parametrize("rule_id", sorted(_PARITY_FIXTURES))
def test_port_rule_matches_jax_rule(tmp_path, rule_id):
    """The same host code, once under operator_tpu/ for the JAX rule and
    once under operator_tpu_torch/ for the port's: equal findings (rule,
    line, symbol, message), the package name normalised."""
    from operator_tpu.analysis import rules_by_id as jax_rules_by_id
    from operator_tpu.analysis import run_analysis as jax_run_analysis
    from operator_tpu.analysis.runner import collect_context as jax_collect

    results = {}
    for pkg, collect, run, by_id in (
        ("operator_tpu", jax_collect, jax_run_analysis, jax_rules_by_id),
        ("operator_tpu_torch", collect_context, run_analysis, rules_by_id),
    ):
        root = tmp_path / pkg
        for rel, text in _PARITY_FIXTURES[rule_id].items():
            path = root / rel.format(pkg=pkg)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(textwrap.dedent(text), encoding="utf-8")
        findings, pragma_errors = run(collect(root), by_id([rule_id]))
        assert pragma_errors == []
        results[pkg] = _normalised(findings, pkg)
    assert results["operator_tpu_torch"], "the fixture must trip the rule"
    assert results["operator_tpu_torch"] == results["operator_tpu"]


#: the serving mesh's collectives (``parallel/mesh.py:ServingShard``),
#: which the programs reach through annotated receivers: ``shard:
#: Optional["ServingShard"]`` in ``models/llama.py`` and ``self.shard``
#: in ``serving/programs.py``
_MESH_COLLECTIVES = {
    "reduce_tp": "    def reduce_tp(",
    "gather": "    def _gather(",
    "logits": "    def logits(self",
}


@pytest.fixture(scope="module")
def probed_mesh(tmp_path_factory):
    """GL001 over a copy of the port's compute tree with a probe sync in
    each of :data:`_MESH_COLLECTIVES`."""
    root = tmp_path_factory.mktemp("probed_mesh")
    for sub in ("ops", "serving", "models", "parallel"):
        shutil.copytree(
            REPO_ROOT / "operator_tpu_torch" / sub, root / "operator_tpu_torch" / sub,
            ignore=shutil.ignore_patterns("__pycache__", "csrc", "builtin"),
        )
    for marker in _MESH_COLLECTIVES.values():
        _inject_probe(root / "operator_tpu_torch/parallel/mesh.py", marker)
    findings, _ = run_analysis(collect_context(root), rules_by_id(["GL001"]))
    return findings


@pytest.mark.parametrize("method", sorted(_MESH_COLLECTIVES))
def test_mesh_collectives_are_reached_from_the_programs(probed_mesh, method):
    """A host sync in a serving mesh collective is one inside every
    program that reaches it; the collectives themselves are not host
    syncs (the repo gate is clean over them)."""
    symbol = "ServingShard._gather" if method == "gather" else f"ServingShard.{method}"
    hits = [f for f in probed_mesh
            if f.path == "operator_tpu_torch/parallel/mesh.py" and f.symbol == symbol]
    assert len(hits) == 1, [f.render() for f in probed_mesh]
    assert len(probed_mesh) == len(_MESH_COLLECTIVES)


def test_an_unannotated_receiver_stays_unresolved(tmp_path):
    """Only a receiver whose class an annotation names resolves: the same
    call on an unannotated parameter reaches nothing."""
    pkg = tmp_path / "operator_tpu_torch" / "serving"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text(
        "class Shard:\n"
        "    def reduce(self, x):\n"
        "        return x.item()\n"
        "\n"
        "class Engine:\n"
        "    def build(self, graphs):\n"
        "        graphs.program('a', self.typed)\n"
        "        graphs.program('b', self.untyped)\n"
        "\n"
        "    def typed(self, x, shard: 'Shard'):\n"
        "        return shard.reduce(x)\n"
        "\n"
        "    def untyped(self, x, shard):\n"
        "        return shard.reduce(x)\n",
        encoding="utf-8",
    )
    findings, _ = run_analysis(collect_context(tmp_path), rules_by_id(["GL001"]))
    assert [f.symbol for f in findings] == ["Shard.reduce"], [f.render() for f in findings]
