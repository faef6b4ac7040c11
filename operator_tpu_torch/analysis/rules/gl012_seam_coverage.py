"""GL012 — chaos-seam coverage: every external call must be faultable.

The chaos harness (``utils/faultinject.py``) only exercises failure paths
that pass through a registered seam — a ``fault_plan.apply("site", ...)``
call on the code path.  An external call that no seam governs is a failure
mode no chaos test can inject, and a seam no test names is a failure mode
nobody rehearses.  Both decay silently: a new kube verb or HTTP hop lands
green because only its happy path runs in CI.

The rule proves two properties for the control plane's side-effecting
sites (the same site set GL003 budgets, via
:func:`~.gl003_deadline.external_call_label`):

(a) **seam-reachable** — from the site's enclosing function, following the
    shared callgraph (``analysis/callgraph.py``) in BOTH directions
    (callees: the seam lives inside the op implementation, e.g.
    ``FakeKubeApi`` applying ``kube.<op>`` before the verb; callers: the
    seam fires before descending into the helper that owns the raw
    socket, e.g. ``http.provider`` wrapping the urlopen closure), some
    function contains a ``fault_plan.apply`` whose site pattern therefore
    governs the call;
(b) **test-named** — every registered seam pattern is named by at least
    one string literal in the port's tests (``tests/test_torch_*.py``),
    its ``loadgen/`` or ``chaos/``, or by a game-day scenario file under
    ``tests/scenarios/*.json`` — a seam only the JAX package's tests name
    is a port finding (f-string
    seam sites register as fnmatch globs — ``f"kube.{op}"`` is
    ``kube.*`` — and a test naming ``kube.patch_status`` matches it; the
    comparison runs both directions so a test's own glob ``kube.*`` also
    matches a literal seam).

Scenario files are first-class seam sources, and the compact is
two-way: a seam a scenario names counts as rehearsed, and a scenario
naming a seam NO ``fault_plan.apply`` registers is a lint error — the
conductor would queue an injection nothing ever consumes, and the
game day's ``pending_faults`` gate would blame the scenario at run
time instead of the diff that renamed the seam.  The same unknown-seam
check covers literal ``Injection("<seam>", ...)`` construction in
the port's chaos/test python.

The full audit is emitted as a deterministic ``seam-coverage.json`` map
(``--seam-coverage FILE``; byte-identical across runs on an unchanged
tree) that CI publishes as an artifact — the seam registry's contract
surface, reviewable in PR diffs.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import re
from typing import Optional

from ..callgraph import DEF_NODES, attr_chain, iter_scope
from ..core import AnalysisContext, Finding, ModuleSource, Rule
from .gl003_deadline import DeadlinePropagation, _is_api_handle, _KUBE_OPS

#: non-self method names the reachability walk may resolve
#: class-agnostically — kube verbs on api handles plus the two provider
#: protocol names; anything wider would alias container protocol methods
#: across the tree
_EDGE_METHOD_NAMES = set(_KUBE_OPS) | {"generate", "communicate"}

#: literals in tests that plausibly name a seam: dotted lowercase head,
#: fnmatch metacharacters allowed in the tail ("kube.*", "kube.watch.Pod")
_SITE_LITERAL_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[A-Za-z0-9_*?\[\]]+)+$")

#: modules whose ``fault_plan.apply`` calls register seams — the package
#: itself, minus the analysis tree (rule fixtures/doc examples are not
#: seams) and minus loadgen and chaos (chaos DRIVERS: their literals
#: count as test-side naming, their apply calls — if any — are not
#: registrations)
_REGISTRY_SCOPE = re.compile(
    r"operator_tpu_torch/(?!analysis/|loadgen/|chaos/).*\.py$"
)

#: the port's own test files: the only ``tests/`` python whose literals
#: name the port's seams
_PORT_TESTS_GLOB = "test_torch_*.py"

#: committed game-day scenario files — seam-naming sources the gameday
#: lane replays (``LOADGEN_SCENARIO=<file.json>``)
_SCENARIO_DIR = "tests/scenarios"

#: a scenario injection's seam key in the JSON text, matched on the raw
#: source so findings carry real line numbers (json.loads drops them)
_SEAM_KEY_RE = re.compile(r'"seam"\s*:\s*"([^"]*)"')


def seam_pattern(call: ast.Call) -> Optional[str]:
    """The site pattern a ``fault_plan.apply(<arg0>, ...)`` or
    ``fault_plan.apply_async(<arg0>, ...)`` call registers: a literal
    string verbatim, an f-string with every interpolation widened to
    ``*`` (``f"kube.watch.{kind}"`` -> ``kube.watch.*``).  None when the
    call is not an apply on a fault-plan receiver or the site argument
    is not statically resolvable."""
    chain = attr_chain(call.func)
    if (
        len(chain) < 2
        or chain[-1] not in ("apply", "apply_async")
        or chain[-2] != "fault_plan"
    ):
        return None
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for piece in arg.values:
            if isinstance(piece, ast.Constant):
                parts.append(str(piece.value))
            else:
                parts.append("*")
        return "".join(parts)
    return None


def _port_python(root) -> list:
    """The python files whose literals count as naming a seam: the port's
    tests (``tests/test_torch_*.py``), its loadgen and its chaos package."""
    paths = sorted((root / "tests").rglob(_PORT_TESTS_GLOB))
    for rel_root in ("operator_tpu_torch/loadgen", "operator_tpu_torch/chaos"):
        paths.extend(sorted((root / rel_root).rglob("*.py")))
    return paths


def _patterns_match(seam: str, literal: str) -> bool:
    """Does a test literal name a seam pattern?  Either side may be the
    glob (seam patterns come from f-strings, test rules use fnmatch)."""
    return (
        seam == literal
        or fnmatch.fnmatch(literal, seam)
        or fnmatch.fnmatch(seam, literal)
    )


class ChaosSeamCoverage(Rule):
    id = "GL012"
    name = "chaos-seam-coverage"
    description = (
        "every blocking external call must be reachable from a registered "
        "fault_plan seam (utils/faultinject.py), every registered seam "
        "must be named by a chaos/loadgen test or a tests/scenarios/*.json "
        "game-day file, and every seam a scenario names must exist — emits "
        "the seam-coverage.json audit map"
    )
    #: sites audited — exactly the deadline rule's control-plane scope;
    #: the seam registry and the callgraph walk span the whole package
    scope = DeadlinePropagation.scope

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        # the registry and the callgraph need the WHOLE package even when
        # only a subset was collected (--changed-only): a changed call
        # site's seam usually lives in an unchanged module (kubeapi's
        # kube.* apply governs every api verb in the tree), so coverage
        # is audited against the full tree, findings reported only on
        # collected files
        package = self._package_modules(ctx)
        tables = ctx.symbol_tables(package)

        # -- seam registry: pattern -> [(module, call node)] ------------
        registry: dict[str, list[tuple[ModuleSource, ast.Call]]] = {}
        defs_with_seams: dict[int, set[str]] = {}
        for module in package:
            if not _REGISTRY_SCOPE.match(module.relpath):
                continue
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                pattern = seam_pattern(node)
                if pattern is None:
                    continue
                registry.setdefault(pattern, []).append((module, node))
                owner = self._enclosing_def(node)
                if owner is not None:
                    defs_with_seams.setdefault(id(owner), set()).add(pattern)

        # -- def-level call edges over the whole package ----------------
        forward, reverse = ctx.memo(
            ("gl012", "call_edges"), lambda: self._call_edges(package, tables)
        )

        # -- external-call sites (GL003's enumeration) ------------------
        gl003 = DeadlinePropagation()
        sites = []  # (module, call node, label, enclosing defs)
        site_scope = [
            m for m in package
            if any(re.match(p, m.relpath) for p in self.scope)
        ]
        for module in site_scope:
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                label = gl003._external_call(node)
                if label is None:
                    continue
                sites.append((module, node, label, self._enclosing_defs(node)))

        # -- (a) seam reachability per site -----------------------------
        findings: list[Finding] = []
        site_rows = []
        for module, node, label, owners in sites:
            governing: set[str] = set()
            # every lexically-enclosing def is on the site's path (a nested
            # closure only runs on its parent's path — the http.provider
            # seam in generate() governs the urlopen inside its to_thread
            # closure), so reachability starts from all of them
            for owner in owners:
                for visited in self._bfs(owner, forward) | self._bfs(owner, reverse):
                    governing |= defs_with_seams.get(visited, set())
            # findings only on COLLECTED files (a --changed-only run
            # audits the whole tree but reports on what you touched —
            # and pragma suppression needs the module in the run)
            if not governing and ctx.module(module.relpath) is not None:
                findings.append(
                    self.finding(
                        module, node,
                        f"external call {label} is reachable from no "
                        "registered fault seam: chaos tests cannot inject "
                        "its failure — add a fault_plan.apply(...) seam on "
                        "its call path (utils/faultinject.py)",
                    )
                )
            site_rows.append({
                "path": module.relpath,
                "line": node.lineno,
                "symbol": module.symbol_at(node),
                "call": label,
                "seams": sorted(governing),
            })

        # -- (b) test naming per registered seam ------------------------
        # scenario files and chaos-package literals count alongside
        # tests/ and loadgen/: a committed game-day scenario rehearses
        # every seam it injects
        literals = self._test_literals(ctx)
        scenarios, scenario_findings = self._scenario_seams(ctx)
        findings.extend(scenario_findings)
        for relpath, rows in scenarios.items():
            literals.setdefault(relpath, set()).update(
                seam for seam, _line, _name in rows
            )
        seam_rows = []
        for pattern in sorted(registry):
            naming = sorted(
                path for path, found in literals.items()
                if any(_patterns_match(pattern, lit) for lit in found)
            )
            where = sorted(
                (module.relpath, call.lineno, module.symbol_at(call))
                for module, call in registry[pattern]
            )
            collected = [
                (module, call) for module, call in registry[pattern]
                if ctx.module(module.relpath) is not None
            ]
            if not naming and collected:
                module, call = min(
                    collected,
                    key=lambda pair: (pair[0].relpath, pair[1].lineno),
                )
                findings.append(
                    self.finding(
                        module, call,
                        f"fault seam `{pattern}` is named by no chaos/"
                        "loadgen test: the failure it injects is never "
                        "rehearsed — add a plan.rule scenario naming it "
                        "under tests/",
                    )
                )
            seam_rows.append({
                "pattern": pattern,
                "registered_at": [f"{p}:{ln} [{sym}]" for p, ln, sym in where],
                "tests": naming,
            })

        # -- (c) unknown seams in scenarios -----------------------------
        # a scenario (JSON file or literal Injection(...) in chaos/test
        # python) naming a seam no fault_plan.apply registers is dead
        # chaos: the conductor queues a rule nothing consumes and the
        # run-time pending_faults gate fires long after the rename that
        # broke it
        known = sorted(registry)
        for relpath in sorted(scenarios):
            for seam, line, scenario_name in scenarios[relpath]:
                if any(_patterns_match(p, seam) for p in known):
                    continue
                findings.append(Finding(
                    rule=self.id,
                    path=relpath,
                    line=line,
                    message=(
                        f"scenario names unknown fault seam `{seam}`: no "
                        "fault_plan.apply registers it, so the game day "
                        "queues an injection nothing can fire — fix the "
                        "seam name or register the seam "
                        "(utils/faultinject.py)"
                    ),
                    symbol=scenario_name,
                ))
        for module, node, seam in self._injection_literals(ctx, package):
            if any(_patterns_match(p, seam) for p in known):
                continue
            if ctx.module(module.relpath) is None:
                continue
            findings.append(
                self.finding(
                    module, node,
                    f"Injection names unknown fault seam `{seam}`: no "
                    "fault_plan.apply registers it, so the game day "
                    "queues an injection nothing can fire — fix the "
                    "seam name or register the seam "
                    "(utils/faultinject.py)",
                )
            )

        # stable artifact for --seam-coverage / CI (plain assignment: no
        # other rule touches this key, and dict stores are atomic)
        ctx.caches["seam_coverage"] = {
            "schema": 1,
            "seams": seam_rows,
            "external_call_sites": sorted(
                site_rows, key=lambda r: (r["path"], r["line"])
            ),
            "scenario_files": {
                relpath: sorted({seam for seam, _l, _n in rows})
                for relpath, rows in sorted(scenarios.items())
            },
            "uncovered_sites": sum(1 for r in site_rows if not r["seams"]),
            "unnamed_seams": sum(1 for r in seam_rows if not r["tests"]),
        }
        return findings

    # -- module enumeration ---------------------------------------------
    @staticmethod
    def _package_modules(ctx: AnalysisContext) -> list[ModuleSource]:
        """Every parsed module under ``operator_tpu_torch/`` (excluding the
        analysis tree's own fixtures is the registry's job, not this
        one's), sourced from the filesystem so partial runs still see
        the whole package; per-file parses memoize on the context."""
        out = []
        base = ctx.root / "operator_tpu_torch"
        if not base.is_dir():
            # fixture trees (tests) root the package elsewhere — fall
            # back to whatever was collected
            return [
                m for m in ctx.modules
                if m.relpath.startswith("operator_tpu_torch/")
                and m.tree is not None
            ]
        for path in sorted(base.rglob("*.py")):
            relpath = path.relative_to(ctx.root).as_posix()
            if "__pycache__" in relpath:
                continue
            module = ctx.aux_module(relpath)
            if module is not None and module.tree is not None:
                out.append(module)
        return out

    # -- callgraph ------------------------------------------------------
    @staticmethod
    def _enclosing_def(node: ast.AST) -> Optional[ast.AST]:
        current = getattr(node, "_graftlint_parent", None)
        while current is not None:
            if isinstance(current, DEF_NODES):
                return current
            current = getattr(current, "_graftlint_parent", None)
        return None

    @staticmethod
    def _enclosing_defs(node: ast.AST) -> list[ast.AST]:
        """Every def lexically enclosing ``node``, innermost first."""
        out = []
        current = getattr(node, "_graftlint_parent", None)
        while current is not None:
            if isinstance(current, DEF_NODES):
                out.append(current)
            current = getattr(current, "_graftlint_parent", None)
        return out

    def _call_edges(self, package, tables):
        """Def-id -> called def-ids (forward) and the reverse map, built
        once per run (shared through the context memo).  Non-self method
        edges are restricted to api-handle kube verbs and the provider
        protocol names so generic ``get``/``list`` receivers do not alias
        the tree."""
        forward: dict[int, set[int]] = {}
        reverse: dict[int, set[int]] = {}
        for module in package:
            for owner in ast.walk(module.tree):
                if not isinstance(owner, DEF_NODES):
                    continue
                out = forward.setdefault(id(owner), set())
                for stmt in owner.body:
                    for node in iter_scope(stmt):
                        if not isinstance(node, ast.Call):
                            continue
                        target = node.func
                        allow_non_self = isinstance(
                            target, ast.Attribute
                        ) and (
                            _is_api_handle(target.value)
                            or target.attr in ("generate", "communicate")
                        )
                        for callee in tables.resolve_ref(
                            module, node, target,
                            non_self_methods=allow_non_self,
                            method_names_ok=lambda name: (
                                name in _EDGE_METHOD_NAMES
                            ),
                        ):
                            out.add(id(callee))
                            reverse.setdefault(id(callee), set()).add(id(owner))
                        # higher-order references: a function PASSED to a
                        # call (to_thread(call), run_in_executor(None, fn),
                        # dispatch(send=send)) may be called on the passing
                        # def's path — the http.provider seam in send()
                        # governs the urlopen inside the call() closure it
                        # ships to the worker thread
                        for arg in (
                            *node.args,
                            *(kw.value for kw in node.keywords),
                        ):
                            if not isinstance(arg, (ast.Name, ast.Attribute)):
                                continue
                            for callee in tables.resolve_ref(
                                module, node, arg,
                            ):
                                out.add(id(callee))
                                reverse.setdefault(
                                    id(callee), set()
                                ).add(id(owner))
        return forward, reverse

    @staticmethod
    def _bfs(start: ast.AST, edges: dict[int, set[int]]) -> set[int]:
        seen = {id(start)}
        frontier = [id(start)]
        while frontier:
            current = frontier.pop()
            for nxt in edges.get(current, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return seen

    # -- test-side naming -----------------------------------------------
    def _test_literals(self, ctx: AnalysisContext) -> dict[str, set[str]]:
        """Repo-relative test/loadgen path -> site-shaped string literals.
        Files are enumerated from the filesystem (not the collected set)
        so a ``--changed-only`` run still audits against the whole test
        tree; parses are memoized on the context."""
        out: dict[str, set[str]] = {}
        for path in _port_python(ctx.root):
            relpath = path.relative_to(ctx.root).as_posix()
            module = ctx.aux_module(relpath)
            if module is None or module.tree is None:
                continue
            found = {
                node.value
                for node in ast.walk(module.tree)
                if isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _SITE_LITERAL_RE.match(node.value)
            }
            if found:
                out[relpath] = found
        return out

    # -- scenario files --------------------------------------------------
    def _scenario_seams(
        self, ctx: AnalysisContext
    ) -> "tuple[dict[str, list[tuple[str, int, str]]], list[Finding]]":
        """Repo-relative scenario path -> [(seam, line, scenario name)]
        for every ``tests/scenarios/*.json``, plus findings for files
        that do not parse (a committed repro the gameday lane cannot
        replay is itself a defect).  Seams and lines come from the raw
        text (``json.loads`` drops positions); the parse is only the
        well-formedness gate."""
        out: dict[str, list[tuple[str, int, str]]] = {}
        findings: list[Finding] = []
        base = ctx.root / _SCENARIO_DIR
        if not base.is_dir():
            return out, findings
        for path in sorted(base.glob("*.json")):
            relpath = path.relative_to(ctx.root).as_posix()
            try:
                text = path.read_text(encoding="utf-8")
                data = json.loads(text)
            except (OSError, ValueError) as exc:
                findings.append(Finding(
                    rule=self.id,
                    path=relpath,
                    line=1,
                    message=(
                        "scenario file is not valid JSON — the gameday "
                        f"lane cannot replay it ({exc})"
                    ),
                    symbol=path.stem,
                ))
                continue
            name = str(data.get("name", path.stem)) if isinstance(
                data, dict
            ) else path.stem
            rows = []
            for match in _SEAM_KEY_RE.finditer(text):
                line = text.count("\n", 0, match.start()) + 1
                rows.append((match.group(1), line, name))
            out[relpath] = rows
        return out, findings

    def _injection_literals(
        self, ctx: AnalysisContext, package: "list[ModuleSource]"
    ) -> "list[tuple[ModuleSource, ast.Call, str]]":
        """Literal first arguments of ``Injection(...)`` constructions in
        the port's chaos package and tests — python-side scenario
        definitions, held to the same known-seam bar as JSON files."""
        modules: dict[str, ModuleSource] = {
            m.relpath: m for m in package
            if m.relpath.startswith("operator_tpu_torch/chaos/")
        }
        for path in sorted((ctx.root / "tests").rglob(_PORT_TESTS_GLOB)):
            relpath = path.relative_to(ctx.root).as_posix()
            module = ctx.aux_module(relpath)
            if module is not None and module.tree is not None:
                modules.setdefault(relpath, module)
        out = []
        for relpath in sorted(modules):
            module = modules[relpath]
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                chain = attr_chain(node.func)
                if not chain or chain[-1] != "Injection":
                    continue
                arg: Optional[ast.expr] = node.args[0] if node.args else None
                if arg is None:
                    for kw in node.keywords:
                        if kw.arg == "seam":
                            arg = kw.value
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    out.append((module, node, arg.value))
        return out
