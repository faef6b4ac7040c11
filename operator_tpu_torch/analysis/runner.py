"""Project walker + rule executor: collect sources, run rules, suppress.

Separated from ``__main__`` so tests (and future in-process consumers, e.g.
a pre-commit hook) can run the analysis without a subprocess.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

from .core import AnalysisContext, Finding, ModuleSource, Rule

#: directories never worth parsing
_SKIP_DIRS = {
    "__pycache__", ".git", ".pytest_cache", ".hypothesis", "build",
    "node_modules", ".venv", "venv", "env", ".tox", ".eggs",
    ".mypy_cache", "site-packages",
}


def collect_context(root: Path, paths: Optional[Sequence[Path]] = None) -> AnalysisContext:
    """Parse every ``.py`` under ``paths`` (default: the whole tree) into an
    :class:`AnalysisContext` rooted at ``root``."""
    root = root.resolve()
    ctx = AnalysisContext(root=root)
    roots = [Path(p).resolve() for p in paths] if paths else [root]
    seen: set[Path] = set()
    for base in roots:
        if not base.exists():
            # a typo'd path in a CI command must fail loudly, never turn
            # the gate into "clean — 0 file(s)"
            raise FileNotFoundError(f"no such path: {base}")
        if not base.is_relative_to(root):
            raise ValueError(
                f"{base} is outside the analysis root {root} — finding "
                "paths are root-relative; pass --root accordingly"
            )
        candidates = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for path in candidates:
            if path.suffix != ".py" or path in seen:
                continue
            if any(part in _SKIP_DIRS for part in path.parts):
                continue
            seen.add(path)
            ctx.add(ModuleSource(root, path))
    return ctx


def changed_paths(root: Path, ref: str) -> list[Path]:
    """Python files under ``root`` that differ from git ``ref`` (committed
    diff + untracked), for ``--changed-only`` pre-commit runs.  Deleted
    files are dropped (nothing to parse); a bad ref raises ValueError so
    the CLI can fail loudly instead of reporting a clean empty run."""
    root = root.resolve()

    def _git(*argv: str) -> list[str]:
        proc = subprocess.run(
            ["git", "-C", str(root), *argv],
            capture_output=True, text=True, timeout=30,
        )
        if proc.returncode != 0:
            raise ValueError(
                f"git {' '.join(argv)} failed: {proc.stderr.strip()}"
            )
        return [line for line in proc.stdout.splitlines() if line.strip()]

    names = set(_git("diff", "--name-only", ref, "--"))
    names.update(_git("ls-files", "--others", "--exclude-standard"))
    out = []
    for name in sorted(names):
        path = root / name
        if path.suffix == ".py" and path.exists():
            out.append(path)
    return out


def run_analysis(
    ctx: AnalysisContext,
    rules: Sequence[Rule],
    timings: Optional[dict] = None,
    jobs: int = 1,
) -> tuple[list[Finding], list[Finding]]:
    """Run ``rules`` over ``ctx``.

    Returns ``(findings, pragma_errors)``: rule findings surviving pragma
    suppression (sorted by location), plus one GL000 finding per malformed
    pragma (``disable=`` without ``reason=`` — a suppression that does not
    document itself does not suppress).  When ``timings`` is a dict it is
    filled with per-rule wall seconds (rule id -> float) — the lint job
    prints these so a rule that grows quadratic pain is caught in review,
    not discovered as a slow CI mystery later.

    ``jobs > 1`` runs rules concurrently on a thread pool.  Rules are
    independent by contract — everything shared (parsed ASTs, symbol
    tables, the program graph) is read through the context's thread-safe memo
    — and results are merged back in catalogue order, so the output is
    byte-identical to a serial run.  Per-rule ``timings`` remain wall
    times of each rule's own check, not of the pool.
    """

    def run_one(rule: Rule) -> tuple[list[Finding], float]:
        started = time.perf_counter()
        kept = []
        for finding in rule.check(ctx):
            module = ctx.module(finding.path)
            if module is not None and module.suppressed(finding.rule, finding.line):
                continue
            kept.append(finding)
        return kept, time.perf_counter() - started

    findings: list[Finding] = []
    if jobs > 1 and len(rules) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=jobs) as pool:
            results = list(pool.map(run_one, rules))
    else:
        results = [run_one(rule) for rule in rules]
    for rule, (kept, wall) in zip(rules, results):
        findings.extend(kept)
        if timings is not None:
            timings[rule.id] = wall
    pragma_errors: list[Finding] = []
    for module in ctx.modules:
        if module.parse_error:
            pragma_errors.append(
                Finding(
                    rule="GL000", path=module.relpath, line=1,
                    message=module.parse_error,
                )
            )
        for pragma in module.malformed_pragmas():
            pragma_errors.append(
                Finding(
                    rule="GL000",
                    path=module.relpath,
                    line=pragma.line,
                    message=(
                        "malformed graftlint pragma: `reason=` is required "
                        "(a suppression must document itself); this pragma "
                        "suppresses nothing"
                    ),
                )
            )
    key = lambda f: (f.path, f.line, f.rule)  # noqa: E731
    return sorted(findings, key=key), sorted(pragma_errors, key=key)
