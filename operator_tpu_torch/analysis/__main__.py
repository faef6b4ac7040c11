"""CLI: ``python -m operator_tpu_torch.analysis [--baseline FILE] [paths...]``.

The port's graftlint: the JAX package's CLI, flag for flag, over the
port's tree (``operator_tpu_torch/``) with its own committed baseline,
``analysis-baseline-torch.json``.

Exit codes: 0 = clean (every finding baselined or suppressed), 1 = new
findings (or malformed pragmas), 2 = usage error.  ``--fix`` does not exist
by design — every finding here is a semantic invariant whose correct repair
needs a human decision (which branch of the degradation ladder, which lock,
which budget slice); a mechanical rewrite would hide exactly the thinking
the rule exists to force.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .baseline import Baseline, load_baseline, write_baseline
from .rules import ALL_RULES, rules_by_id
from .runner import changed_paths, collect_context, run_analysis


def _github_line(finding) -> str:
    """One GitHub workflow-command annotation per finding: the Actions
    runner turns these into inline PR annotations at file:line."""
    # workflow-command property values: escape %, then CR/LF
    message = (
        finding.message.replace("%", "%25")
        .replace("\r", "%0D")
        .replace("\n", "%0A")
    )
    title = finding.rule + (f" {finding.symbol}" if finding.symbol else "")
    title = title.replace("%", "%25").replace(",", "%2C").replace("::", "")
    return (
        f"::error file={finding.path},line={finding.line},"
        f"title={title}::{message}"
    )


def _sarif_report(findings, rules) -> dict:
    """SARIF 2.1.0 document for GitHub code scanning: one run, one result
    per finding, rule metadata from the catalogue.  Deterministic field
    order so artifact diffs are meaningful."""
    known = {rule.id for rule in rules}
    extra = sorted({f.rule for f in findings} - known)  # GL000 pragma/parse
    driver_rules = [
        {
            "id": rule.id,
            "name": rule.name,
            "shortDescription": {"text": rule.description or rule.name},
            "helpUri": "https://example.invalid/docs/ANALYSIS.md",
        }
        for rule in rules
    ] + [
        {
            "id": rule_id,
            "name": "framework",
            "shortDescription": {
                "text": "parse error or malformed graftlint pragma"
            },
        }
        for rule_id in extra
    ]
    results = [
        {
            "ruleId": finding.rule,
            "level": "error",
            "message": {
                "text": finding.message
                + (f" [{finding.symbol}]" if finding.symbol else "")
            },
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": finding.path,
                            "uriBaseId": "%SRCROOT%",
                        },
                        "region": {"startLine": max(finding.line, 1)},
                    }
                }
            ],
        }
        for finding in findings
    ]
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "informationUri": (
                            "https://example.invalid/docs/ANALYSIS.md"
                        ),
                        "rules": driver_rules,
                    }
                },
                "results": results,
            }
        ],
    }


def _detect_root(start: Path) -> Path:
    """Nearest ancestor containing the port's package (or pyproject) — the
    repo root all finding paths are relative to."""
    current = start.resolve()
    for candidate in [current, *current.parents]:
        if (candidate / "operator_tpu_torch").is_dir() or (
            candidate / "pyproject.toml"
        ).exists():
            return candidate
    return current


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m operator_tpu_torch.analysis",
        description="graftlint for the PyTorch/CUDA port: enforce its "
        "CUDA-graph hot-path, deadline, concurrency and generated-artifact "
        "invariants (docs/ANALYSIS.md gives the shared pragma and baseline "
        "workflow)",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to analyse (default: the repo root)",
    )
    parser.add_argument(
        "--root", type=Path, default=None,
        help="repo root for relative paths + project rules (default: "
        "auto-detected from cwd)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="baseline JSON of grandfathered findings "
        "(analysis-baseline-torch.json)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="record the current findings into --baseline and exit 0",
    )
    parser.add_argument(
        "--rules", "--rule", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github", "sarif"),
        default="text",
        help="github = workflow-command annotations (::error file=...) so "
        "CI findings land inline on the PR diff; sarif = SARIF 2.1.0 on "
        "stdout for the code-scanning upload",
    )
    parser.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="run rules concurrently on N threads (parsed ASTs, symbol "
        "tables and the callgraph are shared through the per-run context "
        "memo; output is byte-identical to a serial run)",
    )
    parser.add_argument(
        "--seam-coverage", type=Path, default=None, metavar="FILE",
        help="write GL012's deterministic seam-coverage audit map (JSON) "
        "to FILE — requires GL012 in the run",
    )
    parser.add_argument(
        "--timings-budget", type=float, default=None, metavar="SECONDS",
        help="fail (exit 1) when total rule wall time exceeds SECONDS — "
        "CI asserts the full gate stays within budget",
    )
    parser.add_argument(
        "--changed-only", metavar="REF", default=None,
        help="lint only files differing from git REF (plus untracked) — "
        "the fast local pre-commit mode; repo-level artifact rules still "
        "check the whole tree",
    )
    parser.add_argument(
        "--timings", action="store_true",
        help="print per-rule wall time after the run",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id}  {rule.name}\n    {rule.description}")
        return 0

    try:
        rules = rules_by_id(
            [r.strip() for r in args.rules.split(",")] if args.rules else None
        )
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2

    root = (args.root or _detect_root(Path.cwd())).resolve()
    paths = list(args.paths) if args.paths else None
    if args.changed_only is not None:
        if args.paths:
            print("--changed-only and explicit paths are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        try:
            paths = changed_paths(root, args.changed_only)
        except ValueError as exc:
            print(exc, file=sys.stderr)
            return 2
        if not paths:
            print(
                f"graftlint: clean — no .py files differ from "
                f"{args.changed_only}"
            )
            return 0
    try:
        ctx = collect_context(root, paths)
    except (FileNotFoundError, ValueError) as exc:
        print(exc, file=sys.stderr)
        return 2
    timings: dict = {}
    findings, pragma_errors = run_analysis(
        ctx, rules, timings=timings, jobs=max(1, args.jobs)
    )

    if args.write_baseline:
        if args.baseline is None:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 2
        if args.rules or args.paths or args.changed_only:
            # a partial run writes a partial baseline, silently dropping
            # every other rule's grandfathered entries — refuse
            print(
                "--write-baseline records the FULL analysis; drop --rules/"
                "--changed-only/path arguments (a partial baseline would "
                "discard the other rules' grandfathered findings)",
                file=sys.stderr,
            )
            return 2
        write_baseline(args.baseline, findings)
        print(
            f"baseline written: {len(findings)} finding(s) -> {args.baseline}"
        )
        return 0

    baseline = Baseline()
    if args.baseline is not None:
        if not args.baseline.exists():
            # a moved/typo'd baseline must not dress grandfathered debt up
            # as new regressions — fail loudly like a typo'd source path
            print(f"no such baseline file: {args.baseline} (create one "
                  "with --write-baseline)", file=sys.stderr)
            return 2
        baseline = load_baseline(args.baseline)
    new, stale = baseline.filter(findings)
    # a partial run (--rules/paths) can only vouch for what it ran: an
    # entry for a rule that did not run is not stale, it is unchecked
    if args.rules:
        ran_rules = {rule.id for rule in rules}
        stale = [key for key in stale if key[0] in ran_rules]
    if args.paths or args.changed_only:
        analyzed = {m.relpath for m in ctx.modules}
        stale = [key for key in stale if key[1] in analyzed]
    new = pragma_errors + new

    if args.timings and args.format not in ("json", "sarif"):
        for rule in rules:
            print(f"timing: {rule.id}  {timings.get(rule.id, 0.0) * 1e3:8.1f} ms")

    if args.seam_coverage is not None:
        coverage = ctx.caches.get("seam_coverage")
        if coverage is None:
            print("--seam-coverage requires rule GL012 in the run",
                  file=sys.stderr)
            return 2
        args.seam_coverage.write_text(
            json.dumps(coverage, indent=2, sort_keys=True) + "\n",
            encoding="utf-8",
        )

    def emit() -> int:
        if args.format == "github":
            for finding in new:
                print(_github_line(finding))
            if new:
                print(
                    f"graftlint: {len(new)} finding(s) not in the baseline "
                    "(docs/ANALYSIS.md)"
                )
                return 1
            print(
                f"graftlint: clean — {len(ctx.modules)} file(s), "
                f"{len(rules)} rule(s)"
            )
            return 0

        if args.format == "sarif":
            # pure JSON on stdout (the upload artifact); the human
            # summary rides stderr
            print(json.dumps(_sarif_report(new, rules), indent=2))
            print(
                f"graftlint: {len(new)} finding(s) ({len(ctx.modules)} "
                f"file(s), {len(rules)} rule(s))",
                file=sys.stderr,
            )
            return 1 if new else 0

        if args.format == "json":
            print(json.dumps(
                {
                    "findings": [f.__dict__ for f in new],
                    "baselined": len(findings) - (len(new) - len(pragma_errors)),
                    "stale_baseline": [list(k) for k in stale],
                },
                indent=2,
            ))
            return 1 if new else 0

        for finding in new:
            print(finding.render())
        for rule, path, symbol, message in stale:
            sym = f" [{symbol}]" if symbol else ""
            print(
                f"note: stale baseline entry {rule} {path}{sym}: {message!r} "
                "no longer matches — remove it from the baseline"
            )
        if new:
            print(
                f"\ngraftlint: {len(new)} finding(s) not in the baseline "
                "(see docs/ANALYSIS.md; suppress deliberate exceptions with "
                "`# graftlint: disable=GLxxx reason=...`)"
            )
            return 1
        suppressed = len(findings) - len(new) + len(pragma_errors)
        print(
            f"graftlint: clean — {len(ctx.modules)} file(s), "
            f"{len(ALL_RULES) if not args.rules else len(rules)} rule(s), "
            f"{suppressed} baselined finding(s)"
        )
        return 0

    code = emit()
    total_wall = sum(timings.values())
    if args.timings_budget is not None and total_wall > args.timings_budget:
        print(
            f"graftlint: rule wall time {total_wall:.2f}s exceeds "
            f"--timings-budget {args.timings_budget:.2f}s — a rule grew "
            "quadratic pain; see the per-rule --timings breakdown",
            file=sys.stderr,
        )
        code = max(code, 1)
    return code


if __name__ == "__main__":
    sys.exit(main())
