"""GL010: config fields, deploy env rows and docs must round-trip.

``OperatorConfig.from_env`` maps every dataclass field to the env var
``FIELD.upper()`` (one reference-inherited exception:
``watch_namespaces`` -> ``PODMORTEM_WATCH_NAMESPACES``).  That mapping
is the operator's entire public configuration surface, and it drifts in
three directions, each of which has a distinct failure smell:

- a field with NO mention in README.md or docs/ is an invisible knob —
  operators discover it by reading source during an incident;
- a ``- name: X`` env row in a deploy manifest that no config field or
  ``os.environ`` read consumes is a silently-dead setting — the
  deployment LOOKS configured, the process never reads it (the classic
  renamed-field hazard);
- a README env-table row naming an env nothing reads documents a knob
  that does not exist.

The rule therefore cross-references four surfaces: config fields
(parsed from ``utils/config.py``), code-level ``os.environ``/
``os.getenv`` reads (regex scan, same technique as GL005's metric
scan), ``deploy/**/*.yaml`` env rows, and the README/docs text.  An
overlay's row that deletes a base entry (``$patch: delete``, a
strategic-merge directive) sets nothing, so it is no dead setting: such
rows are how an overlay drops the settings this rule would flag.
Pragmas cannot annotate YAML/Markdown, so deliberate exceptions go in
the committed baseline — which this repo keeps EMPTY, so there are
none.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from ..core import AnalysisContext, Finding, Rule

#: code-level env reads (string-literal keys only; from_env's computed
#: keys are covered by the field mapping itself)
_ENV_READ = re.compile(
    r"(?:os\.environ\.get|os\.environ\[|os\.getenv|environ\.get)"
    r"\s*\(?\s*[\"']([A-Z][A-Z0-9_]*)[\"']"
)
#: a k8s env row: `- name: UPPER_SNAKE` (ports/volumes/containers use
#: lowercase names and never match)
_YAML_ENV_ROW = re.compile(r"^\s*-\s*name:\s*([A-Z][A-Z0-9_]*)\s*$")
#: a strategic-merge patch's deletion of the list element it sits in
_YAML_PATCH_DELETE = re.compile(r"^\s*\$patch:\s*delete\s*$")
#: backticked env names in a README table row's first cell
_README_ROW = re.compile(r"^\|[^|]*\|")
_BACKTICKED_ENV = re.compile(r"`([A-Z][A-Z0-9_]*)`")

CONFIG_RELPATH = "operator_tpu_torch/utils/config.py"


def _deletes(lines: list[str], lineno: int) -> bool:
    """Whether the list element opened on line ``lineno`` (1-based) holds
    ``$patch: delete``: the lines after it indented past its dash."""
    dash = len(lines[lineno - 1]) - len(lines[lineno - 1].lstrip())
    for line in lines[lineno:]:
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if len(line) - len(line.lstrip()) <= dash:
            return False
        if _YAML_PATCH_DELETE.match(line):
            return True
    return False


def _config_fields(tree: ast.Module) -> dict[str, tuple[str, int]]:
    """field name -> (env var, line) for every OperatorConfig field,
    mirroring from_env's mapping."""
    out: dict[str, tuple[str, int]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == "OperatorConfig"):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                name = stmt.target.id
                env = (
                    "PODMORTEM_WATCH_NAMESPACES"
                    if name == "watch_namespaces"
                    else name.upper()
                )
                out[name] = (env, stmt.lineno)
    return out


def _code_read_envs(root: Path) -> set[str]:
    """Every env var name the code reads by string literal — the package
    plus the root-level entry points (bench.py) and scripts/, which read
    BENCH_* / CI knobs the README documents."""
    paths: list[Path] = sorted(root.glob("*.py"))
    for sub in ("operator_tpu_torch", "scripts"):
        if (root / sub).is_dir():
            paths.extend(sorted((root / sub).rglob("*.py")))
    names: set[str] = set()
    for path in paths:
        text = path.read_text(encoding="utf-8", errors="replace")
        names.update(_ENV_READ.findall(text))
    return names


class ConfigDriftRule(Rule):
    id = "GL010"
    name = "config-env-doc-drift"
    description = (
        "every OperatorConfig field must round-trip: its env var "
        "documented under README/docs, every deploy-manifest env row "
        "consumed by a config field or os.environ read, every README "
        "env-table row backed by something that reads it"
    )
    scope = (
        r"operator_tpu_torch/utils/config\.py$",
        r"deploy/.*\.yaml$",
        r"README\.md$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        config_module = ctx.module(CONFIG_RELPATH)
        if config_module is not None and config_module.tree is not None:
            tree = config_module.tree
        else:
            config_path = ctx.root / CONFIG_RELPATH
            if not config_path.exists():
                return []  # fixture/partial tree without the config
            try:
                tree = ast.parse(config_path.read_text(encoding="utf-8"))
            except SyntaxError:
                return []
        fields = _config_fields(tree)
        field_envs = {env for env, _ in fields.values()}
        known_envs = field_envs | _code_read_envs(ctx.root)

        findings: list[Finding] = []

        # 1) every config field's env var must be documented somewhere
        doc_text = self._doc_text(ctx.root)
        for name, (env, line) in sorted(fields.items()):
            if env not in doc_text:
                findings.append(Finding(
                    rule=self.id, path=CONFIG_RELPATH, line=line,
                    symbol=f"OperatorConfig.{name}",
                    message=(
                        f"config field `{name}` (env `{env}`) is not "
                        "documented in README.md or docs/ — an invisible "
                        "knob; add it to the README env table (or a docs "
                        "page)"
                    ),
                ))

        # 2) deploy env rows must be consumed by the code
        for yaml_path in sorted(ctx.root.glob("deploy/**/*.yaml")):
            rel = yaml_path.relative_to(ctx.root).as_posix()
            lines = yaml_path.read_text(encoding="utf-8", errors="replace").splitlines()
            for lineno, line in enumerate(lines, start=1):
                match = _YAML_ENV_ROW.match(line)
                if match and match.group(1) not in known_envs and not _deletes(lines, lineno):
                    findings.append(Finding(
                        rule=self.id, path=rel, line=lineno,
                        symbol=match.group(1),
                        message=(
                            f"deploy env row `{match.group(1)}` matches no "
                            "OperatorConfig field and no os.environ read — "
                            "a dead setting (renamed field?); fix the name "
                            "or delete the row"
                        ),
                    ))

        # 3) README env-table rows must name envs something reads
        readme = ctx.root / "README.md"
        if readme.exists():
            for lineno, line in enumerate(
                readme.read_text(encoding="utf-8", errors="replace")
                .splitlines(),
                start=1,
            ):
                if not _README_ROW.match(line):
                    continue
                first_cell = line.split("|")[1]
                for env in _BACKTICKED_ENV.findall(first_cell):
                    if env not in known_envs:
                        findings.append(Finding(
                            rule=self.id, path="README.md", line=lineno,
                            symbol=env,
                            message=(
                                f"README env-table row documents `{env}`, "
                                "which no config field or os.environ read "
                                "consumes — the knob does not exist"
                            ),
                        ))
        return findings

    @staticmethod
    def _doc_text(root: Path) -> str:
        blobs = []
        readme = root / "README.md"
        if readme.exists():
            blobs.append(readme.read_text(encoding="utf-8", errors="replace"))
        for path in sorted(root.glob("docs/*.md")):
            blobs.append(path.read_text(encoding="utf-8", errors="replace"))
        return "\n".join(blobs)
