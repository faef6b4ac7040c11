"""GL005 — generated artifacts must match their source of truth.

Two drift families, both of which have bitten operators of systems like
this one in the field:

- **CRD manifests**: ``deploy/crds/podmortem-crds.yaml`` is generated from
  ``operator_tpu_torch/schema/crdgen.py``.  A schema edit without a regenerated
  manifest means the apiserver validates against YESTERDAY's API — specs
  the code handles get rejected at admission, or worse, admitted fields
  get silently dropped.
- **metric documentation**: every ``podmortem_*`` metric the code can emit
  must appear in the docs (docs/METRICS.md) — an operator alerting on an
  undocumented counter name is debugging blind.

The metric half absorbed ``scripts/check_metric_docs.py``; the shim is
deleted — CI runs ``python -m operator_tpu_torch.analysis --rule GL005``
directly (same scan via :func:`emitted_metrics`/:func:`documented_text`,
same verdict).
"""

from __future__ import annotations

import pathlib
import re

from ..core import AnalysisContext, Finding, Rule

#: every string literal inside an .incr(...) argument list (conditional
#: expressions like incr("a" if x else "b") emit BOTH names)
INCR_CALL = re.compile(r"\.incr\(([^)]*)\)", re.DOTALL)
#: histogram observations: an .observe(<name>, value) call whose name
#: literal carries a unit suffix renders as the podmortem_<name> family —
#: only unit-suffixed strings count, so the step clock's kind= literals
#: ("decode", "mixed") never read as metrics
OBSERVE_CALL = re.compile(r"\.observe\(([^)]*)\)", re.DOTALL)
UNIT_SUFFIXES = ("_milliseconds", "_seconds", "_bytes")
STRING = re.compile(r"[\"']([a-z0-9_]+)[\"']")
#: fully-formed metric names in code (the stage-summary constant); a bare
#: "podmortem_..." dict key without a metric suffix is not a metric
LITERAL = re.compile(
    r"[\"'](podmortem_[a-z0-9_]+_total|podmortem_[a-z0-9_]+_milliseconds)[\"']"
)

CRD_MANIFEST = "deploy/crds/podmortem-crds.yaml"


def emitted_metrics(root: pathlib.Path) -> set[str]:
    """Every ``podmortem_*`` metric name the code under ``root`` can emit
    (the scan the old ``check_metric_docs`` script always ran, verbatim)."""
    metrics: set[str] = set()
    for path in (root / "operator_tpu_torch").rglob("*.py"):
        text = path.read_text(encoding="utf-8", errors="replace")
        for args in INCR_CALL.findall(text):
            # the labels= kwarg of a labeled counter carries label KEYS
            # ("reason", "slo_class"), not metric names — stop before it
            for name in STRING.findall(args.split("labels=")[0]):
                metrics.add(f"podmortem_{name}_total")
        for args in OBSERVE_CALL.findall(text):
            for name in STRING.findall(args):
                if name.endswith(UNIT_SUFFIXES):
                    metrics.add(f"podmortem_{name}")
        for name in LITERAL.findall(text):
            metrics.add(name)
    return metrics


def documented_text(root: pathlib.Path) -> str:
    blobs = []
    for path in sorted((root / "docs").glob("*.md")):
        blobs.append(path.read_text(encoding="utf-8", errors="replace"))
    readme = root / "README.md"
    if readme.exists():
        blobs.append(readme.read_text(encoding="utf-8", errors="replace"))
    return "\n".join(blobs)


def undocumented_metrics(root: pathlib.Path) -> list[str]:
    docs = documented_text(root)
    return sorted(m for m in emitted_metrics(root) if m not in docs)


class GeneratedArtifactDrift(Rule):
    id = "GL005"
    name = "generated-artifact-drift"
    description = (
        "deploy/crds/podmortem-crds.yaml must equal schema/crdgen.py output, "
        "and every emitted podmortem_* metric must be documented under docs/"
    )
    scope = (CRD_MANIFEST.replace(".", r"\.") + "$", r"docs/METRICS\.md$")

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        findings: list[Finding] = []
        findings.extend(self._check_crds(ctx))
        for metric in undocumented_metrics(ctx.root):
            findings.append(
                Finding(
                    rule=self.id,
                    path="docs/METRICS.md",
                    line=1,
                    message=(
                        f"emitted metric {metric} is not documented anywhere "
                        "under docs/ or README.md"
                    ),
                    symbol="metrics",
                )
            )
        return findings

    def _check_crds(self, ctx: AnalysisContext) -> list[Finding]:
        if not (ctx.root / "operator_tpu_torch/schema/crdgen.py").exists():
            # fixture/partial tree without the generator: nothing to compare
            return []
        manifest = ctx.root / CRD_MANIFEST
        if not manifest.exists():
            return [
                Finding(
                    rule=self.id, path=CRD_MANIFEST, line=1, symbol="crds",
                    message=(
                        f"{CRD_MANIFEST} is missing — regenerate with "
                        "`python -m operator_tpu_torch.schema.crdgen > "
                        f"{CRD_MANIFEST}`"
                    ),
                )
            ]
        try:
            # one comparison, shared with `python -m operator_tpu_torch.schema.
            # crdgen --check` so the regen loop and the CI gate can never
            # disagree about what counts as drift
            from ...schema.crdgen import check_manifest
        except Exception as exc:  # yaml missing, import cycle, ...
            return [
                Finding(
                    rule=self.id, path=CRD_MANIFEST, line=1, symbol="crds",
                    message=f"cannot render CRDs to compare: {exc}",
                )
            ]
        if not check_manifest(str(manifest)):
            return [
                Finding(
                    rule=self.id, path=CRD_MANIFEST, line=1, symbol="crds",
                    message=(
                        f"{CRD_MANIFEST} drifted from schema/crdgen.py — "
                        "regenerate with `python -m operator_tpu_torch.schema."
                        f"crdgen > {CRD_MANIFEST}`"
                    ),
                )
            ]
        return []
