"""graftlint for the PyTorch/CUDA port — static analysis of the port's own
invariants, the counterpart of the JAX package's ``operator_tpu.analysis``.

It keeps that package's file names, class names, rule ids, pragma syntax and
CLI flags, so a reader finds each counterpart and one pragma means the same
thing to both linters.  The invariant families ordinary linters cannot see:

- **hot-path purity** — nothing reachable from a function the port
  captures as a CUDA graph (``GraphSet.program``, the engine's
  ``_aot_wrap``, a ``with torch.cuda.graph`` block) may synchronise with
  the host (``.item()``, ``.cpu()``, ``.tolist()``, ``bool(tensor)``, a
  Python ``if`` on a tensor): inside a capture that fails the capture, and
  with graphs off it stalls every step without an error (GL001/GL002);
- **deadline propagation** — every blocking external call on the analysis
  path must spend a budget, not block forever;
- **lock discipline** — operator/memory state shared between watcher
  threads and the pipeline must only be touched under its guarding lock;
- **mesh-axis consistency** — every functional collective, mesh lookup
  and placement spec must name an axis the governing ``DeviceMesh``
  declares (GL013);
- the event-loop, replay, release, config, await and chaos-seam rules of
  the JAX catalogue, retargeted at ``operator_tpu_torch/``.

GL008 (Mosaic lowerability) has no counterpart: the port's kernels are
CUDA C++.

``python -m operator_tpu_torch.analysis --baseline
analysis-baseline-torch.json`` runs every registered rule over the repo,
honours inline ``# graftlint: disable=GLxxx reason=...`` pragmas and the
committed baseline of grandfathered findings, and exits non-zero on
anything new.

This package imports neither torch, jax nor the runtime modules it analyses
(pure ``ast``; GL005 alone imports the port's ``schema.crdgen`` lazily), so
the gate runs on any box in seconds.
"""

from .baseline import Baseline, load_baseline, write_baseline
from .core import AnalysisContext, Finding, ModuleSource, Rule
from .rules import ALL_RULES, rules_by_id
from .runner import run_analysis

__all__ = [
    "ALL_RULES",
    "AnalysisContext",
    "Baseline",
    "Finding",
    "ModuleSource",
    "Rule",
    "load_baseline",
    "rules_by_id",
    "run_analysis",
    "write_baseline",
]
