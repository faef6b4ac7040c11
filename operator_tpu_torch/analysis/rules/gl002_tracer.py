"""GL002 — implicit ``bool()`` of a device tensor inside a graph program.

Inside a function the port captures as a CUDA graph, a Python ``if`` /
``while`` / ``assert`` or a conditional expression on a tensor calls
``bool()`` on it: a device→host readback.  Under capture that fails
("operation not permitted when stream is capturing"); run eagerly it
stalls the step, and a graph captured around a branch that "worked"
bakes one branch in for every later replay.  The JAX rule of the same
id catches the tracer form of this trap; here it is a host sync that
GL001 cannot see, because no call is written.  (Python iteration over a
tensor is NOT flagged: its length is the static shape, no sync.)

The taint model (``jitgraph``) keeps the legal idioms quiet: branching on
parameters annotated as host scalars (part of the graph's key), on
shape/dtype/device metadata, on closure configuration, and ``x is None``
dispatch are all host decisions and never flagged.  The fix for a real
finding is ``torch.where`` / a mask, or moving the decision to the host
before the program.
"""

from __future__ import annotations

import ast

from ..core import AnalysisContext, Finding, Rule
from ..jitgraph import JitGraph, iter_scope


class TracerUnsafeControlFlow(Rule):
    id = "GL002"
    name = "tracer-unsafe-control-flow"
    description = (
        "no Python if/while/assert/conditional expression on a device "
        "tensor inside a CUDA-graph program (an implicit bool(): a host "
        "sync that fails the capture) — use torch.where or a mask"
    )
    scope = (
        r"operator_tpu_torch/ops/.*\.py$",
        r"operator_tpu_torch/serving/.*\.py$",
        r"operator_tpu_torch/models/.*\.py$",
        r"operator_tpu_torch/patterns/.*\.py$",
        # the serving mesh's collectives (ServingShard), which the
        # programs call on a mesh
        r"operator_tpu_torch/parallel/mesh\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        graph = JitGraph.for_modules(ctx, ctx.in_scope(self.scope))
        findings: list[Finding] = []
        seen: set[tuple[str, int]] = set()
        for info in graph.reachable_functions():
            env = graph.local_taint(info)
            module = info.module
            for stmt in info.body:
                for node in iter_scope(stmt):
                    message: str | None = None
                    if isinstance(node, ast.If) and graph.expr_tainted(
                        node.test, env, module
                    ):
                        message = (
                            "Python `if` on a device tensor inside a graph "
                            "program — use torch.where / a mask"
                        )
                    elif isinstance(node, ast.While) and graph.expr_tainted(
                        node.test, env, module
                    ):
                        message = (
                            "Python `while` on a device tensor inside a "
                            "graph program — bound the loop on the host"
                        )
                    elif isinstance(node, ast.Assert) and graph.expr_tainted(
                        node.test, env, module
                    ):
                        message = (
                            "`assert` on a device tensor inside a graph "
                            "program — check the precondition on the host"
                        )
                    elif isinstance(node, ast.IfExp) and graph.expr_tainted(
                        node.test, env, module
                    ):
                        message = (
                            "conditional expression on a device tensor "
                            "inside a graph program — use torch.where"
                        )
                    if message is None or (module.relpath, id(node)) in seen:
                        continue
                    seen.add((module.relpath, id(node)))
                    findings.append(self.finding(module, node, message))
        return findings
