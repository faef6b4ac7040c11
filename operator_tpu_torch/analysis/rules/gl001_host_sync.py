"""GL001 — no host synchronisation inside a CUDA-graph program.

A ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``torch.cuda.synchronize()``
inside anything reachable from a function the port captures as a CUDA
graph (``serving/graphs.py``) makes the capture fail ("operation not
permitted when stream is capturing"); with graphs off, the same call
stalls every step on a device→host readback without any error — the
decode block that is supposed to launch K steps per host round-trip
(serving/engine.py) silently serialises the card instead.

Scope: the compute tree — ``ops/``, ``serving/``, ``models/``,
``patterns/``.  Host-side orchestration in those files (admission, the
step loop's token fetch — "the ONE host sync per block", the launch
counter's reader) is fine: the rule only looks INSIDE the reachable set
computed by :mod:`..jitgraph`.

``float(x)`` / ``int(x)`` / ``bool(x)`` and ``np.asarray(x)`` are flagged
only when ``x`` is *tainted* (derives from a device tensor): on a tensor
they copy it to the host, while ``float(len(xs))``-style host arithmetic
and numpy on host values stay legal.
"""

from __future__ import annotations

import ast

from ..core import AnalysisContext, Finding, Rule
from ..jitgraph import JitGraph, _attr_chain, _func_root, iter_scope

#: numpy module aliases in this codebase
_NUMPY_ALIASES = {"np", "numpy", "onp"}
#: numpy calls that copy a tensor to a host array
_NUMPY_MATERIALIZERS = {"asarray", "array", "ascontiguousarray", "copy"}
#: method calls on a tensor (or an Event/Stream) that wait for the device
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")``."""
    values = list(call.args[:1]) + [
        kw.value for kw in call.keywords if kw.arg == "device"
    ]
    return any(
        isinstance(v, ast.Constant) and isinstance(v.value, str)
        and v.value.split(":")[0] == "cpu"
        for v in values
    )


class HostSyncInHotPath(Rule):
    id = "GL001"
    name = "host-sync-in-hot-path"
    description = (
        "no .item()/.tolist()/.cpu()/.numpy()/.to('cpu')/torch.cuda."
        "synchronize()/Event or Stream .synchronize() — and no float()/"
        "int()/bool()/np.asarray() on device tensors — in functions "
        "reachable from a CUDA-graph program (GraphSet.program / _aot_wrap "
        "/ with torch.cuda.graph)"
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
            for stmt in info.body:
                for node in iter_scope(stmt):
                    # nested defs are their own reachable infos: iter_scope
                    # never descends into them; a capture block inside a
                    # reachable def is walked twice, hence ``seen``
                    if not isinstance(node, ast.Call):
                        continue
                    if (info.module.relpath, id(node)) in seen:
                        continue
                    message = self._sync_message(graph, node, env, info.module)
                    if message is not None:
                        seen.add((info.module.relpath, id(node)))
                        findings.append(
                            self.finding(
                                info.module, node,
                                f"{message} in a CUDA-graph program "
                                f"(reachable from a captured function)",
                            )
                        )
        return findings

    def _sync_message(
        self, graph: JitGraph, call: ast.Call, env: set[str], module
    ) -> str | None:
        func = call.func
        if isinstance(func, ast.Attribute):
            root = _func_root(func)
            if _attr_chain(func)[-3:] == ["torch", "cuda", "synchronize"]:
                return "host sync: torch.cuda.synchronize()"
            if func.attr in _SYNC_METHODS and root not in _NUMPY_ALIASES:
                return f"host sync: .{func.attr}()"
            if func.attr == "to" and _to_cpu(call):
                return "host sync: .to('cpu')"
            if (
                root in _NUMPY_ALIASES
                and func.attr in _NUMPY_MATERIALIZERS
                and call.args
                and graph.expr_tainted(call.args[0], env, module)
            ):
                return f"host materialisation: {root}.{func.attr}() of a device tensor"
        elif isinstance(func, ast.Name):
            if (
                func.id in ("float", "int", "bool")
                and call.args
                and graph.expr_tainted(call.args[0], env, module)
            ):
                return f"host sync: {func.id}() on a device tensor"
        return None
