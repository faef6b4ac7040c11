"""GL013 — mesh-axis consistency for collectives, mesh lookups and specs.

A functional collective given an axis the mesh never declared
(``funcol.all_reduce(x, "sum", (mesh, "model"))`` under
``init_device_mesh(..., mesh_dim_names=("dp", "fsdp", "tp"))``), a
lookup of such an axis (``mesh["model"]``, ``mesh.get_group("model")``)
and a placement spec naming it (``P(None, "model")``) all pass every
one-process test and fail only when a multi-rank mesh runs.  The port of
the JAX package's rule, retargeted at ``torch.distributed``.

Scope model (``ops/`` + ``parallel/`` + ``serving/``):

- **axis environment** — the axis names declared by the governing mesh.
  The nearest lexically-enclosing ``with init_device_mesh(...)`` or
  ``with DeviceMesh(...)`` (directly, or through a local ``m =
  init_device_mesh(...)`` binding) shadows; with no enclosing mesh the
  module environment applies: the union of every mesh declared in the
  module.  A declaration's axes are its ``mesh_dim_names=``, resolved
  through literals and module-level constants (``AXES``), following
  ``from x import y`` across the analysed set.  A module that declares
  NO mesh has an empty environment and is skipped — its specs are
  checked where a mesh is in scope.
- **collectives** — ``torch.distributed._functional_collectives``
  functions (reached through a module alias such as ``funcol`` or
  imported bare) given a ``(mesh, axis)`` group, positionally or as
  ``group=``; unresolvable (dynamic) axes are skipped, not guessed.
- **mesh lookups** — ``<mesh>["tp"]``, ``<mesh>["dp", "fsdp"]``,
  ``<mesh>.get_group("tp")`` and ``<mesh>.get_local_rank("tp")`` on a
  receiver whose name says it is a mesh (``mesh``, ``device_mesh``, ...).
- **specs** — every string axis in a ``P``/``PartitionSpec`` call (the
  port's ``parallel/mesh.py`` spec type, imported or defined in the
  module), including tuple entries, must be declared.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..callgraph import attr_chain
from ..core import AnalysisContext, Finding, ModuleSource, Rule

#: the functional collectives that take a group
_FUNCOL = {
    "all_reduce", "all_gather_tensor", "all_gather_tensor_autograd",
    "reduce_scatter_tensor", "reduce_scatter_tensor_autograd",
    "all_to_all_single", "all_to_all_single_autograd", "broadcast",
    "all_reduce_coalesced", "all_gather_into_tensor_coalesced",
    "reduce_scatter_tensor_coalesced", "permute_tensor",
}
_FUNCOL_MODULE = "torch.distributed._functional_collectives"

#: DeviceMesh methods whose first argument (or ``mesh_dim=``) is an axis
_MESH_METHODS = {"get_group", "get_local_rank"}

#: calls that declare a mesh through ``mesh_dim_names=``
_MESH_CALLS = {"init_device_mesh", "DeviceMesh"}


def _is_mesh_name(chain: list[str]) -> bool:
    return bool(chain) and "mesh" in chain[-1].lower()


class MeshAxisConsistency(Rule):
    id = "GL013"
    name = "mesh-axis-consistency"
    description = (
        "every functional collective given a (mesh, axis) group, every "
        "mesh['axis'] / mesh.get_group('axis') lookup and every P(...) spec "
        "axis must be declared by the governing mesh's mesh_dim_names — "
        "mistyped axes otherwise fail only on a multi-rank mesh"
    )
    scope = (
        r"operator_tpu_torch/ops/.*\.py$",
        r"operator_tpu_torch/parallel/.*\.py$",
        r"operator_tpu_torch/serving/.*\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        modules = ctx.in_scope(self.scope)
        tables = ctx.symbol_tables(modules)
        findings: list[Finding] = []
        for module in modules:
            if module.tree is None:
                continue
            consts = self._module_constants(module)
            spec_names = self._spec_aliases(module)
            funcol_roots, funcol_bare = self._funcol_imports(module)

            def resolve_axes(node: ast.AST) -> Optional[set[str]]:
                """Axis-name set denoted by an expression, None when not
                statically resolvable.  Follows module constants in this
                module and, through the import table, in siblings."""
                if isinstance(node, ast.Constant):
                    return {node.value} if isinstance(node.value, str) else None
                if isinstance(node, (ast.Tuple, ast.List)):
                    out: set[str] = set()
                    for element in node.elts:
                        got = resolve_axes(element)
                        if got is None:
                            return None
                        out |= got
                    return out
                if isinstance(node, ast.Name):
                    if node.id in consts:
                        return consts[node.id]
                    imported = tables.imports.get(module.relpath, {}).get(node.id)
                    if imported is not None:
                        rel, orig = imported
                        other = ctx.module(rel)
                        if other is not None:
                            return self._module_constants(other).get(orig)
                return None

            def mesh_axes(call: ast.Call) -> Optional[set[str]]:
                """Axes an ``init_device_mesh``/``DeviceMesh`` call declares."""
                chain = attr_chain(call.func)
                if not chain or chain[-1] not in _MESH_CALLS:
                    return None
                for kw in call.keywords:
                    if kw.arg == "mesh_dim_names":
                        return resolve_axes(kw.value)
                return None

            # module environment: union of every mesh declaration
            module_env: set[str] = set()
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Call):
                    got = mesh_axes(node)
                    if got:
                        module_env |= got

            def local_mesh_binding(name: str, site: ast.AST) -> Optional[set[str]]:
                """Axes of ``name`` when bound by ``name = init_device_mesh(...)``
                in an enclosing def or at module level."""
                scope = getattr(site, "_graftlint_parent", None)
                while scope is not None:
                    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
                        for child in ast.walk(scope):
                            if not isinstance(child, ast.Assign):
                                continue
                            if not any(isinstance(t, ast.Name) and t.id == name
                                       for t in child.targets):
                                continue
                            if isinstance(child.value, ast.Call):
                                got = mesh_axes(child.value)
                                if got:
                                    return got
                    scope = getattr(scope, "_graftlint_parent", None)
                return None

            def report(site, names, env, what):
                for axis in sorted(names):
                    if axis not in env:
                        declared = ", ".join(sorted(env))
                        findings.append(self.finding(
                            module, site,
                            f"{what} names axis '{axis}' not declared by the governing "
                            f"mesh (axes: {declared}) — a mistyped axis fails only when "
                            "a multi-rank mesh runs",
                        ))

            def walk(node: ast.AST, env: set[str]) -> None:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        expr = item.context_expr
                        got = None
                        if isinstance(expr, ast.Call):
                            got = mesh_axes(expr)
                        elif isinstance(expr, ast.Name):
                            got = local_mesh_binding(expr.id, node)
                        if got:
                            # nearest mesh context SHADOWS — an inner
                            # mesh redefines the axis world
                            env = got
                if env and isinstance(node, ast.Call):
                    self._check_call(node, env, spec_names, funcol_roots, funcol_bare,
                                     resolve_axes, report)
                if env and isinstance(node, ast.Subscript) \
                        and _is_mesh_name(attr_chain(node.value)):
                    axes = resolve_axes(node.slice)
                    if axes:
                        report(node, axes, env, "mesh lookup [...]")
                for child in ast.iter_child_nodes(node):
                    walk(child, env)

            walk(module.tree, module_env)
        return findings

    # -- per-call check -------------------------------------------------
    @staticmethod
    def _check_call(call, env, spec_names, funcol_roots, funcol_bare, resolve_axes,
                    report) -> None:
        chain = attr_chain(call.func)
        name = chain[-1] if chain else ""
        is_funcol = name in _FUNCOL and (
            (len(chain) == 1 and name in funcol_bare)
            or ".".join(chain[:-1]) in funcol_roots
        )
        if is_funcol:
            groups = [kw.value for kw in call.keywords if kw.arg == "group"] or list(call.args)
            for group in groups:
                if isinstance(group, ast.Tuple) and len(group.elts) == 2:
                    axes = resolve_axes(group.elts[1])
                    if axes:
                        report(call, axes, env, f"collective {name}(...)")
            return
        if name in _MESH_METHODS and _is_mesh_name(chain[:-1]):
            axis = call.args[0] if call.args else None
            for kw in call.keywords:
                if kw.arg == "mesh_dim":
                    axis = kw.value
            axes = resolve_axes(axis) if axis is not None else None
            if axes:
                report(call, axes, env, f"mesh lookup {name}(...)")
            return
        if name == "PartitionSpec" or (len(chain) == 1 and name in spec_names):
            axes: set[str] = set()
            for arg in call.args:
                got = resolve_axes(arg)
                if got:
                    axes |= got
            if axes:
                report(call, axes, env, "spec P(...)")

    # -- per-module tables ----------------------------------------------
    @staticmethod
    def _module_constants(module: ModuleSource) -> dict[str, set[str]]:
        """Module-level ``NAME = ("a", "b")`` / ``NAME = "a"`` string
        constants — how ``AXES`` reaches ``mesh_dim_names=AXES``."""
        out: dict[str, set[str]] = {}
        if module.tree is None:
            return out
        for node in module.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            axes: Optional[set[str]] = None
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                axes = {value.value}
            elif isinstance(value, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str) for e in value.elts
            ):
                axes = {e.value for e in value.elts}
            if axes is None:
                continue
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = axes
        return out

    @staticmethod
    def _spec_aliases(module: ModuleSource) -> set[str]:
        """Local names of the port's spec type: ``P`` imported from a
        ``mesh`` or ``parallel`` module (under any alias), or a
        module-level ``class P`` (``parallel/mesh.py`` itself)."""
        names: set[str] = set()
        if module.tree is None:
            return names
        for node in module.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "P":
                names.add("P")
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.split(".")[-1] in ("mesh", "parallel")
            ):
                for alias in node.names:
                    if alias.name == "P":
                        names.add(alias.asname or alias.name)
        return names

    @staticmethod
    def _funcol_imports(module: ModuleSource) -> tuple[set[str], set[str]]:
        """(dotted names the functional-collectives module is reached
        by, collective names imported from it bare)."""
        roots: set[str] = set()
        bare: set[str] = set()
        if module.tree is None:
            return roots, bare
        package, leaf = _FUNCOL_MODULE.rsplit(".", 1)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == _FUNCOL_MODULE:
                        roots.add(alias.asname or alias.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if node.module == package and alias.name == leaf:
                        roots.add(alias.asname or alias.name)
                    elif node.module == _FUNCOL_MODULE and alias.name in _FUNCOL:
                        bare.add(alias.asname or alias.name)
        return roots, bare
