"""Shared syntactic call-graph machinery for graftlint rules.

Shared by ``jitgraph.py`` (GL001/GL002's graph-program reachability) and
the host rules, so GL006's async-reachability walk rides the
SAME resolution semantics instead of a second drifting copy:

- :func:`iter_scope` — statement walk that does NOT descend into nested
  function/lambda subtrees (each def is its own scope);
- :func:`attr_chain` / :func:`func_root` — dotted-call-target helpers;
- :class:`SymbolTables` — per-module function tables, ``from x import
  y`` resolution within the analysed set, class-agnostic method lookup,
  and :meth:`SymbolTables.resolve_ref`: the defs a function-valued
  expression can denote.

Resolution is deliberately class-agnostic for method references (the
serving generator is assembled from mixins; the operator wires
collaborators by attribute) — a ``<recv>.method`` reference resolves to
every analysed method of that name.  Callers that cannot afford the
imprecision on non-``self`` receivers restrict it via
``method_names_ok`` (GL006 drops generic container-protocol names like
``append``/``get`` there, where ``self``-dispatch keeps them).
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from .core import ModuleSource

DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

__all__ = [
    "DEF_NODES",
    "iter_scope",
    "func_root",
    "attr_chain",
    "SymbolTables",
]


def iter_scope(stmt: ast.AST):
    """Walk a statement WITHOUT descending into nested function/lambda
    subtrees.  Nested defs are yielded (so callers can register them) but
    their bodies belong to their own scope: a nested helper's locals,
    returns and calls must never leak into the enclosing function's
    analysis (each reachable nested def is analysed as its own unit)."""
    stack: list[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (*DEF_NODES, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def func_root(func: ast.AST) -> Optional[str]:
    """Leftmost name of a (possibly dotted) call target."""
    while isinstance(func, ast.Attribute):
        func = func.value
    return func.id if isinstance(func, ast.Name) else None


def attr_chain(func: ast.AST) -> list[str]:
    """``torch.cuda.synchronize`` -> ["torch", "cuda", "synchronize"]; []
    when not a pure name/attribute chain."""
    parts: list[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
        return list(reversed(parts))
    return []


def annotation_names(annotation: Optional[ast.AST]) -> set[str]:
    """The names an annotation mentions, string forward references
    included (``Optional["ServingShard"]`` -> {"Optional", "ServingShard"})."""
    out: set[str] = set()
    for node in ast.walk(annotation) if annotation is not None else ():
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                out |= annotation_names(ast.parse(node.value, mode="eval").body)
            except SyntaxError:
                continue
    return out


class SymbolTables:
    """Function/method/import tables over a set of parsed modules.

    One instance per (rule, scope) — building is a single AST walk per
    module; resolution is dict lookups plus a lexical-scope climb."""

    def __init__(self, modules: Iterable[ModuleSource]) -> None:
        self.modules = [m for m in modules if m.tree is not None]
        self.relpaths = {m.relpath for m in self.modules}
        #: relpath -> {module-level function name -> def node}
        self.module_funcs: dict[str, dict[str, ast.AST]] = {}
        #: method name -> every class-body def node of that name
        self.methods_by_name: dict[str, list[ast.AST]] = {}
        #: relpath -> {local name -> (target relpath, original name)}
        self.imports: dict[str, dict[str, tuple[str, str]]] = {}
        #: def node id -> owning module (resolution output needs it)
        self.module_of: dict[int, ModuleSource] = {}
        #: attribute name -> the class names a class body annotates it
        #: with (``shard: Optional["ServingShard"]``), over every class
        self.attr_classes: dict[str, set[str]] = {}
        for module in self.modules:
            funcs: dict[str, ast.AST] = {}
            for node in ast.walk(module.tree):
                if (
                    isinstance(node, ast.AnnAssign)
                    and isinstance(node.target, ast.Name)
                    and isinstance(getattr(node, "_graftlint_parent", None), ast.ClassDef)
                ):
                    self.attr_classes.setdefault(node.target.id, set()).update(
                        annotation_names(node.annotation)
                    )
                if isinstance(node, DEF_NODES):
                    self.module_of[id(node)] = module
                    parent = getattr(node, "_graftlint_parent", None)
                    if isinstance(parent, ast.Module):
                        funcs[node.name] = node
                    elif isinstance(parent, ast.ClassDef):
                        self.methods_by_name.setdefault(
                            node.name, []
                        ).append(node)
            self.module_funcs[module.relpath] = funcs
            self.imports[module.relpath] = self._scan_imports(module)

    def _scan_imports(
        self, module: ModuleSource
    ) -> dict[str, tuple[str, str]]:
        """local name -> (target module relpath, original name) for
        ``from X import y [as z]`` imports resolvable inside the set."""
        out: dict[str, tuple[str, str]] = {}
        package_parts = module.relpath.split("/")[:-1]
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level:
                base = package_parts[: len(package_parts) - (node.level - 1)]
            else:
                base = []
            target = base + (node.module.split(".") if node.module else [])
            rel = "/".join(target) + ".py"
            if rel not in self.relpaths:
                continue
            for alias in node.names:
                out[alias.asname or alias.name] = (rel, alias.name)
        return out

    def resolve_ref(
        self,
        module: ModuleSource,
        site: ast.AST,
        target: ast.AST,
        *,
        non_self_methods: bool = False,
        method_names_ok=None,
    ) -> list[ast.AST]:
        """Def nodes a function-valued expression can denote.

        ``self.method`` always resolves class-agnostically.  With
        ``non_self_methods=True``, ``<any receiver>.method`` does too —
        gated by ``method_names_ok`` (a predicate on the method name)
        because generic protocol names (``get``, ``append``) would
        otherwise alias half the analysed tree."""
        if isinstance(target, ast.Attribute):
            is_self = (
                isinstance(target.value, ast.Name)
                and target.value.id == "self"
            )
            if is_self or non_self_methods:
                candidates = self.methods_by_name.get(target.attr, [])
                if not is_self and method_names_ok is not None:
                    if not method_names_ok(target.attr):
                        return []
                return list(candidates)
            return []
        if not isinstance(target, ast.Name):
            return []
        name = target.id
        # nearest lexically-enclosing def holding a nested def of that name
        scope = getattr(site, "_graftlint_parent", None)
        while scope is not None:
            if isinstance(scope, DEF_NODES):
                for child in ast.walk(scope):
                    if (
                        isinstance(child, DEF_NODES)
                        and child.name == name
                        and child is not scope
                    ):
                        return [child]
            scope = getattr(scope, "_graftlint_parent", None)
        local = self.module_funcs.get(module.relpath, {}).get(name)
        if local is not None:
            return [local]
        imported = self.imports.get(module.relpath, {}).get(name)
        if imported is not None:
            rel, orig = imported
            other = self.module_funcs.get(rel, {}).get(orig)
            if other is not None:
                return [other]
        return []

    def typed_methods(self, site: ast.AST, target: ast.Attribute) -> list[ast.AST]:
        """Defs of ``target.attr`` on a receiver whose class an annotation
        names: a parameter of the enclosing def (``shard:
        Optional["ServingShard"]``), or ``self.<a>`` where a class body
        annotates ``a`` (class-agnostic, as ``self.method`` is).  Only
        methods of classes so named, in the analysed set."""
        receiver, classes = target.value, set()
        if isinstance(receiver, ast.Name) and receiver.id != "self":
            scope = getattr(site, "_graftlint_parent", None)
            while scope is not None and not isinstance(scope, DEF_NODES):
                scope = getattr(scope, "_graftlint_parent", None)
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = scope.args
                for arg in (*args.posonlyargs, *args.args, *args.kwonlyargs):
                    if arg.arg == receiver.id:
                        classes = annotation_names(arg.annotation)
        elif (
            isinstance(receiver, ast.Attribute)
            and isinstance(receiver.value, ast.Name)
            and receiver.value.id == "self"
        ):
            classes = self.attr_classes.get(receiver.attr, set())
        return [
            node for node in self.methods_by_name.get(target.attr, [])
            if getattr(getattr(node, "_graftlint_parent", None), "name", None) in classes
        ]
