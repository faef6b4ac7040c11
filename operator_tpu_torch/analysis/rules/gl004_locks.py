"""GL004 — lock discipline on state shared across threads.

Operator state is touched from several threads at once: the asyncio control
plane, ``asyncio.to_thread`` workers (pattern parse, incident recall/insert),
and the serving executor.  The codebase's convention is a per-object
``threading.Lock`` guarding a set of attributes; nothing enforced that the
set is guarded EVERYWHERE — one lock-free read of a dict that a worker
thread mutates is a data race that surfaces as a once-a-week corrupted
incident journal, not a test failure.

The rule infers, per class in ``operator/*.py`` and ``memory/*.py``:

- the class's **lock attributes** (assigned ``threading.Lock()`` /
  ``RLock()`` / ``Condition()`` / ``asyncio.Lock()``);
- the **guarded set**: attributes ever written inside a
  ``with self._lock:`` block (or inside a lock-held helper);
- **lock-held helpers**: methods whose every call site is under the lock
  (or in another lock-held helper) — plus anything named ``*_locked`` by
  convention;
- **init-only helpers**: methods reachable only from ``__init__``
  (construction happens-before publication; no other thread can see the
  object yet).

Every read or write of a guarded attribute outside a lock region in any
other method is a finding.  Deliberate lock-free snapshot reads (immutable
tuple swap + atomic reference read) are real patterns — mark them with
``# graftlint: disable=GL004 reason=...`` where reviewers can audit the
claim.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from ..core import AnalysisContext, Finding, ModuleSource, Rule

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
#: method names that mutate their container in place: ``self.x.append(...)``
#: is a WRITE to the guarded structure, not a read of the attribute
_MUTATOR_METHODS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "setdefault", "remove", "discard", "add", "move_to_end", "appendleft",
    "popleft", "sort", "reverse", "write",
}


def _self_attr(expr: ast.AST) -> Optional[str]:
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


@dataclass
class _Access:
    attr: str
    node: ast.AST
    is_write: bool
    under_lock: bool
    method: str


@dataclass
class _MethodInfo:
    node: ast.AST
    name: str
    accesses: list[_Access] = field(default_factory=list)
    #: self.method() call sites: (callee name, under_lock)
    calls: list[tuple[str, bool]] = field(default_factory=list)


class LockDiscipline(Rule):
    id = "GL004"
    name = "lock-discipline"
    description = (
        "an attribute ever written under a class's threading.Lock must "
        "never be read or written outside one (per-class guard-set "
        "inference; *_locked helpers and __init__-only paths exempt)"
    )
    scope = (
        r"operator_tpu_torch/operator/.*\.py$",
        r"operator_tpu_torch/memory/.*\.py$",
        # multi-replica data plane + the shared journal helper:
        # router health/ring state is mutated from concurrent dispatches,
        # and the journal's handle moves between caller and writer thread
        r"operator_tpu_torch/router/.*\.py$",
        r"operator_tpu_torch/utils/journal\.py$",
        # continuous-batching scheduler: row state is mutated
        # from the decode worker while submit paths enqueue/cancel —
        # any lock that grows here must follow the discipline
        r"operator_tpu_torch/serving/sched/.*\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        findings: list[Finding] = []
        for module in ctx.in_scope(self.scope):
            if module.tree is None:
                continue
            for node in module.tree.body:
                if isinstance(node, ast.ClassDef):
                    findings.extend(self._check_class(module, node))
        return findings

    # ------------------------------------------------------------------
    def _check_class(
        self, module: ModuleSource, cls: ast.ClassDef
    ) -> list[Finding]:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return []
        methods: dict[str, _MethodInfo] = {}
        for item in cls.body:
            if isinstance(item, _DEF_NODES):
                methods[item.name] = self._scan_method(item, lock_attrs)

        init_only = self._closure(methods, seeds={"__init__"})
        init_only.discard("__init__")

        # lock-held helpers: fixpoint over "every non-init call site is
        # under the lock or inside another lock-held helper"
        lock_held = {
            name for name in methods if name.endswith("_locked")
        }
        changed = True
        while changed:
            changed = False
            for name, info in methods.items():
                if name in lock_held or name in init_only or name == "__init__":
                    continue
                sites = [
                    (caller, under)
                    for caller, m in methods.items()
                    for callee, under in m.calls
                    if callee == name and caller not in init_only
                    and caller != "__init__"
                ]
                if sites and all(
                    under or caller in lock_held for caller, under in sites
                ):
                    lock_held.add(name)
                    changed = True

        guarded: set[str] = set()
        for name, info in methods.items():
            for access in info.accesses:
                if access.is_write and (
                    access.under_lock or name in lock_held
                ):
                    guarded.add(access.attr)
        guarded -= lock_attrs

        findings: list[Finding] = []
        for name, info in methods.items():
            if name == "__init__" or name in init_only or name in lock_held:
                continue
            for access in info.accesses:
                if access.attr not in guarded or access.under_lock:
                    continue
                kind = "write to" if access.is_write else "read of"
                findings.append(
                    self.finding(
                        module, access.node,
                        f"unguarded {kind} self.{access.attr} — guarded by "
                        f"{cls.name}'s lock elsewhere (escape from the "
                        "inferred guard set)",
                    )
                )
        return findings

    # ------------------------------------------------------------------
    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> set[str]:
        locks: set[str] = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if not isinstance(value, ast.Call):
                continue
            factory = (
                value.func.attr
                if isinstance(value.func, ast.Attribute)
                else value.func.id if isinstance(value.func, ast.Name) else ""
            )
            if factory not in _LOCK_FACTORIES:
                continue
            for target in node.targets:
                attr = _self_attr(target)
                if attr is not None:
                    locks.add(attr)
        return locks

    def _scan_method(
        self, method: ast.AST, lock_attrs: set[str]
    ) -> _MethodInfo:
        info = _MethodInfo(node=method, name=method.name)

        def visit(node: ast.AST, under_lock: bool) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                locks_here = any(
                    _self_attr(item.context_expr) in lock_attrs
                    or (
                        isinstance(item.context_expr, ast.Call)
                        and _self_attr(item.context_expr.func) in lock_attrs
                    )
                    for item in node.items
                )
                for item in node.items:
                    visit(item.context_expr, under_lock)
                for child in node.body:
                    visit(child, under_lock or locks_here)
                return
            if isinstance(node, _DEF_NODES) and node is not method:
                # a closure outlives the statement that defined it: it may
                # run on another thread (executor.submit, callbacks) after
                # the lock is released, so its accesses count as LOCK-FREE
                # even when the def sits inside a `with self._lock:` block
                for child in node.body:
                    visit(child, False)
                return
            attr = _self_attr(node)
            if attr is not None and attr not in lock_attrs:
                parent = getattr(node, "_graftlint_parent", None)
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                # `self.x[k] = v` and `self.x.append(...)` mutate through a
                # read-context attribute: count container mutation as write
                if not is_write and isinstance(parent, ast.Subscript):
                    is_write = isinstance(parent.ctx, (ast.Store, ast.Del))
                grandparent = getattr(parent, "_graftlint_parent", None)
                if (
                    not is_write
                    and isinstance(parent, ast.Attribute)
                    and parent.attr in _MUTATOR_METHODS
                    and isinstance(grandparent, ast.Call)
                    and grandparent.func is parent
                ):
                    is_write = True
                info.accesses.append(
                    _Access(attr, node, is_write, under_lock, method.name)
                )
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee is not None:
                    info.calls.append((callee, under_lock))
            for child in ast.iter_child_nodes(node):
                visit(child, under_lock)

        for stmt in method.body:
            visit(stmt, False)
        return info

    # ------------------------------------------------------------------
    @staticmethod
    def _closure(
        methods: dict[str, _MethodInfo], seeds: set[str]
    ) -> set[str]:
        """Methods reachable ONLY from ``seeds`` (call-graph closure with
        the constraint that no non-seed, non-member method calls them)."""
        reachable = set(seeds)
        changed = True
        while changed:
            changed = False
            for name, info in methods.items():
                if name in reachable:
                    continue
                callers = [
                    caller
                    for caller, m in methods.items()
                    for callee, _ in m.calls
                    if callee == name
                ]
                if callers and all(c in reachable for c in callers):
                    reachable.add(name)
                    changed = True
        return reachable
