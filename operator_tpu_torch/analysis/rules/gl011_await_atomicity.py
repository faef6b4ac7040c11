"""GL011: check-then-act across an await — the asyncio TOCTOU shape.

The serverless-fleet arc multiplied the number of concurrent coroutines
mutating shared object state: autoscaler ticks, endpoint-watch ring
membership, health-poll sweeps, leader cycles, supervisor restarts,
pipelined scheduler commits.  In asyncio nothing interleaves between two
statements — until one of them awaits.  The bug shape is always the
same: read shared state, suspend, then write something derived from the
stale read.  The write is not torn (the GIL is not the issue); it is
*based on a world that no longer exists* — a replica re-added after the
watch removed it, a slot double-committed, a cursor rewound.

The rule, per ``async def`` in ``operator/``, ``router/``, ``serving/``
and ``obs/`` (flow-sensitive, statement order respected):

- **Read**: a load of ``self.<attr>`` or of a module-level mutable
  container (dict/list/set literal at module scope, or a ``global``
  declaration).  Method lookups that are immediately called
  (``self._helper()``) are calls, not state reads.
- **Suspension**: a direct ``await``, an ``async for`` step, an ``async
  with`` enter, or a bare call whose interprocedural summary — computed
  on the shared callgraph tables, the same discipline as GL006's
  async-reachability — says it may await.  Function references handed
  to ``asyncio.to_thread`` / ``create_task`` / ``ensure_future`` /
  executors do not suspend the caller and are not summary edges.
- **Write**: an assignment / ``del`` / subscript store to the same
  location, or an in-place container mutation (``.append``/``.add``/
  ``.discard``/``.update`` ...).
- **Feeds**: the write mentions a local tainted by the stale read
  (including loop targets iterating a snapshot of the state), or sits
  inside an ``if``/``while``/``for`` region whose test/iterable read the
  state before the suspension — the classic check-then-act.

Sanctioned shapes that stay quiet by construction:

- **Revalidation**: re-reading the state after the await (a fresh
  membership check, a compare-before-set) clears staleness — the write
  is then based on the current world.
- **Held lock**: a write inside ``with``/``async with`` on an inferred
  lock attribute (GL004's guard-set discipline, plus ``asyncio.Lock``)
  is serialized against competing coroutines.
- **Atomic read-modify-write**: ``self.n += 1`` re-reads at the write
  with no interleaving point between — not a TOCTOU.
- **resourceVersion-guarded patches / done-guarded futures**: the guard
  re-reads (or the apiserver enforces) the current state at the act, so
  the data-flow condition never fires.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from ..callgraph import DEF_NODES, SymbolTables, attr_chain
from ..core import AnalysisContext, Finding, ModuleSource, Rule

#: in-place container mutations: a write to the attribute's structure
#: (mirrors GL004's set — Event.set()/clear() style signal methods are
#: deliberately absent: signaling is not state derivation)
_MUTATOR_METHODS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "setdefault", "remove", "discard", "add", "move_to_end", "appendleft",
    "popleft", "sort", "reverse",
}

#: lock constructors (threading + asyncio share the names)
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}

#: wrappers whose function-valued / coroutine-valued arguments run
#: elsewhere: not a suspension of THIS coroutine, not a summary edge
_DETACH_CALLS = {"to_thread", "run_in_executor", "submit", "Thread",
                 "call_soon_threadsafe", "run_sync", "create_task",
                 "ensure_future"}

#: method names too generic for non-self interprocedural resolution
#: (same rationale as GL006)
_GENERIC_METHODS = {
    "append", "add", "acquire", "cancel", "clear", "close", "copy",
    "count", "discard", "done", "extend", "flush", "get", "index",
    "insert", "items", "join", "keys", "load", "open", "parse", "pop",
    "popleft", "put", "read", "record", "release", "remove", "result",
    "run", "send", "set", "sort", "start", "submit", "to_dict",
    "update", "values", "wait", "write",
}


def _self_attr(expr: ast.AST) -> Optional[str]:
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


def _module_mutable_globals(module: ModuleSource) -> set[str]:
    """Module-level names bound to mutable containers — shared state for
    every coroutine importing the module."""
    out: set[str] = set()
    _MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                      "OrderedDict", "Counter"}
    for node in module.tree.body if module.tree else []:
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        mutable = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                     ast.DictComp, ast.ListComp,
                                     ast.SetComp))
        if isinstance(value, ast.Call):
            name = (value.func.id if isinstance(value.func, ast.Name)
                    else value.func.attr if isinstance(value.func, ast.Attribute)
                    else "")
            mutable = name in _MUTABLE_CTORS
        if not mutable:
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                out.add(target.id)
    return out


def _lock_names(module: ModuleSource, cls: Optional[ast.ClassDef]) -> set[str]:
    """Keys recognised as locks in ``with``/``async with`` items:
    ``self.<attr>`` assigned a Lock factory in the class, plus
    module-level lock names."""
    locks: set[str] = set()

    def factory_name(value: ast.AST) -> str:
        if not isinstance(value, ast.Call):
            return ""
        func = value.func
        if isinstance(func, ast.Attribute):
            return func.attr
        if isinstance(func, ast.Name):
            return func.id
        return ""

    if cls is not None:
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if factory_name(node.value) in _LOCK_FACTORIES:
                for target in node.targets:
                    attr = _self_attr(target)
                    if attr is not None:
                        locks.add(f"self.{attr}")
    for node in module.tree.body if module.tree else []:
        if isinstance(node, ast.Assign) and factory_name(node.value) in _LOCK_FACTORIES:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    locks.add(target.id)
    return locks


def _owner_class(node: ast.AST) -> Optional[ast.ClassDef]:
    parent = getattr(node, "_graftlint_parent", None)
    while parent is not None:
        if isinstance(parent, ast.ClassDef):
            return parent
        parent = getattr(parent, "_graftlint_parent", None)
    return None


@dataclass
class _KeyState:
    """One shared location's history on the current path."""

    read_line: int
    stale_line: Optional[int] = None  # suspension line; None = fresh

    @property
    def stale(self) -> bool:
        return self.stale_line is not None


class _FnWalker:
    """Flow walk of ONE async def body, statement order respected.

    ``state`` maps shared keys (``self.x`` / global name) to their
    read/staleness; ``taint`` maps local names to the (key, read line)
    provenance of the shared reads that produced them; ``regions`` is the
    stack of enclosing branch/loop tests' shared reads (control
    dependence)."""

    def __init__(
        self,
        rule: "AwaitAtomicityRule",
        module: ModuleSource,
        fn: ast.AST,
        globals_: set[str],
        locks: set[str],
        may_await: "set[int]",
        tables: SymbolTables,
    ) -> None:
        self.rule = rule
        self.module = module
        self.fn = fn
        self.globals = globals_
        self.locks = locks
        self.may_await = may_await
        self.tables = tables
        self.state: dict[str, _KeyState] = {}
        self.taint: dict[str, set[tuple[str, int]]] = {}
        self.findings: dict[tuple[str, int], Finding] = {}

    # -- event primitives ---------------------------------------------
    def _suspend(self, line: int) -> None:
        for st in self.state.values():
            if st.stale_line is None:
                st.stale_line = line

    def _read(self, key: str, line: int) -> None:
        self.state[key] = _KeyState(read_line=line)

    def _write(
        self,
        key: str,
        node: ast.AST,
        stmt_locals: set[str],
        regions: list[dict[str, int]],
        under_lock: bool,
    ) -> None:
        st = self.state.get(key)
        if st is None or not st.stale or under_lock:
            return
        dependent = False
        for name in stmt_locals:
            for origin_key, _line in self.taint.get(name, ()):
                if origin_key == key:
                    dependent = True
        if not dependent:
            for region in regions:
                if key in region:
                    dependent = True
                    break
        if not dependent:
            return
        ident = (key, st.read_line)
        if ident in self.findings:
            return
        self.findings[ident] = self.rule.finding(
            self.module, node,
            f"`{key}` read at line {st.read_line} feeds this write across a "
            f"suspension point (line {st.stale_line}) — check-then-act is "
            "not atomic across an await: re-read/validate the state after "
            "the await, or hold the guarding lock across both",
        )

    # -- expression walking (eval order, own scope only) ---------------
    def _key_of(self, node: ast.AST) -> Optional[str]:
        attr = _self_attr(node)
        if attr is not None:
            return f"self.{attr}"
        if isinstance(node, ast.Name) and node.id in self.globals:
            return node.id
        return None

    def _walk_expr(self, node: ast.AST) -> None:
        """Record reads/suspensions of an expression tree in (approximate)
        evaluation order.  Does not descend into nested def/lambda bodies
        (their execution is deferred to their own call)."""
        if node is None:
            return
        if isinstance(node, (*DEF_NODES, ast.Lambda)):
            return
        if isinstance(node, ast.Await):
            self._walk_expr(node.value)
            self._suspend(node.lineno)
            return
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            detached = bool(chain) and chain[-1] in _DETACH_CALLS
            # receiver expression of the call target still evaluates
            if isinstance(node.func, ast.Attribute):
                key = self._key_of(node.func)
                # a method/attr lookup that is immediately called is a
                # call, not a state read — unless it mutates (handled at
                # the statement level) or feeds detach wrappers
                if key is None:
                    self._walk_expr(node.func.value)
            if not detached:
                for arg in node.args:
                    self._walk_expr(arg)
                for kw in node.keywords:
                    self._walk_expr(kw.value)
                if self._call_may_await(node):
                    self._suspend(node.lineno)
            return
        key = self._key_of(node)
        if key is not None and isinstance(getattr(node, "ctx", ast.Load()), ast.Load):
            self._read(key, node.lineno)
            return
        for child in ast.iter_child_nodes(node):
            self._walk_expr(child)

    def _call_may_await(self, call: ast.Call) -> bool:
        """Interprocedural summary lookup: does this bare call suspend?"""
        for callee in self.tables.resolve_ref(
            self.module, call, call.func,
            non_self_methods=True,
            method_names_ok=lambda n: n not in _GENERIC_METHODS,
        ):
            if id(callee) in self.may_await:
                return True
        return False

    @staticmethod
    def _loaded_locals(node: ast.AST) -> set[str]:
        return {
            sub.id
            for sub in ast.walk(node)
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
        }

    def _read_keys(self, node: ast.AST) -> set[tuple[str, int]]:
        """Shared keys loaded anywhere in ``node`` (provenance for taint)."""
        out: set[tuple[str, int]] = set()
        for sub in ast.walk(node):
            if isinstance(sub, (*DEF_NODES, ast.Lambda)):
                continue
            key = self._key_of(sub)
            if key is not None and isinstance(getattr(sub, "ctx", None), ast.Load):
                # skip the pure method-lookup shape f(...) where sub is func
                parent = getattr(sub, "_graftlint_parent", None)
                if isinstance(parent, ast.Call) and parent.func is sub:
                    continue
                out.add((key, sub.lineno))
        return out

    # -- write shapes ---------------------------------------------------
    def _write_targets(self, stmt: ast.stmt) -> list[tuple[str, ast.AST]]:
        """(key, node) for every shared-state write this statement makes."""
        out: list[tuple[str, ast.AST]] = []

        def target_key(target: ast.AST) -> Optional[tuple[str, ast.AST]]:
            key = self._key_of(target)
            if key is not None:
                return key, target
            if isinstance(target, ast.Subscript):
                key = self._key_of(target.value)
                if key is not None:
                    return key, target
            if isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    hit = target_key(elt)
                    if hit is not None:
                        out.append(hit)
            return None

        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                hit = target_key(target)
                if hit is not None:
                    out.append(hit)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            hit = target_key(stmt.target)
            if hit is not None:
                out.append(hit)
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                hit = target_key(target)
                if hit is not None:
                    out.append(hit)
        # in-place container mutation anywhere in the statement
        for sub in ast.walk(stmt):
            if isinstance(sub, (*DEF_NODES, ast.Lambda)):
                continue
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATOR_METHODS
            ):
                key = self._key_of(sub.func.value)
                if key is not None:
                    out.append((key, sub))
        return out

    # -- statement walk -------------------------------------------------
    def walk(self, body: list[ast.stmt]) -> None:
        self._block(body, regions=[], under_lock=False)

    def _block(
        self, stmts: list[ast.stmt],
        regions: list[dict[str, int]], under_lock: bool,
    ) -> None:
        for stmt in stmts:
            self._stmt(stmt, regions, under_lock)

    def _snapshot(self):
        return (
            {k: _KeyState(v.read_line, v.stale_line)
             for k, v in self.state.items()},
            {k: set(v) for k, v in self.taint.items()},
        )

    def _merge(self, snapshots) -> None:
        """Conservative path join: stale on ANY arm wins; taint unions."""
        merged_state: dict[str, _KeyState] = {}
        merged_taint: dict[str, set] = {}
        for state, taint in snapshots:
            for key, st in state.items():
                cur = merged_state.get(key)
                if cur is None or (st.stale and not cur.stale):
                    merged_state[key] = _KeyState(st.read_line, st.stale_line)
            for name, origins in taint.items():
                merged_taint.setdefault(name, set()).update(origins)
        self.state = merged_state
        self.taint = merged_taint

    def _region_of(self, *exprs: ast.AST) -> dict[str, int]:
        region: dict[str, int] = {}
        for expr in exprs:
            if expr is None:
                continue
            for key, line in self._read_keys(expr):
                region[key] = line
        return region

    def _assign_taint(self, stmt: ast.stmt) -> None:
        """Propagate shared-read provenance into bound locals."""
        if isinstance(stmt, ast.Assign):
            value, targets = stmt.value, stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            value, targets = stmt.value, [stmt.target]
        elif isinstance(stmt, ast.AugAssign):
            value, targets = stmt.value, [stmt.target]
        else:
            return
        origins = set(self._read_keys(value))
        for name in self._loaded_locals(value):
            origins |= self.taint.get(name, set())
        for target in targets:
            for sub in ast.walk(target):
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                    if isinstance(stmt, ast.AugAssign):
                        self.taint.setdefault(sub.id, set()).update(origins)
                    elif origins:
                        self.taint[sub.id] = set(origins)
                    else:
                        self.taint.pop(sub.id, None)

    def _loop_taint(self, target: ast.AST, iter_expr: ast.AST) -> None:
        origins = set(self._read_keys(iter_expr))
        for name in self._loaded_locals(iter_expr):
            origins |= self.taint.get(name, set())
        if not origins:
            return
        for sub in ast.walk(target):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                self.taint[sub.id] = set(origins)

    def _stmt(
        self, stmt: ast.stmt,
        regions: list[dict[str, int]], under_lock: bool,
    ) -> None:
        if isinstance(stmt, (*DEF_NODES, ast.ClassDef)):
            return  # nested scope: runs when called, its own analysis unit
        if isinstance(stmt, ast.If):
            self._walk_expr(stmt.test)
            region = self._region_of(stmt.test)
            before = self._snapshot()
            self._block(stmt.body, regions + [region], under_lock)
            arm_a = self._snapshot()
            self.state, self.taint = before
            self._block(stmt.orelse, regions + [region], under_lock)
            arm_b = self._snapshot()
            self._merge([arm_a, arm_b])
            return
        if isinstance(stmt, ast.While):
            self._walk_expr(stmt.test)
            region = self._region_of(stmt.test)
            before = self._snapshot()
            self._block(stmt.body, regions + [region], under_lock)
            body_exit = self._snapshot()
            self._block(stmt.orelse, regions, under_lock)
            self._merge([before, body_exit, self._snapshot()])
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._walk_expr(stmt.iter)
            region = self._region_of(stmt.iter)
            self._loop_taint(stmt.target, stmt.iter)
            if isinstance(stmt, ast.AsyncFor):
                # each iteration step suspends BEFORE the body runs
                self._suspend(stmt.lineno)
            before = self._snapshot()
            self._block(stmt.body, regions + [region], under_lock)
            body_exit = self._snapshot()
            self._block(stmt.orelse, regions, under_lock)
            self._merge([before, body_exit, self._snapshot()])
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locked = under_lock
            for item in stmt.items:
                expr = item.context_expr
                base = expr.func if isinstance(expr, ast.Call) else expr
                rendered = (
                    f"self.{_self_attr(base)}" if _self_attr(base) else
                    base.id if isinstance(base, ast.Name) else ""
                )
                if rendered in self.locks:
                    locked = True
                else:
                    self._walk_expr(expr)
            if isinstance(stmt, ast.AsyncWith) and not locked:
                self._suspend(stmt.lineno)
            self._block(stmt.body, regions, locked)
            return
        if isinstance(stmt, ast.Try):
            entry = self._snapshot()
            self._block(stmt.body, regions, under_lock)
            arms = [self._snapshot()]
            for handler in stmt.handlers:
                self.state, self.taint = (
                    {k: _KeyState(v.read_line, v.stale_line)
                     for k, v in entry[0].items()},
                    {k: set(v) for k, v in entry[1].items()},
                )
                self._block(handler.body, regions, under_lock)
                arms.append(self._snapshot())
            self._merge(arms)
            self._block(stmt.orelse, regions, under_lock)
            self._block(stmt.finalbody, regions, under_lock)
            return
        # ---- simple statement ----
        writes = self._write_targets(stmt)
        write_nodes = {id(node) for _k, node in writes}
        # evaluation order: the value/expression side first (reads refresh,
        # awaits stale), then the write check, then taint/store effects
        if isinstance(stmt, ast.Assign):
            self._walk_expr(stmt.value)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if getattr(stmt, "value", None) is not None:
                self._walk_expr(stmt.value)
            if isinstance(stmt, ast.AugAssign):
                key = self._key_of(stmt.target)
                if key is not None:
                    # in-place RMW re-reads at the write: fresh by definition
                    self._read(key, stmt.lineno)
        elif isinstance(stmt, ast.Expr):
            # mutator-call receivers are the write itself, not a re-read:
            # walk arguments only for the mutating calls
            self._walk_expr_skipping_writes(stmt.value, write_nodes)
        elif isinstance(stmt, (ast.Return, ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                self._walk_expr(child)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._walk_expr(child)
        stmt_locals = self._loaded_locals(stmt)
        for key, node in writes:
            self._write(key, node, stmt_locals, regions, under_lock)
        self._assign_taint(stmt)
        # a plain rebind of self.x makes the location's current value this
        # coroutine's own: later UNRELATED writes are not check-then-act,
        # but stale taint still flags derived writes (no read-state reset)

    def _walk_expr_skipping_writes(self, node: ast.AST, write_nodes: set[int]) -> None:
        if node is None or isinstance(node, (*DEF_NODES, ast.Lambda)):
            return
        if id(node) in write_nodes and isinstance(node, ast.Call):
            for arg in node.args:
                self._walk_expr(arg)
            for kw in node.keywords:
                self._walk_expr(kw.value)
            return
        if isinstance(node, (ast.Await, ast.Call)):
            self._walk_expr(node)
            return
        for child in ast.iter_child_nodes(node):
            self._walk_expr_skipping_writes(child, write_nodes)


class AwaitAtomicityRule(Rule):
    id = "GL011"
    name = "await-atomicity"
    description = (
        "a read of shared mutable state (self.* / module global) must not "
        "feed a later write across a suspension point (await, async for/"
        "with, may-await call) without a held lock or a re-read after the "
        "await — asyncio check-then-act is only atomic between awaits"
    )
    scope = (
        r"operator_tpu_torch/operator/.*\.py$",
        r"operator_tpu_torch/router/.*\.py$",
        r"operator_tpu_torch/serving/.*\.py$",
        r"operator_tpu_torch/obs/.*\.py$",
        # fleet KV fabric: the fetch client interleaves index
        # reads with awaited transport calls — stale-read check-then-act
        # here silently adopts pages a peer already dropped
        r"operator_tpu_torch/fabric/.*\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        modules = [m for m in ctx.in_scope(self.scope) if m.tree is not None]
        if not modules:
            return []
        tables = ctx.symbol_tables(modules)
        may_await = self._may_await_summaries(tables)
        findings: list[Finding] = []
        for module in modules:
            globals_ = _module_mutable_globals(module)
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.AsyncFunctionDef):
                    continue
                locks = _lock_names(module, _owner_class(node))
                walker = _FnWalker(
                    self, module, node, globals_, locks, may_await, tables
                )
                walker.walk(node.body)
                findings.extend(walker.findings.values())
        return findings

    # -- interprocedural suspension summaries ---------------------------
    def _may_await_summaries(self, tables: SymbolTables) -> set[int]:
        """Def node ids that may suspend the calling coroutine: async defs
        and anything that (transitively) calls one — the same resolution
        discipline as GL006's async-reachability, inverted into a
        may-await fixpoint."""
        from ..callgraph import iter_scope

        may_await: set[int] = set()
        calls: dict[int, list[ast.AST]] = {}
        defs: list[ast.AST] = []
        for module in tables.modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, DEF_NODES):
                    continue
                defs.append(node)
                if isinstance(node, ast.AsyncFunctionDef):
                    may_await.add(id(node))
                callees: list[ast.AST] = []
                for stmt in node.body:
                    for sub in iter_scope(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        chain = attr_chain(sub.func)
                        if chain and chain[-1] in _DETACH_CALLS:
                            continue
                        callees.extend(tables.resolve_ref(
                            module, sub, sub.func,
                            non_self_methods=True,
                            method_names_ok=lambda n: n not in _GENERIC_METHODS,
                        ))
                calls[id(node)] = callees
        changed = True
        while changed:
            changed = False
            for node in defs:
                if id(node) in may_await:
                    continue
                if any(id(c) in may_await for c in calls.get(id(node), ())):
                    may_await.add(id(node))
                    changed = True
        return may_await
