"""GL009: every slot/page acquire must reach a release on all paths.

The KV economy hands out finite resources — allocator pages,
KV-store block refs, transfer lanes, scheduler slots.  A page acquired
and then dropped on an early return or an exception path is not a
crash: it is a slow capacity leak that shows up days later as admission
stalls with a healthy-looking fleet.  This rule proves, per function,
that every tracked acquire is discharged on every syntactic path.

The CFG model (deliberately small — see docs/ANALYSIS.md#gl009):

- **Obligation**: ``name = <recv>.allocate(...)`` / ``<recv>.acquire(...)``
  with a single Name target, unwrapping ``await`` and a trailing
  subscript (``page = g.allocator.allocate(1)[0]``).  An acquire whose
  result is NOT bound to a name is untracked (the codebase uses that
  shape only for refcount bumps whose release is owned elsewhere).
- **Discharge**: any later load of the name — a ``release(pages)`` call,
  an ownership transfer into a row/struct (``_Row(..., pages=grant)``),
  a return of the handle.  Coarse on purpose: the rule's job is the
  *dropped* handle, not auditing what the consumer does with it.
- **Paths**: ``if``/``elif``/``else`` branch states merge by union (a
  handle still live on either arm is still an obligation);
  ``for``/``while`` bodies walk once inline; ``with`` walks inline.
  ``try`` bodies walk with every name mentioned in a handler or
  ``finally`` marked *protected* (the handler/finally is the release
  path — the engine's ``except BaseException: release(pages); raise``
  idiom); handlers then walk from the try-entry state.
- **Flag points**: a ``return`` leaving a live, unprotected handle that
  the return value does not carry ("early-return leak"); a ``raise``
  leaving one ("void-in-flight leak" — the in-flight handle dies with
  the exception); and function end.

Part B, same economy from the durability side: append-mode ``open``
(``"a"``/``"ab"``/``"a+"``) anywhere outside ``utils/journal.py`` is a
finding — every durable append must ride the Journal (fsync policy,
torn-tail recovery, writer-thread offload) instead of re-growing ad-hoc
append files the resume/compaction machinery cannot see.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from ..callgraph import DEF_NODES, attr_chain, iter_scope
from ..core import AnalysisContext, Finding, ModuleSource, Rule

#: method names whose bound result is a tracked resource handle
_ACQUIRE_METHODS = {"allocate", "acquire"}
#: modules under the intraprocedural CFG pass (the resource economy)
_CFG_SCOPE = (
    "operator_tpu_torch/serving/sched/",
    "operator_tpu_torch/serving/kvstore.py",
    "operator_tpu_torch/serving/engine.py",
    "operator_tpu_torch/ops/kv_transfer.py",
    # serverless-fleet arc: ring membership and scale ticks hold
    # leases/guards whose early-return paths must discharge them too
    "operator_tpu_torch/router/discovery.py",
    "operator_tpu_torch/operator/autoscale.py",
    # fleet KV fabric: host-pool page adoption and fetch
    # bookkeeping must discharge what they acquire on every exit path
    "operator_tpu_torch/fabric/",
)


def _acquire_target(stmt: ast.stmt) -> Optional[tuple[str, ast.Call]]:
    """``name`` and the acquire call when ``stmt`` binds one, else None."""
    if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
        return None
    target = stmt.targets[0]
    if not isinstance(target, ast.Name):
        return None
    value = stmt.value
    if isinstance(value, ast.Await):
        value = value.value
    if isinstance(value, ast.Subscript):
        value = value.value
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and value.func.attr in _ACQUIRE_METHODS
    ):
        return target.id, value
    return None


def _loaded_names(node: ast.AST) -> set[str]:
    return {
        sub.id
        for sub in ast.walk(node)
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
    }


@dataclass(frozen=True)
class _Obligation:
    name: str
    line: int
    call: str  # rendered acquire expression, for the message


class _Walker:
    """One function's path walk.  ``live`` maps name -> obligation."""

    def __init__(self, rule: "ResourceReleaseRule", module: ModuleSource):
        self.rule = rule
        self.module = module
        self.leaks: dict[tuple[str, int], tuple[ast.AST, str]] = {}

    def walk(self, body: list[ast.stmt]) -> None:
        live = self._block(body, {}, protected=frozenset())
        for ob in live.values():
            self._leak(
                ob,
                body[-1],
                "still live at function end — no path releases it",
            )

    # -- the walk -------------------------------------------------------
    def _block(
        self,
        stmts: list[ast.stmt],
        live: dict[str, _Obligation],
        protected: frozenset,
    ) -> dict[str, _Obligation]:
        live = dict(live)
        for stmt in stmts:
            live = self._stmt(stmt, live, protected)
        return live

    def _discharge(
        self, node: ast.AST, live: dict[str, _Obligation],
        skip: Optional[str] = None,
    ) -> None:
        for name in _loaded_names(node):
            if name != skip:
                live.pop(name, None)

    def _stmt(
        self,
        stmt: ast.stmt,
        live: dict[str, _Obligation],
        protected: frozenset,
    ) -> dict[str, _Obligation]:
        acquired = _acquire_target(stmt)
        if acquired is not None:
            name, call = acquired
            # loads elsewhere in the SAME statement (the receiver) are
            # not a discharge of the new handle
            self._discharge(stmt, live, skip=name)
            live[name] = _Obligation(
                name=name, line=stmt.lineno,
                call=ast.unparse(call.func),
            )
            return live
        if isinstance(stmt, ast.Return):
            carried = _loaded_names(stmt.value) if stmt.value else set()
            for name, ob in list(live.items()):
                if name in carried or name in protected:
                    continue
                self._leak(
                    ob, stmt,
                    "dropped on early return — release (or transfer) it "
                    "before this return",
                )
            return {}
        if isinstance(stmt, ast.Raise):
            mentioned = _loaded_names(stmt)
            for name, ob in list(live.items()):
                if name in mentioned or name in protected:
                    continue
                self._leak(
                    ob, stmt,
                    "void-in-flight: still held when this raise unwinds — "
                    "release in an except/finally before re-raising",
                )
            return {}
        if isinstance(stmt, ast.If):
            self._discharge(stmt.test, live)
            then_live = self._block(stmt.body, live, protected)
            else_live = self._block(stmt.orelse, live, protected)
            return {**then_live, **else_live}
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._discharge(stmt.iter, live)
            body_live = self._block(stmt.body, live, protected)
            body_live = self._block(stmt.orelse, body_live, protected)
            return body_live
        if isinstance(stmt, ast.While):
            self._discharge(stmt.test, live)
            return self._block(stmt.body, live, protected)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._discharge(item.context_expr, live)
            return self._block(stmt.body, live, protected)
        if isinstance(stmt, ast.Try):
            cleanup: set[str] = set()
            for handler in stmt.handlers:
                cleanup |= _loaded_names(ast.Module(handler.body, []))
            cleanup |= _loaded_names(ast.Module(stmt.finalbody, []))
            entry = dict(live)
            body_live = self._block(
                stmt.body, live, protected | frozenset(cleanup)
            )
            for handler in stmt.handlers:
                self._block(handler.body, entry, protected)
            body_live = self._block(stmt.orelse, body_live, protected)
            return self._block(stmt.finalbody, body_live, protected)
        if isinstance(stmt, DEF_NODES) or isinstance(stmt, ast.ClassDef):
            return live  # nested scope: its own walk
        # plain statement: loads discharge
        self._discharge(stmt, live)
        return live

    def _leak(self, ob: _Obligation, at: ast.AST, why: str) -> None:
        key = (ob.name, ob.line)
        if key in self.leaks:
            return
        self.leaks[key] = (
            at,
            f"resource `{ob.name}` from `{ob.call}(...)` (line {ob.line}) "
            f"{why}",
        )


class ResourceReleaseRule(Rule):
    id = "GL009"
    name = "resource-release"
    description = (
        "every bound allocator/lane acquire in the KV economy must reach "
        "a release or ownership transfer on all paths (early returns, "
        "raises, function end); durable append-mode open() outside "
        "utils/journal.py must go through Journal"
    )
    scope = (r"operator_tpu_torch/.*\.py$",)

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        findings: list[Finding] = []
        for module in ctx.in_scope(self.scope):
            if module.tree is None:
                continue
            if any(module.relpath.startswith(p) or module.relpath == p
                   for p in _CFG_SCOPE):
                findings.extend(self._check_cfg(module))
            if module.relpath != "operator_tpu_torch/utils/journal.py":
                findings.extend(self._check_append_open(module))
        return findings

    def _check_cfg(self, module: ModuleSource) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, DEF_NODES):
                continue
            walker = _Walker(self, module)
            walker.walk(node.body)
            for at, message in walker.leaks.values():
                findings.append(self.finding(module, at, message))
        return findings

    def _check_append_open(self, module: ModuleSource) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] not in ("open", "fdopen"):
                continue
            if chain == ["open"] or chain[-2:] == ["os", "fdopen"]:
                # open(path, mode) / os.fdopen(fd, mode)
                mode = node.args[1] if len(node.args) > 1 else None
            else:
                # <path-like>.open(mode)
                mode = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if (
                isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and mode.value.startswith("a")
            ):
                findings.append(self.finding(
                    module, node,
                    f"append-mode open({mode.value!r}) outside "
                    "utils/journal.py — durable appends must go through "
                    "Journal (fsync policy, torn-tail recovery, writer "
                    "thread); ad-hoc append files are invisible to resume/"
                    "compaction",
                ))
        return findings
