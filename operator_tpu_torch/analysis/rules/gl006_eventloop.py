"""GL006: no blocking calls reachable from the event loop.

The control plane (``operator/``), the data-plane router (``router/``),
the observability surface (``obs/``) and the serving HTTP front
(``serving/httpserver.py``) are single-event-loop asyncio programs: one
synchronous file write, ``time.sleep`` or subprocess wait on the loop
stalls every lease renewal, health probe and streaming response at once
— the failure mode (journal IO on the dispatch path) this rule
turns into a lint finding.

Mechanics — an interprocedural async-reachability walk on the shared
callgraph tables (``analysis/callgraph.py``, the same resolution
GL001/GL002's graph-program walk uses):

1. Seed: every ``async def`` in scope (handlers are registered
   dynamically, so an un-called async def still counts).
2. Propagate: direct calls resolve through module functions, ``from x
   import y`` imports, ``self.method`` (class-agnostic, as in
   jitgraph), and ``<recv>.method`` for method names that are not
   generic container-protocol names.  Function REFERENCES handed to
   ``asyncio.to_thread`` / ``run_in_executor`` / ``Thread(target=...)``
   / ``executor.submit`` are not calls on the loop and are never
   walked — that is the sanctioned escape hatch for blocking work.
3. Report: in every reachable function, flag ``time.sleep``, sync
   ``subprocess`` / ``os.system``, sync file IO (``open``,
   ``Path.read_text``/``write_text``, ``os.replace``/``rename``/
   ``fsync``), ``Future.result()`` (unless the receiver is proven done
   in an enclosing ``if x.done()``) — and sync :class:`Journal` traffic:
   ``append``/``compact``/``load``/``open`` on a journal constructed
   without ``async_writes=True``, plus ``append(..., wait=True)`` on ANY
   journal (a durable append blocks by definition; the claim ledger's
   durable-before-analysis write is the deliberate, pragma'd exception).
"""

from __future__ import annotations

import ast
from typing import Optional

from ..callgraph import DEF_NODES, SymbolTables, attr_chain, iter_scope
from ..core import AnalysisContext, Finding, ModuleSource, Rule

#: method names too generic to resolve across classes on a non-``self``
#: receiver (dict/list/queue/file protocol + ubiquitous helper names) —
#: ``self.method`` dispatch is unaffected
_GENERIC_METHODS = {
    "append", "add", "acquire", "cancel", "clear", "close", "copy",
    "count", "discard", "done", "extend", "flush", "get", "index",
    "insert", "items", "join", "keys", "load", "open", "parse", "pop",
    "popleft", "put", "read", "record", "release", "remove", "result",
    "run", "send", "set", "sort", "start", "submit", "to_dict",
    "update", "values", "wait", "write",
}

#: executor-style wrappers: a function REFERENCE in their arguments runs
#: off the loop, so it must not seed reachability
_OFFLOAD_CALLS = {"to_thread", "run_in_executor", "submit", "Thread",
                  "call_soon_threadsafe", "run_sync"}

_SYNC_SUBPROCESS = {"run", "call", "check_call", "check_output", "Popen"}
_SYNC_PATH_IO = {"read_text", "write_text", "read_bytes", "write_bytes"}
_SYNC_OS_IO = {"replace", "rename", "remove", "fsync", "system", "popen"}
_SYNC_SHUTIL = {"copy", "copy2", "copyfile", "copytree", "move", "rmtree"}
#: journal methods that perform IO on the calling thread in sync mode
_JOURNAL_SYNC_IO = {"append", "compact", "load", "open"}


def _truthy_kw(call: ast.Call, name: str) -> Optional[bool]:
    """True/False when ``name=`` is a boolean constant, None otherwise."""
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return None


def _journal_attrs(module: ModuleSource) -> dict[int, dict[str, bool]]:
    """Per-class journal attributes: ClassDef id -> {attr: async_writes}.

    Detected from ``self.<attr> = Journal(...)`` (possibly inside a
    conditional expression).  ``async_writes`` defaults False, matching
    the Journal constructor."""
    out: dict[int, dict[str, bool]] = {}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        attrs: dict[str, bool] = {}
        for child in ast.walk(node):
            if not isinstance(child, ast.Assign) or len(child.targets) != 1:
                continue
            target = child.targets[0]
            if not (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                continue
            for sub in ast.walk(child.value):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "Journal"
                ):
                    attrs[target.attr] = _truthy_kw(sub, "async_writes") is True
        if attrs:
            out[id(node)] = attrs
    return out


def _owner_class(node: ast.AST) -> Optional[ast.ClassDef]:
    parent = getattr(node, "_graftlint_parent", None)
    while parent is not None:
        if isinstance(parent, ast.ClassDef):
            return parent
        if isinstance(parent, ast.Module):
            return None
        parent = getattr(parent, "_graftlint_parent", None)
    return None


def _done_guarded(call: ast.Call) -> bool:
    """Is this ``x.result()`` lexically inside an ``if`` whose test calls
    ``x.done()`` on the same receiver?  A done future's result() does not
    block — the streaming peek path relies on exactly this shape."""
    receiver = ast.unparse(call.func.value)
    node: Optional[ast.AST] = call
    while node is not None:
        if isinstance(node, ast.If):
            for sub in ast.walk(node.test):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "done"
                    and ast.unparse(sub.func.value) == receiver
                ):
                    return True
        node = getattr(node, "_graftlint_parent", None)
    return False


class EventLoopBlockingRule(Rule):
    id = "GL006"
    name = "event-loop-blocking"
    description = (
        "no blocking calls (sync file IO, time.sleep, subprocess, "
        "Future.result(), sync Journal appends) reachable from async "
        "def bodies in operator/, router/, obs/, serving/httpserver.py "
        "— offload via asyncio.to_thread / run_in_executor, or use "
        "Journal(async_writes=True)"
    )
    scope = (
        r"operator_tpu_torch/operator/.*\.py$",
        r"operator_tpu_torch/router/.*\.py$",
        r"operator_tpu_torch/obs/.*\.py$",
        r"operator_tpu_torch/serving/httpserver\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        modules = [m for m in ctx.in_scope(self.scope) if m.tree is not None]
        tables = SymbolTables(modules)
        journal_by_class = {}
        for module in modules:
            journal_by_class.update(_journal_attrs(module))

        # -- async reachability -----------------------------------------
        reachable: dict[int, str] = {}  # def id -> origin async qualname
        worklist: list[ast.AST] = []
        for module in modules:
            for node in ast.walk(module.tree):
                if isinstance(node, ast.AsyncFunctionDef):
                    reachable[id(node)] = module.symbol_at(node)
                    worklist.append(node)
        while worklist:
            fn = worklist.pop()
            module = tables.module_of[id(fn)]
            origin = reachable[id(fn)]
            for stmt in fn.body:
                for node in iter_scope(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    chain = attr_chain(node.func)
                    if chain and chain[-1] in _OFFLOAD_CALLS:
                        continue  # args run off-loop, refs are not calls
                    for callee in tables.resolve_ref(
                        module, node, node.func,
                        non_self_methods=True,
                        method_names_ok=lambda n: n not in _GENERIC_METHODS,
                    ):
                        if id(callee) not in reachable:
                            reachable[id(callee)] = origin
                            worklist.append(callee)

        # -- blocking-call scan over the reachable set ------------------
        findings: list[Finding] = []
        node_by_id = {}
        for module in modules:
            for node in ast.walk(module.tree):
                if isinstance(node, DEF_NODES):
                    node_by_id[id(node)] = (node, module)
        for fn_id, origin in reachable.items():
            fn, module = node_by_id[fn_id]
            cls = _owner_class(fn)
            journal_attrs = journal_by_class.get(id(cls), {}) if cls else {}
            for stmt in fn.body:
                for node in iter_scope(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    message = self._blocking_message(
                        module, node, journal_attrs
                    )
                    if message is not None:
                        findings.append(self.finding(
                            module, node,
                            f"{message} on the event loop (reachable from "
                            f"async `{origin}`) — offload via "
                            "asyncio.to_thread / run_in_executor, or use "
                            "Journal(async_writes=True)",
                        ))
        return findings

    def _blocking_message(
        self,
        module: ModuleSource,
        call: ast.Call,
        journal_attrs: dict[str, bool],
    ) -> Optional[str]:
        chain = attr_chain(call.func)
        if not chain:
            return None
        if chain[-2:] == ["time", "sleep"]:
            return "blocking `time.sleep(...)`"
        if chain[0] == "subprocess" and chain[-1] in _SYNC_SUBPROCESS:
            return f"sync `subprocess.{chain[-1]}(...)`"
        if len(chain) == 2 and chain[0] == "os" and chain[1] in _SYNC_OS_IO:
            return f"sync `os.{chain[1]}(...)`"
        if chain == ["open"]:
            return "sync `open(...)` file IO"
        if len(chain) >= 2 and chain[-1] in _SYNC_PATH_IO:
            return f"sync `.{chain[-1]}(...)` file IO"
        if chain[0] == "shutil" and chain[-1] in _SYNC_SHUTIL:
            return f"sync `shutil.{chain[-1]}(...)` file IO"
        # Future.result(): blocking unless proven done
        if (
            chain[-1] == "result"
            and isinstance(call.func, ast.Attribute)
            and not _done_guarded(call)
        ):
            return "blocking `.result()` on a future"
        # Journal traffic on self-owned journal attributes
        if (
            len(chain) == 3
            and chain[0] == "self"
            and chain[1] in journal_attrs
        ):
            is_async = journal_attrs[chain[1]]
            method = chain[2]
            if method == "append":
                for kw in call.keywords:
                    if kw.arg != "wait":
                        continue
                    if isinstance(kw.value, ast.Constant) and not kw.value.value:
                        break  # wait=False: plain enqueue
                    # literal True or a pass-through variable: the caller
                    # CAN block the loop until the fsync completes
                    return (
                        f"durable `self.{chain[1]}.append(..., "
                        f"wait={ast.unparse(kw.value)})` (blocks until "
                        "flushed even in writer-thread mode)"
                    )
            if not is_async and method in _JOURNAL_SYNC_IO:
                return (
                    f"sync-mode Journal IO `self.{chain[1]}.{method}(...)` "
                    "(constructed without async_writes=True)"
                )
        return None
