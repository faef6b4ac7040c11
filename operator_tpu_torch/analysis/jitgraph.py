"""CUDA-graph program reachability + taint — the engine behind GL001/GL002.

The module keeps the name of the JAX package's counterpart (whose roots are
``jax.jit`` and ``pallas_call``).  Here the roots are the functions the port
captures as CUDA graphs (``serving/graphs.py``): on the card every serving
program and the encoder's bucket is one graph per key, and a host sync
inside one either fails the capture ("operation not permitted when stream
is capturing") or, run eagerly, stalls every step.

Purely syntactic (``ast``), no torch import.  Three passes:

1. **Root detection** — every function that becomes a graph program:
   the function passed to ``<graphs>.program(name, fn, ...)``
   (``GraphSet.program``) or ``<engine>._aot_wrap(name, fn, ...)``, and the
   body of a ``with torch.cuda.graph(...)`` block.  ``fn`` resolves through
   every form the port uses: a lambda, a def by name, a bound method passed
   by attribute (``self._prefill``, class-agnostic), a local bound by
   assignment — tuple unpacking and every branch included
   (``decode_fn, decode_fixed = self._decode_block_paged, ...``) — and a
   factory call, whose returned closure is the program
   (``self._mixed_fn()``).
2. **Reachability** — from each root, resolve calls through module-level
   functions, ``from x import y`` imports within the analysed set,
   class-agnostic ``self.method`` lookups, methods of a receiver whose
   class an annotation names (a parameter ``shard:
   Optional["ServingShard"]``, or ``self.shard`` where a class body
   annotates ``shard``: the serving mesh's collectives), and the same
   local-binding and factory forms (``step = make_mixed_step(...)`` then
   ``step(...)``).
   Higher-order wrappers (``functools.partial``, ``torch.vmap``,
   ``torch.func.*``, ``torch.utils.checkpoint.checkpoint``) treat
   function-valued arguments as calls.
3. **Taint** — which names hold device tensors: root parameters minus
   ``self`` and minus parameters annotated as host scalars (``int``,
   ``float``, ``bool``, ``str``, optionally ``Optional``: a non-tensor
   argument is part of a graph's key, the counterpart of JAX's
   ``static_argnames``), anything produced by a ``torch.*`` /
   ``torch.nn.functional`` / ``F.*`` call or by a call to the port's
   ``ops`` wrappers, and everything derived from those.  Metadata is host
   data and sanitises: the attributes ``.shape``, ``.ndim``, ``.dtype``,
   ``.device``, ``.is_cuda``, ``.requires_grad``, the methods ``.size()``,
   ``.dim()``, ``.numel()``, and ``len(x)``; so do ``is``/``is not``/``in``
   tests.
   Host-introspection calls under ``torch`` (``torch.cuda.*``,
   ``torch.device``, ``torch.finfo``, ``torch.is_tensor``, ...) yield host
   values.  Taint propagates into callees per call site (positional +
   keyword mapping) to a fixpoint.

Heuristic boundaries, documented for rule consumers: attributes of ``self``
are treated as host configuration (untainted) — per-slot device state is
read through parameters in this codebase — and free variables of nested
functions default to untainted.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field
from typing import Optional

from .callgraph import (
    DEF_NODES as _DEF_NODES,
    SymbolTables,
    attr_chain as _attr_chain,
    func_root as _func_root,
    iter_scope,
)
from .core import AnalysisContext, ModuleSource

#: attribute accesses that yield host metadata of a tensor
SANITIZING_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad"}
#: tensor methods that return host metadata (``size`` is a method in torch;
#: ``data_ptr``/``stride`` feed a kernel launch's arguments)
SANITIZING_METHODS = {"size", "dim", "numel", "data_ptr", "stride",
                      "element_size", "is_contiguous"}
#: builtins whose result is a static host value
SANITIZING_CALLS = {"len", "isinstance", "range", "type", "hasattr", "getattr"}
#: roots whose calls produce device tensors
ARRAY_NAMESPACES = {"torch", "F"}
#: ``torch.<second>`` namespaces whose calls return host values
HOST_TORCH_SUBMODULES = {"cuda", "backends", "profiler", "compiler", "jit",
                         "autograd", "library", "distributed"}
#: ``torch.<name>(...)`` calls that return host values
HOST_TORCH_CALLS = {"device", "dtype", "finfo", "iinfo", "is_tensor",
                    "is_floating_point", "is_complex", "get_default_dtype",
                    "is_grad_enabled", "is_inference_mode_enabled",
                    "Generator", "Size", "no_grad", "inference_mode",
                    "enable_grad", "set_grad_enabled"}
#: higher-order wrappers whose function-valued args are effectively called
HOF_NAMES = {"partial", "vmap", "checkpoint", "grad", "jacrev", "jacfwd",
             "vjp", "jvp"}
#: methods that register a graph program: ``GraphSet.program(name, fn)``
#: and the engine's ``_aot_wrap(name, fn)``
PROGRAM_METHODS = {"program", "_aot_wrap"}
#: trace-inert context managers: profiler/span metadata that neither
#: syncs the host nor yields device tensors —
#: ``torch.profiler.record_function``, ``torch.cuda.nvtx.range``, and the
#: obs tracer's ``span()``/``trace()`` (operator_tpu_torch/obs/span.py).
#: The serving engine wraps its prefill/decode dispatches in these;
#: GL001/GL002 must stay quiet on them, and taint must not flow out of
#: them (their return is a context object, not a tensor).
TRACE_INERT_CALLS = {"record_function", "_annotation"}
#: receivers whose ``.span()``/``.trace()`` methods are span context
#: managers, not tensor ops — ``torch.trace(x)`` (the matrix trace!) must
#: stay tainted, so the generic method names require a tracer-shaped
#: receiver
_TRACER_RECEIVERS = {"profiler", "tracer", "obs", "TRACER"}
#: annotation names of a host scalar parameter
_HOST_SCALARS = {"int", "float", "bool", "str"}
_HOST_ANNOTATION_NAMES = _HOST_SCALARS | {"None", "Optional", "Union", "Literal"}
#: depth of local-binding / factory-return resolution
_RESOLVE_DEPTH = 4


def is_trace_inert_call(func: ast.AST) -> bool:
    """Is this call a trace/profiler annotation (see TRACE_INERT_CALLS)?"""
    chain = _attr_chain(func)
    if not chain:
        return False
    if chain[-1] in TRACE_INERT_CALLS:
        return True
    if chain[-2:] == ["nvtx", "range"]:
        return True
    if chain[-1] in ("span", "trace"):
        if chain == ["span"] or chain == ["obs_span"]:
            return True  # `from operator_tpu_torch.obs import span [as obs_span]`
        if len(chain) >= 2 and (
            chain[-2] in _TRACER_RECEIVERS or "trace" in chain[-2].lower()
        ):
            return True  # torch.profiler.trace / self.tracer.span / obs.span
    return False


def _is_host_torch_call(chain: list[str]) -> bool:
    if len(chain) < 2 or chain[0] != "torch":
        return False
    if chain[1] in HOST_TORCH_SUBMODULES:
        return True
    return len(chain) == 2 and chain[1] in HOST_TORCH_CALLS


def _is_array_namespace_call(func: ast.AST) -> bool:
    chain = _attr_chain(func)
    if not chain or chain[0] not in ARRAY_NAMESPACES:
        return False
    return not _is_host_torch_call(chain)


def is_cuda_graph_block(node: ast.AST) -> bool:
    """``with torch.cuda.graph(...)`` (any alias ending ``cuda.graph``)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and _attr_chain(expr.func)[-2:] == [
            "cuda", "graph"
        ]:
            return True
    return False


def _program_fn_arg(call: ast.Call) -> Optional[ast.AST]:
    """The ``fn`` of ``<x>.program(name, fn, ...)`` / ``<x>._aot_wrap(name,
    fn, ...)``; None for any other call."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr in PROGRAM_METHODS):
        return None
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


def _host_scalar_annotation(annotation: Optional[ast.AST]) -> bool:
    """``int``, ``Optional[bool]``, ``"float"``, ``int | None`` ...: a
    parameter the program receives as a host value (part of its key)."""
    if annotation is None:
        return False
    if isinstance(annotation, ast.Constant) and isinstance(annotation.value, str):
        try:
            annotation = ast.parse(annotation.value, mode="eval").body
        except SyntaxError:
            return False
    names: set[str] = set()
    for node in ast.walk(annotation):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Constant) and node.value is None:
            names.add("None")
    return bool(names & _HOST_SCALARS) and names <= _HOST_ANNOTATION_NAMES


def _host_type_test(expr: ast.AST, negated: bool) -> Optional[str]:
    """The name ``expr`` proves a host scalar when it holds (``isinstance(x,
    int)``) or, with ``negated``, when it fails (``not isinstance(x,
    int)``)."""
    if negated:
        if not (isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not)):
            return None
        expr = expr.operand
    if not (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id == "isinstance"
        and len(expr.args) == 2
        and isinstance(expr.args[0], ast.Name)
        and _host_scalar_annotation(expr.args[1])
    ):
        return None
    return expr.args[0].id


@dataclass
class FunctionInfo:
    """One def, lambda or ``with torch.cuda.graph`` body in the analysed
    set."""

    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda | With
    module: ModuleSource
    qualname: str
    is_entry: bool = False
    static_params: set[str] = field(default_factory=set)
    tainted_params: set[str] = field(default_factory=set)
    reachable: bool = False

    @property
    def params(self) -> list[str]:
        args = getattr(self.node, "args", None)
        if not isinstance(args, ast.arguments):
            return []  # a capture block has no parameters
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        return names

    @property
    def body(self) -> list[ast.AST]:
        """Statements to walk (a lambda's expression wrapped as one)."""
        body = self.node.body
        return body if isinstance(body, list) else [ast.Expr(body)]

    def host_scalar_params(self) -> set[str]:
        args = getattr(self.node, "args", None)
        if not isinstance(args, ast.arguments):
            return set()
        return {
            a.arg
            for a in args.posonlyargs + args.args + args.kwonlyargs
            if _host_scalar_annotation(a.annotation)
        }


class JitGraph:
    """Reachability/taint index over a set of modules (see module doc)."""

    @classmethod
    def for_modules(
        cls, ctx: AnalysisContext, modules: list[ModuleSource]
    ) -> "JitGraph":
        """Cached constructor: GL001 and GL002 share one scope, so the
        fixpoint (the expensive half of the analysis) runs once per run."""
        key = ("jitgraph", tuple(m.relpath for m in modules))
        return ctx.memo(key, lambda: cls(ctx, modules))

    def __init__(self, ctx: AnalysisContext, modules: list[ModuleSource]) -> None:
        self.ctx = ctx
        self.modules = [m for m in modules if m.tree is not None]
        self._infos: dict[int, FunctionInfo] = {}  # id(node) -> info
        #: shared syntactic tables (callgraph.py) — the same resolution
        #: semantics GL006's async walk uses
        self._tables = SymbolTables(self.modules)
        #: relpath -> local names imported from the port's ``ops`` package
        self._ops_names: dict[str, set[str]] = {
            m.relpath: self._scan_ops_imports(m) for m in self.modules
        }
        self._build_infos()
        self._detect_entries()
        self._propagate()

    # -- construction --------------------------------------------------
    def _build_infos(self) -> None:
        for module in self.modules:
            for node in ast.walk(module.tree):
                if isinstance(node, _DEF_NODES):
                    self._infos[id(node)] = FunctionInfo(
                        node=node, module=module,
                        qualname=module.symbol_at(node),
                    )

    @staticmethod
    def _scan_ops_imports(module: ModuleSource) -> set[str]:
        """Names bound by ``from <...>ops[.x] import y``, ``from <...> import
        ops`` and ``import <...>.ops.x as y``: calls through them run a
        kernel wrapper and return device tensors."""
        names: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                from_ops = "ops" in (node.module or "").split(".")
                names.update(
                    a.asname or a.name
                    for a in node.names if from_ops or a.name == "ops"
                )
            elif isinstance(node, ast.Import):
                names.update(
                    a.asname for a in node.names
                    if a.asname and "ops" in a.name.split(".")
                )
        return names

    def info(self, node: ast.AST) -> Optional[FunctionInfo]:
        return self._infos.get(id(node))

    def reachable_functions(self) -> list[FunctionInfo]:
        return [i for i in self._infos.values() if i.reachable]

    # -- root detection ------------------------------------------------
    def _detect_entries(self) -> None:
        for module in self.modules:
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Call):
                    target = _program_fn_arg(node)
                    if target is None:
                        continue
                    for info in self._resolve_value(module, node, target):
                        self._mark_entry(info)
                elif is_cuda_graph_block(node):
                    info = FunctionInfo(
                        node=node, module=module,
                        qualname=module.symbol_at(node),
                    )
                    self._infos[id(node)] = info
                    self._mark_entry(info)

    def _mark_entry(self, info: Optional[FunctionInfo]) -> None:
        if info is None:
            return
        info.is_entry = True
        info.static_params.update(info.host_scalar_params())
        info.tainted_params.update(
            p for p in info.params
            if p not in info.static_params and p != "self"
        )

    # -- name resolution -----------------------------------------------
    def _lambda_info(self, module: ModuleSource, node: ast.Lambda) -> FunctionInfo:
        info = self._infos.get(id(node))
        if info is None:
            info = FunctionInfo(
                node=node, module=module,
                qualname=f"{module.symbol_at(node)}.<lambda>",
            )
            self._infos[id(node)] = info
        return info

    def _resolve_function_ref(
        self, module: ModuleSource, site: ast.AST, target: ast.AST
    ) -> list[FunctionInfo]:
        """Defs a function-valued expression can denote."""
        if isinstance(target, ast.Lambda):
            return [self._lambda_info(module, target)]
        nodes = self._tables.resolve_ref(module, site, target)
        return [
            self._infos[id(node)] for node in nodes if id(node) in self._infos
        ]

    def _resolve_value(
        self, module: ModuleSource, site: ast.AST, target: ast.AST,
        depth: int = 0,
    ) -> list[FunctionInfo]:
        """Functions a function-VALUED expression can hold: what
        :meth:`_resolve_function_ref` resolves, plus bound methods on any
        receiver, locals bound by (tuple) assignment in any branch, and
        the closures a factory call returns."""
        if depth > _RESOLVE_DEPTH:
            return []
        if isinstance(target, ast.Attribute):
            nodes = self._tables.resolve_ref(
                module, site, target, non_self_methods=True
            )
            return [self._infos[id(n)] for n in nodes if id(n) in self._infos]
        if isinstance(target, ast.Call):
            return self._factory_returns(module, target, depth)
        found = self._resolve_function_ref(module, site, target)
        if found or not isinstance(target, ast.Name) or hasattr(
            builtins, target.id
        ):
            return found
        out: list[FunctionInfo] = []
        for bind_site, value in self._local_bindings(module, site, target.id):
            out.extend(self._resolve_value(module, bind_site, value, depth + 1))
        return out

    def _factory_returns(
        self, module: ModuleSource, call: ast.Call, depth: int
    ) -> list[FunctionInfo]:
        """The functions ``call`` returns: for ``partial(f, ...)`` /
        ``vmap(f)`` style wrappers ``f``; for a resolved factory, every
        function-valued ``return`` in its own body."""
        func = call.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else ""
        )
        if name in HOF_NAMES and call.args:
            return self._resolve_value(module, call, call.args[0], depth + 1)
        out: list[FunctionInfo] = []
        for factory in self._resolve_value(module, call, func, depth + 1):
            if not isinstance(factory.node, _DEF_NODES):
                continue
            for stmt in factory.node.body:
                for node in iter_scope(stmt):
                    if isinstance(node, ast.Return) and node.value is not None:
                        out.extend(self._resolve_value(
                            factory.module, node, node.value, depth + 1
                        ))
        return out

    @staticmethod
    def _local_bindings(
        module: ModuleSource, site: ast.AST, name: str
    ) -> list[tuple[ast.AST, ast.AST]]:
        """(assignment, value) pairs binding ``name`` in the nearest
        lexically-enclosing scope that assigns it (the module body last):
        ``name = v`` and ``a, name = x, v`` positionally, every branch."""
        scopes: list[ast.AST] = []
        scope = getattr(site, "_graftlint_parent", None)
        while scope is not None:
            if isinstance(scope, (*_DEF_NODES, ast.Module)):
                scopes.append(scope)
            scope = getattr(scope, "_graftlint_parent", None)
        for scope in scopes:
            found: list[tuple[ast.AST, ast.AST]] = []
            for stmt in scope.body:
                for node in iter_scope(stmt):
                    if not isinstance(node, ast.Assign):
                        continue
                    for target in node.targets:
                        if isinstance(target, ast.Name) and target.id == name:
                            found.append((node, node.value))
                        elif isinstance(target, (ast.Tuple, ast.List)) and (
                            isinstance(node.value, (ast.Tuple, ast.List))
                            and len(node.value.elts) == len(target.elts)
                        ):
                            for elt, value in zip(target.elts, node.value.elts):
                                if isinstance(elt, ast.Name) and elt.id == name:
                                    found.append((node, value))
            if found:
                return found
        return []

    # -- reachability + taint fixpoint ---------------------------------
    def _propagate(self) -> None:
        """Reachability and parameter taint to a least fixpoint.  A call's
        result is tainted by what its callee returns under the callee's
        CURRENT parameter taint, so the pass repeats (return memo cleared)
        until no parameter gains taint and no function turns reachable:
        everything only grows, so it ends, and no launch helper's host
        result (a split plan from shapes) taints what it feeds."""
        for info in self._infos.values():
            if info.is_entry:
                info.reachable = True
        while True:
            self._return_memo: dict[int, bool] = {}
            state = self._taint_state()
            worklist = self.reachable_functions()
            while worklist:
                info = worklist.pop()
                env = self.local_taint(info)
                for stmt in info.body:
                    for node in iter_scope(stmt):
                        # nested defs become reachable through their call
                        # sites (precise per-site taint mapping)
                        if not isinstance(node, ast.Call):
                            continue
                        for callee, args_taint in self._resolve_call(
                            info.module, node, env
                        ):
                            changed = not callee.reachable
                            callee.reachable = True
                            before = len(callee.tainted_params)
                            callee.tainted_params.update(args_taint)
                            if changed or len(callee.tainted_params) != before:
                                worklist.append(callee)
            if self._taint_state() == state:
                break
        self._return_memo = {}

    def _taint_state(self) -> int:
        return sum(
            1 + len(i.tainted_params) for i in self._infos.values() if i.reachable
        )

    def _resolve_call(
        self, module: ModuleSource, call: ast.Call, env: set[str]
    ) -> list[tuple[FunctionInfo, set[str]]]:
        """(callee, tainted-param-names) pairs for one call site."""
        out: list[tuple[FunctionInfo, set[str]]] = []
        func = call.func
        # higher-order wrappers: function-valued args are called with
        # device values
        attr = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else ""
        )
        if attr in HOF_NAMES:
            for arg in call.args:
                for info in self._resolve_value(module, call, arg):
                    out.append(
                        (info, {p for p in info.params if p != "self"})
                    )
        if isinstance(func, ast.Name):
            targets = self._resolve_value(module, call, func)
        elif (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            targets = self._resolve_function_ref(module, call, func)
        elif isinstance(func, ast.Attribute):
            # a method of a receiver whose class an annotation names
            targets = [
                self._infos[id(node)] for node in self._tables.typed_methods(call, func)
                if id(node) in self._infos
            ]
        else:
            targets = []
        for info in targets:
            out.append((info, self._map_taint(info, call, env, module)))
        return out

    def _map_taint(
        self, callee: FunctionInfo, call: ast.Call, env: set[str],
        module: ModuleSource,
    ) -> set[str]:
        params = [p for p in callee.params if p != "self"]
        tainted: set[str] = set()
        for idx, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                # can't map positions past a splat: taint the rest
                tainted.update(params[idx:])
                break
            if idx < len(params) and self.expr_tainted(arg, env, module):
                tainted.add(params[idx])
        for kw in call.keywords:
            if kw.arg is not None and self.expr_tainted(kw.value, env, module):
                tainted.add(kw.arg)
        return tainted & set(params)

    # -- taint ----------------------------------------------------------
    def local_taint(self, info: FunctionInfo) -> set[str]:
        """Names holding device tensors inside ``info``: tainted params
        plus assignment targets of tainted expressions (iterated to
        fixpoint — straight-line reassignment chains converge in a few
        passes)."""
        env = set(info.tainted_params)
        body = info.node.body if isinstance(info.node.body, list) else []
        for _ in range(8):
            before = len(env)
            for stmt in body:
                for node in iter_scope(stmt):
                    if isinstance(node, _DEF_NODES):
                        continue
                    targets: list[ast.AST] = []
                    value: Optional[ast.AST] = None
                    if isinstance(node, ast.Assign):
                        targets, value = node.targets, node.value
                    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                        targets, value = [node.target], node.value
                    elif isinstance(node, ast.For):
                        targets, value = [node.target], node.iter
                    if value is not None and self.expr_tainted(
                        value, env, module=info.module
                    ):
                        for target in targets:
                            for leaf in ast.walk(target):
                                if isinstance(leaf, ast.Name):
                                    env.add(leaf.id)
            if len(env) == before:
                break
        return env

    def _return_tainted(self, info: FunctionInfo) -> bool:
        """Does a call to ``info`` yield a device tensor?  Computed from its
        (post-fixpoint) tainted params and return expressions; cycles
        resolve conservatively to tainted."""
        memo = self._return_memo
        key = id(info.node)
        if key in memo:
            return memo[key]
        memo[key] = True  # in-progress: recursion assumes tainted
        if isinstance(info.node, ast.Lambda):
            result = self.expr_tainted(
                info.node.body, set(info.tainted_params), module=info.module
            )
        else:
            env = self.local_taint(info)
            result = False
            for stmt in info.node.body:
                for node in iter_scope(stmt):
                    if isinstance(node, _DEF_NODES):
                        continue
                    if isinstance(node, ast.Return) and node.value is not None:
                        if self.expr_tainted(node.value, env, module=info.module):
                            result = True
                            break
                if result:
                    break
        memo[key] = result
        return result

    def expr_tainted(
        self,
        expr: ast.AST,
        env: set[str],
        module: Optional[ModuleSource] = None,
    ) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in env
        if isinstance(expr, ast.Constant):
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in SANITIZING_ATTRS:
                return False
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                return False  # host-owned configuration (module doc)
            return self.expr_tainted(expr.value, env, module)
        if isinstance(expr, ast.Compare):
            if all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in expr.ops
            ):
                # None dispatch / dict-membership config checks
                # (`name in layer_lora`) are host tests
                return False
            return any(
                self.expr_tainted(e, env, module)
                for e in [expr.left, *expr.comparators]
            )
        if isinstance(expr, ast.Call):
            func = expr.func
            if isinstance(func, ast.Name) and func.id in SANITIZING_CALLS:
                return False
            if (
                isinstance(func, ast.Attribute)
                and func.attr in SANITIZING_METHODS
            ):
                return False
            # BEFORE the namespace check: torch.profiler.record_function
            # is torch-rooted but trace-inert — its result is a context
            # object, never a tensor
            if is_trace_inert_call(func):
                return False
            if _is_array_namespace_call(func):
                return True
            # resolved local/imported/self calls: taint of their returns
            if module is not None:
                infos = self._resolve_function_ref(module, expr, func)
                if infos:
                    return any(self._return_tainted(i) for i in infos)
            if module is not None and _func_root(func) in self._ops_names.get(
                module.relpath, ()
            ):
                return True  # a kernel wrapper of the port's ops package
            if isinstance(func, ast.Attribute) and self.expr_tainted(
                func.value, env, module
            ):
                return True  # method on a device tensor
            return any(
                self.expr_tainted(a, env, module) for a in expr.args
            ) or any(
                self.expr_tainted(kw.value, env, module)
                for kw in expr.keywords
            )
        if isinstance(expr, ast.BoolOp):
            # `not isinstance(x, int) or x != 0` / `isinstance(x, int) and
            # x > 0`: the operands after the type test see a host scalar
            narrowed = set(env)
            for value in expr.values:
                if self.expr_tainted(value, narrowed, module):
                    return True
                name = _host_type_test(value, negated=isinstance(expr.op, ast.Or))
                narrowed.discard(name)
            return False
        if isinstance(expr, ast.BinOp):
            return self.expr_tainted(
                expr.left, env, module
            ) or self.expr_tainted(expr.right, env, module)
        if isinstance(expr, ast.UnaryOp):
            return self.expr_tainted(expr.operand, env, module)
        if isinstance(expr, ast.Subscript):
            return self.expr_tainted(
                expr.value, env, module
            ) or self.expr_tainted(expr.slice, env, module)
        if isinstance(expr, ast.IfExp):
            return any(
                self.expr_tainted(e, env, module)
                for e in [expr.test, expr.body, expr.orelse]
            )
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(e, env, module) for e in expr.elts)
        if isinstance(expr, ast.Starred):
            return self.expr_tainted(expr.value, env, module)
        return False
