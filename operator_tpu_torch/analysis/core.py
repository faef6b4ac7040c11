"""Framework core: findings, rules, pragma suppression, parsed sources.

A :class:`Rule` sees the whole project at once (:class:`AnalysisContext`)
because the interesting invariants are cross-file: graph programs
registered in ``serving/engine.py`` reach bodies defined in
``serving/programs.py`` and ``models/llama.py``, and the generated-artifact rule compares code against
``deploy/``.  Rules that only need one file at a time simply iterate
``ctx.modules``.

Suppression is explicit and auditable: a finding survives unless the
offending line (or its enclosing ``def``/``class`` line) carries

    # graftlint: disable=GL001 reason=why this is deliberate

The ``reason=`` clause is mandatory — a pragma without one does NOT
suppress (it surfaces as a GL000 malformed-pragma finding instead), so
every exception in the tree documents itself.
"""

from __future__ import annotations

import ast
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

#: pragma grammar (GLxxx = rule id): ``graftlint: disable=GLxxx[,GLyyy] reason=<text to EOL>``
PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*disable=(?P<rules>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)"
    r"(?P<reason>\s+reason=\S.*)?"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one place.

    ``symbol`` is the enclosing qualified name (``Class.method`` or a
    module-level function); with ``message`` it forms the baseline identity,
    so unrelated edits that shift line numbers do not churn the baseline.
    """

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    symbol: str = ""

    def key(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}: {self.message}{sym}"


@dataclass
class Pragma:
    line: int
    rules: tuple[str, ...]
    has_reason: bool
    #: the pragma is the whole line (a standalone comment): it also covers
    #: the next source line, the own-line form used when the inline form
    #: would not fit
    standalone: bool = False


class ModuleSource:
    """One parsed Python file: source text, AST (with parent links), the
    pragma table, and the enclosing-scope index used for symbols and
    def-level suppression."""

    def __init__(self, root: Path, path: Path) -> None:
        self.abspath = path
        self.relpath = path.relative_to(root).as_posix()
        self.text = path.read_text(encoding="utf-8", errors="replace")
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.text)
        except SyntaxError as exc:  # surfaced as a finding by the runner
            self.parse_error = f"syntax error: {exc.msg} (line {exc.lineno})"
        if self.tree is not None:
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    child._graftlint_parent = node  # type: ignore[attr-defined]
        self.pragmas = self._scan_pragmas()

    # -- pragmas -------------------------------------------------------
    def _scan_pragmas(self) -> dict[int, Pragma]:
        """Pragmas live in COMMENT tokens only — pragma-shaped text inside
        string literals and docstrings (rule documentation, test fixtures)
        must neither suppress nor trip the GL000 malformed-pragma check."""
        import io
        import tokenize

        pragmas: dict[int, Pragma] = {}
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for token in tokens:
                if token.type != tokenize.COMMENT:
                    continue
                match = PRAGMA_RE.search(token.string)
                if match is None:
                    continue
                lineno, col = token.start
                rules = tuple(
                    r.strip()
                    for r in match.group("rules").split(",")
                    if r.strip()
                )
                pragmas[lineno] = Pragma(
                    line=lineno,
                    rules=rules,
                    has_reason=match.group("reason") is not None,
                    standalone=token.line[:col].strip() == "",
                )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparseable file: surfaced as a GL000 parse finding
        return pragmas

    def malformed_pragmas(self) -> list[Pragma]:
        return [p for p in self.pragmas.values() if not p.has_reason]

    def suppressed(self, rule: str, line: int) -> bool:
        """Is ``rule`` disabled at ``line``?  Honoured positions: the line
        itself, a standalone pragma comment on the line above, or the
        ``def``/``class`` header of any enclosing scope."""
        pragma = self.pragmas.get(line)
        if pragma and pragma.has_reason and rule in pragma.rules:
            return True
        above = self.pragmas.get(line - 1)
        if (
            above is not None
            and above.standalone
            and above.has_reason
            and rule in above.rules
        ):
            return True
        for scope in self._enclosing_scopes(line):
            pragma = self.pragmas.get(scope.lineno)
            if pragma and pragma.has_reason and rule in pragma.rules:
                return True
        return False

    # -- scopes --------------------------------------------------------
    _SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)

    def _enclosing_scopes(self, line: int) -> Iterator[ast.AST]:
        if self.tree is None:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, self._SCOPE_NODES):
                end = getattr(node, "end_lineno", node.lineno)
                if node.lineno <= line <= (end or node.lineno):
                    yield node

    def symbol_at(self, node: ast.AST) -> str:
        """``Class.method`` / ``func`` / ``func.<locals>.inner`` for the
        scope enclosing ``node`` (the node itself when it is a def)."""
        chain: list[str] = []
        current: Optional[ast.AST] = node
        while current is not None:
            if isinstance(current, self._SCOPE_NODES):
                chain.append(current.name)
            current = getattr(current, "_graftlint_parent", None)
        return ".".join(reversed(chain))


@dataclass
class AnalysisContext:
    """Everything a rule may look at: the repo root and every parsed module
    under the analysed trees.  ``module(relpath)`` is the per-file lookup;
    rules with generated-artifact checks also read non-Python files through
    ``root``.

    The context is also the per-run memo: parsed ASTs live in ``modules``
    (one parse per file per run, however many rules look at it), and
    :meth:`memo` / :meth:`symbol_tables` share expensive derived structures
    — symbol/callgraph tables, the graph-program reachability index, auxiliary
    out-of-scope parses — across rules.  Both are thread-safe so rules can
    run concurrently under ``--jobs``."""

    root: Path
    modules: list[ModuleSource] = field(default_factory=list)
    _by_path: dict[str, ModuleSource] = field(default_factory=dict)
    #: scratch space for cross-rule shared computations (e.g. the program
    #: reachability index GL001 and GL002 both need, the callgraph tables
    #: GL006/GL011/GL012 share) — access through :meth:`memo`
    caches: dict = field(default_factory=dict)
    #: reentrant: a memoized builder may itself read other memo entries
    #: (GL012's package enumeration parses aux modules)
    _memo_lock: "threading.RLock" = field(default_factory=threading.RLock)

    def add(self, module: ModuleSource) -> None:
        self.modules.append(module)
        self._by_path[module.relpath] = module

    def module(self, relpath: str) -> Optional[ModuleSource]:
        return self._by_path.get(relpath)

    def in_scope(self, patterns: tuple[str, ...]) -> list[ModuleSource]:
        out = []
        for module in self.modules:
            if any(re.match(pattern, module.relpath) for pattern in patterns):
                out.append(module)
        return out

    def memo(self, key, builder):
        """``caches[key]``, built once under the lock.  Rules running in
        parallel (``--jobs``) must reach every shared computation through
        here — two threads racing the same build would each pay the cost
        and the loser's result would be silently dropped."""
        with self._memo_lock:
            value = self.caches.get(key)
            if value is None:
                value = builder()
                self.caches[key] = value
        return value

    def symbol_tables(self, modules: list["ModuleSource"]):
        """Shared :class:`~.callgraph.SymbolTables` over ``modules``,
        memoized by the module set — rules with the same scope (GL011 and
        GL012 both walk the control plane) build the tables once per run
        instead of once per rule."""
        from .callgraph import SymbolTables

        key = ("symbol_tables", tuple(sorted(m.relpath for m in modules)))
        return self.memo(key, lambda: SymbolTables(modules))

    def aux_module(self, relpath: str) -> Optional["ModuleSource"]:
        """Parse a repo file OUTSIDE the collected set (e.g. ``tests/``
        under ``--changed-only``), memoized.  Returns the in-context module when
        the path was collected normally.  None when the file is missing."""
        hit = self._by_path.get(relpath)
        if hit is not None:
            return hit

        def build():
            path = self.root / relpath
            if not path.is_file():
                return ()
            return ModuleSource(self.root, path)

        built = self.memo(("aux_module", relpath), build)
        return None if built == () else built


class Rule:
    """Base class: subclasses set ``id``/``name``/``description`` and
    implement :meth:`check`.  ``scope`` documents (and restricts) which
    repo-relative paths the rule inspects — regex, anchored at start."""

    id: str = "GL000"
    name: str = "abstract"
    description: str = ""
    scope: tuple[str, ...] = (r".*\.py$",)

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        raise NotImplementedError

    # helper shared by every AST rule
    def finding(
        self, module: ModuleSource, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.id,
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            message=message,
            symbol=module.symbol_at(node),
        )
