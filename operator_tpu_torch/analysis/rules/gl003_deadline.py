"""GL003 — deadline propagation on the analysis control plane.

The latency contract is end-to-end: a :class:`~operator_tpu_torch.utils.
deadline.Deadline` is born when a failure is claimed and every downstream
hop spends from it.  That contract decays one "quick" API call at a time —
an unbudgeted apiserver read in a helper blocks the pipeline for the TCP
stack's idea of forever, and the p50 SLO is gone with no test failing.

The rule: every blocking external call in the control-plane files
(``operator/pipeline.py``, ``providers.py``, ``patternsync.py``,
``kubeapi.py`` — and the rest of the control plane, ``storage.py``, ``events.py``, ``watcher.py``,
``app.py``, plus the HA modules ``lease.py`` and ``claims.py``) must be
budget-bound **at the call itself**:

- wrapped in ``asyncio.wait_for(...)`` (the residue of a threaded
  Deadline — ``timeout=deadline.remaining()`` — is the idiom), or
- passing a ``timeout=`` / ``deadline=`` keyword.

A ``deadline`` parameter on the enclosing function is how the budget
arrives but is deliberately NOT sufficient on its own — an unspent
parameter bounds nothing, and the docs promise per-call enforcement.

"Blocking external" means: Kubernetes API verbs on an api handle
(``self.api.get(...)``, ``api.list(...)``), provider ``.generate(...)``,
subprocess ``.communicate()``, and ``urlopen``/opener HTTP calls.  Internal
awaits (queues, events, locks) are not external and are not flagged.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..core import AnalysisContext, Finding, ModuleSource, Rule

_KUBE_OPS = {
    "get", "list", "list_rv", "create", "patch", "patch_status", "delete",
    "get_log", "watch",
}
_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_api_handle(expr: ast.AST) -> bool:
    """``api`` / ``self.api`` / ``self._api`` — the KubeApi handle shapes
    used across the control plane."""
    if isinstance(expr, ast.Name):
        return expr.id == "api"
    return (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
        and expr.attr in ("api", "_api")
    )


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def external_call_label(call: ast.Call) -> Optional[str]:
    """Label a blocking-external-call site, or None.  Shared with GL012:
    the set of side-effecting sites the deadline rule budgets is exactly
    the set the chaos-seam auditor must prove faultable."""
    func = call.func
    if isinstance(func, ast.Attribute):
        if func.attr in _KUBE_OPS and _is_api_handle(func.value):
            return f"{ast.unparse(func)}(...)"
        if func.attr == "generate":
            return f"{ast.unparse(func)}(...)"
        if func.attr == "communicate":
            return f"{ast.unparse(func)}(...)"
        if func.attr in ("urlopen", "_opener"):
            return f"{ast.unparse(func)}(...)"
    elif isinstance(func, ast.Name) and func.id in ("urlopen", "_opener"):
        return f"{func.id}(...)"
    return None


class DeadlinePropagation(Rule):
    id = "GL003"
    name = "deadline-propagation"
    description = (
        "every blocking external call (kube API verb, provider generate, "
        "subprocess communicate, urlopen) must spend a budget at the call: "
        "asyncio.wait_for (typically on a threaded Deadline's remaining()) "
        "or a timeout=/deadline= keyword"
    )
    scope = (
        r"operator_tpu_torch/operator/pipeline\.py$",
        r"operator_tpu_torch/operator/providers\.py$",
        r"operator_tpu_torch/operator/patternsync\.py$",
        r"operator_tpu_torch/operator/kubeapi\.py$",
        # widened beyond the four analysis-path modules (the standing
        # ROADMAP item): the retry/backoff paths in storage and events,
        # the watch-adjacent lists in the watcher, and the app wiring all
        # make kube calls that must spend kube_call_timeout_s at the call
        r"operator_tpu_torch/operator/storage\.py$",
        r"operator_tpu_torch/operator/events\.py$",
        r"operator_tpu_torch/operator/watcher\.py$",
        r"operator_tpu_torch/operator/app\.py$",
        # survivable-control-plane modules: every lease
        # acquire/renew/release call and every claim-resume kube read must
        # spend kube_call_timeout_s AT the call — a wedged apiserver may
        # cost one bounded tick, never the renew loop (a leader that can't
        # step down is a split brain) or the takeover resume
        r"operator_tpu_torch/operator/lease\.py$",
        r"operator_tpu_torch/operator/claims\.py$",
        # multi-replica data plane: every routed dispatch must
        # spend its residual budget AT the attempt (asyncio.wait_for on
        # the deadline residue) — an unbudgeted replica call would let one
        # wedged replica eat the whole analysis envelope before failover;
        # the shared journal helper's IO rides the writer thread but any
        # external call it ever grows must be budget-bound too
        r"operator_tpu_torch/router/.*\.py$",
        r"operator_tpu_torch/utils/journal\.py$",
        # fleet KV fabric: every peer page fetch must spend its
        # residual budget AT the transport call — a wedged holder must
        # never cost more than the recompute the fetch was replacing
        r"operator_tpu_torch/fabric/.*\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        findings: list[Finding] = []
        for module in ctx.in_scope(self.scope):
            if module.tree is None:
                continue
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                label = self._external_call(node)
                if label is None:
                    continue
                if self._guarded(node):
                    continue
                findings.append(
                    self.finding(
                        module, node,
                        f"blocking external call {label} without a budget: "
                        "wrap in asyncio.wait_for on a threaded Deadline's "
                        "remaining() (utils/deadline.py), or pass timeout=",
                    )
                )
        return findings

    # -- matchers ------------------------------------------------------
    def _external_call(self, call: ast.Call) -> Optional[str]:
        return external_call_label(call)

    # -- guards --------------------------------------------------------
    @staticmethod
    def _is_literal_none(expr: ast.AST) -> bool:
        return isinstance(expr, ast.Constant) and expr.value is None

    def _guarded(self, call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg in ("timeout", "timeout_s", "deadline", "deadline_s"):
                # `timeout=None` is spelled like a budget and bounds
                # nothing; dynamic expressions (deadline.remaining(), a
                # conditional residue) are accepted
                return not self._is_literal_none(kw.value)
        node: Optional[ast.AST] = call
        while node is not None:
            node = getattr(node, "_graftlint_parent", None)
            if (
                isinstance(node, ast.Call)
                and node is not call
                and _terminal_name(node.func) == "wait_for"
            ):
                timeout: Optional[ast.AST] = None
                if len(node.args) > 1:
                    timeout = node.args[1]
                for kw in node.keywords:
                    if kw.arg == "timeout":
                        timeout = kw.value
                return timeout is not None and not self._is_literal_none(timeout)
        return False
