"""GL007: replay-gated modules must not read ambient time or entropy.

The storm harness replays a recorded open-loop trace and asserts the
fleet reproduces the same admission/eviction/SLO decisions; the fault
injector replays failure schedules; resume replays journal suffixes.
One raw ``time.time()`` in a decision path or one unseeded
``random.random()`` silently forks the replay from the recording and
every downstream assertion becomes noise.

Convention this rule enforces (the "seam" convention, used throughout
``loadgen/`` and ``router/health.py``):

- decision clocks are injected: ``self._clock = clock or time.monotonic``
  stores a bare UNCALLED reference — that is the seam, and it is never
  flagged (the rule only matches ``Call`` nodes).  A direct
  ``time.time()`` / ``time.monotonic()`` CALL in scope is a finding.
- ``time.perf_counter()`` is measurement-only (histograms, step-clock
  timings) and never drives a decision — always allowed.
- randomness must be a seeded generator threaded through the seam:
  ``random.Random(seed)`` / ``np.random.default_rng(seed)`` are fine;
  module-level ``random.*`` functions, zero-arg ``random.Random()``,
  ``SystemRandom`` and legacy ``np.random.*`` draws are findings.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..callgraph import attr_chain
from ..core import AnalysisContext, Finding, Rule

#: time.* / datetime.* reads that fork a replay when called directly
_WALL_CLOCK = {"time", "monotonic", "time_ns", "monotonic_ns"}
_DATETIME_NOW = {"now", "utcnow", "today"}
#: module-level random.* draws (random.Random(seed) is the sanctioned form)
_RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "expovariate",
    "betavariate", "triangular", "getrandbits", "randbytes",
}
#: np.random legacy draws; the generator constructors below are exempt
#: when given an explicit seed argument
_NP_SEEDED_CTORS = {"default_rng", "SeedSequence", "PCG64", "Philox"}


class ReplayDeterminismRule(Rule):
    id = "GL007"
    name = "replay-determinism"
    description = (
        "replay-gated modules (loadgen/, faultinject, sched planning, "
        "router dispatch, SLO ledger) must not call wall clocks "
        "(time.time/monotonic — inject a clock seam; perf_counter is "
        "measurement-only and allowed) or unseeded randomness "
        "(random.*, Random(), np.random.* — thread a seeded generator)"
    )
    scope = (
        r"operator_tpu_torch/loadgen/.*\.py$",
        r"operator_tpu_torch/utils/faultinject\.py$",
        r"operator_tpu_torch/serving/sched/.*\.py$",
        r"operator_tpu_torch/router/.*\.py$",
        r"operator_tpu_torch/obs/sloledger\.py$",
        # serverless-fleet arc: the autoscaler's decide() is pure
        # against an injected clock — a bare time.time()/random there
        # would fork chaos replays of scale decisions (discovery.py rides
        # the router/ glob above)
        r"operator_tpu_torch/operator/autoscale\.py$",
    )

    def check(self, ctx: AnalysisContext) -> list[Finding]:
        findings: list[Finding] = []
        for module in ctx.in_scope(self.scope):
            if module.tree is None:
                continue
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                message = self._nondeterminism(node)
                if message is not None:
                    findings.append(self.finding(module, node, message))
        return findings

    def _nondeterminism(self, call: ast.Call) -> Optional[str]:
        chain = attr_chain(call.func)
        if len(chain) < 2:
            return None
        root, leaf = chain[0], chain[-1]
        if root == "time" and leaf in _WALL_CLOCK:
            return (
                f"direct wall-clock read `time.{leaf}()` in a replay-gated "
                "module — inject a clock seam (`clock or time.monotonic`, "
                "called via the seam) so replays can pin time; "
                "time.perf_counter() is allowed for measurement"
            )
        if root == "datetime" and leaf in _DATETIME_NOW:
            return (
                f"direct wall-clock read `datetime.{leaf}()` in a "
                "replay-gated module — derive timestamps from the injected "
                "clock seam"
            )
        if root == "random":
            if leaf in _RANDOM_MODULE_FNS:
                return (
                    f"unseeded module-level `random.{leaf}(...)` — draw "
                    "from a `random.Random(seed)` instance threaded "
                    "through the config/seam"
                )
            if leaf == "Random" and not call.args and not call.keywords:
                return (
                    "`random.Random()` without a seed — pass the replay "
                    "seed explicitly"
                )
            if leaf == "SystemRandom":
                return (
                    "`random.SystemRandom()` is OS entropy and can never "
                    "replay — use `random.Random(seed)`"
                )
        if len(chain) >= 3 and chain[-2] == "random" and root in {
            "np", "numpy",
        }:
            if leaf in _NP_SEEDED_CTORS and (call.args or call.keywords):
                return None
            return (
                f"legacy `{root}.random.{leaf}(...)` draws from global "
                "numpy state — use `np.random.default_rng(seed)` threaded "
                "through the seam"
            )
        return None
