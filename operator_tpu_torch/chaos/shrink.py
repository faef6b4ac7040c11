"""Fault-plan shrinking: ddmin a failing scenario to a minimal repro.

The port's own copy of ``operator_tpu/chaos/shrink.py``.

A composed game day that violates an invariant is a terrible bug
report: six injections, three fleet actions, hundreds of arrivals.
The shrinker reduces it to the smallest injection subset that still
fails, using Zeller's ddmin over the scenario's flat injection index
space (:meth:`ChaosScenario.injections` /
:meth:`ChaosScenario.with_injections` — phases and fleet actions are
structural context and are preserved verbatim; only injections shrink).

The caller supplies the failing PREDICATE — ``async probe(scenario) ->
bool``, True when the reduced scenario STILL fails (e.g. "run it under
the conductor with the mutation armed and check
``report['violations']``").  Because injections fire on per-site call
counters and every random draw happens at compile time, the predicate
is a deterministic function of the injection subset — ddmin's
monotonicity assumption actually holds here, and the minimal repro
replays byte-identically (same fingerprint, same verdict) every time.

Results are cached per subset, so the probe never runs twice for one
candidate; the final subset is re-verified before being returned.  The
minimal scenario is emitted as runnable JSON —

    LOADGEN_GAMEDAY=1 LOADGEN_SCENARIO=<path> python -m operator_tpu_torch.loadgen

— the exact artifact to commit under ``tests/scenarios/`` as a
regression game day (docs/ROBUSTNESS.md, "committing a repro").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Awaitable, Callable

from ..utils.timing import METRICS
from .scenario import ChaosScenario

Probe = Callable[[ChaosScenario], Awaitable[bool]]


@dataclass(frozen=True)
class ShrinkResult:
    """The minimal failing reproducer and how we got there."""

    scenario: ChaosScenario
    #: surviving indices into the ORIGINAL scenario's injections()
    indices: "tuple[int, ...]"
    #: probe invocations actually run (cache misses)
    probes: int
    #: injection count before / after
    original: int
    minimal: int

    def repro_json(self) -> str:
        return self.scenario.to_json()

    def repro_command(self, path: str) -> str:
        """The one-liner that replays the minimal repro from ``path``
        (write :meth:`repro_json` there first)."""
        return (
            f"LOADGEN_GAMEDAY=1 LOADGEN_SCENARIO={path} "
            "python -m operator_tpu_torch.loadgen"
        )


def _chunks(items: "list[int]", n: int) -> "list[list[int]]":
    size, rem = divmod(len(items), n)
    out, start = [], 0
    for i in range(n):
        end = start + size + (1 if i < rem else 0)
        if end > start:
            out.append(items[start:end])
        start = end
    return out


async def shrink(
    scenario: ChaosScenario,
    probe: Probe,
    *,
    metrics=None,
) -> ShrinkResult:
    """ddmin ``scenario``'s injections down to a minimal set for which
    ``probe`` still returns True.  ``probe`` must return True for the
    full scenario (asserted — shrinking a passing scenario is a test
    bug, not a shrink)."""
    metrics = metrics if metrics is not None else METRICS
    total = len(scenario.injections())
    cache: "dict[tuple[int, ...], bool]" = {}
    runs = {"n": 0}

    async def failing(indices: "list[int]") -> bool:
        key = tuple(indices)
        if key not in cache:
            runs["n"] += 1
            metrics.incr("chaos_shrink_probe")
            cache[key] = await probe(scenario.with_injections(list(indices)))
        return cache[key]

    if not await failing(list(range(total))):
        raise ValueError(
            "shrink() needs a failing scenario: probe returned False for "
            "the full injection set"
        )

    indices = list(range(total))
    n = 2
    while len(indices) >= 2:
        parts = _chunks(indices, n)
        reduced = False
        # subsets first: a failing chunk is the biggest single cut
        for part in parts:
            if await failing(part):
                indices, n, reduced = part, 2, True
                break
        if not reduced:
            # complements: drop one chunk at a time
            for part in parts:
                dropped = set(part)
                complement = [i for i in indices if i not in dropped]
                if complement and await failing(complement):
                    indices, reduced = complement, True
                    n = max(2, n - 1)
                    break
        if not reduced:
            if n >= len(indices):
                break
            n = min(len(indices), 2 * n)

    assert await failing(indices)  # cached: the minimal set verified failing
    metrics.incr("chaos_shrink_done")
    return ShrinkResult(
        scenario=scenario.with_injections(indices),
        indices=tuple(indices),
        probes=runs["n"],
        original=total,
        minimal=len(indices),
    )
