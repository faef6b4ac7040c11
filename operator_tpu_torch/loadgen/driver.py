"""The open-loop driver: fire arrivals on schedule, never wait in line.

``run_open_loop`` launches one task per :class:`~.arrivals.ArrivalEvent`
at its offset WITHOUT awaiting earlier completions — when the system
falls behind, arrivals keep coming and queues grow; that queueing
collapse is exactly what closed-loop benchmarks hide (docs/PERF.md).
After the last arrival, a bounded drain collects what it can; stragglers
past the drain budget are cancelled and counted (an operator reading the
report must see offered vs achieved diverge, never a silently shrunk
denominator).
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from .arrivals import ArrivalEvent, ArrivalProcess

__all__ = ["run_open_loop"]


async def run_open_loop(
    submit: Callable[[ArrivalEvent], Any],
    process: ArrivalProcess,
    *,
    time_scale: float = 1.0,
    drain_s: float = 30.0,
) -> dict:
    """Drive ``submit(event)`` (an async callable owning its own ledger
    accounting) open-loop over the process's materialised schedule.

    ``time_scale`` compresses the schedule for smokes (0.1 = 10x faster
    than specified); the SCHEDULE itself is untouched — determinism is
    asserted on the materialised events, not on wall-clock.  Returns the
    offered/achieved accounting; SLO attainment lives in the caller's
    ledger."""
    events = process.materialize()
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    tasks: list[asyncio.Task] = []
    for event in events:
        delay = event.at_s * time_scale - (loop.time() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        # ensure_future, never await: the arrival process does not care
        # how far behind the system is
        tasks.append(asyncio.ensure_future(submit(event)))
    launched_span_s = max(loop.time() - t0, 1e-9)
    drained = cancelled = errored = 0
    if tasks:
        done, pending = await asyncio.wait(tasks, timeout=drain_s)
        for task in pending:
            task.cancel()
            cancelled += 1
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        for task in done:
            if task.cancelled() or task.exception() is not None:
                errored += 1
            else:
                drained += 1
    wall_s = max(loop.time() - t0, 1e-9)
    scaled_duration = max(process.spec.duration_s * time_scale, 1e-9)
    return {
        "arrivals": len(events),
        "offered_per_min": round(len(events) * 60.0 / scaled_duration, 3),
        "achieved_per_min": round(drained * 60.0 / wall_s, 3),
        "launch_span_s": round(launched_span_s, 3),
        "wall_s": round(wall_s, 3),
        "drained": drained,
        "cancelled_at_drain": cancelled,
        "submit_errors": errored,
    }
