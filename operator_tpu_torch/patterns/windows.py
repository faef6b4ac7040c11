"""Log windowing.

Copy of ``operator_tpu/patterns/windows.py``.

The reference ships the entire pod log as one string to its parser with no
chunking (reference PodFailureWatcher.java:319-324) and delegates long-log
scaling to the unseen service.  Here windowing is a first-class primitive:
the CPU matcher extracts context windows around hits, and the TPU semantic
path embeds fixed-stride windows so arbitrarily long logs become a dense
``[num_windows, window_tokens]`` batch — the shape the MXU wants
(SURVEY.md §5 long-context entry).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class LogWindow:
    """A contiguous span of log lines. ``start`` is 0-based, ``stop`` exclusive."""

    start: int
    stop: int
    text: str

    def __len__(self) -> int:
        return self.stop - self.start


def split_lines(logs: Optional[str], *, max_lines: int = 100_000) -> list[str]:
    """Split raw pod logs into lines, keeping only the newest ``max_lines``
    (failures live at the tail; an unbounded crash-loop log must not blow up
    memory)."""
    if not logs:
        return []
    lines = logs.splitlines()
    if len(lines) > max_lines:
        lines = lines[-max_lines:]
    return lines


def iter_windows(
    lines: list[str],
    *,
    window_lines: int = 16,
    stride: int = 8,
) -> Iterator[LogWindow]:
    """Fixed-size overlapping windows over the log (stride < window_lines
    gives overlap so a failure signature split across a boundary still lands
    whole in some window)."""
    if not lines:
        return
    if window_lines <= 0 or stride <= 0:
        raise ValueError("window_lines and stride must be positive")
    n = len(lines)
    start = 0
    while True:
        stop = min(start + window_lines, n)
        yield LogWindow(start=start, stop=stop, text="\n".join(lines[start:stop]))
        if stop >= n:
            break
        start += stride


def context_window(
    lines: list[str],
    line_number: int,
    *,
    before: int = 5,
    after: int = 3,
) -> tuple[list[str], list[str]]:
    """Lines surrounding a hit, for MatchContext / prompt construction."""
    lo = max(0, line_number - before)
    hi = min(len(lines), line_number + 1 + after)
    return lines[lo:line_number], lines[line_number + 1 : hi]


def tail_chars(logs: Optional[str], limit: int = 4000) -> str:
    """The newest ``limit`` characters, starting at a line boundary when
    possible — used to cap prompt size."""
    if not logs:
        return ""
    if len(logs) <= limit:
        return logs
    tail = logs[-limit:]
    newline = tail.find("\n")
    if 0 <= newline < len(tail) - 1:
        tail = tail[newline + 1 :]
    return tail
