"""Token-level streaming resume checkpoints for the router.

The port's own copy of ``operator_tpu/router/resume.py``.

A replica death mid-stream used to mean restart-from-scratch: the router
re-dispatched the request and the survivor re-prefilled the prompt and
re-decoded every token the client had already been streamed.  The
:class:`ResumeLog` closes the second half of that waste: as tokens
stream back, the router checkpoints the generated-so-far ids per
request; on failover it hands the survivor ``prompt + generated`` as
the resume point, so the survivor re-prefills (cheap, and mostly cached
when the prefix store holds the blocks — serving/kvstore.py) instead of
re-DECODING (expensive, one step per token).  The client's stream then
strictly extends: no token is ever re-emitted, because the scheduler
bills the resumed tokens as prompt and emits only the continuation.

Durability rides the port's :class:`..utils.journal.Journal` — the same
torn-line-tolerant append-only JSONL as the incident store and claim
ledger, so a router crash loses at most the final checkpoint line (the
resume point degrades by one flush interval, never corrupts).  Records
are last-wins per request id; ``done`` tombstones drop completed
requests at replay.  ``path=None`` keeps the log purely in memory —
resume still works across replica deaths within one router process,
which is the common case.

Thread-safety: the router's dispatch path is single-event-loop, and the
Journal serializes its own IO; no extra lock is needed here.
"""

from __future__ import annotations

from typing import Optional

from ..utils.journal import Journal

__all__ = ["ResumeLog"]


class ResumeLog:
    """Per-request generated-token checkpoints with journal durability.

    Monotonic contract: :meth:`checkpoint` only ever EXTENDS a request's
    recorded tokens — a shorter (stale, out-of-order) report is dropped,
    so a resume point can never move backwards and a replayed journal
    reduces to the longest checkpoint per request.
    """

    def __init__(self, path: Optional[str] = None, *,
                 compact_every: int = 256) -> None:
        self._tokens: dict[str, list[int]] = {}
        self._compact_every = max(1, compact_every)
        # async_writes: checkpoint/complete run on the router's dispatch
        # path — appends must enqueue to the writer thread, not do file
        # IO on the event loop (graftlint GL006)
        self._journal = Journal(path, label="resume-log", async_writes=True)
        self._journal.load(self._replay)
        self._journal.open()

    def _replay(self, record: dict) -> None:
        request_id = str(record["id"])
        if record.get("done"):
            self._tokens.pop(request_id, None)
            return
        tokens = record.get("tokens")
        if not isinstance(tokens, list):
            raise ValueError("resume record without tokens")
        current = self._tokens.get(request_id)
        # last-wins, but keep the monotonic guarantee against reordered
        # or duplicated lines: never replace a checkpoint with a shorter one
        if current is None or len(tokens) > len(current):
            self._tokens[request_id] = [int(t) for t in tokens]

    # -- recording -----------------------------------------------------
    def checkpoint(self, request_id: str, token_ids: "list[int]") -> bool:
        """Record the generated-so-far ids for ``request_id``.  Returns
        False (and writes nothing) unless this strictly extends the
        previous checkpoint."""
        current = self._tokens.get(request_id)
        if current is not None and len(token_ids) <= len(current):
            return False
        tokens = [int(t) for t in token_ids]
        self._tokens[request_id] = tokens
        self._journal.append({"id": request_id, "tokens": tokens})
        self._maybe_compact()
        return True

    def complete(self, request_id: str) -> None:
        """The request settled (success or terminal failure): drop its
        checkpoint and tombstone it in the journal so replay forgets it."""
        if self._tokens.pop(request_id, None) is not None:
            self._journal.append({"id": request_id, "done": True})
            self._maybe_compact()

    # -- reads ---------------------------------------------------------
    def tokens(self, request_id: str) -> Optional["list[int]"]:
        """Generated-so-far ids for a live request (a copy), or None."""
        current = self._tokens.get(request_id)
        return list(current) if current is not None else None

    def __len__(self) -> int:
        return len(self._tokens)

    def close(self) -> None:
        self._journal.close()

    # -- compaction ----------------------------------------------------
    def _maybe_compact(self) -> None:
        """Every checkpoint rewrites the request's full token list, so an
        L-token stream costs O(L) lines of O(L) tokens — compact once the
        journal is clearly dominated by superseded lines."""
        if self._journal.lines > max(self._compact_every,
                                     2 * len(self._tokens)):
            self._journal.compact([
                {"id": request_id, "tokens": tokens}
                for request_id, tokens in self._tokens.items()
            ])
