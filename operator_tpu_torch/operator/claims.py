"""Durable analysis claims — the crash-safe successor to the in-memory dedupe.

The pipeline used to claim a ``(pod, failureTime)`` in a process-local map
(``FailureDedupe``): an operator crash or node preemption silently dropped
every in-flight analysis, and a second replica would happily double-analyze
everything the first one already owned.  This module replaces that map with
an append-only JSONL **claim ledger** (same torn-line-tolerant discipline as
``memory/store.py``):

- ``claim`` records carry everything a *successor process* needs to re-run
  the analysis: pod coordinates, failure time, the matched Podmortem refs,
  the claim's total deadline budget, and its wall-clock birth;
- ``stage`` records note coarse progress (which CR is being analyzed) so a
  post-mortem of the ledger shows where a crash landed;
- ``done`` / ``release`` are the terminal transitions (``release`` =
  retryable: the other detection path may claim the failure again).

On startup — or on lease takeover (``operator/lease.py``) — the pipeline
replays the ledger and re-enqueues every NON-terminal claim with its
**remaining** deadline budget (total minus wall-clock elapsed since the
claim was born; wall-clock because monotonic clocks do not survive the
process).  Status patches are idempotent (``operator/storage.py``), so
at-least-once execution of a resumed claim still yields exactly-once
``status.recentFailures`` entries.

``path=None`` keeps the ledger purely in-memory — exactly the old
``FailureDedupe`` semantics — for tests and laptops.

The port's own copy of ``operator_tpu/operator/claims.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.journal import Journal

log = logging.getLogger(__name__)

_IN_FLIGHT = "in-flight"
_DONE = "done"


@dataclass
class ClaimRecord:
    """One claimed failure: identity + everything a successor needs to
    resume it after a crash."""

    key: str
    pod_name: str = ""
    pod_namespace: str = ""
    failure_time: str = ""
    #: matched Podmortem CRs as "namespace/name" refs — the fan-out a
    #: resumed claim re-runs (a ref deleted since the claim is skipped)
    podmortems: list[str] = field(default_factory=list)
    #: the claim's full deadline envelope; the successor runs with
    #: ``total - (wall_now - claimed_at)`` — the REMAINING budget
    deadline_total_s: float = 0.0
    #: wall-clock birth (epoch seconds): monotonic clocks die with the
    #: process, so cross-process budget arithmetic must be wall-clock
    claimed_at: float = 0.0
    #: coarse progress marker ("analyze:<ns>/<name>") for forensics
    stage: str = ""
    state: str = _IN_FLIGHT

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "pod_name": self.pod_name,
            "pod_namespace": self.pod_namespace,
            "failure_time": self.failure_time,
            "podmortems": list(self.podmortems),
            "deadline_total_s": self.deadline_total_s,
            "claimed_at": self.claimed_at,
            "stage": self.stage,
        }

    @classmethod
    def parse(cls, data: dict) -> "ClaimRecord":
        return cls(
            key=str(data["key"]),
            pod_name=str(data.get("pod_name") or ""),
            pod_namespace=str(data.get("pod_namespace") or ""),
            failure_time=str(data.get("failure_time") or ""),
            podmortems=[str(p) for p in (data.get("podmortems") or [])],
            deadline_total_s=float(data.get("deadline_total_s") or 0.0),
            claimed_at=float(data.get("claimed_at") or 0.0),
            stage=str(data.get("stage") or ""),
        )


class ClaimLedger:
    """Thread-safe bounded claim map with an optional crash-safe journal.

    The map is an LRU bounded at ``max_entries`` exactly like the old
    dedupe (terminal entries age out; the durable annotation marker in
    etcd remains the long-term dedupe).  Journal compaction rewrites one
    line per live entry via temp-file + ``os.replace`` so a crash
    mid-compaction leaves the old journal intact.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        max_entries: int = 10_000,
        compact_factor: int = 8,
        wall_clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.path = path
        self.max_entries = max(1, max_entries)
        self.compact_factor = max(2, compact_factor)
        self._wall = wall_clock or time.time
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ClaimRecord]" = OrderedDict()
        # shared crash-safe JSONL discipline (utils/journal.py) on a
        # dedicated writer thread (the obs/record.py pattern): stage/done/
        # release transitions and compaction enqueue and return, so the
        # ROUTINE ledger traffic — including every compaction — runs off
        # the event loop and a slow RWX volume no longer stalls the lease
        # renew loop on each transition.  try_claim alone WAITS for its
        # flush (durable-before-analysis, by contract); that one wait can
        # still queue behind an in-flight compaction on severely wedged
        # storage — the residual, rare exposure, down from every-append.
        self._journal = Journal(path, label="claim ledger", async_writes=True)
        #: non-terminal claims found at load: a previous process died while
        #: they were in flight.  Drained (once) by :meth:`take_pending`.
        self._pending: list[ClaimRecord] = []
        if path:
            with self._lock:
                self._load_journal_locked()
                self._journal.open()

    @staticmethod
    def key(pod, failure_time: str) -> str:
        """Same identity as the old ``FailureDedupe.key``."""
        return f"{pod.metadata.namespace}/{pod.metadata.name}@{failure_time}"

    # -- journal (the shared utils/journal.py discipline) ---------------
    def _load_journal_locked(self) -> None:
        self._journal.load(self._replay_locked)
        self._pending = [
            record for record in self._entries.values() if record.state == _IN_FLIGHT
        ]
        if self._pending:
            log.warning(
                "claim ledger %s: %d non-terminal claim(s) from a previous "
                "process await resume", self.path, len(self._pending),
            )

    def _replay_locked(self, record: dict) -> None:
        op = record.get("op")
        if op == "claim":
            claim = ClaimRecord.parse(record["claim"])
            self._entries[claim.key] = claim
            self._entries.move_to_end(claim.key)
        elif op == "stage":
            claim = self._entries.get(record["key"])
            if claim is not None:
                claim.stage = str(record.get("stage") or "")
        elif op == "done":
            claim = self._entries.get(record["key"])
            if claim is not None:
                claim.state = _DONE
        elif op == "release":
            self._entries.pop(record.get("key", ""), None)
        else:
            raise KeyError(f"unknown ledger op {op!r}")

    def _append_locked(self, record: dict, *, wait: bool = False) -> None:
        # the wait=True caller is try_claim's durable-before-analysis
        # write: the claim record MUST hit disk before the analysis
        # starts, or a crash in the gap loses the failure entirely —
        # a deliberate, bounded stall (one fsync) the ledger's contract
        # documents (utils/journal.py module doc)
        self._journal.append(record, wait=wait)  # graftlint: disable=GL006 reason=durable-before-analysis claim write; one bounded fsync by contract
        if self._journal.lines > self.compact_factor * max(len(self._entries), 16):
            self._compact_locked()

    def _compact_locked(self) -> None:
        """One ``claim`` (+ ``done`` for terminal entries, preserving the
        stage marker on the claim record) per live claim — serialized
        under the lock NOW, replaced atomically on the writer thread."""
        records: list[dict] = []
        for claim in self._entries.values():
            records.append({"op": "claim", "claim": claim.to_dict()})
            if claim.state == _DONE:
                records.append({"op": "done", "key": claim.key})
        self._journal.compact(records)

    def close(self) -> None:
        with self._lock:
            self._journal.close()

    def reload(self) -> None:
        """Re-read the journal from disk and reopen the append handle.

        The HA takeover path: a warm standby's ledger was loaded at ITS
        boot, but the claims that matter at takeover are the ones the dead
        leader wrote to the shared journal SINCE — and the leader's
        compaction may have ``os.replace``d the file, which would orphan
        this process's boot-time append handle (appends to the old inode
        are lost).  ``resume_pending`` calls this before draining pending
        claims.  Only safe while this process has no un-journaled
        in-flight claims of its own — exactly the takeover/startup window,
        where the control loops are not running yet."""
        if not self.path:
            return
        with self._lock:
            self._journal.close()
            self._entries.clear()
            self._pending = []
            self._load_journal_locked()
            self._journal.open()

    def abandon(self) -> None:
        """Chaos seam: drop the journal handle WITHOUT terminal records —
        the on-disk state a SIGKILL leaves behind.  Further transitions
        mutate only this process's memory; a successor ledger opened on
        the same path sees the claims exactly as the kill left them."""
        with self._lock:
            self._journal.abandon()

    # -- claim lifecycle ------------------------------------------------
    def try_claim(
        self,
        key: str,
        *,
        pod_name: str = "",
        pod_namespace: str = "",
        failure_time: str = "",
        podmortems: Optional[list[str]] = None,
        deadline_total_s: float = 0.0,
    ) -> bool:
        """Claim the failure for processing; False if already in flight or
        done.  The claim record is durable BEFORE the analysis starts, so
        a crash at any later point leaves a resumable record."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return False
            claim = ClaimRecord(
                key=key,
                pod_name=pod_name,
                pod_namespace=pod_namespace,
                failure_time=failure_time,
                podmortems=list(podmortems or []),
                deadline_total_s=float(deadline_total_s),
                claimed_at=self._wall(),
            )
            self._entries[key] = claim
            while len(self._entries) > self.max_entries:
                evicted_key, _ = self._entries.popitem(last=False)
                # the eviction must reach the journal too: a "claim" line
                # with no terminal op would resurrect as pending at the
                # next load and re-run an arbitrarily stale analysis
                self._append_locked({"op": "release", "key": evicted_key})
            # the ONE write that waits for its flush: the claim record
            # must be durable BEFORE the analysis starts, or a crash in
            # the gap loses the failure entirely
            self._append_locked({"op": "claim", "claim": claim.to_dict()}, wait=True)
            return True

    def note_stage(self, key: str, stage: str) -> None:
        """Coarse progress marker; forensics only (which CR was mid-flight
        when the process died)."""
        with self._lock:
            claim = self._entries.get(key)
            if claim is None:
                return
            claim.stage = stage
            self._append_locked({"op": "stage", "key": key, "stage": stage})

    def mark_done(self, key: str) -> None:
        with self._lock:
            claim = self._entries.get(key)
            if claim is not None:
                claim.state = _DONE
            self._append_locked({"op": "done", "key": key})

    def release(self, key: str) -> None:
        """Forget a failed attempt so either path may retry it."""
        with self._lock:
            self._entries.pop(key, None)
            self._append_locked({"op": "release", "key": key})

    # -- crash-resume ---------------------------------------------------
    def take_pending(self) -> list[ClaimRecord]:
        """Drain the non-terminal claims a previous process left behind
        (oldest first).  Single-shot: the caller owns resuming them; each
        resumed claim ends in ``mark_done``/``release`` as usual."""
        with self._lock:
            pending, self._pending = self._pending, []
            return sorted(pending, key=lambda c: c.claimed_at)

    def remaining_budget_s(self, claim: ClaimRecord) -> float:
        """The claim's residual deadline envelope at resume time."""
        elapsed = max(0.0, self._wall() - claim.claimed_at)
        return max(0.0, claim.deadline_total_s - elapsed)

    # -- introspection --------------------------------------------------
    def get(self, key: str) -> Optional[ClaimRecord]:
        with self._lock:
            return self._entries.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
