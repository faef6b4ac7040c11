"""Bounded durable incident store.

One :class:`Incident` per distinct failure fingerprint, kept in an LRU
ordering with TTL expiry so the store tracks the fleet's CURRENT failure
population, not everything it ever saw.

Durability is an append-only JSONL journal (optional — ``path=None`` keeps
the store purely in-memory for tests and laptops):

- every mutation appends one line (``put`` = full incident, ``touch`` =
  recurrence bump), flushed immediately — crash-safe in the sense that a
  torn final line is detected and skipped at load, losing at most the one
  mutation that was mid-write;
- the journal compacts (rewrite to a temp file + ``os.replace``, the
  atomic-on-POSIX pattern) once it grows past ``compact_factor`` times the
  live entry count, so a 500x-recurring incident does not append 500
  copies of its analysis text.

An optional ConfigMap snapshot (``snapshot()``/``load_snapshot()``) gives
operators without a PVC a bounded recovery point: newest incidents first,
truncated to fit the apiserver's object-size comfort zone.

The port's own copy of ``operator_tpu/memory/store.py``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..schema.meta import now_iso
from ..schema.serde import from_dict, to_dict
from ..utils.journal import Journal

log = logging.getLogger(__name__)

#: ConfigMap payloads stay under this (the 256 KiB annotation guard's
#: big sibling: ConfigMaps cap at 1 MiB total; leave generous headroom)
MAX_SNAPSHOT_BYTES = 768 * 1024


@dataclass
class CachedAnalysis:
    """One provider's clean analysis of a failure class — the unit an
    exact hit reuses verbatim."""

    explanation: Optional[str] = None
    provider_id: Optional[str] = None
    model_id: Optional[str] = None


@dataclass
class Incident:
    """One remembered failure class: identity, recurrence accounting, and
    the cached analyses future exact hits reuse verbatim.

    Recurrence (``seen_count`` etc.) is per failure CLASS; the reusable
    analyses are per AIProvider ref (``analyses`` keyed by
    "namespace/name", "" for none) — two CRs watching one workload with
    different providers each reuse THEIR OWN text, never each other's."""

    fingerprint: Optional[str] = None
    pattern_ids: list[str] = field(default_factory=list)
    severity: Optional[str] = None
    template: str = ""
    exit_code: Optional[int] = None
    reason: Optional[str] = None
    #: the LATEST clean analysis text (display + near-hit prompt context;
    #: None while only pattern-only/degraded results exist for this class)
    explanation: Optional[str] = None
    provider_id: Optional[str] = None
    model_id: Optional[str] = None
    #: per-provider-ref reusable analyses (exact-hit reuse looks up the
    #: recalling CR's own ref here)
    analyses: dict[str, CachedAnalysis] = field(default_factory=dict)
    #: where this class was FIRST seen (display only — identity excludes it)
    pod_name: Optional[str] = None
    pod_namespace: Optional[str] = None
    first_seen: Optional[str] = None
    last_seen: Optional[str] = None
    #: wall-clock epoch of the last sighting (TTL arithmetic; the ISO
    #: strings above are for humans and the CR status)
    last_seen_ts: float = 0.0
    seen_count: int = 1
    #: how many of those sightings reused the cached analysis
    reused_count: int = 0
    #: fingerprints of near-miss incidents this analysis was linked to
    #: (retrieval-augmented context at generation time)
    related: list[str] = field(default_factory=list)
    #: flight-recorder trace id of the most recent sighting's analysis —
    #: a recurrence links straight to the prior timeline via
    #: GET /traces/{id}
    last_trace_id: Optional[str] = None

    def to_dict(self) -> dict:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict) -> "Incident":
        return from_dict(cls, data)


class IncidentStore:
    """Thread-safe bounded LRU of incidents keyed by fingerprint digest."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        max_entries: int = 2048,
        ttl_s: float = 7 * 86400.0,
        compact_factor: int = 4,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.path = path
        self.max_entries = max(1, max_entries)
        self.ttl_s = ttl_s
        self.compact_factor = max(2, compact_factor)
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Incident]" = OrderedDict()
        # shared crash-safe JSONL discipline (utils/journal.py): torn-line
        # tolerant load, append+flush, temp-file+os.replace compaction.
        # Direct (caller-thread) writes: store mutations already run off
        # the event loop via asyncio.to_thread.
        self._journal = Journal(path, label="incident journal")
        if path:
            with self._lock:
                self._journal.load(self._replay_locked)
                self._journal.open()
            log.info("incident store: %d incident(s) restored from %s",
                     len(self), path)

    def _replay_locked(self, record: dict) -> None:
        op = record.get("op")
        if op == "put":
            incident = Incident.parse(record["incident"])
            if incident.fingerprint:
                self._entries[incident.fingerprint] = incident
                self._entries.move_to_end(incident.fingerprint)
        elif op == "touch":
            incident = self._entries.get(record["fp"])
            if incident is not None:
                incident.seen_count = int(record.get("seen", incident.seen_count + 1))
                incident.reused_count = int(record.get("reused", incident.reused_count))
                incident.last_seen = record.get("last_seen", incident.last_seen)
                incident.last_seen_ts = float(record.get("ts", incident.last_seen_ts))
                # pre-obs journals have no trace field; keep what we had
                incident.last_trace_id = record.get("trace", incident.last_trace_id)
                self._entries.move_to_end(record["fp"])
        elif op == "evict":
            self._entries.pop(record.get("fp", ""), None)
        else:
            raise KeyError(f"unknown journal op {op!r}")

    def _append(self, record: dict) -> None:
        self._journal.append(record)
        if self._journal.lines > self.compact_factor * max(len(self._entries), 16):
            # one ``put`` per live incident — a 500x-recurring incident
            # must not keep 500 copies of its analysis text on disk
            self._journal.compact(
                [{"op": "put", "incident": incident.to_dict()}
                 for incident in self._entries.values()]
            )

    def close(self) -> None:
        with self._lock:
            self._journal.close()

    # -- mutation ------------------------------------------------------
    def upsert(self, incident: Incident, *, bump_if_existing: bool = False) -> list[str]:
        """Insert or update (same digest keeps first_seen and merges in
        the new analysis text).  ``bump_if_existing`` counts the sighting
        when the caller had NOT already recorded it via
        :meth:`record_recurrence` — the concurrent-first-sighting race
        (two recalls miss, two inserts land) must not undercount.
        Returns the digests EVICTED to make room — the caller's cue to
        drop index rows."""
        assert incident.fingerprint, "incident requires a fingerprint"
        now = self._clock()
        with self._lock:
            existing = self._entries.get(incident.fingerprint)
            if existing is not None:
                # recurrence accounting lives on the existing record; the
                # new record only contributes fresher analysis metadata
                if bump_if_existing:
                    existing.seen_count += 1
                existing.explanation = incident.explanation or existing.explanation
                existing.provider_id = incident.provider_id or existing.provider_id
                existing.model_id = incident.model_id or existing.model_id
                existing.analyses.update(incident.analyses)  # per-ref, new wins
                existing.severity = incident.severity or existing.severity
                for digest in incident.related:
                    if digest not in existing.related:
                        existing.related.append(digest)
                existing.last_seen = incident.last_seen or now_iso()
                existing.last_seen_ts = now
                existing.last_trace_id = incident.last_trace_id or existing.last_trace_id
                incident = existing
            else:
                incident.first_seen = incident.first_seen or now_iso()
                incident.last_seen = incident.last_seen or incident.first_seen
                incident.last_seen_ts = now
                self._entries[incident.fingerprint] = incident
            self._entries.move_to_end(incident.fingerprint)
            evicted = self._evict_locked(now)
            self._append({"op": "put", "incident": incident.to_dict()})
            for digest in evicted:
                self._append({"op": "evict", "fp": digest})
            return evicted

    def record_recurrence(
        self, digest: str, *, reused: bool = False, trace_id: Optional[str] = None
    ) -> Optional[Incident]:
        """Bump the sighting counters of an exact fingerprint hit; returns
        the updated incident (None when the digest is unknown).
        ``trace_id`` stamps this sighting's flight-recorder trace onto the
        incident so the NEXT recurrence can link back to it."""
        with self._lock:
            incident = self._entries.get(digest)
            if incident is None:
                return None
            incident.seen_count += 1
            if reused:
                incident.reused_count += 1
            incident.last_seen = now_iso()
            incident.last_seen_ts = self._clock()
            if trace_id:
                incident.last_trace_id = trace_id
            self._entries.move_to_end(digest)
            record = {
                "op": "touch", "fp": digest, "seen": incident.seen_count,
                "reused": incident.reused_count, "last_seen": incident.last_seen,
                "ts": incident.last_seen_ts,
            }
            if incident.last_trace_id:
                record["trace"] = incident.last_trace_id
            self._append(record)
            return incident

    def _evict_locked(self, now: float) -> list[str]:
        evicted: list[str] = []
        if self.ttl_s > 0:
            for digest in [
                d for d, inc in self._entries.items()
                if now - inc.last_seen_ts > self.ttl_s
            ]:
                self._entries.pop(digest)
                evicted.append(digest)
        while len(self._entries) > self.max_entries:
            digest, _ = self._entries.popitem(last=False)  # LRU tail
            evicted.append(digest)
        return evicted

    def expire(self) -> list[str]:
        """TTL sweep on demand (recall consults the store lazily; callers
        with no traffic can still age incidents out)."""
        with self._lock:
            evicted = self._evict_locked(self._clock())
            for digest in evicted:
                self._append({"op": "evict", "fp": digest})
            return evicted

    # -- queries -------------------------------------------------------
    def get(self, digest: str) -> Optional[Incident]:
        with self._lock:
            return self._entries.get(digest)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def all(self, newest_first: bool = True) -> list[Incident]:
        with self._lock:
            incidents = list(self._entries.values())
        return list(reversed(incidents)) if newest_first else incidents

    def to_dicts(
        self, newest_first: bool = True, limit: Optional[int] = None
    ) -> list[dict]:
        """Serialized snapshot taken UNDER the lock — Incident objects are
        live and mutated by worker threads (upsert merging a new analyses
        key), so serializing them lock-free can raise mid-iteration.
        ``limit`` bounds how many incidents are serialized (the lock is
        held for the duration; callers paging a 2048-entry store must not
        serialize all of it for a ?limit=5 request)."""
        with self._lock:
            incidents = list(self._entries.values())
            if newest_first:
                incidents.reverse()
            if limit is not None:
                incidents = incidents[: max(0, limit)]
            return [to_dict(i) for i in incidents]

    def dump(self, digest: str) -> Optional[dict]:
        """One incident, serialized under the lock (see to_dicts)."""
        with self._lock:
            incident = self._entries.get(digest)
            return to_dict(incident) if incident is not None else None

    # -- ConfigMap snapshot -------------------------------------------
    def snapshot(self, max_bytes: int = MAX_SNAPSHOT_BYTES) -> str:
        """Newest-first JSONL of the store, truncated (whole incidents at
        a time, oldest dropped first) to fit ``max_bytes`` of UTF-8 —
        bytes because that is what the apiserver's 1 MiB object limit
        counts (non-ASCII evidence encodes at 3-4 bytes per char)."""
        lines: list[str] = []
        used = 0
        for payload in self.to_dicts(newest_first=True):  # lock-held to_dict
            line = json.dumps({"op": "put", "incident": payload}, sort_keys=True)
            cost = len(line.encode("utf-8")) + 1
            if used + cost > max_bytes:
                break
            lines.append(line)
            used += cost
        return "\n".join(lines)

    def load_snapshot(self, text: str) -> int:
        """Merge a snapshot produced by :meth:`snapshot` (e.g. read back
        from the ConfigMap after a restart without a PVC).  Existing
        entries win — the journal is fresher than any snapshot."""
        loaded = 0
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                incident = Incident.parse(json.loads(line)["incident"])
            except (ValueError, KeyError, TypeError):
                continue
            if not incident.fingerprint:
                continue
            with self._lock:
                if incident.fingerprint in self._entries:
                    continue
                self._entries[incident.fingerprint] = incident
                self._entries.move_to_end(incident.fingerprint, last=False)
                loaded += 1
        return loaded

    def digests(self) -> list[str]:
        with self._lock:
            return list(self._entries.keys())

    def iter_incidents(self) -> Iterable[Incident]:
        return self.all(newest_first=False)
