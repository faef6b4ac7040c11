"""Fabric block index: which replica holds which KV blocks.

The port's own copy of ``operator_tpu/fabric/index.py``; the router's
health board keeps it.  The rest of the fabric (the wire, the fetch
client, disaggregation) is ROADMAP.md Queue 1 item 5b.

This promotes the router's passive ``HealthBoard.holders()`` scan into a
first-class index with two freshness mechanisms the scan could not
express:

- **Replace-on-report (staleness tombstones).**  Each health poll
  replaces a replica's advertised set wholesale, so a holder that
  stopped advertising a block is dropped the moment its next report
  lands — not after some TTL.  A replica that leaves the ring (or whose
  breaker opens) is removed outright, taking its whole inventory with
  it before the next poll round trips.
- **Fetch-outcome feedback.**  A 404 from a supposed holder evicts that
  single (replica, block) entry immediately; the rest of the replica's
  inventory stays matchable until its next report.  Timeouts and
  transport errors are softer evidence — a black-holed peer never
  answers at all, so it can never 404 — and decay the entry instead:
  ``failure_threshold`` CONSECUTIVE failures against one (replica,
  block) pair evict it just like a 404 would, so a dead-but-still-
  listed holder stops winning the kv-hint re-rank.  Any success, or a
  fresh health report from the replica, resets its counters.

The index is plain in-process state fed by the router's health poll —
no clock, no background task.  Entries carry the replica's URL so the
fetch client can hit ``GET /kv/blocks/{hash}`` without a second lookup.
Block hashes are the 32-hex digest strings from the ``/healthz``
``kvBlocks`` inventory (see serving/kvstore.py ``block_hashes``).
"""

from __future__ import annotations

from typing import Iterable, Optional


class FabricIndex:
    """replica_id -> (advertised block set, base URL)."""

    def __init__(self, *, failure_threshold: int = 3) -> None:
        self._blocks: dict[str, frozenset[str]] = {}
        self._urls: dict[str, str] = {}
        #: consecutive non-404 fetch failures per (replica, block) pair
        self._failures: dict[tuple[str, str], int] = {}
        #: consecutive failures before a (replica, block) entry decays
        self.failure_threshold = max(1, int(failure_threshold))
        #: fetch-feedback evictions since construction (stats only)
        self.evictions = 0

    def update(
        self, replica_id: str, blocks: Optional[Iterable[str]], *, url: str = ""
    ) -> None:
        """Replace ``replica_id``'s advertised set (staleness tombstone:
        anything it stopped advertising is gone as of this call).  A
        fresh report is fresh evidence the replica is alive, so its
        failure counters reset too."""
        self._blocks[replica_id] = frozenset(blocks or ())
        if url:
            self._urls[replica_id] = url
        self._clear_failures(replica_id)

    def remove(self, replica_id: str) -> None:
        """Drop the replica and its whole inventory (ring leave, breaker
        open, scale-down)."""
        self._blocks.pop(replica_id, None)
        self._urls.pop(replica_id, None)
        self._clear_failures(replica_id)

    def evict(self, replica_id: str, block_hash: str) -> bool:
        """Fetch-outcome feedback: the holder 404'd this block.  Returns
        True when an entry was actually dropped."""
        held = self._blocks.get(replica_id)
        if held is None or block_hash not in held:
            return False
        self._blocks[replica_id] = held - {block_hash}
        self._failures.pop((replica_id, block_hash), None)
        self.evictions += 1
        return True

    def note_failure(self, replica_id: str, block_hash: str) -> bool:
        """Fetch-outcome feedback for timeouts/transport errors: decay
        the (replica, block) entry after ``failure_threshold``
        CONSECUTIVE failures (a black-holed peer never 404s, so without
        this it would stay advertised forever).  Returns True when the
        entry was evicted by this failure."""
        held = self._blocks.get(replica_id)
        if held is None or block_hash not in held:
            return False
        key = (replica_id, block_hash)
        count = self._failures.get(key, 0) + 1
        if count >= self.failure_threshold:
            self._failures.pop(key, None)
            self._blocks[replica_id] = held - {block_hash}
            self.evictions += 1
            return True
        self._failures[key] = count
        return False

    def note_success(self, replica_id: str, block_hash: str) -> None:
        """A successful fetch resets the pair's consecutive-failure
        count (decay needs CONSECUTIVE evidence, not lifetime totals)."""
        self._failures.pop((replica_id, block_hash), None)

    def _clear_failures(self, replica_id: str) -> None:
        for key in [k for k in self._failures if k[0] == replica_id]:
            del self._failures[key]

    def empty(self) -> bool:
        """True when no replica currently advertises any block — the
        cheap pre-tokenize gate for the admission-time prefetch (an
        unfed index must cost a request nothing, not a re-tokenize)."""
        return not any(self._blocks.values())

    def holders(self, block_hash: str) -> list[str]:
        """Replica ids currently advertising ``block_hash``, sorted for
        deterministic fetch ordering."""
        return sorted(
            rid for rid, held in self._blocks.items() if block_hash in held
        )

    def holder_urls(self, block_hash: str) -> list[tuple[str, str]]:
        """``(replica_id, url)`` pairs for holders with a known URL."""
        return [
            (rid, self._urls[rid])
            for rid in self.holders(block_hash)
            if self._urls.get(rid)
        ]

    def blocks(self, replica_id: str) -> frozenset[str]:
        return self._blocks.get(replica_id, frozenset())

    def replicas(self) -> list[str]:
        return sorted(self._blocks)

    def stats(self) -> dict:
        return {
            "replicas": len(self._blocks),
            "entries": sum(len(held) for held in self._blocks.values()),
            "evictions": self.evictions,
            "decaying": len(self._failures),
        }
