"""Consistent-hash ring — stable affinity placement across replica churn.

The port's own copy of ``operator_tpu/router/ring.py``: the same sha256
points, so every preference order equals the JAX ring's.

The router's placement goal (docs/ROBUSTNESS.md "Multi-replica data
plane") is cache locality: requests sharing a prompt prefix or an
incident fingerprint should land on the SAME replica, so its prefix
cache, ``ResponseCache`` and incident-recall cache actually hit — and
that mapping must survive replica churn.  A modulo over the replica list
remaps nearly every key when one replica joins or dies; a consistent
ring remaps only the keys the changed replica owned (~1/N of the space),
which is exactly the AIBrix-style property the scale-out item asks for
(PAPERS.md: arxiv 2504.03648).

Implementation: each replica contributes ``vnodes`` points on a 2^64
ring (sha256 over ``"<id>#<i>"``), a key hashes to a point, and
ownership walks clockwise.  :meth:`preference` returns the full distinct
walk order — the failover/shed candidates in affinity order — so callers
apply health gating and load feedback WITHOUT consulting the ring twice.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Optional

__all__ = ["HashRing"]


def _point(basis: str) -> int:
    return int.from_bytes(hashlib.sha256(basis.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing with virtual nodes; not thread-safe on its own
    (the owning router serializes mutation under its lock)."""

    def __init__(self, replica_ids: Optional[Iterable[str]] = None, *,
                 vnodes: int = 64) -> None:
        self.vnodes = max(1, vnodes)
        self._points: list[int] = []       # sorted ring positions
        self._owner: dict[int, str] = {}   # position -> replica id
        self._ids: set[str] = set()
        for replica_id in replica_ids or ():
            self.add(replica_id)

    def add(self, replica_id: str) -> None:
        if replica_id in self._ids:
            return
        self._ids.add(replica_id)
        for i in range(self.vnodes):
            point = _point(f"{replica_id}#{i}")
            # sha collisions across 8-byte points are ~impossible at fleet
            # scale; first owner keeps a contested point (deterministic)
            if point in self._owner:
                continue
            self._owner[point] = replica_id
            bisect.insort(self._points, point)

    def remove(self, replica_id: str) -> None:
        if replica_id not in self._ids:
            return
        self._ids.discard(replica_id)
        dead = [p for p, owner in self._owner.items() if owner == replica_id]
        for point in dead:
            del self._owner[point]
        dead_set = set(dead)
        self._points = [p for p in self._points if p not in dead_set]

    def replicas(self) -> list[str]:
        return sorted(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def owner(self, key: str) -> Optional[str]:
        """The replica owning ``key`` (None on an empty ring)."""
        order = self.preference(key, limit=1)
        return order[0] if order else None

    def preference(self, key: str, *, limit: Optional[int] = None) -> list[str]:
        """Distinct replica ids in clockwise walk order from ``key``'s
        ring position — element 0 is the affinity owner, the rest are the
        failover order.  ``limit`` stops the walk early."""
        if not self._points:
            return []
        want = limit if limit is not None else len(self._ids)
        start = bisect.bisect(self._points, _point(key))
        seen: list[str] = []
        for i in range(len(self._points)):
            owner = self._owner[self._points[(start + i) % len(self._points)]]
            if owner not in seen:
                seen.append(owner)
                if len(seen) >= want:
                    break
        return seen
