"""Block-hash prefix KV cache for the continuous scheduler.

The port's own copy of ``operator_tpu/serving/kvstore.py``: the same
hash chain (SHA-256 over the decimal token ids, 16-byte digests), so a
prompt's block hashes are byte-identical in both packages.  The device
side of the host-RAM tier is ``ops/kv_transfer.py``.

The wave engine's registered-shared-prefix (engine.set_shared_prefix)
needs the prefix declared up front and serves only wave mode.  This
module generalizes it to *automatic* page-granular prefix caching
(vLLM-style APC) for the mixed prefill+decode program:

- A **block** is exactly one KV page of tokens (``page_size``).  Blocks
  are keyed by a rolling hash: ``h_i = sha256(h_{i-1} || tokens_i)``,
  so a block's identity pins its entire prefix — two requests share a
  block only when every token before it matches too.
- On admission the scheduler matches the request's longest cached block
  chain and maps those device pages into the row's page table
  **read-only** (refcounted); only the uncached suffix is prefilled.
  The ragged mixed program already handles arbitrary per-row q_count,
  so a hit is just a shorter prefill chunk.
- The match is capped at ``(len(tokens) - 1) // page_size`` blocks so at
  least one suffix token always prefills.  That makes the copy-on-write
  rule structural: a row's own writes (suffix prefill + generation)
  always start at ``cached_len`` — the first position of a row-owned
  page — so no row ever appends into a shared page and no copy is ever
  needed.  (A page-unaligned shared tail would require CoW; we simply
  never map one.)
- Eviction is LRU over refcount-zero blocks.  An evicted block may
  spill to the host pool (ops/kv_transfer.py) and be revived on the
  next hit — restore is one page DMA + a table write, not recompute.

KV vectors are per-token projections (W_k·x_t with absolute RoPE
positions), independent of how the prompt was chunked, so reusing a
cached page is numerically exact and greedy output stays byte-identical
cache-on vs cache-off.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence


def block_hashes(tokens: Sequence[int], page_size: int) -> list[bytes]:
    """Rolling hash chain over page-aligned token blocks.

    Returns one digest per FULL block (``len(tokens) // page_size``);
    the page-unaligned tail never gets a hash, so it can never be
    shared.  Digest i commits to tokens[0 : (i+1)*page_size].
    """
    out: list[bytes] = []
    h = b""
    for i in range(len(tokens) // page_size):
        block = tokens[i * page_size : (i + 1) * page_size]
        m = hashlib.sha256()
        m.update(h)
        m.update(b",".join(str(t).encode() for t in block))
        h = m.digest()[:16]
        out.append(h)
    return out


@dataclass
class CachedBlock:
    """One page-sized KV block owned by the store.

    ``page`` is the device page id holding the block's KV, or -1 when
    the block lives only in the host pool (evicted from device but
    restorable).  ``refs`` counts live rows currently reading the page;
    only refcount-zero device blocks are evictable.
    """

    hash: bytes
    parent: Optional[bytes]
    tokens: tuple
    page: int = -1
    refs: int = 0
    last_used: int = 0


class PrefixKVStore:
    """Refcounted page-granular prefix cache + LRU eviction policy.

    The store OWNS the device pages of its blocks (they are allocated
    from the same PageAllocator as row grants but tracked here, not in
    any row).  Rows acquire/release references; the scheduler drives
    insert (ownership transfer at prefill completion), eviction
    (``evict_lru`` when admission needs pages), and host offload.

    Threading: the scheduler mutates the store on the engine's
    single-thread decode executor, while the event loop reads it
    (``inventory``/``stats`` behind /healthz) and the fabric prefetch
    path probes/adopts into it.  Every method therefore takes one
    re-entrant lock so no reader ever iterates ``_blocks`` mid-mutation.
    The lock guards PER-METHOD invariants only — compound sequences
    (check residency, then forget; evict_lru, then mark_offloaded) stay
    correct because every MUTATING caller runs on the decode executor
    (the fabric fetcher ships its probe/adopt work there too).
    """

    def __init__(self, page_size: int, *, host_pool=None, metrics=None) -> None:
        self.page_size = page_size
        self.host_pool = host_pool  # ops/kv_transfer.HostKVPool or None
        self.metrics = metrics
        self._lock = threading.RLock()
        self._blocks: dict[bytes, CachedBlock] = {}
        #: hashes gathered off-device at eviction but not yet fetched
        #: into the host pool (the scheduler's _pending_offload holds the
        #: device buffers): restorable, just not via host_pool.get yet
        self.pending_offload: set[bytes] = set()
        self._clock = 0  # LRU tick, bumped on every match/acquire
        # cumulative lookup accounting (feeds prefixHitRate in /healthz)
        self.lookups = 0
        self.hits = 0
        self.misses = 0

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def get(self, h: bytes) -> Optional[CachedBlock]:
        with self._lock:
            return self._blocks.get(h)

    @property
    def device_pages_held(self) -> int:
        """Device pages the store currently owns (resident blocks)."""
        with self._lock:
            return sum(1 for b in self._blocks.values() if b.page >= 0)

    def restorable(self, h: bytes) -> bool:
        """An off-device block that can come back without recompute:
        pooled on host, or gathered and awaiting the offload drain."""
        with self._lock:
            if h in self.pending_offload:
                return True
        return bool(self.host_pool and self.host_pool.has(h))

    def hit_rate(self) -> Optional[float]:
        total = self.hits + self.misses
        return (self.hits / total) if total else None

    def inventory(self, limit: int = 128) -> list[str]:
        """Most-recently-used block hashes (hex), for the /healthz peer
        index — bounded so the load report stays small."""
        with self._lock:
            blocks = sorted(
                self._blocks.values(), key=lambda b: b.last_used, reverse=True
            )
            return [b.hash.hex() for b in blocks[:limit]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._blocks),
                "device_pages": self.device_pages_held,
                "host_blocks": (len(self.host_pool) if self.host_pool else 0),
                "lookups": self.lookups,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hit_rate(),
            }

    # -- matching ---------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> list[CachedBlock]:
        """Longest cached chain of full blocks prefixing ``tokens``.

        Capped at ``(len(tokens) - 1) // page_size`` blocks so at least
        one token is always left for the row to prefill (the structural
        no-CoW rule — see module docstring).  A block counts as cached
        when it is device-resident OR restorable from the host pool.
        Updates hit/miss accounting at block granularity.
        """
        with self._lock:
            self._clock += 1
            self.lookups += 1
            ps = self.page_size
            matchable = max(0, (len(tokens) - 1) // ps)
            chain: list[CachedBlock] = []
            h = b""
            for i in range(matchable):
                block = tokens[i * ps : (i + 1) * ps]
                m = hashlib.sha256()
                m.update(h)
                m.update(b",".join(str(t).encode() for t in block))
                h = m.digest()[:16]
                entry = self._blocks.get(h)
                if entry is None:
                    break
                if entry.page < 0 and not self.restorable(h):
                    # stale index entry: neither on device nor restorable
                    break
                entry.last_used = self._clock
                chain.append(entry)
            self.hits += len(chain)
            self.misses += matchable - len(chain)
        if self.metrics is not None:
            if chain:
                self.metrics.incr("kv_hit", len(chain))
            if matchable - len(chain):
                self.metrics.incr("kv_miss", matchable - len(chain))
        return chain

    def probe(self, tokens: Sequence[int]) -> list[tuple[bytes, bool]]:
        """Pure residency probe over the matchable prefix — ``(hash,
        resident)`` per full block, no accounting, no LRU bump.

        The fabric prefetch path uses this to find which prefix blocks
        are worth fetching from a peer before admission runs the real
        ``match``.  ``resident`` means the block would count as cached:
        device-resident or restorable from the host side.
        """
        ps = self.page_size
        matchable = max(0, (len(tokens) - 1) // ps)
        out: list[tuple[bytes, bool]] = []
        with self._lock:
            for h in block_hashes(tokens[: matchable * ps], ps):
                entry = self._blocks.get(h)
                resident = entry is not None and (
                    entry.page >= 0 or self.restorable(h)
                )
                out.append((h, resident))
        return out

    # -- refcounts --------------------------------------------------------

    def acquire(self, blocks: Sequence[CachedBlock]) -> None:
        with self._lock:
            self._clock += 1
            for b in blocks:
                b.refs += 1
                b.last_used = self._clock

    def release(self, hashes: Sequence[bytes]) -> None:
        with self._lock:
            for h in hashes:
                entry = self._blocks.get(h)
                if entry is not None and entry.refs > 0:
                    entry.refs -= 1

    # -- insert / evict ---------------------------------------------------

    def insert(
        self,
        h: bytes,
        parent: Optional[bytes],
        tokens: Sequence[int],
        page: int,
        *,
        refs: int = 0,
    ) -> CachedBlock:
        """Register a block, transferring ownership of ``page`` to the
        store.  If the block already exists without a device page (host
        resident after eviction), the page is adopted — a free revival.
        """
        with self._lock:
            self._clock += 1
            entry = self._blocks.get(h)
            if entry is not None:
                if entry.page < 0 and page >= 0:
                    entry.page = page
                    entry.refs += refs
                    entry.last_used = self._clock
                    return entry
                # caller keeps its duplicate page; store already has one
                raise ValueError("block already device-resident")
            entry = CachedBlock(
                hash=h,
                parent=parent,
                tokens=tuple(tokens),
                page=page,
                refs=refs,
                last_used=self._clock,
            )
            self._blocks[h] = entry
            return entry

    def adopt_host(
        self, h: bytes, parent: Optional[bytes], tokens: Sequence[int]
    ) -> CachedBlock:
        """Register a host-pool-resident block fetched over the fabric.

        Unlike :meth:`insert` there is no device page to transfer — the
        entry lands restorable (``page = -1``) and the ordinary one-DMA
        restore path revives it when a match acquires it.  Idempotent:
        an existing entry (any residency) is returned untouched.
        """
        with self._lock:
            entry = self._blocks.get(h)
            if entry is not None:
                return entry
            self._clock += 1
            entry = CachedBlock(
                hash=h,
                parent=parent,
                tokens=tuple(tokens),
                page=-1,
                refs=0,
                last_used=self._clock,
            )
            self._blocks[h] = entry
            return entry

    def evictable(self) -> list[CachedBlock]:
        """Device-resident refcount-zero blocks, LRU first."""
        with self._lock:
            out = [
                b for b in self._blocks.values()
                if b.refs == 0 and b.page >= 0
            ]
        out.sort(key=lambda b: b.last_used)
        return out

    def evict_lru(self, count: int) -> list[CachedBlock]:
        """Pick up to ``count`` LRU refcount-zero device blocks for
        eviction.  Pure selection — the CALLER must, per block, gather
        the page's KV for host offload (or decide not to), return the
        page to the allocator, then call ``mark_offloaded`` (host copy
        exists/will exist) or ``forget`` (block is gone for good)."""
        victims = self.evictable()[:count]
        if victims and self.metrics is not None:
            self.metrics.incr("kv_evict", len(victims))
        return victims

    def mark_offloaded(self, h: bytes) -> None:
        """Block left the device but survives in the host pool: keep the
        index entry restorable (page = -1)."""
        with self._lock:
            entry = self._blocks.get(h)
            if entry is not None:
                entry.page = -1

    def forget(self, h: bytes) -> None:
        """Drop a block from the index entirely (evicted with no host
        copy — it can never be restored, so a match must miss)."""
        with self._lock:
            self._blocks.pop(h, None)

    def reset(self) -> None:
        """Device reset: every device page is gone (the generator
        rebuilds its allocator), but host-pool copies survive and their
        index entries stay restorable."""
        with self._lock:
            self.pending_offload.clear()  # gathered device buffers died
            for h in list(self._blocks):
                b = self._blocks[h]
                b.page = -1
                b.refs = 0
                if not (self.host_pool and self.host_pool.has(h)):
                    del self._blocks[h]
