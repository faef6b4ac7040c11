"""Bounded-concurrency KV page fetch client: the port's copy of
``operator_tpu/fabric/fetch.py``.

The admission-time flow: a replica whose prefix match misses locally
asks the fabric index who holds the missing blocks and pulls the pages
from a holder's host pool over ``GET /kv/blocks/{hash}`` instead of
recomputing them.  Two invariants shape everything here:

- **A failed fetch must never be slower than the recompute it
  replaced.**  Every fetch runs under ``min(kv_fabric_fetch_timeout_s,
  residual request budget)``; timeout, miss, corruption, or a dead
  holder all degrade to the ordinary recompute path — the request never
  sees a fabric error.
- **Adoption is prefix-contiguous.**  The prefix matcher walks blocks
  in order, so a fetched block behind a gap is unmatchable; prefetch
  adopts the longest contiguous run of fetched blocks and drops the
  rest on the floor (they were cheap host tensors, not device pages).

Fetch outcomes feed back into the index: a 404 from a supposed holder
evicts that (replica, block) entry immediately, and timeouts/transport
errors decay it after ``FabricIndex.failure_threshold`` consecutive
failures (a black-holed peer can never 404 — see index.py).
"""

from __future__ import annotations

import asyncio
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from ..utils.timing import METRICS
from .index import FabricIndex
from .wire import CorruptBlock, decode_block

#: slack added to the asyncio.wait_for guard over the threaded HTTP GET:
#: the socket timeout is authoritative, the wait_for only covers thread
#: scheduling delay so a wedged executor cannot outlive the budget
_THREAD_SLACK_S = 0.25


def _is_timeout(exc: BaseException) -> bool:
    if isinstance(exc, (asyncio.TimeoutError, TimeoutError)):
        return True
    if isinstance(exc, urllib.error.URLError):
        return isinstance(exc.reason, TimeoutError)
    return False


class FabricFetcher:
    """Pulls missing prefix blocks from fleet holders into the local
    host pool, bounded in concurrency and clamped in time."""

    def __init__(
        self,
        index: FabricIndex,
        *,
        api_token: Optional[str] = None,
        timeout_s: float = 2.0,
        concurrency: int = 4,
        self_id: str = "",
        metrics=None,
        fault_plan=None,
        transport=None,
        clock=None,
    ) -> None:
        self.index = index
        self.api_token = api_token
        self.timeout_s = float(timeout_s)
        self.self_id = self_id
        self.metrics = metrics if metrics is not None else METRICS
        self.fault_plan = fault_plan
        #: injectable transport for tests (None = real HTTP GET)
        self._transport = transport
        self._clock = clock if clock is not None else time.monotonic
        self._sem = asyncio.Semaphore(max(1, int(concurrency)))

    # -- transport ------------------------------------------------------
    async def _http_get(self, url: str, budget_s: float) -> tuple[int, bytes]:
        def fetch() -> tuple[int, bytes]:
            req = urllib.request.Request(url, method="GET")
            if self.api_token:
                req.add_header("Authorization", f"Bearer {self.api_token}")
            try:
                with urllib.request.urlopen(req, timeout=budget_s) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as exc:
                return exc.code, b""

        return await asyncio.wait_for(
            asyncio.to_thread(fetch), timeout=budget_s + _THREAD_SLACK_S
        )

    def _note_failure(self, rid: str, block_hash: str) -> None:
        """Feed a non-404 fetch failure into the index's consecutive-
        failure decay; counts the eviction when the threshold tripped."""
        if self.index.note_failure(rid, block_hash):
            self.metrics.incr("fabric_index_decayed", exemplar=rid)

    # -- one block ------------------------------------------------------
    async def fetch_block(self, block_hash: str, *, budget_s: Optional[float] = None):
        """Fetch one block from any current holder.

        Returns ``(k, v)`` host arrays or ``None`` — every failure mode
        (no holder, exhausted budget, timeout, 404, corruption) is a
        ``None``, and the caller recomputes.
        """
        budget = (
            self.timeout_s
            if budget_s is None
            else min(self.timeout_s, float(budget_s))
        )
        if budget <= 0:
            self.metrics.incr("fabric_fetch_fallback", exemplar=block_hash)
            return None
        holders = [
            (rid, url)
            for rid, url in self.index.holder_urls(block_hash)
            if rid != self.self_id
        ]
        if not holders:
            self.metrics.incr("fabric_fetch_fallback", exemplar=block_hash)
            return None
        deadline = self._clock() + budget
        async with self._sem:
            for rid, url in holders:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                if self.fault_plan is not None:
                    try:
                        await self.fault_plan.apply_async(
                            "fabric.fetch", replica=rid, block=block_hash
                        )
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:
                        if _is_timeout(exc):
                            self.metrics.incr(
                                "fabric_fetch_timeout", exemplar=rid
                            )
                        else:
                            self.metrics.incr(
                                "fabric_fetch_error", exemplar=rid
                            )
                        self._note_failure(rid, block_hash)
                        continue
                block_url = f"{url.rstrip('/')}/kv/blocks/{block_hash}"
                try:
                    if self._transport is not None:
                        status, data = await self._transport(
                            block_url, remaining
                        )
                    else:
                        status, data = await self._http_get(
                            block_url, remaining
                        )
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    if _is_timeout(exc):
                        self.metrics.incr("fabric_fetch_timeout", exemplar=rid)
                    else:
                        self.metrics.incr("fabric_fetch_error", exemplar=rid)
                    self._note_failure(rid, block_hash)
                    continue
                if status == 404:
                    if self.index.evict(rid, block_hash):
                        self.metrics.incr("fabric_index_evicted", exemplar=rid)
                    self.metrics.incr("fabric_fetch_miss", exemplar=rid)
                    continue
                if status != 200:
                    self.metrics.incr("fabric_fetch_error", exemplar=rid)
                    self._note_failure(rid, block_hash)
                    continue
                try:
                    got_hash, k, v = decode_block(data)
                except CorruptBlock:
                    self.metrics.incr("fabric_fetch_corrupt", exemplar=rid)
                    self._note_failure(rid, block_hash)
                    continue
                if got_hash.hex() != block_hash:
                    self.metrics.incr("fabric_fetch_corrupt", exemplar=rid)
                    self._note_failure(rid, block_hash)
                    continue
                self.index.note_success(rid, block_hash)
                self.metrics.incr("fabric_fetch_ok", exemplar=rid)
                return k, v
        self.metrics.incr("fabric_fetch_fallback", exemplar=block_hash)
        return None

    # -- the admission-time entry point ---------------------------------
    async def prefetch(
        self,
        tokens: Sequence[int],
        *,
        store,
        budget_s: Optional[float] = None,
        executor=None,
    ) -> int:
        """Pull the prompt's missing prefix blocks into the local host
        pool so the ordinary one-DMA restore path turns the fabric hit
        into a prefix-cache hit.

        Returns the number of blocks adopted.  Requires the store to
        carry a non-empty host pool (``kv_host_pool_mb > 0``) — without
        one there is nowhere to land a page without touching device
        memory off the commit window.

        ``executor`` is the engine's worker (``ServingEngine``'s
        ``store_executor``: the thread that steps the scheduler, which
        runs each call at a step boundary holding the worker's lock):
        when given, the store probe and the adoption loop run THERE, so
        every store mutation serializes with enqueue/step and the
        check-then-forget in adoption is atomic w.r.t. a concurrent
        restore flipping the block back to device residency.  None
        (tests, in-process harnesses with no worker) runs them inline.
        """
        pool = getattr(store, "host_pool", None)
        if pool is None or getattr(pool, "capacity_bytes", 0) <= 0:
            return 0
        if executor is not None:
            probe = await asyncio.get_running_loop().run_in_executor(
                executor, store.probe, tokens
            )
        else:
            probe = store.probe(tokens)
        wanted = [
            (i, block_hash)
            for i, (block_hash, resident) in enumerate(probe)
            if not resident and self.index.holders(block_hash.hex())
        ]
        if not wanted:
            return 0
        results = await asyncio.gather(
            *(self.fetch_block(h.hex(), budget_s=budget_s) for _, h in wanted)
        )
        fetched = {
            i: page for (i, _h), page in zip(wanted, results) if page is not None
        }

        def adopt() -> int:
            page_size = store.page_size
            adopted = 0
            parent: Optional[bytes] = None
            for i, (block_hash, resident) in enumerate(probe):
                if resident:
                    parent = block_hash
                    continue
                page = fetched.get(i)
                if page is None:
                    break  # gap: later blocks are unmatchable, stop here
                k, v = page
                dropped = pool.put(block_hash, k, v)
                if dropped is None:
                    break  # pool refused (disabled or page > pool)
                for old in dropped:
                    entry = store.get(old)
                    if entry is not None and entry.page < 0:
                        store.forget(old)
                store.adopt_host(
                    block_hash, parent,
                    tokens[i * page_size:(i + 1) * page_size],
                )
                adopted += 1
                parent = block_hash
            return adopted

        if executor is not None:
            adopted = await asyncio.get_running_loop().run_in_executor(
                executor, adopt
            )
        else:
            adopted = adopt()
        if adopted:
            self.metrics.incr("fabric_prefetch_adopted", adopted)
        return adopted
