"""Endpoint-watch fleet membership (docs/SCALING.md).

The port's own copy of ``operator_tpu/router/discovery.py``: host code, the same names and
behaviour.

The serving fleet stops being a static URL list: :class:`EndpointDiscovery`
lists + watches the headless serving Service's ``Endpoints`` object and
mutates an :class:`~operator_tpu_torch.router.EngineRouter`'s consistent-hash
ring live —

- a pod that turns Ready appears in ``subsets[].addresses`` and JOINS:
  optionally pre-warmed first (an async health probe that also primes the
  replica's load/KV view) so it never takes traffic before it can serve;
- a pod that dies or goes NotReady disappears and LEAVES: the ring drops
  its vnodes (only ~1/N of keys remap — consistent hashing), and any
  in-flight request on it drains through the router's existing
  breaker/failover path;
- the watch resumes from the list's ``resourceVersion`` via the shared
  :func:`~operator_tpu_torch.operator.kubeapi.iter_watch_resumed` discipline —
  a 410 compaction triggers a relist, a plain close resumes at the
  cursor, and every apiserver call outside the watch stream itself is
  bounded by ``kube_timeout_s`` (graftlint GL003).

Membership changes emit ``podmortem_ring_member_added_total`` /
``podmortem_ring_member_removed_total`` / ``podmortem_ring_resize_total``
(from the router itself, so storm-harness membership counts too).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Optional

from ..operator.kubeapi import KubeApi, WatchExpired, iter_watch_resumed
from .core import EngineRouter, Replica

log = logging.getLogger(__name__)

__all__ = ["EndpointDiscovery", "endpoint_urls"]


def endpoint_urls(
    obj: dict, *, scheme: str = "http", port_name: str = "http"
) -> dict[str, str]:
    """READY replica URLs from a raw Endpoints dict: ``{replica_id: url}``.

    Each subset contributes its ready ``addresses`` crossed with ONE port —
    the one named ``port_name``, else the subset's first port (a
    single-port serving Service needs no name).  NotReady addresses are
    deliberately excluded: the kubelet's readiness gate is the first
    admission filter, the pre-warm probe the second.  The replica id IS
    the URL, so the consistent-hash ring keys on a stable identity that
    survives operator restarts.
    """
    urls: dict[str, str] = {}
    for subset in obj.get("subsets") or []:
        ports = subset.get("ports") or []
        port = None
        for p in ports:
            if p.get("name") == port_name:
                port = p.get("port")
                break
        if port is None and ports:
            port = ports[0].get("port")
        if port is None:
            continue
        for addr in subset.get("addresses") or []:
            ip = addr.get("ip")
            if not ip:
                continue
            host = f"[{ip}]" if ":" in ip else ip
            url = f"{scheme}://{host}:{port}"
            urls[url] = url
    return urls


class EndpointDiscovery:
    """Drive one router's membership from one Service's Endpoints."""

    def __init__(
        self,
        api: KubeApi,
        router: EngineRouter,
        *,
        service: str,
        namespace: str = "default",
        scheme: str = "http",
        port_name: str = "http",
        kube_timeout_s: float = 15.0,
        restart_delay_s: float = 5.0,
        prewarm: Optional[Callable[[Replica], Awaitable[bool]]] = None,
    ) -> None:
        self.api = api
        self.router = router
        self.service = service
        self.namespace = namespace
        self.scheme = scheme
        self.port_name = port_name
        #: budget for each relist (graftlint GL003; mirrors
        #: OperatorConfig.kube_call_timeout_s)
        self.kube_timeout_s = kube_timeout_s
        self.restart_delay_s = restart_delay_s
        #: async gate a joining replica must pass before ring insertion
        #: (providers.OpenAICompatProvider.prewarm_replica: a /healthz
        #: probe whose load report also primes the health board); a False
        #: or raising pre-warm SKIPS the join — the next Endpoints event
        #: or relist retries it
        self.prewarm = prewarm
        #: replica ids this loop added (never remove members someone else
        #: placed in the router, e.g. a static seed set)
        self._managed: set[str] = set()
        self._cursor: Optional[str] = None
        self._synced = asyncio.Event()

    # -- introspection -------------------------------------------------
    def members(self) -> list[str]:
        return sorted(self._managed)

    async def wait_synced(self, timeout_s: float) -> bool:
        """Best-effort wait for the first successful list+sync."""
        try:
            await asyncio.wait_for(self._synced.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    # -- sync ----------------------------------------------------------
    async def _sync(self, obj: Optional[dict]) -> None:
        """Reconcile the router against one Endpoints snapshot (None =
        the object is gone: drain every managed member)."""
        urls = (
            endpoint_urls(obj, scheme=self.scheme, port_name=self.port_name)
            if obj is not None
            else {}
        )
        desired = set(urls)
        for replica_id in sorted(self._managed - desired):
            self._managed.discard(replica_id)
            self.router.remove(replica_id)
            log.info("discovery: %s left the serving fleet (drained via "
                     "breaker/failover)", replica_id)
        for replica_id in sorted(desired - self._managed):
            replica = Replica(id=replica_id, url=urls[replica_id])
            if self.prewarm is not None:
                try:
                    ready = await self.prewarm(replica)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 - a bad probe just defers the join
                    log.warning("discovery: pre-warm probe for %s failed "
                                "(%s); join deferred", replica_id, exc)
                    continue
                if not ready:
                    log.info("discovery: %s not ready yet; join deferred",
                             replica_id)
                    continue
                if replica_id in self._managed:
                    # revalidate after the probe await: a concurrent sync
                    # (watch event racing the relist) already admitted it —
                    # adding again would double-register with the router
                    continue
            self._managed.add(replica_id)
            self.router.add(replica)
            log.info("discovery: %s joined the serving fleet (pre-warmed, "
                     "~1/N keys remap)", replica_id)

    def _is_ours(self, raw: dict) -> bool:
        meta = raw.get("metadata") or {}
        return (
            meta.get("name") == self.service
            and meta.get("namespace") == self.namespace
        )

    async def _relist(self) -> None:
        items, cursor = await asyncio.wait_for(
            self.api.list_rv("Endpoints", self.namespace),
            timeout=self.kube_timeout_s,
        )
        ours = next((raw for raw in items if self._is_ours(raw)), None)
        await self._sync(ours)
        self._cursor = cursor
        self._synced.set()

    # -- loop ----------------------------------------------------------
    async def run(self, stop: asyncio.Event) -> None:
        """Maintain membership until ``stop``: list, then watch-resumed;
        relist on 410, resume (or relist when the cursor died with the
        stream) on any other interruption."""
        def set_cursor(value: Optional[str]) -> None:
            self._cursor = value

        primed = False
        while not stop.is_set():
            try:
                if not primed or self._cursor is None:
                    await self._relist()
                    primed = True
                async for event, version in iter_watch_resumed(
                    self.api, "Endpoints", self.namespace,
                    lambda: self._cursor, set_cursor,
                ):
                    if self._is_ours(event.object):
                        await self._sync(
                            None if event.type == "DELETED" else event.object
                        )
                    if version:
                        # graftlint: disable=GL011 reason=cursor advance is single-writer (one run() task per discovery); monotonic resourceVersion overwrite is the informer discipline
                        self._cursor = version
                    if stop.is_set():
                        return
            except asyncio.CancelledError:
                raise
            except WatchExpired:
                # the helper already cleared the cursor; only a fresh
                # LIST restores a consistent membership view
                log.warning("discovery: Endpoints cursor expired; re-listing")
                primed = False
                await _interruptible_sleep(stop, self.restart_delay_s)
            except Exception:  # noqa: BLE001 - WatchClosed, ApiError from relist, ...
                log.warning("discovery: membership watch interrupted; "
                            "resyncing", exc_info=True)
                await _interruptible_sleep(stop, self.restart_delay_s)


async def _interruptible_sleep(stop: asyncio.Event, delay_s: float) -> None:
    try:
        await asyncio.wait_for(stop.wait(), timeout=delay_s)
    except asyncio.TimeoutError:
        pass
