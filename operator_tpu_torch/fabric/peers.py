"""Peer inventory poller: feeds a replica-local fabric index.

The port's own copy of ``operator_tpu/fabric/peers.py``.  In-process
fleets (loadgen storms, ``chip_smoke.py``, tests) can point a replica's
:class:`~.fetch.FabricFetcher` straight at the
router's ``health.kv_index``, which the router's own ``/healthz`` polls
keep fresh.  A **standalone** replica (``python -m
operator_tpu_torch.serving``, the k8s serving Deployment) has no router in
its process — without a feeder its private index stays empty forever
and every "fabric" fetch is a silent no-op that still pays the probe.

``KV_FABRIC_PEERS`` closes that loop: a comma-separated list of peer
base URLs this poller GETs ``/healthz`` from (auth-exempt, the same
endpoint the router polls), feeding each answer's ``replica`` id and
``load.kvBlocks`` inventory into the index with the router's exact
replace-on-report freshness.  A hostname entry is DNS-expanded every
round, so the single headless-Service name
(``http://podmortem-serving:8000``) covers the whole fleet as pods come
and go — no k8s API access, no static peer list to maintain.

Freshness mirrors :class:`~..router.health.HealthBoard`:

- replace-on-report — a block the peer stopped advertising is gone the
  moment its next answer lands;
- a peer that fails to answer a round (or drops out of DNS) is removed
  from the index that same round — a dead peer is never offered as a
  holder, and the fetch path's 404 feedback covers the gap in between.

The poller itself never touches the engine or the store: it is pure
index plumbing on the event loop, started by
:meth:`~..serving.engine.ServingEngine.start_fabric` and cancelled
on engine close.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Sequence

from ..utils.timing import METRICS
from .index import FabricIndex

log = logging.getLogger(__name__)

__all__ = ["PeerPoller"]


class PeerPoller:
    """Poll peer ``/healthz`` inventories into a :class:`FabricIndex`."""

    def __init__(
        self,
        index: FabricIndex,
        *,
        peers: Sequence[str],
        self_id: str = "",
        poll_s: float = 5.0,
        timeout_s: float = 2.0,
        metrics=None,
        transport=None,
        resolver=None,
    ) -> None:
        self.index = index
        #: base URLs, each possibly a DNS name expanding to many pods
        self.peers = [u.rstrip("/") for u in peers if u.strip()]
        self.self_id = self_id
        self.poll_s = float(poll_s)
        self.timeout_s = float(timeout_s)
        self.metrics = metrics if metrics is not None else METRICS
        #: injectable ``async (url, timeout_s) -> (status, bytes)`` for
        #: tests (None = real HTTP GET on a thread)
        self._transport = transport
        #: injectable ``(host, port) -> list[(host, port)]`` for tests
        #: (None = socket.getaddrinfo)
        self._resolver = resolver
        #: replica ids fed last round — the staleness diff: anything
        #: here that the current round did not re-observe is removed
        self._last_seen: set[str] = set()

    # -- transport ------------------------------------------------------
    async def _http_get(self, url: str) -> tuple[int, bytes]:
        def fetch() -> tuple[int, bytes]:
            req = urllib.request.Request(url, method="GET")
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as exc:
                return exc.code, b""

        return await asyncio.wait_for(
            asyncio.to_thread(fetch), timeout=self.timeout_s + 0.25
        )

    def _resolve(self, host: str, port: int) -> list[tuple[str, int]]:
        if self._resolver is not None:
            return list(self._resolver(host, port))
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
        seen: list[tuple[str, int]] = []
        for _family, _type, _proto, _canon, addr in infos:
            pair = (str(addr[0]), int(addr[1]))
            if pair not in seen:
                seen.append(pair)
        return seen

    async def _expand(self) -> list[str]:
        """Every pollable base URL this round: each peer entry's host is
        DNS-expanded (bounded by the poll timeout) so a headless-Service
        name yields one URL per ready pod."""
        urls: list[str] = []
        loop = asyncio.get_running_loop()
        for base in self.peers:
            parsed = urllib.parse.urlsplit(base)
            host = parsed.hostname or ""
            port = parsed.port or (443 if parsed.scheme == "https" else 80)
            try:
                addrs = await asyncio.wait_for(
                    loop.run_in_executor(None, self._resolve, host, port),
                    timeout=self.timeout_s,
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                self.metrics.incr("fabric_peer_resolve_error", exemplar=host)
                continue
            for addr_host, addr_port in addrs:
                netloc_host = (
                    f"[{addr_host}]" if ":" in addr_host else addr_host
                )
                urls.append(f"{parsed.scheme}://{netloc_host}:{addr_port}")
        return urls

    # -- one round ------------------------------------------------------
    async def poll_once(self) -> int:
        """Poll every resolved peer once; returns replicas indexed.

        The staleness diff runs against the whole round: a replica fed
        in an earlier round that no resolved URL answered for this round
        is removed from the index (dead pod, DNS departure, or an
        unreachable peer — all the same verdict: not a holder).
        """
        seen: set[str] = set()
        for url in await self._expand():
            try:
                if self._transport is not None:
                    status, data = await self._transport(
                        f"{url}/healthz", self.timeout_s
                    )
                else:
                    status, data = await self._http_get(f"{url}/healthz")
            except asyncio.CancelledError:
                raise
            except Exception:
                self.metrics.incr("fabric_peer_poll_error", exemplar=url)
                continue
            if status != 200:
                self.metrics.incr("fabric_peer_poll_error", exemplar=url)
                continue
            try:
                body = json.loads(data.decode("utf-8"))
                rid = str(body.get("replica") or "")
                load = body.get("load") or {}
                raw_blocks = load.get("kvBlocks")
            except (ValueError, AttributeError):
                self.metrics.incr("fabric_peer_poll_error", exemplar=url)
                continue
            if not rid or rid == self.self_id:
                continue  # never index ourselves as a fetch target
            blocks = (
                [str(h) for h in raw_blocks]
                if isinstance(raw_blocks, list) else None
            )
            self.index.update(rid, blocks, url=url)
            seen.add(rid)
            self.metrics.incr("fabric_peer_poll_ok", exemplar=rid)
        for rid in self._last_seen - seen:
            self.index.remove(rid)
            self.metrics.incr("fabric_peer_removed", exemplar=rid)
        self._last_seen = seen
        return len(seen)

    # -- the loop -------------------------------------------------------
    async def run(self) -> None:
        """Poll forever at ``poll_s``; cancelled by engine close.  A
        failed round logs and keeps going — the index just ages via the
        fetch path's 404 feedback until polling recovers."""
        while True:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - polling must outlive any one bad round
                log.debug("fabric peer poll round failed; retrying",
                          exc_info=True)
            await asyncio.sleep(self.poll_s)
