"""Lease-based leader election — HA for the control plane.

The port's own copy of ``operator_tpu/operator/lease.py``: host code, the same names and
behaviour.

A ``coordination.k8s.io/v1 Lease`` object is the shared lock: the replica
whose identity is in ``spec.holderIdentity`` — and whose ``spec.renewTime``
is fresher than ``spec.leaseDurationSeconds`` ago — is the leader.  Only
the leader runs the watcher, reconcilers, pattern sync, and the analysis
pipeline; standbys keep their health server (and engine warmup) hot and
poll the lease so takeover is a re-list away (client-go's
``leaderelection`` discipline, sized down to the calls this control plane
actually needs).

Semantics:

- **acquire**: create the Lease if missing; otherwise take over only when
  the current holder's renewTime has EXPIRED (or the lease is unheld /
  already ours), guarded by resourceVersion so two standbys racing the
  same takeover produce exactly one winner (409 loses);
- **renew**: the leader re-stamps renewTime every ``renew_period_s``
  (jittered so a fleet of operators doesn't synchronize its apiserver
  load).  A renewal observing a DIFFERENT holder steps down immediately;
  renewals failing past ``renew_deadline_s`` (client-go's renewDeadline,
  default 2/3 of the lease duration) step down too — strictly before the
  lease can expire, so the step-down completes while a standby is still
  fenced out; two concurrent "leaders" is the one state this module
  exists to prevent;
- **graceful release**: on shutdown the leader blanks holderIdentity so
  the standby acquires on its next retry tick instead of waiting out the
  full lease duration.

Every apiserver call is bounded by ``kube_timeout_s`` at the call
(graftlint GL003) — a wedged apiserver costs one bounded tick, never the
renew loop.  Clock and jitter rng are injectable so chaos tests replay
deterministically (tests/test_leader.py).
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import random
from typing import Callable, Optional

from ..schema.kube import Lease, LeaseSpec
from ..schema.meta import ObjectMeta
from ..schema.serde import to_dict as _serde_to_dict
from ..utils.timing import METRICS, MetricsRegistry
from .kubeapi import ApiError, ConflictError, KubeApi, NotFoundError

log = logging.getLogger(__name__)

LEASE_KIND = "Lease"


def _iso_micro(epoch: float) -> str:
    """RFC3339 MicroTime, the Lease wire format for acquire/renew times."""
    return (
        datetime.datetime.fromtimestamp(epoch, datetime.timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


def parse_micro(stamp: Optional[str]) -> Optional[float]:
    """Epoch seconds from an RFC3339(Micro) stamp; None on junk — an
    unparseable renewTime counts as expired (fail open to takeover, the
    alternative is a permanently wedged lease)."""
    if not stamp:
        return None
    try:
        return datetime.datetime.fromisoformat(
            stamp.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return None


class LeaseElector:
    """Acquire/renew/release loop over one Lease object."""

    def __init__(
        self,
        api: KubeApi,
        *,
        lease_name: str,
        namespace: str,
        identity: str,
        duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        retry_period_s: float = 2.0,
        renew_deadline_s: Optional[float] = None,
        kube_timeout_s: float = 15.0,
        metrics: Optional[MetricsRegistry] = None,
        wall_clock: Optional[Callable[[], float]] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        import time

        self.api = api
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity
        self.duration_s = max(1.0, duration_s)
        self.renew_period_s = max(0.01, renew_period_s)
        self.retry_period_s = max(0.01, retry_period_s)
        # client-go's renewDeadline discipline: the leader must stop
        # renewing (and step down) strictly BEFORE the lease can expire
        # under it, so the step-down completes while the stale lease still
        # fences the standby out.  Without this, a renew RPC wedged in a
        # partitioned apiserver for kube_timeout_s could keep the control
        # loops running seconds after a standby legitimately took over.
        self.renew_deadline_s = min(
            renew_deadline_s if renew_deadline_s is not None
            else 2.0 * self.duration_s / 3.0,
            self.duration_s,
        )
        self.kube_timeout_s = kube_timeout_s
        self.metrics = metrics or METRICS
        self._wall = wall_clock or time.time
        self._rng = rng or random.Random()
        self._leading = asyncio.Event()
        self._not_leading = asyncio.Event()
        self._not_leading.set()
        self._last_renew: Optional[float] = None
        #: leadership transitions observed by THIS elector (tests)
        self.elections = 0

    # -- observers -------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    async def wait_leading(self, stop: asyncio.Event) -> bool:
        """Block until this replica leads (True) or ``stop`` is set."""
        return await self._wait(self._leading, stop)

    async def wait_not_leading(self, stop: asyncio.Event) -> bool:
        """Block until leadership is LOST (True) or ``stop`` is set."""
        return await self._wait(self._not_leading, stop)

    @staticmethod
    async def _wait(event: asyncio.Event, stop: asyncio.Event) -> bool:
        waiters = [
            asyncio.create_task(event.wait()),
            asyncio.create_task(stop.wait()),
        ]
        try:
            await asyncio.wait(waiters, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for task in waiters:
                task.cancel()
            await asyncio.gather(*waiters, return_exceptions=True)
        return event.is_set()

    # -- state flips ------------------------------------------------------
    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading.is_set():
            self.elections += 1
            self.metrics.incr("leader_elected")
            log.info("leader election: %s acquired lease %s/%s",
                     self.identity, self.namespace, self.lease_name)
            self._leading.set()
            self._not_leading.clear()
        elif not leading and self._leading.is_set():
            self.metrics.incr("leader_lost")
            log.warning("leader election: %s lost lease %s/%s",
                        self.identity, self.namespace, self.lease_name)
            self._leading.clear()
            self._not_leading.set()

    def _jittered(self, period: float) -> float:
        """±20% so a fleet of operators doesn't synchronize its apiserver
        load (and a post-failure retry isn't guaranteed to land late)."""
        return period * (1.0 + 0.2 * (2.0 * self._rng.random() - 1.0))

    # -- main loop --------------------------------------------------------
    async def run(self, stop: asyncio.Event) -> None:
        """Contend for the lease until ``stop``; on exit, release if held."""
        try:
            while not stop.is_set():
                if await self._try_acquire():
                    self._set_leading(True)
                    self._last_renew = self._wall()
                    await self._renew_until_lost(stop)
                    self._set_leading(False)
                if stop.is_set():
                    return
                await self._sleep(self._jittered(self.retry_period_s), stop)
        finally:
            self._set_leading(False)

    async def _renew_until_lost(self, stop: asyncio.Event) -> None:
        period = self.renew_period_s
        while not stop.is_set():
            await self._sleep(self._jittered(period), stop)
            if stop.is_set():
                return
            # bound the attempt by the REMAINING renew deadline, not just
            # kube_timeout_s: an RPC blocked past the deadline must not
            # delay the step-down below it
            budget = self.renew_deadline_s
            if self._last_renew is not None:
                budget = (self._last_renew + self.renew_deadline_s) - self._wall()
            renewed: Optional[bool] = None
            if budget > 0:
                try:
                    renewed = await asyncio.wait_for(self._renew(), timeout=budget)
                except asyncio.TimeoutError:
                    self.metrics.incr("leader_renew_errors")
            now = self._wall()
            if renewed:
                self._last_renew = now
                period = self.renew_period_s
                continue
            if renewed is False:
                # positively lost: another holder observed on the lease
                return
            # transient apiserver failure (None): keep trying while OUR
            # last successful renewal is within the renew deadline — past
            # that the lease may expire mid-attempt and a standby
            # legitimately acquire it, so step down first
            if self._last_renew is None or now - self._last_renew >= self.renew_deadline_s:
                log.warning(
                    "leader election: renewals failing for >%.0fs; stepping down",
                    self.renew_deadline_s,
                )
                return
            # retry at the FASTER retry cadence (client-go's retryPeriod):
            # at the renew cadence, a single blip would usually exhaust the
            # remaining deadline before the next attempt and depose a
            # leader whose lease was still perfectly valid
            period = self.retry_period_s

    @staticmethod
    async def _sleep(seconds: float, stop: asyncio.Event) -> None:
        try:
            await asyncio.wait_for(stop.wait(), timeout=seconds)
        except asyncio.TimeoutError:
            pass

    # -- lease CRUD --------------------------------------------------------
    def _lease_body(self, *, transitions: int, acquire_time: Optional[str]) -> dict:
        spec = LeaseSpec(
            holder_identity=self.identity,
            lease_duration_seconds=int(self.duration_s),
            renew_time=_iso_micro(self._wall()),
            lease_transitions=transitions,
            acquire_time=acquire_time,
        )
        return _serde_to_dict(spec)

    async def _try_acquire(self) -> bool:
        """One acquisition attempt; False on held-by-live-leader, races,
        and apiserver failures (the run loop retries)."""
        try:
            raw = await asyncio.wait_for(
                self.api.get(LEASE_KIND, self.lease_name, self.namespace),
                timeout=self.kube_timeout_s,
            )
        except NotFoundError:
            return await self._create_lease()
        except (ApiError, asyncio.TimeoutError):
            self.metrics.incr("leader_renew_errors")
            return False
        spec = raw.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        renew = parse_micro(spec.get("renewTime"))
        fresh = renew is not None and (self._wall() - renew) < self.duration_s
        if holder and holder != self.identity and fresh:
            return False  # a live leader holds it
        transitions = int(spec.get("leaseTransitions") or 0)
        if holder != self.identity:
            transitions += 1
        patch = {"spec": self._lease_body(
            transitions=transitions, acquire_time=_iso_micro(self._wall())
        )}
        try:
            await asyncio.wait_for(
                self.api.patch(
                    LEASE_KIND, self.lease_name, self.namespace, patch,
                    resource_version=(raw.get("metadata") or {}).get("resourceVersion"),
                ),
                timeout=self.kube_timeout_s,
            )
        except ConflictError:
            return False  # another standby won the takeover race
        except NotFoundError:
            return await self._create_lease()
        except (ApiError, asyncio.TimeoutError):
            self.metrics.incr("leader_renew_errors")
            return False
        return True

    async def _create_lease(self) -> bool:
        body = Lease(
            metadata=ObjectMeta(name=self.lease_name, namespace=self.namespace),
        ).to_dict()
        body["spec"] = self._lease_body(
            transitions=0, acquire_time=_iso_micro(self._wall())
        )
        try:
            await asyncio.wait_for(
                self.api.create(LEASE_KIND, body), timeout=self.kube_timeout_s
            )
        except ConflictError:
            return False  # another replica created it first
        except (ApiError, asyncio.TimeoutError):
            self.metrics.incr("leader_renew_errors")
            return False
        return True

    async def _renew(self) -> Optional[bool]:
        """One renewal tick: True = renewed, False = positively lost (a
        different holder is on the lease), None = transient failure."""
        try:
            raw = await asyncio.wait_for(
                self.api.get(LEASE_KIND, self.lease_name, self.namespace),
                timeout=self.kube_timeout_s,
            )
        except NotFoundError:
            # someone deleted the lease out from under us: re-create on the
            # acquire path rather than silently leading lease-less
            return False
        except (ApiError, asyncio.TimeoutError):
            self.metrics.incr("leader_renew_errors")
            return None
        spec = raw.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        if holder and holder != self.identity:
            return False
        try:
            await asyncio.wait_for(
                self.api.patch(
                    LEASE_KIND, self.lease_name, self.namespace,
                    {"spec": {
                        "holderIdentity": self.identity,
                        "renewTime": _iso_micro(self._wall()),
                    }},
                    resource_version=(raw.get("metadata") or {}).get("resourceVersion"),
                ),
                timeout=self.kube_timeout_s,
            )
        except ConflictError:
            return None  # racing write; next tick re-reads
        except NotFoundError:
            return False
        except (ApiError, asyncio.TimeoutError):
            self.metrics.incr("leader_renew_errors")
            return None
        return True

    async def release(self) -> None:
        """Graceful hand-off: blank holderIdentity so the standby's next
        retry tick acquires immediately instead of waiting out the lease
        duration.  Best-effort and bounded — shutdown must complete.  No
        local is-leader gate: the run loop has usually already stepped down
        by the time shutdown calls this, so the authority on whether there
        is anything to release is the lease's own holder field."""
        self._set_leading(False)
        try:
            raw = await asyncio.wait_for(
                self.api.get(LEASE_KIND, self.lease_name, self.namespace),
                timeout=self.kube_timeout_s,
            )
            if ((raw.get("spec") or {}).get("holderIdentity") or "") != self.identity:
                return  # already taken over; nothing to release
            await asyncio.wait_for(
                self.api.patch(
                    LEASE_KIND, self.lease_name, self.namespace,
                    {"spec": {"holderIdentity": "", "renewTime": None}},
                    resource_version=(raw.get("metadata") or {}).get("resourceVersion"),
                ),
                timeout=self.kube_timeout_s,
            )
            log.info("leader election: released lease %s/%s",
                     self.namespace, self.lease_name)
        except (ApiError, asyncio.TimeoutError):
            log.warning("lease release failed; standby will wait out the "
                        "lease duration", exc_info=True)
