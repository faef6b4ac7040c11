"""PodFailureWatcher — the real-time hot path.

Parity with reference PodFailureWatcher.java (SURVEY.md §3.2) plus the two
scaling fixes the survey calls out:

- **indexed CR cache**: the reference LISTs every Podmortem CR per candidate
  failure (O(CRs) per event, :228-235); here an informer-style cache of
  Podmortem CRs is maintained by its own watch and consulted in-memory;
- **bounded dedupe**: the reference's ``processedFailures`` map grows without
  bound (:50,180-193); this one evicts oldest entries past a cap.

Retained behaviours: namespace allowlist (:52-79), MODIFIED-event filter
(:107), non-zero-exit detection (:147-159), failure-time keyed dedupe
(:180-193), fan-out of one pipeline per matching CR (:196-199), and
auto-restart of a closed watch after a delay (:127-135,562-583).

Beyond the reference: the pod watch is a list+watch with resourceVersion
resume (bookmarks on, 410 -> relist) — the reference's informer client does
this internally; its hand-rolled gap coverage is the poll reconciler alone.

The port's own copy of ``operator_tpu/operator/watcher.py``.
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict
from typing import Optional

from ..schema.crds import Podmortem
from ..schema.kube import ContainerStatus, Pod
from ..utils.config import OperatorConfig
from ..utils.timing import METRICS, MetricsRegistry
from .kubeapi import (
    KubeApi,
    WatchClosed,
    WatchExpired,
    iter_watch_resumed,
)
from .pipeline import AnalysisPipeline

log = logging.getLogger(__name__)


def has_pod_failed(pod: Pod) -> bool:
    """Non-zero container exit (reference :147-159), extended to catch
    CrashLoopBackOff waits whose evidence sits in lastState (a pod stuck
    waiting never shows a current terminated state)."""
    if pod.status is None:
        return False
    statuses = [*pod.status.container_statuses, *pod.status.init_container_statuses]
    for cs in statuses:
        if _terminated_nonzero(cs):
            return True
        if (
            cs.state is not None
            and cs.state.waiting is not None
            and cs.state.waiting.reason in ("CrashLoopBackOff", "ImagePullBackOff", "ErrImagePull")
        ):
            return True
    return pod.status.phase == "Failed"


def _terminated_nonzero(cs: ContainerStatus) -> bool:
    for state in (cs.state, cs.last_state):
        if state is not None and state.terminated is not None:
            exit_code = state.terminated.exit_code
            if exit_code is not None and exit_code != 0:
                return True
    return False


def get_failure_time(pod: Pod) -> Optional[str]:
    """Latest terminated.finishedAt across containers (reference :208)."""
    times = []
    if pod.status is not None:
        for cs in [*pod.status.container_statuses, *pod.status.init_container_statuses]:
            for state in (cs.state, cs.last_state):
                if state is not None and state.terminated is not None and state.terminated.finished_at:
                    times.append(state.terminated.finished_at)
    return max(times) if times else None


class PodmortemCache:
    """Informer-style cache of Podmortem CRs, kept fresh by a watch."""

    def __init__(
        self,
        api: KubeApi,
        *,
        resync_delay_s: float = 1.0,
        list_timeout_s: float = 15.0,
    ) -> None:
        self.api = api
        self.resync_delay_s = resync_delay_s
        #: budget for the prime LIST (mirrors OperatorConfig
        #: .kube_call_timeout_s; graftlint GL003): a wedged apiserver
        #: connection costs one bounded prime, retried by run()
        self.list_timeout_s = list_timeout_s
        self._items: dict[tuple[str, str], Podmortem] = {}
        self._primed = False
        self._ready = asyncio.Event()
        # resume cursor: reconnects resume from the last applied event's
        # resourceVersion so the apiserver replays the gap instead of the
        # cache re-listing every CR on every stream recycle
        self._cursor: Optional[str] = None

    async def prime(self) -> None:
        items, cursor = await asyncio.wait_for(
            self.api.list_rv("Podmortem"), timeout=self.list_timeout_s
        )
        fresh: dict[tuple[str, str], Podmortem] = {}
        for raw in items:
            try:
                pm = Podmortem.parse(raw)
            except Exception:  # noqa: BLE001 - one bad CR must not wipe the cache
                log.exception("unparseable Podmortem in list; skipping")
                continue
            fresh[(pm.metadata.namespace, pm.metadata.name)] = pm
        # swap, don't mutate in place: a re-prime after 410 must drop CRs
        # deleted inside the gap, and a failure above leaves the old cache
        self._items = fresh
        self._cursor = cursor
        self._primed = True
        self._ready.set()

    async def wait_ready(self, timeout_s: float) -> bool:
        """Best-effort wait for the first successful prime — the pod sweep
        is useless against an empty CR cache (nothing would match)."""
        try:
            await asyncio.wait_for(self._ready.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    async def run(self, stop: asyncio.Event) -> None:
        """Maintain the cache until ``stop`` is set; resyncs on watch close."""
        def set_cursor(value: Optional[str]) -> None:
            self._cursor = value

        while not stop.is_set():
            try:
                if not self._primed:
                    await self.prime()
                async for event, version in iter_watch_resumed(
                    self.api, "Podmortem", None,
                    lambda: self._cursor, set_cursor,
                ):
                    try:
                        pm = Podmortem.parse(event.object)
                    except Exception:  # noqa: BLE001 - skip malformed objects
                        log.exception("unparseable Podmortem watch event; skipping")
                        if version:
                            self._cursor = version
                        continue
                    key = (pm.metadata.namespace, pm.metadata.name)
                    if event.type == "DELETED":
                        self._items.pop(key, None)
                    else:
                        self._items[key] = pm
                    if version:
                        self._cursor = version
                    if stop.is_set():
                        return
            except asyncio.CancelledError:
                raise
            except WatchExpired:
                # only a fresh LIST restores a consistent cache (the
                # helper already cleared the cursor)
                log.warning("podmortem cache cursor expired; re-listing")
                self._primed = False
                await asyncio.sleep(self.resync_delay_s)
            except Exception:  # noqa: BLE001 - WatchClosed, ApiError from prime(), ...
                # a dead cache silently drops every failure; resume from the
                # cursor (or re-list when none survived)
                log.warning("podmortem cache interrupted; resyncing", exc_info=True)
                if self._cursor is None:
                    self._primed = False
                await asyncio.sleep(self.resync_delay_s)

    def matching(self, pod: Pod) -> list[Podmortem]:
        return [
            pm
            for pm in self._items.values()
            if pm.spec.pod_selector.matches(pod.metadata.labels)
        ]

    def all(self) -> list[Podmortem]:
        return list(self._items.values())


class PodFailureWatcher:
    def __init__(
        self,
        api: KubeApi,
        pipeline: AnalysisPipeline,
        *,
        config: Optional[OperatorConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
        cache: Optional[PodmortemCache] = None,
        max_dedupe_entries: int = 10_000,
    ) -> None:
        self.api = api
        self.pipeline = pipeline
        self.config = config or OperatorConfig()
        self.metrics = metrics or METRICS
        self.cache = cache or PodmortemCache(api)
        # claims are shared with the reconciler via pipeline.claims; this map
        # only cheap-filters repeat MODIFIED events for an already-claimed
        # failure so we don't spawn no-op tasks per kubelet status update
        self._seen: OrderedDict[str, str] = OrderedDict()
        self._max_dedupe = max_dedupe_entries
        self._tasks: set[asyncio.Task] = set()
        self.restarts = 0
        # per-namespace watch resume cursor (resourceVersion): a reconnect
        # resumes exactly where the stream dropped, replaying the gap
        # server-side — None forces the blind-window sweep + fresh list
        self._cursors: dict[Optional[str], Optional[str]] = {}

    # ------------------------------------------------------------------
    def _allowed(self, namespace: Optional[str]) -> bool:
        allow = self.config.watch_namespaces
        return not allow or (namespace in allow)

    def _seen_recently(self, pod: Pod, failure_time: str) -> bool:
        key = f"{pod.metadata.namespace}/{pod.metadata.name}"
        if self._seen.get(key) == failure_time:
            return True
        self._seen[key] = failure_time
        self._seen.move_to_end(key)
        while len(self._seen) > self._max_dedupe:
            self._seen.popitem(last=False)
        return False

    # ------------------------------------------------------------------
    async def handle_pod_event(self, event_type: str, pod: Pod) -> int:
        """Returns number of pipelines launched (for tests)."""
        if event_type not in ("MODIFIED", "ADDED"):
            return 0
        if not self._allowed(pod.metadata.namespace):
            return 0
        if not has_pod_failed(pod):
            return 0
        failure_time = get_failure_time(pod) or "unknown"
        # match BEFORE marking seen: a failure observed while the CR cache is
        # still priming must stay eligible for the next observation (sweep,
        # repeat event, or reconciler) instead of being suppressed forever
        matching = self.cache.matching(pod)
        if not matching:
            log.debug("failed pod %s matches no Podmortem CR", pod.qualified_name())
            return 0
        if self._seen_recently(pod, failure_time):
            return 0
        log.info("pod failure %s at %s -> %d podmortem(s)",
                 pod.qualified_name(), failure_time, len(matching))
        task = asyncio.create_task(
            self.pipeline.process_failure_group(pod, matching, failure_time=failure_time)
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return len(matching)

    # ------------------------------------------------------------------
    async def run(self, stop: asyncio.Event) -> None:
        """Watch loop with auto-restart (reference restartWatcher :562-583).
        Survives any exception, not just clean watch closes — a dead watch
        loop with a live process would be invisible to health probes."""
        cache_task = asyncio.create_task(self.cache.run(stop))
        if not await self.cache.wait_ready(10.0):
            log.warning("podmortem cache not primed after 10s; watching anyway")
        try:
            while not stop.is_set():
                try:
                    namespaces = self.config.watch_namespaces or [None]
                    if len(namespaces) == 1:
                        await self._watch_one(namespaces[0], stop)
                    else:
                        await self._watch_many(namespaces, stop)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 - WatchClosed, ApiError, ...
                    self.restarts += 1
                    self.metrics.incr("watch_restarts")
                    log.warning(
                        "pod watch interrupted (%s); restarting in %.1fs",
                        exc,
                        self.config.watch_restart_delay_s,
                    )
                    await asyncio.sleep(self.config.watch_restart_delay_s)
        finally:
            cache_task.cancel()
            if self._tasks:
                await asyncio.gather(*self._tasks, return_exceptions=True)

    async def _watch_many(self, namespaces: list[Optional[str]], stop: asyncio.Event) -> None:
        """Run one watch per namespace; when any fails, cancel the siblings
        before the restart so streams don't accumulate across restarts."""
        tasks = [
            asyncio.create_task(self._watch_one(ns, stop), name=f"pod-watch-{ns}")
            for ns in namespaces
        ]
        try:
            done, pending = await asyncio.wait(tasks, return_when=asyncio.FIRST_EXCEPTION)
            for task in done:
                if task.exception() is not None:
                    raise task.exception()
        finally:
            for task in tasks:
                if not task.done():
                    task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _watch_one(self, namespace: Optional[str], stop: asyncio.Event) -> None:
        # list+watch with resourceVersion resume (the informer discipline of
        # the client the reference runs on, PodFailureWatcher.java:92): with
        # a live cursor the stream resumes exactly where it dropped and the
        # apiserver REPLAYS the gap — no blind window, no sweep needed.
        # Without one (first run, or after a 410 told us the cursor was
        # compacted away) sweep current pods AND capture the list's
        # collection resourceVersion so the subsequent watch starts exactly
        # where the sweep observed; dedupe makes re-observation free
        # (reference covers the gap with its poll-path reconciler only)
        cursor = self._cursors.get(namespace)
        if cursor is None:
            try:
                # the sweep LIST is bounded (kube_call_timeout_s, GL003);
                # the watch STREAM below is deliberately not — liveness
                # comes from server-side close + resume (kubeapi.py)
                items, cursor = await asyncio.wait_for(
                    self.api.list_rv("Pod", namespace),
                    timeout=self.config.kube_call_timeout_s,
                )
                for raw in items:
                    try:
                        await self.handle_pod_event("MODIFIED", Pod.parse(raw))
                    except Exception:  # noqa: BLE001 - one bad pod shouldn't kill the sweep
                        log.exception("pre-watch sweep failed for one pod; skipping")
            except Exception:  # noqa: BLE001 - sweep is best-effort; watch still runs
                cursor = None
                log.warning("pre-watch pod sweep failed; relying on reconciler",
                            exc_info=True)
            # persist immediately: a stream that drops before delivering a
            # single event must still resume from the LIST's version, not
            # relist (the list already observed everything up to it)
            self._cursors[namespace] = cursor

        def set_cursor(value: Optional[str]) -> None:
            self._cursors[namespace] = value

        # 410 (WatchExpired) propagates with the cursor already cleared by
        # the helper, so the restart path sweeps + relists
        async for event, version in iter_watch_resumed(
            self.api, "Pod", namespace,
            lambda: self._cursors.get(namespace), set_cursor,
        ):
            try:
                pod = Pod.parse(event.object)
            except Exception:  # noqa: BLE001 - skip malformed objects
                log.exception("unparseable Pod watch event; skipping")
                if version:
                    # graftlint: disable=GL011 reason=cursor advance is single-writer (one _watch_one task per namespace key); monotonic resourceVersion overwrite is the informer discipline
                    self._cursors[namespace] = version
                continue
            await self.handle_pod_event(event.type, pod)
            # cursor advances only AFTER the handler returns: if it
            # raises, the restart resumes AT this event and the server
            # replays it (there is no per-restart sweep to catch a
            # skipped failure anymore)
            if version:
                # graftlint: disable=GL011 reason=cursor advance is single-writer (one _watch_one task per namespace key); monotonic resourceVersion overwrite is the informer discipline
                self._cursors[namespace] = version
            if stop.is_set():
                return

    async def drain(self) -> None:
        """Wait for in-flight pipelines (tests/shutdown)."""
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)

    def cancel_inflight(self) -> None:
        """Cancel in-flight pipelines — the shutdown-grace boundary
        (operator/app.py stop): a cancelled analysis RELEASES its claim in
        the ledger, so the successor's sweep/reconciler may claim the
        failure afresh instead of it being lost."""
        for task in self._tasks:
            task.cancel()
