"""Kubernetes API abstraction + in-memory fake apiserver.

The port's own copy of ``operator_tpu/operator/kubeapi.py``.  The control
plane talks to this interface only; production uses the HTTP client
(``httpapi.py``), tests and the demo use :class:`FakeKubeApi` — the
fabric8-mock-server role the reference's test strategy called for.

The fake reproduces the apiserver behaviours the operator's correctness
depends on:

- **optimistic concurrency**: a patch carrying a stale ``resourceVersion``
  fails with 409, exactly what AnalysisStorageService's retry discipline is
  built against (reference AnalysisStorageService.java:179-187);
- **watch streams** per kind/namespace with ADDED/MODIFIED/DELETED events and
  server-side close (so watcher auto-restart logic is testable —
  reference PodFailureWatcher.java:127-135);
- **label-selector list filtering** (reference PodmortemReconciler.java:105-111);
- **error injection hooks** for 409 storms, 403s, and transient faults —
  filterable by kind, so chaos tests can partition the leader away from its
  ``coordination.k8s.io/Lease`` (operator/lease.py) while the rest of its
  API traffic flows (Lease CRUD itself rides the generic kind-keyed store:
  create/get/patch with resourceVersion guards behave exactly like the real
  apiserver's optimistic concurrency, which is what leader takeover races
  are decided by).
"""

from __future__ import annotations

import asyncio
import copy
import logging
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

from ..schema.meta import LabelSelector, now_iso

log = logging.getLogger(__name__)


class ApiError(Exception):
    status = 500

    def __init__(self, message: str, status: Optional[int] = None) -> None:
        super().__init__(message)
        if status is not None:
            self.status = status


class NotFoundError(ApiError):
    status = 404


class ConflictError(ApiError):
    status = 409


class ForbiddenError(ApiError):
    status = 403


class WatchClosed(Exception):
    """The server closed the watch stream; callers should re-establish
    (the reference restarts its watch 5s after an error close —
    PodFailureWatcher.java:562-583)."""


class WatchExpired(WatchClosed):
    """The resume resourceVersion is too old (HTTP 410 Gone / ERROR event
    with code 410): the apiserver has compacted past it.  Callers must
    relist (re-sweep) and watch from the fresh list's resourceVersion —
    resuming from the stale cursor would silently drop events."""


@dataclass
class WatchEvent:
    #: ADDED | MODIFIED | DELETED | BOOKMARK — bookmarks carry only
    #: metadata.resourceVersion (cursor refresh); consumers MUST skip them
    #: before parsing (a bookmark parsed as a CR is a phantom object whose
    #: empty selector matches everything)
    type: str
    object: dict[str, Any]


# --------------------------------------------------------------------------
# interface
# --------------------------------------------------------------------------


class KubeApi:
    """Async Kubernetes API surface used by the control plane.  All objects
    are plain camelCase dicts (parse into schema types at the edges)."""

    async def get(self, kind: str, name: str, namespace: str) -> dict:
        raise NotImplementedError

    async def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> list[dict]:
        raise NotImplementedError

    async def list_rv(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> tuple[list[dict], Optional[str]]:
        """List plus the collection's resourceVersion — the resume cursor
        a subsequent watch() starts from so nothing between the list and
        the watch is missed.  None when the backend can't provide one
        (callers then watch from "now" and rely on sweeps)."""
        return await self.list(kind, namespace, label_selector), None

    async def create(self, kind: str, obj: dict) -> dict:
        raise NotImplementedError

    async def patch(
        self,
        kind: str,
        name: str,
        namespace: str,
        patch: dict,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        raise NotImplementedError

    async def patch_status(
        self,
        kind: str,
        name: str,
        namespace: str,
        status: dict,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        raise NotImplementedError

    async def delete(self, kind: str, name: str, namespace: str) -> None:
        raise NotImplementedError

    async def get_scale(self, kind: str, name: str, namespace: str) -> dict:
        """Read the ``scale`` subresource (autoscaling/v1 Scale dict) of a
        scalable object — ``spec.replicas`` is the desired count, an RBAC
        grant on ``deployments/scale`` alone suffices (the autoscaler
        never needs the full Deployment)."""
        raise NotImplementedError

    async def patch_scale(
        self,
        kind: str,
        name: str,
        namespace: str,
        replicas: int,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        """Set ``spec.replicas`` through the ``scale`` subresource.  With
        ``resource_version`` the write is guarded by the same optimistic
        concurrency as :meth:`patch` (409 on mismatch)."""
        raise NotImplementedError

    async def get_log(
        self,
        name: str,
        namespace: str,
        *,
        container: Optional[str] = None,
        previous: bool = False,
        tail_bytes: Optional[int] = None,
    ) -> str:
        raise NotImplementedError

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        resource_version: Optional[str] = None,
    ) -> AsyncIterator[WatchEvent]:
        """Stream events.  With ``resource_version`` the stream RESUMES
        from that point (events after it are replayed), raising
        :class:`WatchExpired` when the server compacted past it.  BOOKMARK
        events surface to the caller (cursor refresh), everything else is
        ADDED/MODIFIED/DELETED."""
        raise NotImplementedError


# --------------------------------------------------------------------------
# fake implementation
# --------------------------------------------------------------------------


def _deep_merge(base: dict, patch: dict) -> dict:
    """JSON-merge-patch semantics: dicts merge recursively, ``None`` deletes,
    everything else (lists included) replaces."""
    out = dict(base)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        elif isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


@dataclass
class _WatchRegistration:
    kind: str
    namespace: Optional[str]
    queue: asyncio.Queue = field(default_factory=asyncio.Queue)


async def iter_watch_resumed(
    api: KubeApi,
    kind: str,
    namespace: Optional[str],
    get_cursor: Callable[[], Optional[str]],
    set_cursor: Callable[[Optional[str]], None],
) -> AsyncIterator[tuple[WatchEvent, Optional[str]]]:
    """The shared resumable-watch discipline for every watch consumer.

    Opens ``api.watch`` at the current cursor and yields
    ``(event, resourceVersion)`` pairs for non-BOOKMARK events.  Bookmarks
    refresh the cursor silently; a 410 (WatchExpired) CLEARS the cursor —
    so the caller's restart path re-lists — before propagating.  The
    caller applies the event and then advances the cursor itself (advance
    must follow a successful apply: on an apply failure the restart
    resumes AT the unapplied event and the server replays it).
    """
    try:
        # graftlint: disable=GL003 reason=watch streams are deliberately unbounded; liveness comes from server-side close + the resume discipline, not a deadline
        async for event in api.watch(
            kind, namespace, resource_version=get_cursor()
        ):
            version = (event.object.get("metadata") or {}).get(
                "resourceVersion"
            )
            if event.type == "BOOKMARK":
                # cursor-refresh only: its object is bare metadata that
                # would parse into a phantom object downstream
                if version:
                    set_cursor(version)
                continue
            yield event, version
    except WatchExpired:
        # compacted past the cursor: resuming would silently drop events
        set_cursor(None)
        raise


#: error-injection hook: (op, kind, name) -> Exception to raise, or None
ErrorHook = Callable[[str, str, str], Optional[Exception]]


class FakeKubeApi(KubeApi):
    #: watch-history ring size per kind: events older than this are
    #: compacted away and a resume from before them gets 410 (WatchExpired),
    #: the real apiserver's etcd-compaction behavior
    WATCH_HISTORY = 1024

    def __init__(self) -> None:
        self._objects: dict[str, dict[tuple[str, str], dict]] = {}
        self._logs: dict[tuple[str, str, bool], str] = {}
        self._rv = 0
        self._watches: list[_WatchRegistration] = []
        # per-kind replay buffer [(rv_at_event, event)] + highest rv ever
        # compacted out of it (0 = full history retained)
        self._history: dict[str, list[tuple[int, WatchEvent]]] = {}
        self._trimmed_through: dict[str, int] = {}
        self.error_hooks: list[ErrorHook] = []
        #: opt-in chaos seam (utils/faultinject.py FaultPlan): consulted on
        #: every API op ("kube.<op>"), at watch-stream open
        #: ("kube.watch_open.<kind>") and per delivered watch event
        #: ("kube.watch.<kind>") — declarative 409 storms, 410 relists and
        #: disconnect storms that replay deterministically
        self.fault_plan = None

    # --- error injection --------------------------------------------------
    def inject_errors(
        self,
        op: str,
        error_factory: Callable[[], Exception],
        times: int = 1,
        *,
        kind: Optional[str] = None,
    ) -> None:
        """Raise ``error_factory()`` for the next ``times`` calls of ``op``
        (op is 'get'/'list'/'create'/'patch'/'patch_status'/'delete'/
        'get_log'/'get_scale'/'patch_scale').  ``kind`` narrows the fault
        to one object kind — e.g. partitioning a leader away from its
        Lease (``kind="Lease"``) without touching its Pod/Podmortem
        traffic (tests/test_leader.py), or partitioning the autoscaler
        away from the Deployment scale subresource mid-scale-up
        (``kind="Deployment"``, tests/test_chaos.py)."""
        remaining = {"n": times}

        def hook(actual_op: str, actual_kind: str, name: str) -> Optional[Exception]:
            if kind is not None and actual_kind != kind:
                return None
            if actual_op == op and remaining["n"] > 0:
                remaining["n"] -= 1
                return error_factory()
            return None

        self.error_hooks.append(hook)

    def inject_conflicts(self, times: int, op: str = "patch_status") -> None:
        self.inject_errors(op, lambda: ConflictError("the object has been modified"), times)

    async def _check_hooks(self, op: str, kind: str, name: str) -> None:
        for hook in self.error_hooks:
            exc = hook(op, kind, name)
            if exc is not None:
                raise exc
        if self.fault_plan is not None:
            # apply_async: a delay/jitter action holds the op without
            # blocking the loop (latency-shaped apiserver)
            await self.fault_plan.apply_async(f"kube.{op}", kind=kind, name=name)

    # --- store helpers ----------------------------------------------------
    def _bucket(self, kind: str) -> dict[tuple[str, str], dict]:
        return self._objects.setdefault(kind, {})

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _notify(self, event_type: str, kind: str, obj: dict) -> None:
        namespace = obj.get("metadata", {}).get("namespace")
        event = WatchEvent(event_type, copy.deepcopy(obj))
        history = self._history.setdefault(kind, [])
        history.append((self._rv, event))
        if len(history) > self.WATCH_HISTORY:
            trimmed_rv, _ = history.pop(0)
            self._trimmed_through[kind] = max(
                self._trimmed_through.get(kind, 0), trimmed_rv
            )
        for registration in list(self._watches):
            if registration.kind != kind:
                continue
            if registration.namespace is not None and registration.namespace != namespace:
                continue
            registration.queue.put_nowait(
                WatchEvent(event_type, copy.deepcopy(obj))
            )

    # --- KubeApi ----------------------------------------------------------
    async def get(self, kind: str, name: str, namespace: str) -> dict:
        await self._check_hooks("get", kind, name)
        obj = self._bucket(kind).get((namespace, name))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        return copy.deepcopy(obj)

    async def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> list[dict]:
        await self._check_hooks("list", kind, "*")
        out = []
        for (ns, _), obj in sorted(self._bucket(kind).items()):
            if namespace is not None and ns != namespace:
                continue
            if label_selector is not None and not label_selector.matches(
                obj.get("metadata", {}).get("labels") or {}
            ):
                continue
            out.append(copy.deepcopy(obj))
        return out

    async def create(self, kind: str, obj: dict) -> dict:
        meta = obj.setdefault("metadata", {})
        name, namespace = meta.get("name"), meta.get("namespace")
        if not name or not namespace:
            raise ApiError(f"{kind} requires metadata.name and metadata.namespace", 422)
        await self._check_hooks("create", kind, name)
        bucket = self._bucket(kind)
        if (namespace, name) in bucket:
            raise ConflictError(f"{kind} {namespace}/{name} already exists")
        stored = copy.deepcopy(obj)
        stored["metadata"].setdefault("uid", str(uuid.uuid4()))
        stored["metadata"].setdefault("creationTimestamp", now_iso())
        stored["metadata"]["resourceVersion"] = self._next_rv()
        bucket[(namespace, name)] = stored
        self._notify("ADDED", kind, stored)
        return copy.deepcopy(stored)

    async def _patch_impl(
        self,
        op: str,
        kind: str,
        name: str,
        namespace: str,
        patch: dict,
        resource_version: Optional[str],
    ) -> dict:
        await self._check_hooks(op, kind, name)
        bucket = self._bucket(kind)
        current = bucket.get((namespace, name))
        if current is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        if resource_version is not None and current["metadata"].get("resourceVersion") != resource_version:
            raise ConflictError(
                f"Operation cannot be fulfilled on {kind} {namespace}/{name}: "
                f"the object has been modified"
            )
        merged = _deep_merge(current, patch)
        merged["metadata"]["resourceVersion"] = self._next_rv()
        bucket[(namespace, name)] = merged
        self._notify("MODIFIED", kind, merged)
        return copy.deepcopy(merged)

    async def patch(
        self,
        kind: str,
        name: str,
        namespace: str,
        patch: dict,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        return await self._patch_impl("patch", kind, name, namespace, patch, resource_version)

    async def patch_status(
        self,
        kind: str,
        name: str,
        namespace: str,
        status: dict,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        return await self._patch_impl(
            "patch_status", kind, name, namespace, {"status": status}, resource_version
        )

    async def delete(self, kind: str, name: str, namespace: str) -> None:
        await self._check_hooks("delete", kind, name)
        bucket = self._bucket(kind)
        obj = bucket.pop((namespace, name), None)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        # deletion is a store write: it gets its own resourceVersion (so a
        # watch resume strictly after the previous event still replays it)
        obj["metadata"]["resourceVersion"] = self._next_rv()
        self._notify("DELETED", kind, obj)

    # --- scale subresource ------------------------------------------------
    async def get_scale(self, kind: str, name: str, namespace: str) -> dict:
        await self._check_hooks("get_scale", kind, name)
        obj = self._bucket(kind).get((namespace, name))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        spec_replicas = (obj.get("spec") or {}).get("replicas")
        return {
            "apiVersion": "autoscaling/v1",
            "kind": "Scale",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "resourceVersion": obj["metadata"].get("resourceVersion"),
            },
            "spec": {"replicas": int(spec_replicas or 0)},
            "status": {
                "replicas": int(
                    (obj.get("status") or {}).get("replicas")
                    or spec_replicas
                    or 0
                ),
            },
        }

    async def patch_scale(
        self,
        kind: str,
        name: str,
        namespace: str,
        replicas: int,
        *,
        resource_version: Optional[str] = None,
    ) -> dict:
        await self._check_hooks("patch_scale", kind, name)
        bucket = self._bucket(kind)
        current = bucket.get((namespace, name))
        if current is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        if (
            resource_version is not None
            and current["metadata"].get("resourceVersion") != resource_version
        ):
            raise ConflictError(
                f"Operation cannot be fulfilled on {kind} "
                f"{namespace}/{name}: the object has been modified"
            )
        merged = _deep_merge(current, {"spec": {"replicas": int(replicas)}})
        merged["metadata"]["resourceVersion"] = self._next_rv()
        bucket[(namespace, name)] = merged
        # a scale write IS a Deployment modification: watchers of the kind
        # see it exactly as they would from the real apiserver
        self._notify("MODIFIED", kind, merged)
        return {
            "apiVersion": "autoscaling/v1",
            "kind": "Scale",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "resourceVersion": merged["metadata"]["resourceVersion"],
            },
            "spec": {"replicas": int(replicas)},
            "status": {"replicas": int(replicas)},
        }

    # --- pod logs ---------------------------------------------------------
    def set_pod_log(self, namespace: str, name: str, text: str, *, previous: bool = False) -> None:
        self._logs[(namespace, name, previous)] = text

    async def get_log(
        self,
        name: str,
        namespace: str,
        *,
        container: Optional[str] = None,
        previous: bool = False,
        tail_bytes: Optional[int] = None,
    ) -> str:
        await self._check_hooks("get_log", "Pod", name)
        text = self._logs.get((namespace, name, previous))
        if text is None and previous:
            text = self._logs.get((namespace, name, False))
        if text is None:
            if (namespace, name) not in self._bucket("Pod"):
                raise NotFoundError(f"Pod {namespace}/{name} not found")
            return ""
        if tail_bytes is not None and len(text) > tail_bytes:
            text = text[-tail_bytes:]
        return text

    # --- watch ------------------------------------------------------------
    async def watch(  # type: ignore[override]
        self,
        kind: str,
        namespace: Optional[str] = None,
        resource_version: Optional[str] = None,
    ) -> AsyncIterator[WatchEvent]:
        if self.fault_plan is not None:
            # stream-open faults: inject a 410 on a resume attempt
            # (WatchExpired forces the consumer's relist path) or refuse the
            # connection (WatchClosed) before any replay happens
            await self.fault_plan.apply_async(
                f"kube.watch_open.{kind}", resource_version=resource_version
            )
        replayed: list[WatchEvent] = []
        if resource_version is not None:
            since = int(resource_version)
            if since < self._trimmed_through.get(kind, 0):
                raise WatchExpired(
                    f"resourceVersion {resource_version} for {kind} is too "
                    f"old (compacted through "
                    f"{self._trimmed_through.get(kind, 0)})"
                )
            for rv, event in self._history.get(kind, []):
                if rv <= since:
                    continue
                obj_ns = event.object.get("metadata", {}).get("namespace")
                if namespace is not None and obj_ns != namespace:
                    continue
                replayed.append(
                    WatchEvent(event.type, copy.deepcopy(event.object))
                )
        # snapshot-then-register runs with no await in between, so no event
        # can land in both the replay list and the live queue
        registration = _WatchRegistration(kind=kind, namespace=namespace)
        self._watches.append(registration)
        try:
            for event in replayed:
                if self.fault_plan is not None:
                    # per-event faults ("drop the stream after N events"):
                    # WatchClosed/WatchExpired here reaches the consumer
                    # exactly as a server-side stream death would
                    await self.fault_plan.apply_async(f"kube.watch.{kind}", event=event.type)
                yield event
            while True:
                event = await registration.queue.get()
                if isinstance(event, Exception):
                    raise WatchClosed(str(event)) from event
                if self.fault_plan is not None:
                    await self.fault_plan.apply_async(f"kube.watch.{kind}", event=event.type)
                yield event
        finally:
            if registration in self._watches:
                self._watches.remove(registration)

    def close_watches(self, error: str = "server closed the watch") -> int:
        """Simulate the apiserver dropping all watch streams."""
        closed = 0
        for registration in list(self._watches):
            registration.queue.put_nowait(RuntimeError(error))
            closed += 1
        return closed

    def bookmark_watches(self, kind: Optional[str] = None) -> int:
        """Deliver a BOOKMARK event (current resourceVersion, no object
        payload) to open watches — the apiserver's periodic cursor
        refresh when allowWatchBookmarks is on."""
        sent = 0
        for registration in list(self._watches):
            if kind is not None and registration.kind != kind:
                continue
            registration.queue.put_nowait(WatchEvent(
                "BOOKMARK",
                {
                    "kind": registration.kind,
                    "metadata": {"resourceVersion": str(self._rv)},
                },
            ))
            sent += 1
        return sent

    def compact_watch_history(self, kind: str) -> None:
        """Drop the retained event history for ``kind`` — a subsequent
        resume from any pre-compaction resourceVersion gets 410
        (WatchExpired), the etcd-compaction path."""
        self._history[kind] = []
        self._trimmed_through[kind] = self._rv

    async def list_rv(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[LabelSelector] = None,
    ) -> tuple[list[dict], Optional[str]]:
        return await self.list(kind, namespace, label_selector), str(self._rv)

    # --- typed convenience (tests) ---------------------------------------
    async def create_obj(self, obj: Any) -> dict:
        return await self.create(obj.kind, obj.to_dict())
