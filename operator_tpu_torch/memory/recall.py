"""Recall policy — what incident memory does to the analysis hot path.

Three outcomes per analyzed failure (operator/pipeline.py consults this
between the pattern parse and the AI leg):

- **hit** — the exact fingerprint is stored with a reusable analysis: the
  pipeline reuses it verbatim and skips the AI leg entirely.  A recurring
  fleet-wide failure turns from a multi-second decode on the card into a
  store lookup, and the analysis's unused deadline budget is returned.
- **near** — no exact hit, but stored incidents score above the embedder's
  similarity threshold: the top-k priors are injected into the prompt as
  retrieval-augmented context (serving/prompts.py) and linked on the new
  incident.
- **miss** — full analysis; the result is inserted afterwards.

Counters: ``podmortem_recall_{hit,near,miss}_total`` on ``/metrics``.

The port's own copy of ``operator_tpu/memory/recall.py``.  The index
scores on its device (``IncidentIndex``: the best-window similarity
kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from ..patterns.semantic import Embedder, HashingEmbedder
from ..schema.analysis import AIResponse, AnalysisResult
from ..schema.kube import Pod
from ..schema.meta import now_iso
from .fingerprint import FailureFingerprint, failure_fingerprint
from .index import IncidentIndex
from .store import CachedAnalysis, Incident, IncidentStore

log = logging.getLogger(__name__)

RECALL_HIT = "hit"
RECALL_NEAR = "near"
RECALL_MISS = "miss"

#: ConfigMap data key holding the snapshot JSONL
CONFIGMAP_KEY = "incidents"


@dataclass
class RecallDecision:
    kind: str  # RECALL_HIT | RECALL_NEAR | RECALL_MISS
    fingerprint: FailureFingerprint
    #: the stored incident for this exact fingerprint (post recurrence
    #: bump) — present on hit, and on near/miss when the class was seen
    #: before without a reusable analysis
    incident: Optional[Incident] = None
    #: on hit: the recalling CR's OWN cached analysis (per provider ref)
    analysis: Optional[CachedAnalysis] = None
    #: (prior incident, similarity score) pairs for prompt injection,
    #: best first — non-empty only on near
    neighbors: list[tuple[Incident, float]] = field(default_factory=list)
    #: flight-recorder trace id of the PREVIOUS sighting's analysis
    #: (captured before this sighting overwrote it) — how a recurrence
    #: links back to its prior timeline (docs/OBSERVABILITY.md)
    prior_trace_id: Optional[str] = None


class IncidentMemory:
    """Fingerprint + store + index composed behind the pipeline's API."""

    def __init__(
        self,
        store: Optional[IncidentStore] = None,
        index: Optional[IncidentIndex] = None,
        embedder: Optional[Embedder] = None,
        *,
        near_threshold: Optional[float] = None,
        top_k: int = 3,
        configmap: Optional[str] = None,
        flush_interval_s: float = 30.0,
        kube_timeout_s: float = 15.0,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        embedder = embedder or HashingEmbedder()
        # explicit None checks: an EMPTY store/index is falsy (__len__) and
        # must not be swapped for a fresh default; a default index scores
        # on ``device`` (cuda unless the caller asks for another)
        self.store = store if store is not None else IncidentStore()
        self.index = index if index is not None else IncidentIndex(embedder, device=device)
        # threshold is an embedder property (lexical overlap scores run
        # lower than contextual cosines), overridable by config
        self.near_threshold = (
            near_threshold
            if near_threshold is not None and near_threshold > 0
            else getattr(self.index.embedder, "default_threshold", 0.3)
        )
        self.top_k = max(1, top_k)
        self.configmap = configmap
        self.flush_interval_s = flush_interval_s
        #: per-call budget for the ConfigMap snapshot/restore kube calls
        #: (mirrors OperatorConfig.kube_call_timeout_s): the flush rides
        #: the analysis pipeline's remember stage, and a wedged apiserver
        #: connection must cost one bounded attempt, not the analysis task
        self.kube_timeout_s = kube_timeout_s
        self._last_flush = 0.0
        if len(self.store):
            # journal-restored incidents must be queryable immediately
            self.index.rebuild(self.store.all(newest_first=False))

    # ------------------------------------------------------------------
    def recall(
        self,
        result: Optional[AnalysisResult],
        pod: Optional[Pod],
        *,
        allow_reuse: bool = True,
        provider_ref: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> RecallDecision:
        """Classify one analyzed failure against memory.  Every call is a
        sighting: an exact fingerprint match bumps the incident's
        recurrence counters whether or not its analysis is reused.
        ``allow_reuse=False`` (no AI leg configured for this CR) still
        tracks recurrence but never returns a hit.  ``provider_ref``
        (the CR's "namespace/name" AIProvider reference) must equal the
        stored incident's — a hit must reuse an analysis the recalling CR
        would itself have produced, never another provider's text."""
        fingerprint = failure_fingerprint(result, pod)
        if fingerprint.is_weak:
            # (exit code, reason) alone is not an identity: unrelated
            # failures would collide and swap analyses — always analyze
            return RecallDecision(RECALL_MISS, fingerprint)
        # TTL sweep rides every recall, so a hit-only workload still ages
        # dead incidents out of the store AND the index
        expired = self.store.expire()
        if expired:
            self.index.remove(expired)
        incident = self.store.get(fingerprint.digest)
        prior_trace_id: Optional[str] = None
        if incident is not None:
            # the PRIOR sighting's trace, read before this sighting's
            # trace id overwrites it on the stored incident
            prior_trace_id = incident.last_trace_id
            # reuse is per provider ref: this CR only ever gets back an
            # analysis ITS OWN provider produced earlier
            cached = incident.analyses.get(provider_ref or "")
            reuse = (
                allow_reuse and cached is not None and bool(cached.explanation)
            )
            incident = self.store.record_recurrence(
                fingerprint.digest, reused=reuse, trace_id=trace_id
            )
            # incident is None only if eviction raced the lookup — fall
            # through to near/miss rather than reuse a vanished record
            if reuse and incident is not None:
                return RecallDecision(
                    RECALL_HIT, fingerprint, incident=incident, analysis=cached,
                    prior_trace_id=prior_trace_id,
                )
        neighbors: list[tuple[Incident, float]] = []
        for digest, score in self.index.query(
            fingerprint.embedding_text(), k=self.top_k + 1
        ):
            if digest == fingerprint.digest or score < self.near_threshold:
                continue
            prior = self.store.get(digest)
            if prior is None or not prior.explanation:
                continue  # nothing worth injecting
            neighbors.append((prior, score))
        neighbors = neighbors[: self.top_k]
        if neighbors:
            return RecallDecision(
                RECALL_NEAR, fingerprint, incident=incident, neighbors=neighbors,
                prior_trace_id=prior_trace_id,
            )
        return RecallDecision(
            RECALL_MISS, fingerprint, incident=incident,
            prior_trace_id=prior_trace_id,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def hit_probability(decision: RecallDecision) -> float:
        """How likely this request resolves from memory instead of a cold
        analysis — the admission signal the overload value model reads
        (router/value.py: a recall hit costs ~4% of a cold analysis, so
        a likely-recalled request is ~25x cheaper per unit value and is
        shed only after all cold work of equal-or-lower class).

        Pure read over an already-made decision: a hit IS a reuse (1.0);
        a known incident that could not be reused this time (no cached
        explanation for this provider ref, reuse disabled) still predicts
        a warm path (0.75); a near-neighbor match predicts partial reuse
        capped by the top neighbor's similarity (<= 0.5); a miss is cold
        (0.0)."""
        if decision.kind == RECALL_HIT:
            return 1.0
        if decision.kind == RECALL_NEAR:
            top = max((s for _, s in decision.neighbors), default=0.0)
            return min(0.5, float(top))
        if decision.incident is not None:
            return 0.75
        return 0.0

    # ------------------------------------------------------------------
    def insert(
        self,
        fingerprint: FailureFingerprint,
        result: Optional[AnalysisResult],
        pod: Optional[Pod],
        ai_response: Optional[AIResponse],
        *,
        related: Optional[list[str]] = None,
        seen_recorded: bool = False,
        provider_ref: Optional[str] = None,
        cacheable: bool = True,
        trace_id: Optional[str] = None,
    ) -> Optional[Incident]:
        """Remember a completed analysis (upsert: a class first seen
        pattern-only gains its analysis text when the AI leg later
        succeeds).  Returns the stored incident, or None for a weak
        fingerprint (see :meth:`FailureFingerprint.is_weak` — never
        stored).

        ``seen_recorded=True`` means this sighting's recurrence was
        already counted by :meth:`recall` (the digest was in the store
        then).  False + an existing digest = a concurrent first sighting
        (two pods of one ReplicaSet crashing together): the upsert bumps
        ``seen_count`` so the race cannot undercount recurrence.

        Only a CLEAN analysis is stored as reusable: an errored or
        deadline-truncated explanation would otherwise be replayed
        verbatim forever, freezing a cut-off root cause fleet-wide.
        ``cacheable=False`` (the AIProvider's cachingEnabled opt-out)
        tracks recurrence but never remembers the generated text."""
        if fingerprint.is_weak:
            return None
        reusable = (
            cacheable
            and ai_response is not None
            and bool(ai_response.explanation)
            and not ai_response.error
            and ai_response.deadline_outcome in (None, "completed")
        )
        now = now_iso()
        incident = Incident(
            fingerprint=fingerprint.digest,
            pattern_ids=list(fingerprint.pattern_ids),
            severity=(result.summary.highest_severity if result else None),
            template=fingerprint.template,
            exit_code=fingerprint.exit_code,
            reason=fingerprint.reason,
            explanation=ai_response.explanation if reusable else None,
            provider_id=(ai_response.provider_id if ai_response else None),
            model_id=(ai_response.model_id if ai_response else None),
            analyses=(
                {
                    provider_ref or "": CachedAnalysis(
                        explanation=ai_response.explanation,
                        provider_id=ai_response.provider_id,
                        model_id=ai_response.model_id,
                    )
                }
                if reusable
                else {}
            ),
            pod_name=(pod.metadata.name if pod else None),
            pod_namespace=(pod.metadata.namespace if pod else None),
            first_seen=now,
            last_seen=now,
            related=list(related or []),
            last_trace_id=trace_id,
        )
        evicted = self.store.upsert(incident, bump_if_existing=not seen_recorded)
        if evicted:
            self.index.remove(evicted)
        stored = self.store.get(fingerprint.digest)
        assert stored is not None
        self.index.add(stored)
        return stored

    # ------------------------------------------------------------------
    def query_text(self, text: str, k: int = 3) -> list[tuple[Incident, float]]:
        """Free-text similarity query (the /incidents/query endpoint):
        top-k stored incidents by embedding score, no threshold — a
        debugging surface, the caller reads the scores."""
        out: list[tuple[Incident, float]] = []
        for digest, score in self.index.query(text, k=k):
            incident = self.store.get(digest)
            if incident is not None:
                out.append((incident, score))
        return out

    def close(self) -> None:
        self.store.close()

    # -- ConfigMap backing ---------------------------------------------
    async def restore_from_configmap(self, api, namespace: str) -> int:
        """Merge the ConfigMap snapshot into the store (PVC-less restarts).
        Journal/live entries win over snapshot ones."""
        if not self.configmap:
            return 0
        from ..operator.kubeapi import ApiError, NotFoundError  # lazy: no cycle

        try:
            cm = await asyncio.wait_for(
                api.get("ConfigMap", self.configmap, namespace),
                timeout=self.kube_timeout_s,
            )
        except NotFoundError:
            return 0
        except (ApiError, asyncio.TimeoutError) as exc:
            log.warning("incident ConfigMap restore failed: %s",
                        str(exc) or "timed out")
            return 0
        loaded = self.store.load_snapshot((cm.get("data") or {}).get(CONFIGMAP_KEY, ""))
        if loaded:
            self.index.rebuild(self.store.all(newest_first=False))
            log.info("incident memory: %d incident(s) restored from ConfigMap %s",
                     loaded, self.configmap)
        return loaded

    async def maybe_flush_to_configmap(
        self, api, namespace: str, clock=None, *, force: bool = False
    ) -> bool:
        """Snapshot the store into the ConfigMap at most once per
        ``flush_interval_s`` (called after inserts; failures are logged,
        never raised — durability backing must not break analyses).
        ``force=True`` bypasses the throttle — the shutdown flush, so the
        last interval's incidents survive a PVC-less restart."""
        if not self.configmap:
            return False
        import time as _time

        now = (clock or _time.monotonic)()
        if (not force and self._last_flush
                and now - self._last_flush < self.flush_interval_s):
            return False
        from ..operator.kubeapi import ApiError, NotFoundError  # lazy: no cycle

        try:
            data = {CONFIGMAP_KEY: self.store.snapshot()}
            try:
                await asyncio.wait_for(
                    api.patch("ConfigMap", self.configmap, namespace,
                              {"data": data}),
                    timeout=self.kube_timeout_s,
                )
            except NotFoundError:
                await asyncio.wait_for(
                    api.create("ConfigMap", {
                        "apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": self.configmap,
                                     "namespace": namespace},
                        "data": data,
                    }),
                    timeout=self.kube_timeout_s,
                )
            # advance the throttle only on SUCCESS: a transient apiserver
            # error must not suppress the retry for a whole interval
            self._last_flush = now
            return True
        except (ApiError, asyncio.TimeoutError) as exc:
            log.warning("incident ConfigMap flush failed: %s",
                        str(exc) or "timed out")
            return False


def build_incident_memory(
    config,
    *,
    embedder: Optional[Embedder] = None,
    device: Optional[Union[str, torch.device]] = None,
):
    """The one construction path (pipeline default + operator wiring):
    ``None`` when the subsystem is disabled.  ``embedder`` lets the
    operator share the semantic matcher's neural encoder; the default is
    the always-available lexical HashingEmbedder.  The index scores on
    ``device`` (cuda unless the caller asks for another)."""
    if not getattr(config, "memory_enabled", True):
        return None
    store = IncidentStore(
        config.memory_path or None,
        max_entries=config.memory_max_entries,
        ttl_s=config.memory_ttl_s,
    )
    return IncidentMemory(
        store=store,
        embedder=embedder,
        near_threshold=config.recall_threshold or None,
        top_k=config.recall_top_k,
        configmap=config.memory_configmap or None,
        flush_interval_s=config.memory_flush_interval_s,
        kube_timeout_s=getattr(config, "kube_call_timeout_s", 15.0),
        device=device,
    )
