"""Embedding index over stored incidents — the near-miss half of recall.

Port of ``operator_tpu/memory/index.py``.  Exact fingerprint equality
catches literal replays; this index catches the *same failure phrased
differently*.  It reuses the pattern engine's embedders
(``patterns/semantic.py``) and scores query x incidents with the
best-window similarity kernel (``ops/similarity.py``; K5 on the card):
one query row as the only window against the incident matrix as the
patterns, so each incident's best score is its cosine with the query.
The incident matrix lives on the index's device.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..ops.similarity import best_window_scores
from ..patterns.semantic import Embedder, HashingEmbedder
from ..utils.device import resolve_device
from .store import Incident

log = logging.getLogger(__name__)


class IncidentIndex:
    """(digests, embedding matrix) kept in lockstep; readers snapshot the
    pair atomically (same discipline as SemanticMatcher._state).  The
    matrix lives on ``device`` (``cuda`` unless the caller asks for
    another)."""

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.embedder = embedder or HashingEmbedder()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._state: tuple[list[str], torch.Tensor] = ([], self._empty())

    def _empty(self) -> torch.Tensor:
        return torch.zeros((0, self.embedder.dim), dtype=torch.float32, device=self.device)

    def _rows(self, texts: Sequence[str]) -> torch.Tensor:
        rows = self.embedder.embed(list(texts)).astype(np.float32)
        return torch.as_tensor(rows).to(self.device)

    def __len__(self) -> int:
        # graftlint: disable=GL004 reason=deliberate lock-free snapshot read; _state is an immutable tuple swapped atomically under the lock
        return len(self._state[0])

    # ------------------------------------------------------------------
    def rebuild(self, incidents: Sequence[Incident], texts: Optional[Sequence[str]] = None) -> int:
        """Re-embed every incident (after eviction or a restore).  ``texts``
        overrides the per-incident embedding text when the caller has richer
        basis than the stored template (recall passes fingerprint
        embedding_text)."""
        digests = [i.fingerprint for i in incidents if i.fingerprint]
        if texts is None:
            texts = [self._incident_text(i) for i in incidents if i.fingerprint]
        embeddings = self._rows(texts)
        with self._lock:
            self._state = (digests, embeddings)
        return len(digests)

    def add(self, incident: Incident, text: Optional[str] = None) -> None:
        """Append one incident's embedding row (no-op if already present —
        an upsert of an existing digest keeps its original embedding, the
        template is part of the identity and cannot have changed)."""
        if not incident.fingerprint:
            return
        row = self._rows([text or self._incident_text(incident)])
        with self._lock:
            digests, matrix = self._state
            if incident.fingerprint in digests:
                return
            self._state = (digests + [incident.fingerprint], torch.cat([matrix, row]))

    def remove(self, evicted: Sequence[str]) -> None:
        if not evicted:
            return
        gone = set(evicted)
        with self._lock:
            digests, matrix = self._state
            keep = [i for i, d in enumerate(digests) if d not in gone]
            self._state = (
                [digests[i] for i in keep],
                matrix[keep] if keep else self._empty(),
            )

    @staticmethod
    def _incident_text(incident: Incident) -> str:
        from .fingerprint import incident_embedding_text  # one shared basis

        return incident_embedding_text(
            incident.template, incident.pattern_ids,
            incident.reason, incident.exit_code,
        )

    # ------------------------------------------------------------------
    def query(self, text: str, k: int = 3) -> list[tuple[str, float]]:
        """Top-k (digest, cosine score), descending: one best-window
        similarity call on the index's device."""
        # graftlint: disable=GL004 reason=deliberate lock-free snapshot read; _state is an immutable tuple swapped atomically under the lock
        digests, matrix = self._state  # one consistent snapshot
        if not digests or not text.strip():
            return []
        scores = self._score(self._rows([text]), matrix)  # query [1, D]
        k = min(max(1, k), len(digests))
        order = np.argsort(scores)[::-1][:k]
        return [(digests[int(i)], float(scores[int(i)])) for i in order]

    @staticmethod
    def _score(query: torch.Tensor, matrix: torch.Tensor) -> np.ndarray:
        # one query "window" against the incident matrix as the pattern
        # side: per-incident best == the cosine itself
        scores, _ = best_window_scores(query, matrix)
        return scores.cpu().numpy()
