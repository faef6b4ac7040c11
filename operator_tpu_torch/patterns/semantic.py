"""Semantic pattern matching: embedding similarity over log windows.

Port of ``operator_tpu/patterns/semantic.py``.  The regex matcher
(matcher.py) only fires on patterns whose exact regex or keywords appear;
the semantic path catches failures phrased differently — it embeds every
log window and every pattern's anchor text into one vector space and
scores ``windows @ patterns.T`` with the best-window similarity kernel
(``ops/similarity.py``; K5 on the card).

Two embedders, one interface (text -> f32 numpy rows):

- :class:`HashingEmbedder` — deterministic char-n-gram feature hashing,
  zero weights, pure numpy (copied as it is).
- :class:`NeuralEmbedder` — the MiniLM-class encoder
  (``models/encoder.py``) run eagerly on its device.

Pattern embeddings are (re)built on ``rebuild`` and kept on the matcher's
device; the window embeddings go there once per ``match``.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import zlib
from typing import Optional, Protocol, Sequence, Union

import numpy as np
import torch

from ..models.encoder import encode
from ..ops.similarity import best_window_scores
from ..schema.analysis import AnalysisEvent, MatchContext, MatchedPattern
from ..schema.patterns import Pattern
from ..serving.graphs import GraphSet
from ..utils.device import resolve_device
from .loader import LoadedLibrary
from .windows import LogWindow, iter_windows

log = logging.getLogger(__name__)

DEFAULT_WINDOW_LINES = 16
DEFAULT_STRIDE = 8


class Embedder(Protocol):
    """Text -> L2-normalised embeddings [N, dim]."""

    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray: ...


_REGEX_TOKEN = re.compile(r"[A-Za-z][A-Za-z0-9_.]{2,}")


def regex_literals(regex: Optional[str]) -> list[str]:
    """Literal word-ish tokens inside a regex (``java\\.lang\\.OutOfMemoryError``
    -> ``java lang OutOfMemoryError``) — the vocabulary the pattern expects
    to see in real log lines."""
    if not regex:
        return []
    cleaned = regex.replace("\\.", " ").replace("\\", " ")
    return [t for t in _REGEX_TOKEN.findall(cleaned) if t.lower() not in {"the", "and"}]


def embedding_text(pattern: Pattern) -> str:
    """What gets embedded for a pattern: the natural-language anchor plus
    the literal vocabulary of its regexes/keywords, so lexical embedders
    see log-shaped tokens and neural embedders see the description."""
    parts = [pattern.anchor_text()]
    if pattern.primary_pattern:
        parts.extend(regex_literals(pattern.primary_pattern.regex))
        parts.extend(pattern.primary_pattern.keywords)
    for secondary in pattern.secondary_patterns:
        parts.extend(regex_literals(secondary.regex))
    seen: set[str] = set()
    unique = []
    for p in parts:
        if p and p.lower() not in seen:
            seen.add(p.lower())
            unique.append(p)
    return " ".join(unique)


# ---------------------------------------------------------------------------
# hashing embedder (no weights, deterministic, lexical)
# ---------------------------------------------------------------------------


class HashingEmbedder:
    """Signed char-n-gram feature hashing into a fixed-dim unit vector.

    Cosine similarity under this embedding measures character-n-gram
    overlap — strong enough to pair "OOMKilled exit code 137" with a
    pattern anchored on "container killed out of memory 137", with zero
    model weights.  Lexical overlap lives at line granularity, so the
    default windows are small (``default_window_lines``); the threshold is
    calibrated against the 12-fixture failure corpus: 0.3 keeps every
    paraphrase recall (tests/test_corpus.py::TestSemanticCalibration) while
    rejecting the strongest observed cross-class overlap (0.2-range hits
    from generic words like "container"/"failed" shared across classes).
    """

    default_threshold = 0.3
    default_window_lines = 4
    default_stride = 2

    #: tokens so common across failure classes (and English) that their
    #: n-grams carry no class signal — every k8s log and every pattern
    #: anchor says "container"/"failed"/"error".  Stripped SYMMETRICALLY
    #: from pattern anchors and log windows before hashing, so similarity
    #: is driven by the distinctive vocabulary (OOMKilled, init, heap,
    #: x509, resolv...).  The neural path embeds the raw text — this list
    #:  is a lexical-embedder concern only.
    GENERIC_TOKENS = frozenset(
        """container containers fail failed failure failures error errors
        pod pods status exit exited code warning restarting restart kubelet
        terminated reason process the a an was were with and for of to in
        is are so not never main after before during""".split()
    )

    def __init__(self, dim: int = 384, ngram_sizes: tuple[int, ...] = (3, 4, 5)) -> None:
        self.dim = dim
        self.ngram_sizes = ngram_sizes

    def _features(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, np.float32)
        tokens = [
            t for t in re.split(r"[^a-z0-9]+", text.lower())
            if t and t not in self.GENERIC_TOKENS
        ]
        normalized = " ".join(tokens)
        data = normalized.encode("utf-8", errors="replace")
        for n in self.ngram_sizes:
            if len(data) < n:
                continue
            for i in range(len(data) - n + 1):
                gram = data[i : i + n]
                h = zlib.crc32(gram)
                sign = 1.0 if (h >> 31) & 1 else -1.0
                vec[h % self.dim] += sign
        norm = float(np.linalg.norm(vec))
        if norm > 0:
            vec /= norm
        return vec

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self._features(t) for t in texts])


# ---------------------------------------------------------------------------
# neural embedder (the MiniLM-class encoder, on the card)
# ---------------------------------------------------------------------------


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {key: _to_device(value, device) for key, value in tree.items()}
    return tree.to(device)


class NeuralEmbedder:
    """MiniLM-class encoder behind the same embed() interface.

    Batches are padded to fixed ``[batch_size, max_tokens]`` buckets (the
    JAX package's compile-once shapes, one ``jax.jit`` per bucket).  Here
    ``encode`` runs as one program per bucket shape
    (``serving/graphs.py``): a CUDA graph on the card, captured at the
    first bucket and replayed for every later one, eager on the CPU
    (``device``, ``cuda`` unless the caller asks for another).  Each
    bucket's embeddings are copied out of the graph's output on the
    device; ``embed`` returns them as one f32 numpy array.  The best-window
    kernel after it (K5) stays eager: its window count changes per log.
    """

    default_threshold = 0.45
    default_window_lines = DEFAULT_WINDOW_LINES
    default_stride = DEFAULT_STRIDE

    def __init__(
        self,
        params,
        config,
        tokenize,  # (text) -> list[int], no specials
        *,
        max_tokens: int = 256,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.config = config
        self.tokenize = tokenize
        self.max_tokens = min(max_tokens, config.max_positions)
        self.batch_size = batch_size
        self.dim = config.hidden_size
        # one instance may be shared by the analysis thread and other
        # callers; tokenizers are not all safe for concurrent use
        self._lock = threading.Lock()
        self.graphs = GraphSet(self.device)
        self._encode = self.graphs.program(
            "encoder",
            lambda params, ids, mask: encode(params, config, ids, mask),
            fixed_args=(0,),
        )

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_dir: str,
        *,
        max_tokens: int = 256,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "NeuralEmbedder":
        """Build from a local sentence-transformers/BERT checkpoint dir
        (safetensors weights + config.json + the tokenizer files), the
        weights loaded straight onto ``device``.  The tokenizer is read
        in ``AutoTokenizer``'s order, as the reference's is:
        ``tokenizer.json`` when the directory has one
        (:class:`~..models.tokenizer.HFTokenizer`, its post-processor's
        specials), else ``vocab.txt`` (the BERT WordPiece tokenizer).

        Tokenisation includes the [CLS]/[SEP] specials — the
        sentence-transformers mean-pooling convention counts them, and
        matching it is what makes cosine scores comparable to the public
        MiniLM embeddings.
        """
        from ..models.encoder import load_encoder_params
        from ..models.tokenizer import HFTokenizer
        from ..models.wordpiece import WordPieceTokenizer

        device = resolve_device(device)
        params, config = load_encoder_params(checkpoint_dir, device=device)
        if os.path.exists(os.path.join(checkpoint_dir, "tokenizer.json")):
            tokenize = HFTokenizer(checkpoint_dir).encode_with_special_tokens
        else:
            tok = WordPieceTokenizer.from_dir(checkpoint_dir)

            def tokenize(text: str) -> list[int]:
                return tok.encode(text, add_special_tokens=True)

        return cls(
            params, config, tokenize, max_tokens=max_tokens, batch_size=batch_size,
            device=device,
        )

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        with self._lock:
            return self._embed_locked(texts)

    def _embed_locked(self, texts: Sequence[str]) -> np.ndarray:
        out = torch.empty((len(texts), self.dim), dtype=torch.float32, device=self.device)
        for lo in range(0, len(texts), self.batch_size):
            chunk = texts[lo : lo + self.batch_size]
            ids = np.zeros((self.batch_size, self.max_tokens), np.int64)
            mask = np.zeros((self.batch_size, self.max_tokens), np.int64)
            for row, text in enumerate(chunk):
                toks = self.tokenize(text)[: self.max_tokens]
                ids[row, : len(toks)] = toks
                mask[row, : len(toks)] = 1
            emb = self._encode(
                self.params,
                torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device),
                key=(self.batch_size, self.max_tokens),
            )
            # the next replay overwrites the graph's output: copy it out
            out[lo : lo + len(chunk)] = emb[: len(chunk)]
        return out.cpu().numpy()


def build_embedder(
    encoder_checkpoint_dir: "str | None",
    *,
    fallback: bool = True,
    device: Optional[Union[str, torch.device]] = None,
):
    """The one embedder ladder every surface uses: MiniLM-class neural
    encoder on ``device`` when a checkpoint dir is given and loads,
    degrading with a warning to the lexical ``HashingEmbedder`` (or
    ``None`` when ``fallback=False`` — the semantic matcher treats
    no-encoder as "lexical matching only")."""
    if encoder_checkpoint_dir:
        try:
            embedder = NeuralEmbedder.from_checkpoint(encoder_checkpoint_dir, device=device)
            log.info("neural embedder from %s", encoder_checkpoint_dir)
            return embedder
        except Exception:  # noqa: BLE001 - optional neural path degrades
            log.warning(
                "encoder checkpoint %s unusable; degrading to lexical",
                encoder_checkpoint_dir, exc_info=True,
            )
    return HashingEmbedder() if fallback else None


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------


class SemanticMatcher:
    """Holds pattern embeddings on ``device``; scores logs window by window.

    ``rebuild(libraries)`` re-embeds all pattern anchor texts (called after
    every pattern sync); ``match(lines)`` embeds the log windows and emits
    an :class:`AnalysisEvent` per pattern whose best window clears the
    similarity threshold.  The best window of every pattern comes from one
    :func:`best_window_scores` call on ``device`` (``cuda`` unless the
    caller asks for another): the kernel on the card, with no fallback.
    """

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        threshold: Optional[float] = None,
        window_lines: Optional[int] = None,
        stride: Optional[int] = None,
        max_windows: int = 4096,
    ) -> None:
        self.embedder = embedder or HashingEmbedder()
        self.device = resolve_device(device)
        self.threshold = (
            threshold
            if threshold is not None
            else getattr(self.embedder, "default_threshold", 0.3)
        )
        # window granularity is an embedder property: lexical overlap lives
        # at line scale, contextual embeddings want wider spans
        self.window_lines = window_lines or getattr(
            self.embedder, "default_window_lines", DEFAULT_WINDOW_LINES
        )
        self.stride = stride or getattr(
            self.embedder, "default_stride", DEFAULT_STRIDE
        )
        self.max_windows = max_windows
        # (patterns, embeddings) swapped as ONE tuple: rebuild() may run in a
        # sync thread while match() runs in an analysis thread; readers take
        # a single snapshot so list and matrix can never be mismatched
        self._state: tuple[list[Pattern], torch.Tensor] = (
            [],
            torch.zeros((0, self.embedder.dim), dtype=torch.float32, device=self.device),
        )

    # ------------------------------------------------------------------
    def rebuild(self, libraries: Sequence[LoadedLibrary]) -> int:
        patterns = [p for lib in libraries for p in lib.patterns]
        texts = [embedding_text(p) for p in patterns]
        keep = [i for i, t in enumerate(texts) if t.strip()]
        kept_patterns = [patterns[i] for i in keep]
        embeddings = self.embedder.embed([texts[i] for i in keep])
        self._state = (kept_patterns, torch.as_tensor(embeddings).to(self.device))  # atomic swap
        log.info("semantic matcher: embedded %d patterns", len(kept_patterns))
        return len(kept_patterns)

    @property
    def num_patterns(self) -> int:
        return len(self._state[0])

    # ------------------------------------------------------------------
    def match(self, lines: list[str]) -> list[AnalysisEvent]:
        patterns, pattern_emb = self._state  # one consistent snapshot
        if not lines or not patterns:
            return []
        windows = list(
            iter_windows(lines, window_lines=self.window_lines, stride=self.stride)
        )
        if len(windows) > self.max_windows:
            # evidence concentrates at the tail — keep the newest windows
            windows = windows[-self.max_windows :]
        window_emb = self.embedder.embed([w.text for w in windows])

        scores, best_idx = self._score(window_emb, patterns, pattern_emb)
        events: list[AnalysisEvent] = []
        for i, pattern in enumerate(patterns):
            score = float(scores[i])
            if score < self.threshold:
                continue
            window = windows[int(best_idx[i])]
            events.append(self._to_event(pattern, window, score, lines))
        events.sort(key=lambda e: e.score, reverse=True)
        return events

    def _score(
        self,
        window_emb: np.ndarray,
        patterns: list[Pattern],
        pattern_emb: torch.Tensor,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-pattern (best score, best window index)."""
        if window_emb.shape[0] == 0:
            n = len(patterns)
            return np.full(n, -1.0, np.float32), np.zeros(n, np.int64)
        scores, idx = best_window_scores(
            torch.as_tensor(window_emb).to(self.device), pattern_emb
        )
        return scores.cpu().numpy(), idx.cpu().numpy()

    def _to_event(
        self, pattern: Pattern, window: LogWindow, score: float, lines: list[str]
    ) -> AnalysisEvent:
        # anchor the event at the window's middle line for context display
        line_number = min(window.start + len(window) // 2, len(lines) - 1)
        window_lines = window.text.splitlines()
        mid = min(len(window) // 2, max(len(window_lines) - 1, 0))
        remediation = (
            pattern.remediation.description if pattern.remediation else None
        )
        return AnalysisEvent(
            score=round(score, 4),
            source="semantic",
            matched_pattern=MatchedPattern(
                id=pattern.id,
                name=pattern.name or pattern.id,
                severity=pattern.severity_enum.value,
                category=pattern.category,
                remediation=remediation,
            ),
            context=MatchContext(
                line_number=line_number,
                matched_line=window_lines[mid] if window_lines else "",
                lines_before=window_lines[:mid],
                lines_after=window_lines[mid + 1 :],
            ),
        )
