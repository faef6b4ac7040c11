"""PatternEngine — the analysis facade (the log-parser service's role).

Port of ``operator_tpu/patterns/engine.py``.  ``analyze(PodFailureData)
-> AnalysisResult`` is the behavioural equivalent of the reference's
``POST /parse`` (LogParserRestClient.java:37-39), run in-process.
Evidence beyond the raw log also participates in matching:

- container termination states (exit code / reason / message) become
  synthetic evidence lines like
  ``[container-status] app terminated exit code 137 reason=OOMKilled``;
- Kubernetes event notes collected with the failure are matched as
  ``[k8s-event] Warning BackOff: ...`` lines.

A reload() picks up newly synced pattern libraries.  With a semantic
matcher, every ``analyze`` that has lines and patterns scores them with
one best-window similarity call on the matcher's device (K5 on the card).
``python -m operator_tpu_torch.patterns [logfile ...]`` prints the result
as YAML, as the JAX module's command line does.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Optional, Union

import torch

from ..schema.analysis import AnalysisResult, PodFailureData, StageTimings
from ..schema.kube import Pod
from .loader import LoadedLibrary, load_builtin_library, load_libraries
from .matcher import MatcherConfig, collect_events, fold_events
from .prefilter import LiteralPrefilter
from .semantic import SemanticMatcher
from .windows import split_lines

log = logging.getLogger(__name__)


def status_evidence_lines(pod: Optional[Pod]) -> list[str]:
    """Synthetic evidence lines derived from the pod's container statuses."""
    if pod is None or pod.status is None:
        return []
    lines: list[str] = []
    for cs in [*pod.status.container_statuses, *pod.status.init_container_statuses]:
        for label, state in (("state", cs.state), ("lastState", cs.last_state)):
            if state is None:
                continue
            if state.terminated is not None:
                t = state.terminated
                parts = [f"[container-status] {cs.name} terminated"]
                if t.exit_code is not None:
                    parts.append(f"exit code {t.exit_code}")
                if t.reason:
                    parts.append(f"reason={t.reason}")
                if t.message:
                    parts.append(t.message)
                lines.append(" ".join(parts))
            if state.waiting is not None and state.waiting.reason:
                msg = state.waiting.message or ""
                lines.append(f"[container-status] {cs.name} waiting reason={state.waiting.reason} {msg}".rstrip())
        if cs.restart_count:
            lines.append(f"[container-status] {cs.name} restartCount={cs.restart_count}")
    return lines


def event_evidence_lines(failure: PodFailureData) -> list[str]:
    lines = []
    for event in failure.events:
        note = event.note or ""
        lines.append(f"[k8s-event] {event.type_ or 'Normal'} {event.reason or ''}: {note}".rstrip())
    return lines


class PatternEngine:
    """Thread-safe holder of loaded libraries + the match entry point.

    The control plane calls :meth:`analyze` per failure and
    :meth:`reload` after every pattern sync; both may race, hence the lock
    around the library snapshot.  ``semantic=True`` builds a
    :class:`SemanticMatcher` with the lexical embedder on ``device``
    (``cuda`` unless the caller asks for another); a matcher passed in
    keeps its own device.
    """

    def __init__(
        self,
        cache_dir: Optional[str] = None,
        *,
        enabled_libraries: Optional[list[str]] = None,
        include_builtin: bool = True,
        config: Optional[MatcherConfig] = None,
        semantic: "SemanticMatcher | bool | None" = None,
        prefilter: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.cache_dir = cache_dir
        self.enabled_libraries = enabled_libraries
        self.include_builtin = include_builtin
        self.config = config or MatcherConfig()
        if semantic is True:
            semantic = SemanticMatcher(device=device)
        self.semantic: Optional[SemanticMatcher] = semantic or None
        self._use_prefilter = prefilter
        self.prefilter: Optional[LiteralPrefilter] = None
        self._lock = threading.Lock()
        self._libraries: list[LoadedLibrary] = []
        self.reload()

    # ------------------------------------------------------------------
    def reload(self) -> int:
        """Re-scan the cache dir; returns the number of loaded patterns."""
        libraries: list[LoadedLibrary] = []
        if self.cache_dir:
            libraries.extend(load_libraries(self.cache_dir, self.enabled_libraries))
        if self.include_builtin:
            builtin = load_builtin_library()
            # synced libraries shadow the builtin one by name
            if all(lib.name != builtin.name for lib in libraries):
                libraries.append(builtin)
        with self._lock:
            self._libraries = libraries
        if self._use_prefilter:
            # rebuild the literal scanner for the new pattern set
            all_patterns = [p for lib in libraries for p in lib.patterns]
            self.prefilter = LiteralPrefilter(all_patterns)
            log.info(
                "literal prefilter: %d anchored / %d full-scan (native=%s)",
                self.prefilter.num_anchored, len(self.prefilter.full_scan_ids),
                self.prefilter.native,
            )
        if self.semantic is not None:
            # the embedding-cache build step of the sync reconciler:
            # re-embed anchors after every git pull
            self.semantic.rebuild(libraries)
        total = sum(len(lib.patterns) for lib in libraries)
        log.info("pattern engine loaded %d libraries / %d patterns", len(libraries), total)
        return total

    @property
    def libraries(self) -> list[LoadedLibrary]:
        with self._lock:
            return list(self._libraries)

    def library_names(self) -> list[str]:
        return sorted(lib.name for lib in self.libraries)

    # ------------------------------------------------------------------
    def analyze(self, failure: PodFailureData) -> AnalysisResult:
        started = time.perf_counter()
        lines = split_lines(failure.logs)
        lines.extend(event_evidence_lines(failure))
        lines.extend(status_evidence_lines(failure.pod))
        pod = failure.pod
        # collect the UNtruncated regex/keyword hits first so the semantic
        # merge dedupes and summarises over the full set — one fold at the
        # end ranks/truncates exactly once
        events = collect_events(self.libraries, lines, self.config, prefilter=self.prefilter)
        if self.semantic is not None and self.semantic.num_patterns:
            # semantic catches what regex missed; a pattern already hit by
            # its regex keeps the (higher-precision) regex event only
            matched_ids = {e.matched_pattern.id for e in events}
            events.extend(
                e
                for e in self.semantic.match(lines)
                if e.matched_pattern.id not in matched_ids
            )
        summary, folded = fold_events(events, self.config)
        result = AnalysisResult(
            analysis_id=str(uuid.uuid4()),
            pod_name=pod.metadata.name if pod else None,
            pod_namespace=pod.metadata.namespace if pod else None,
            summary=summary,
            events=folded,
        )
        result.timings = StageTimings(parse_ms=round((time.perf_counter() - started) * 1e3, 3))
        return result


def _main(argv: Optional[list[str]] = None) -> int:
    """``python -m operator_tpu_torch.patterns.engine [logfile ...]`` — analyze log
    files (or stdin) against the loaded pattern libraries and print the
    result as YAML."""
    import argparse
    import sys

    import yaml

    parser = argparse.ArgumentParser(
        prog="operator_tpu_torch.patterns.engine",
        description="Pattern-match log files against failure-pattern libraries.",
    )
    parser.add_argument("logfiles", nargs="*", help="log files (default: stdin)")
    parser.add_argument("--cache-dir", help="synced pattern-cache directory")
    parser.add_argument("--no-builtin", action="store_true",
                        help="skip the built-in kubernetes-common library")
    parser.add_argument("--top", type=int, default=5, help="show top-K events")
    args = parser.parse_args(argv)

    engine = PatternEngine(cache_dir=args.cache_dir, include_builtin=not args.no_builtin)
    sources = args.logfiles or ["-"]
    exit_code = 0
    for source in sources:
        try:
            logs = sys.stdin.read() if source == "-" else open(source, encoding="utf-8", errors="replace").read()
        except OSError as exc:
            print(f"error: cannot read {source}: {exc}", file=sys.stderr)
            exit_code = 2
            continue
        result = engine.analyze(PodFailureData(logs=logs))
        doc = {
            "source": source,
            "summary": result.summary.__dict__,
            "events": [
                {
                    "pattern": e.matched_pattern.id,
                    "name": e.matched_pattern.name,
                    "severity": e.matched_pattern.severity,
                    "score": e.score,
                    "line": e.context.line_number if e.context else None,
                    "matched": e.context.matched_line if e.context else None,
                }
                for e in result.top_events(args.top)
            ],
        }
        try:
            print(yaml.safe_dump(doc, sort_keys=False), end="")
        except BrokenPipeError:
            sys.stderr.close()
            return 0
    return exit_code


if __name__ == "__main__":
    raise SystemExit(_main())
