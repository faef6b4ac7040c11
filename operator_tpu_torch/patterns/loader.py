"""Pattern-library loading from the synced cache directory.

Copy of ``operator_tpu/patterns/loader.py``; the built-in library is the
port's own copy, ``builtin/kubernetes-common.yaml`` beside this module.

Directory contract (reference PatternSyncService.java:42-58): the sync
reconciler materialises each Git repo at
``<cache>/<library-cr-name>/<repo-name>/``; every ``*.yaml|*.yml`` anywhere
under the cache is one pattern library named after its file stem
(reference PatternSyncService.getAvailableLibraries :88-114).

Robustness the reference can't have (its parser is an unseen sibling):
patterns with malformed regexes are skipped with a warning at load time
instead of blowing up the match path.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

from ..schema.patterns import Pattern, PatternLibraryFile

log = logging.getLogger(__name__)

_YAML_EXTS = (".yaml", ".yml")


@dataclass
class LoadedLibrary:
    """One validated pattern library ready for matching."""

    name: str
    path: Optional[str] = None
    patterns: list[Pattern] = field(default_factory=list)
    skipped: int = 0  # patterns dropped for malformed regexes


def discover_library_files(cache_dir: str | Path) -> list[Path]:
    """All pattern YAML files under the cache, sorted for determinism
    (reference walks with Files.walk, PatternSyncService.java:94-107)."""
    root = Path(cache_dir)
    if not root.is_dir():
        return []
    return sorted(
        p for p in root.rglob("*") if p.is_file() and p.suffix.lower() in _YAML_EXTS
    )


def available_libraries(cache_dir: str | Path) -> list[str]:
    """Advertised library names: ``metadata.library_id`` when declared, else
    the file stem (the reference only knows stems —
    PatternSyncService.java:94-107; we honour the declared id so the name a
    user sees in status is the name that works in ``enabledLibraries``)."""
    names = set()
    for path in discover_library_files(cache_dir):
        names.add(load_library_file(path).name)
    return sorted(names)


def _validate_pattern(pattern: Pattern, source: str) -> bool:
    """Compile every regex once; reject the pattern if any is malformed or if
    it has no matchable primary at all."""
    primary = pattern.primary_pattern
    if primary is None or (not primary.regex and not primary.keywords):
        log.warning("pattern %r in %s has no primary regex/keywords; skipping",
                    pattern.id or pattern.name, source)
        return False
    try:
        primary.compiled()
        for secondary in pattern.secondary_patterns:
            secondary.compiled()
    except re.error as exc:
        log.warning("pattern %r in %s has malformed regex (%s); skipping",
                    pattern.id or pattern.name, source, exc)
        return False
    return True


def load_library_file(path: str | Path) -> LoadedLibrary:
    path = Path(path)
    try:
        parsed = PatternLibraryFile.load(path)
    except Exception as exc:  # malformed YAML: empty library, not a crash
        log.warning("failed to load pattern library %s: %s", path, exc)
        return LoadedLibrary(name=path.stem, path=str(path), patterns=[], skipped=0)
    kept, skipped = [], 0
    for pattern in parsed.patterns:
        if _validate_pattern(pattern, str(path)):
            kept.append(pattern)
        else:
            skipped += 1
    return LoadedLibrary(
        name=parsed.metadata.library_id or path.stem,
        path=str(path),
        patterns=kept,
        skipped=skipped,
    )


def load_libraries(
    cache_dir: str | Path,
    enabled: Optional[Iterable[str]] = None,
) -> list[LoadedLibrary]:
    """Load every library under the cache; ``enabled`` (from
    PatternLibrary.spec.enabledLibraries, patternlibrary-crd.yaml:46-50)
    filters by the advertised library name (``metadata.library_id`` or file
    stem) when non-empty."""
    enabled_set = {e for e in enabled} if enabled else None
    libraries = []
    for path in discover_library_files(cache_dir):
        lib = load_library_file(path)
        if enabled_set is not None and lib.name not in enabled_set and path.stem not in enabled_set:
            continue
        if lib.patterns or lib.skipped:
            libraries.append(lib)
    return libraries


def builtin_library_path() -> str:
    """The pattern library shipped with the framework (common Kubernetes /
    JVM / Python failure modes) — used when no PatternLibrary CR is synced."""
    return os.path.join(os.path.dirname(__file__), "builtin", "kubernetes-common.yaml")


def load_builtin_library() -> LoadedLibrary:
    return load_library_file(builtin_library_path())
