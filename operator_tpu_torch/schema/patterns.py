"""Pattern-library YAML schema.

Copy of ``operator_tpu/schema/patterns.py``.

The reference never shows the pattern file format — it lives in the unseen
``log-parser`` sibling repo; all that is structurally visible is: YAML files,
one library per file, and that matched patterns carry name/severity/score
(reference PatternSyncService.java:94-107, AnalysisStorageService.java:314-323).
We therefore define a compatible schema (SURVEY.md §2.2) with enough structure
for both the CPU regex scorer and the TPU semantic matcher:

```yaml
metadata:
  library_id: quarkus-patterns
  version: "1.0"
patterns:
  - id: port-conflict
    name: "Port already in use"
    severity: HIGH
    category: startup
    primary_pattern:
      regex: 'Port \\d+ already in use'
      confidence: 0.9
    secondary_patterns:
      - regex: 'java\\.net\\.BindException'
        weight: 0.5
        proximity_window: 20
    semantic_text: "server failed to start because the TCP port was taken"
    context_extraction: {lines_before: 5, lines_after: 3}
    remediation:
      description: "Another process owns the port..."
      common_causes: [...]
      suggested_commands: [...]
```
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from .analysis import Severity
from .serde import from_dict, to_dict


@dataclass
class PrimaryPattern:
    regex: Optional[str] = None
    keywords: list[str] = field(default_factory=list)  # all must appear in a line
    confidence: float = 1.0

    def compiled(self) -> Optional[re.Pattern]:
        if not self.regex:
            return None
        return _compile_cached(self.regex)


@dataclass
class SecondaryPattern:
    """Corroborating evidence near the primary match; adds ``weight`` to the
    score when found within ``proximity_window`` lines."""

    regex: Optional[str] = None
    weight: float = 0.5
    proximity_window: int = 20

    def compiled(self) -> Optional[re.Pattern]:
        if not self.regex:
            return None
        return _compile_cached(self.regex)


@dataclass
class ContextExtraction:
    lines_before: int = 5
    lines_after: int = 3


@dataclass
class Remediation:
    description: Optional[str] = None
    common_causes: list[str] = field(default_factory=list)
    suggested_commands: list[str] = field(default_factory=list)
    documentation_links: list[str] = field(default_factory=list)


@dataclass
class Pattern:
    id: Optional[str] = None
    name: Optional[str] = None
    severity: str = "MEDIUM"
    category: Optional[str] = None
    primary_pattern: Optional[PrimaryPattern] = None
    secondary_patterns: list[SecondaryPattern] = field(default_factory=list)
    semantic_text: Optional[str] = None  # embedding anchor for the TPU matcher
    context_extraction: ContextExtraction = field(default_factory=ContextExtraction)
    remediation: Optional[Remediation] = None

    @property
    def severity_enum(self) -> Severity:
        return Severity.parse(self.severity)

    def anchor_text(self) -> str:
        """Text embedded for semantic matching: explicit anchor, else
        name + remediation description."""
        if self.semantic_text:
            return self.semantic_text
        parts = [self.name or self.id or ""]
        if self.remediation and self.remediation.description:
            parts.append(self.remediation.description)
        return ". ".join(p for p in parts if p)


@dataclass
class LibraryMetadata:
    library_id: Optional[str] = None
    version: Optional[str] = None
    description: Optional[str] = None


@dataclass
class PatternLibraryFile:
    """One YAML file == one library (reference PatternSyncService.java:94-107
    strips the extension to get the library name)."""

    metadata: LibraryMetadata = field(default_factory=LibraryMetadata)
    patterns: list[Pattern] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return to_dict(self)

    @classmethod
    def parse(cls, data: dict[str, Any]) -> "PatternLibraryFile":
        return from_dict(cls, data)

    @classmethod
    def load(cls, path) -> "PatternLibraryFile":
        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        lib = cls.parse(data)
        if not lib.metadata.library_id:
            import os

            lib.metadata.library_id = os.path.splitext(os.path.basename(str(path)))[0]
        return lib

    def dump(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


_REGEX_CACHE: dict[str, re.Pattern] = {}


def _compile_cached(pattern: str) -> re.Pattern:
    compiled = _REGEX_CACHE.get(pattern)
    if compiled is None:
        compiled = re.compile(pattern)
        _REGEX_CACHE[pattern] = compiled
    return compiled
