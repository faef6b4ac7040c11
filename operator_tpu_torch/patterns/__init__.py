"""Pattern-match engine of the port: the analysis path.

Port of ``operator_tpu/patterns``.  CPU path: regex/keyword scoring
(`matcher`, behind the literal `prefilter`).  Device path: embedding
similarity over pattern anchors (`semantic`, with the MiniLM encoder and
the best-window similarity kernel)."""

from .engine import PatternEngine, event_evidence_lines, status_evidence_lines
from .loader import (
    LoadedLibrary,
    available_libraries,
    builtin_library_path,
    discover_library_files,
    load_builtin_library,
    load_libraries,
    load_library_file,
)
from .matcher import MatcherConfig, match_libraries, match_pattern, summarize
from .windows import LogWindow, context_window, iter_windows, split_lines, tail_chars

__all__ = [name for name in dir() if not name.startswith("_")]
