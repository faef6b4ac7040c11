"""Multi-literal scanner of the literal prefilter (``patterns/prefilter.py``).

Copy of the pure-Python scanner of ``operator_tpu/native/__init__.py``
(``_PyScanner``): one ``bytes.find`` sweep per literal.  The JAX package
also builds ``native/logscan.cpp`` (Aho-Corasick, one pass) into a shared
library when a compiler is present; the port has no such build yet.  The
two find the same hits, so the prefilter's candidates are the same either
way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["MultiPatternScanner"]


class MultiPatternScanner:
    """Find all occurrences of N byte literals in a text.

    ``scan_arrays`` returns (literal ids [N] int32, end offsets [N] int64),
    literal by literal, each literal's hits in text order."""

    #: the JAX scanner's flag for its C++ automaton (logged by the engine)
    native = False

    def __init__(self, literals: Sequence[bytes]) -> None:
        self.literals = list(literals)

    def scan_arrays(self, text: bytes) -> tuple[np.ndarray, np.ndarray]:
        ids: list[int] = []
        offsets: list[int] = []
        for literal_id, literal in enumerate(self.literals):
            if not literal:
                continue
            start = text.find(literal)
            while start >= 0:
                ids.append(literal_id)
                offsets.append(start + len(literal) - 1)
                start = text.find(literal, start + 1)
        return np.asarray(ids, np.int32), np.asarray(offsets, np.int64)

    def scan(self, text: bytes) -> list[tuple[int, int]]:
        ids, offsets = self.scan_arrays(text)
        return [(int(i), int(o)) for i, o in zip(ids, offsets)]
