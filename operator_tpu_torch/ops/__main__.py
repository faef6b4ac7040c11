"""Build every kernel library of the port, and the literal scanner,
ahead of time:

    OPERATOR_TPU_TORCH_BUILD_DIR=/opt/operator-tpu-torch/kernels \\
        python -m operator_tpu_torch.ops

``Dockerfile.torch``'s build stage runs it on a CUDA devel image: ``nvcc``
for ``sm_90a`` (one per source, all started together,
:func:`._build.build_all`) and ``g++`` for ``native/logscan.cpp``, no
card needed.  The runtime image copies the directory and names it in
``OPERATOR_TPU_TORCH_BUILD_DIR``, so a pod loads each library by its
source hash and never runs a compiler.  Prints one JSON line (the
directory, each library, the seconds) and exits 1 when a library is
missing after the build.
"""

from __future__ import annotations

import json
import sys
import time


def main() -> int:
    from .. import native
    from . import _build

    started = time.perf_counter()
    _build.build_all()
    scanner = native.library_path() if native._build_library() is not None else None
    libraries = [_build.library_path(name) for name in _build.source_names()]
    missing = [str(p) for p in libraries if not p.is_file()]
    if scanner is None:
        missing.append("liblogscan (g++ or native/logscan.cpp missing)")
    print(json.dumps({
        "build_dir": str(_build.build_dir()),
        "libraries": [p.name for p in libraries] + ([scanner.name] if scanner else []),
        "seconds": time.perf_counter() - started,
        "missing": missing,
    }), flush=True)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
