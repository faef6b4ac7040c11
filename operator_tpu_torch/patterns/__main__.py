"""CLI entry: ``python -m operator_tpu_torch.patterns [logfile ...]``."""

from .engine import _main

if __name__ == "__main__":
    raise SystemExit(_main())
