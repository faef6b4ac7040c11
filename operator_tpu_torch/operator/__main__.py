"""CLI entry: ``python -m operator_tpu_torch.operator [--demo]``."""

from .app import _main

if __name__ == "__main__":
    raise SystemExit(_main())
