"""Device resolution for the port's entry points.

Takes the place of the JAX package's ``utils/platform.py`` and
``ops/_dispatch.py:on_tpu``: an entry point runs on ``cuda`` unless the
caller asks for another device, and it never slides quietly onto the CPU
when no card is present.  Kernel dispatch inside the package keys on
``tensor.is_cuda`` of the inputs, not on this function.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return resolved
