"""The port's serving path: continuous scheduler, engine, HTTP front.

``prompts`` is model-free and re-exported here; the engine, the KV
caches and the ``tpu-native`` provider live in the sibling modules.
"""

from .prompts import DEFAULT_TEMPLATE, build_prompt

__all__ = [
    "DEFAULT_TEMPLATE",
    "build_prompt",
]
