"""Adapters over the model's weights: LoRA's serving half (``lora.py``).
The mesh and training layers of ``operator_tpu/parallel`` are not ported
(ROADMAP Queue 1 item 11)."""

from .lora import (
    DEFAULT_TARGETS,
    apply_lora,
    init_lora,
    load_lora,
    lora_param_count,
    merge_lora,
    save_lora,
    stack_adapters,
    zero_lora,
)

__all__ = [
    "DEFAULT_TARGETS",
    "apply_lora",
    "init_lora",
    "load_lora",
    "lora_param_count",
    "merge_lora",
    "save_lora",
    "stack_adapters",
    "zero_lora",
]
