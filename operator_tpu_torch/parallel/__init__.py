"""Mesh and sharding layer (``mesh.py``), sharded training (``train.py``)
and LoRA adapters (``lora.py``), on ``torch.distributed``: every name of
the JAX package's ``operator_tpu/parallel``.

LoRA's serving half is imported here at once; the mesh and training
names import ``torch.distributed.tensor`` and load on first use, so
serving, which needs only the adapters, does not pay for them.
"""

import importlib

from .lora import (
    DEFAULT_TARGETS,
    apply_lora,
    init_lora,
    load_lora,
    lora_param_count,
    lora_shardings,
    lora_specs,
    make_lora_train_step,
    merge_lora,
    save_lora,
    stack_adapters,
    zero_lora,
)

#: names that load their module on first use
_LAZY = {
    **dict.fromkeys(
        ("AXES", "MeshPlan", "P", "ServingShard", "batch_spec", "initialize_distributed",
         "kv_cache_spec", "launched", "logits_spec", "make_mesh", "mesh_summary",
         "paged_cache_specs", "param_shardings", "param_specs", "placements", "plan_for",
         "shard_params", "validate_param_shardings", "validate_serving_mesh"),
        "mesh"),
    **dict.fromkeys(
        ("TrainState", "adam_moments", "load_train_state", "make_optimizer", "make_train_step",
         "next_token_loss", "save_train_state", "sharded_forward"),
        "train"),
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


__all__ = sorted([
    "DEFAULT_TARGETS",
    "apply_lora",
    "init_lora",
    "load_lora",
    "lora_param_count",
    "lora_shardings",
    "lora_specs",
    "make_lora_train_step",
    "merge_lora",
    "save_lora",
    "stack_adapters",
    "zero_lora",
    *_LAZY,
])
