"""LoRA adapters: init, merge, stack, save and load, and training.

Port of ``operator_tpu/parallel/lora.py``.  An adapter trains only
rank-r factors per projection::

    W_eff = W + (alpha / r) * A @ B      A: [in, r]   B: [r, out]

Adapters follow the stacked ``[n_layers, ...]`` layout of
``models/llama.py``: each target holds ``{"a": [L, in, r], "b": [L, r,
out]}``.  Serving many adapters at once stacks them
(:func:`stack_adapters`, ``[L, n_adapters, ...]``, the all-zeros adapter
at index 0) and each batch row picks its own inside the model's
projections (``models/llama.py:_lora_path``), never expanding a delta
matrix.  :func:`merge_lora` folds one adapter into the weights once, the
reference the stacked path is held to.

Training (:func:`make_lora_train_step`) threads the factors through
``forward(lora=...)`` over a frozen base, which may be int8, so
gradients exist for the rank-r factors alone; the adapters rest on the
mesh at :func:`lora_specs`, derived from each base matrix's spec (A
takes the base fan-in axis, B the fan-out axis).

Files are one safetensors file per adapter, tensors named
``lora.{target}.{a|b}``, written and read through ``models/loader.py``
in the JAX package's byte layout.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Any, Optional, Sequence, Union

import torch

from ..models.configs import ModelConfig
from ..models.llama import Params, layer_matrix_shapes
from ..models.loader import read_safetensors, write_safetensors

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

    from .train import OptimizerFactory

__all__ = [
    "DEFAULT_TARGETS",
    "LoraParams",
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
]

#: default adaptation targets: attention in/out projections — the standard
#: LoRA placement; add mlp names for higher-capacity adaptation
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")

LoraParams = dict[str, dict[str, torch.Tensor]]

Device = Union[str, torch.device]


def _checked_targets(config: ModelConfig, targets: Sequence[str]) -> dict:
    shapes = layer_matrix_shapes(config)
    unknown = set(targets) - set(shapes)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}")
    return shapes


def init_lora(
    config: ModelConfig,
    gen: torch.Generator,
    *,
    rank: int = 16,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.bfloat16,
    device: Device = "cuda",
) -> LoraParams:
    """A ~ N(0, 1/r) and B = 0, so W_eff == W at step 0 (standard LoRA).
    The draws come from ``gen`` (a ``torch.Generator`` on ``device``)."""
    shapes = _checked_targets(config, targets)
    adapters: LoraParams = {}
    for name in targets:
        n, fan_in, fan_out = shapes[name]
        a = torch.randn(
            (n, fan_in, rank), generator=gen, dtype=torch.float32, device=device
        ) * rank ** -0.5
        adapters[name] = {
            "a": a.to(dtype),
            "b": torch.zeros((n, rank, fan_out), dtype=dtype, device=device),
        }
    return adapters


def zero_lora(
    config: ModelConfig,
    *,
    rank: int = 16,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype: torch.dtype = torch.bfloat16,
    device: Device = "cuda",
) -> LoraParams:
    """An all-zeros adapter: W_eff == W exactly.  Index 0 of every stacked
    multi-adapter batch, so un-adapted rows ride the same pass."""
    shapes = _checked_targets(config, targets)
    return {
        name: {
            "a": torch.zeros((shapes[name][0], shapes[name][1], rank),
                             dtype=dtype, device=device),
            "b": torch.zeros((shapes[name][0], rank, shapes[name][2]),
                             dtype=dtype, device=device),
        }
        for name in targets
    }


def lora_param_count(adapters: LoraParams) -> int:
    return sum(int(t.numel()) for factors in adapters.values() for t in factors.values())


def _delta(adapter: dict[str, torch.Tensor], alpha: float) -> torch.Tensor:
    """The full f32 ``[L, in, out]`` delta ``A @ B * alpha / r``."""
    rank = adapter["a"].shape[-1]
    return torch.einsum(
        "nir,nro->nio", adapter["a"].to(torch.float32), adapter["b"].to(torch.float32)
    ) * (alpha / rank)


def apply_lora(params: Params, adapters: LoraParams, *, alpha: float = 16.0) -> Params:
    """Params with each adapted matrix merged.  A quantized base matrix is
    dequantized, merged and kept float in the adapter's dtype (merging
    into int8 would quantize the delta away at small ranks); a float one
    keeps its dtype."""
    layers = dict(params["layers"])
    for name, adapter in adapters.items():
        base = layers[name]
        delta = _delta(adapter, alpha)
        if isinstance(base, dict):  # quantized {q, s}
            dequant = base["q"].to(torch.float32) * base["s"][:, None, :]
            layers[name] = (dequant + delta).to(adapter["a"].dtype)
        else:
            layers[name] = (base.to(torch.float32) + delta).to(base.dtype)
    return {**params, "layers": layers}


def merge_lora(params: Params, adapters: LoraParams, *, alpha: float = 16.0) -> Params:
    """Eager merge for serving one adapter as plain weights (the JAX
    package jits :func:`apply_lora`; here it is the same eager code)."""
    return apply_lora(params, adapters, alpha=alpha)


def stack_adapters(adapters: Sequence[LoraParams]) -> LoraParams:
    """Stack adapters for per-request serving: each leaf becomes
    ``[n_layers, n_adapters, ...]`` — the LAYER axis stays leading, so the
    model's layer loop slices it and hands the per-layer ``[n_adapters,
    ...]`` factors to the per-row gather (``models/llama.py``
    ``lora_indices``).  All adapters must share targets and rank."""
    if not adapters:
        raise ValueError("need at least one adapter")
    first = adapters[0]
    for other in adapters[1:]:
        if set(other) != set(first):
            raise ValueError(
                f"adapters must share targets: {sorted(other)} vs {sorted(first)}"
            )
        for name in first:
            for factor in ("a", "b"):
                if other[name][factor].shape != first[name][factor].shape:
                    raise ValueError(
                        f"adapter rank/shape mismatch on {name}.{factor}: "
                        f"{tuple(other[name][factor].shape)} vs "
                        f"{tuple(first[name][factor].shape)}"
                    )
    return {
        name: {
            factor: torch.stack([ad[name][factor] for ad in adapters], dim=1)
            for factor in ("a", "b")
        }
        for name in first
    }


def save_lora(adapters: LoraParams, path: str) -> None:
    """Write an adapter as one safetensors file (``lora.{target}.{a|b}``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat: dict[str, Any] = {}
    for name, factors in adapters.items():
        for factor, value in factors.items():
            flat[f"lora.{name}.{factor}"] = value.detach().cpu()
    write_safetensors(path, flat)


def load_lora(
    path: str, dtype: torch.dtype = torch.bfloat16, device: Device = "cuda"
) -> LoraParams:
    """Read an adapter file written by :func:`save_lora` or by the JAX
    package's; raises ``ValueError`` for a file that is not one."""
    adapters: LoraParams = {}
    for key, value in read_safetensors(path):
        parts = key.split(".")
        if len(parts) != 3 or parts[0] != "lora" or parts[2] not in ("a", "b"):
            raise ValueError(f"not a LoRA adapter file: unexpected key {key!r}")
        adapters.setdefault(parts[1], {})[parts[2]] = value.to(device=device, dtype=dtype)
    for name, factors in adapters.items():
        if set(factors) != {"a", "b"}:
            raise ValueError(f"adapter target {name!r} is missing a factor")
    return adapters


# --------------------------------------------------------------------------
# training (the mesh modules import torch.distributed.tensor, so they are
# imported here only when training asks for them, not by serving)
# --------------------------------------------------------------------------


def lora_specs(config: ModelConfig, targets: Sequence[str]) -> Any:
    """Specs for adapter factors, derived from each base matrix's spec
    (``mesh.param_specs``): A takes the base fan-in axis, B the base
    fan-out axis, so column-parallel wq/wk/wv (in on fsdp, out on tp)
    and row-parallel wo/w_down (in on tp, out on fsdp) both merge without
    resharding a full-size matrix."""
    from .mesh import P, param_specs

    base = param_specs(config)["layers"]  # plain (unquantized) matrix specs
    return {
        name: {"a": P(None, base[name][1], None),  # [n, in, r]
               "b": P(None, None, base[name][2])}  # [n, r, out]
        for name in targets
    }


def lora_shardings(mesh: DeviceMesh, adapters: LoraParams, config: ModelConfig) -> Any:
    """The placements of every adapter factor on ``mesh``."""
    from .mesh import placements, tree_map

    return tree_map(lambda spec: placements(spec, mesh), lora_specs(config, tuple(adapters)))


def make_lora_train_step(
    config: ModelConfig,
    mesh: DeviceMesh,
    *,
    alpha: float = 16.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    quantized_base: bool = False,
    optimizer: Optional[OptimizerFactory] = None,
):
    """Returns ``(init_state, train_step)``: trains only the adapters.

    ``init_state(adapters)`` copies the factors onto :func:`lora_specs`
    and zeroes their moments there.  ``train_step(state, base_params,
    token_ids, loss_mask)`` returns ``(state, loss)``: the forward
    threads the rank-r factors through ``forward(lora=...)`` (no delta
    matrix, no full-rank gradient), so what trains is the factors and
    their moments.  The base is frozen and never written; it is placed
    (``param_shardings(..., quantized=quantized_base)``) or whole, and
    ``quantized_base`` says whether its layer matrices are int8 ``{q,
    s}`` groups.  The input state is consumed, as in
    :func:`~.train.make_train_step`."""
    from .mesh import param_specs, tree_map, tree_structure
    from .train import (
        _apply, _batch_rows, _loss_terms, _start, _value_and_grad, _whole, make_optimizer,
    )

    optimizer = optimizer or make_optimizer()
    base_specs = param_specs(config, quantized=quantized_base)

    def init_state(adapters: LoraParams):
        if set(adapters) != set(targets):
            raise ValueError(f"adapters {sorted(adapters)} do not match the targets "
                             f"{sorted(targets)}")
        return _start(adapters, lora_shardings(mesh, adapters, config), mesh, optimizer)

    def train_step(state, base_params: Params, token_ids: torch.Tensor,
                   loss_mask: torch.Tensor):
        if tree_structure(base_params) != tree_structure(base_specs):
            kind = "an int8" if quantized_base else "a float"
            raise ValueError(f"base_params is not {kind} param tree of {config.name}")
        tokens, mask = _batch_rows(token_ids, mesh), _batch_rows(loss_mask, mesh)
        with torch.no_grad():
            base = tree_map(_whole, base_params)
        loss, grads = _value_and_grad(
            state.params,
            lambda adapters: _loss_terms(base, config, tokens, mask, adapters, alpha),
            mesh,
        )
        return _apply(state, grads), loss

    return init_state, train_step
