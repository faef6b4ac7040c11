"""Llama-family building blocks in PyTorch.

Port of the pieces of ``operator_tpu/models/llama.py`` that the mixed
serving step runs: ``rms_norm`` (f32 accumulation), ``rope_frequencies``
(with Llama-3.1 ``rope_scaling``), ``apply_rope`` (HF rotate-half),
``_PROJ_BIAS`` and ``init_params``, plus :func:`params_from_jax`, the
bridge that turns a JAX parameter tree (as numpy arrays) into the port's
tensors so both packages can run the same weights.

Weight layout is the JAX package's: every projection is stored
``[in_features, out_features]`` and the seven layer matrices are stacked
on a leading ``num_layers`` axis, so the forward pass is always
``x @ W[layer]``.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
import torch

from .configs import ModelConfig

Params = dict[str, Any]

#: projections that carry a bias vector when config.attention_bias (Qwen2)
_PROJ_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv"}

__all__ = [
    "apply_rope",
    "init_params",
    "layer_matrix_shapes",
    "params_from_jax",
    "rms_norm",
    "rope_frequencies",
]


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------


def layer_matrix_shapes(config: ModelConfig) -> dict[str, tuple[int, int, int]]:
    """Stacked shapes of the seven per-layer matrices."""
    h, f = config.hidden_size, config.intermediate_size
    kvh, qh, d = config.num_kv_heads, config.num_heads, config.head_dim
    n = config.num_layers
    return {
        "wq": (n, h, qh * d),
        "wk": (n, h, kvh * d),
        "wv": (n, h, kvh * d),
        "wo": (n, qh * d, h),
        "w_gate": (n, h, f),
        "w_up": (n, h, f),
        "w_down": (n, f, h),
    }


def _dense_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    """Normal init scaled by fan-in (the second-to-last axis)."""
    scale = shape[-2] ** -0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(scale).to(dtype)


def init_params(
    config: ModelConfig,
    gen: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device: Union[str, torch.device] = "cuda",
    quantize: bool = False,
) -> Params:
    """Random init with per-layer params stacked on axis 0.

    The draws come from ``gen`` (a ``torch.Generator`` on ``device``);
    they are not the JAX package's draws from the same seed — tests that
    compare the two packages build the weights once and convert them with
    :func:`params_from_jax`.  ``quantize=True`` quantizes each layer
    matrix stack as soon as it is drawn, so the float tree never exists
    whole beside the int8 one.
    """
    from .quant import quantize_matrix

    device = torch.device(device)
    h, n = config.hidden_size, config.num_layers
    layers: dict[str, Any] = {}
    for name, shape in layer_matrix_shapes(config).items():
        w = _dense_init(gen, shape, dtype, device)
        layers[name] = quantize_matrix(w) if quantize else w
        del w
    layers["ln_attn"] = torch.ones((n, h), dtype=dtype, device=device)
    layers["ln_mlp"] = torch.ones((n, h), dtype=dtype, device=device)
    if config.attention_bias:
        d, kvh, qh = config.head_dim, config.num_kv_heads, config.num_heads
        layers["bq"] = torch.zeros((n, qh * d), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((n, kvh * d), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((n, kvh * d), dtype=dtype, device=device)
    params: Params = {
        "embed": _dense_init(gen, (config.vocab_size, h), dtype, device),
        "layers": layers,
        "ln_final": torch.ones((h,), dtype=dtype, device=device),
    }
    if not config.tie_embeddings:
        params["lm_head"] = _dense_init(gen, (h, config.vocab_size), dtype, device)
    return params


def _tensor_from_numpy(array: Any, device: torch.device) -> torch.Tensor:
    """One leaf across the bridge.  bf16 (an ``ml_dtypes`` dtype numpy
    cannot hand to torch) travels as its raw 16 bits."""
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(array).view(np.uint16)
        return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(array)).to(device)  # a writable copy


def params_from_jax(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """Convert a JAX parameter tree, with leaves as numpy arrays (or
    anything ``np.asarray`` accepts), into the same nested dict of torch
    tensors.  Layouts are kept (stacked ``[L, in, out]`` matrices), int8
    ``{q, s}`` groups survive as groups, and bf16 comes through
    ``ml_dtypes`` bit for bit."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {key: params_from_jax(value, device) for key, value in tree.items()}
    return _tensor_from_numpy(tree, device)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Float32 accumulation regardless of activation dtype."""
    x32 = x.to(torch.float32)
    variance = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(variance + eps)
    return (normed * scale.to(torch.float32)).to(x.dtype)


def rope_frequencies(
    config: ModelConfig, device: Optional[Union[str, torch.device]] = "cpu"
) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (HF half-rotation convention),
    with Llama-3.1-style NTK-by-parts scaling when configured (HF
    ``rope_type: llama3``)."""
    d = config.head_dim
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv_freq = 1.0 / (config.rope_theta ** exponents)
    scaling = config.rope_scaling
    if scaling is None:
        return inv_freq
    wavelen = 2.0 * math.pi / inv_freq
    low_freq_wavelen = scaling.original_max_positions / scaling.low_freq_factor
    high_freq_wavelen = scaling.original_max_positions / scaling.high_freq_factor
    scaled = inv_freq / scaling.factor
    smooth = (scaling.original_max_positions / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_freq_wavelen, scaled, inv_freq)
    mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(mid, smoothed, out)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
) -> torch.Tensor:
    """x: [B, T, ..., head_dim]; positions: [B, T] — HF ``rotate_half``."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # [B, T, d/2]
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    # broadcast over any head axes between T and head_dim
    for _ in range(x.dim() - 3):
        cos = cos.unsqueeze(2)
        sin = sin.unsqueeze(2)
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
