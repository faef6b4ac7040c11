"""Int8 weight-only quantization for serving.

Port of ``operator_tpu/models/quant.py``.  Symmetric per-output-channel
absmax: for a stored ``[in, out]`` matrix ``W``::

    s   = absmax(W, axis=in) / 127          # [out]
    q   = round(W / s)  as int8             # [in, out]
    x @ W  ~  (x @ q) * s                   # scale folds in AFTER the matmul

The seven layer matrices (stacked ``[n_layers, in, out]``) are quantized;
embeddings, lm_head and norms stay in the float dtype.  The product
itself is a plain ``torch.matmul``: the JAX package leaves it to XLA
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Union

import torch

from .configs import ModelConfig

Params = dict[str, Any]

#: layer matrices that get quantized (stored [n_layers, in, out])
QUANTIZED_LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

__all__ = [
    "QUANTIZED_LAYER_MATRICES",
    "dequantize_params",
    "is_quantized",
    "mm",
    "quantize_matrix",
    "quantize_params",
    "quantized_bytes",
]


def is_quantized(params: Params) -> bool:
    """True if ANY layer matrix is an int8 {q, s} group."""
    return any(
        isinstance(leaf, dict) and "q" in leaf
        for leaf in params.get("layers", {}).values()
    )


def dequantize_params(params: Params, dtype: torch.dtype = torch.bfloat16) -> Params:
    """Expand every int8 {q, s} group back to a float matrix (e.g. before
    ``save_params``, whose HF layout has no quantized convention)."""
    layers = {
        name: (
            (leaf["q"].to(torch.float32) * leaf["s"].unsqueeze(-2)).to(dtype)
            if isinstance(leaf, dict) and "q" in leaf
            else leaf
        )
        for name, leaf in params["layers"].items()
    }
    return {**params, "layers": layers}


def quantize_matrix(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """[..., in, out] float -> {q: int8 [..., in, out], s: f32 [..., out]}."""
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=-2)  # [..., out]
    # a divisor on the tensor's device: CUDA multiplies by the reciprocal
    # of a host scalar, so the card would round differently from the CPU
    scale = absmax.clamp_min(1e-8) / torch.full((), 127.0, device=w.device)
    q = torch.round(w32 / scale.unsqueeze(-2)).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_params(params: Params, config: ModelConfig) -> Params:
    """Quantize the layer matrices of a loaded/initialised param tree.
    One matrix stack at a time, so the float transient of only one
    stack is alive beside the int8 tree."""
    del config  # signature parity with the JAX package
    layers = dict(params["layers"])
    for name in QUANTIZED_LAYER_MATRICES:
        layers[name] = quantize_matrix(layers[name])
    return {**params, "layers": layers}


def mm(x: torch.Tensor, w: Union[torch.Tensor, dict[str, torch.Tensor]]) -> torch.Tensor:
    """``x @ W`` for plain or quantized weights: the int8 matrix is cast
    to the activation dtype going into the product and the per-channel
    scale folds into the result."""
    if isinstance(w, dict):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def quantized_bytes(params: Params) -> int:
    """Bytes of every tensor in the tree (int8 groups at their int8 size)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(leaf) for leaf in params.values())
    return params.numel() * params.element_size()
