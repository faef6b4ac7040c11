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

:func:`parity_report` is the gate that licenses int8 as the serving
default: greedy tokens of the float and the int8 tree, and the
teacher-forced logit error along the float path's tokens.
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
    "init_params_quantized",
    "is_quantized",
    "mm",
    "parity_report",
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


class _Int8MatMul(torch.autograd.Function):
    """``(x @ q) * s`` under autograd, saving the int8 ``q`` and its scale
    rather than the activation-dtype copy of ``q`` that a plain product
    would save for its backward pass (for llama-3-8b, about 14 GB of bf16
    beside 7 GB of int8).  The backward pass casts ``q`` again.  The base
    is frozen: no gradient flows to ``q`` or ``s``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, s)
        return (x @ q.to(x.dtype)) * s.to(x.dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> tuple:
        q, s = ctx.saved_tensors
        return (grad * s.to(grad.dtype)) @ q.to(grad.dtype).transpose(-1, -2), None, None


def mm(x: torch.Tensor, w: Union[torch.Tensor, dict[str, torch.Tensor]]) -> torch.Tensor:
    """``x @ W`` for plain or quantized weights: the int8 matrix is cast
    to the activation dtype going into the product and the per-channel
    scale folds into the result.  Where ``x`` needs a gradient, the int8
    product runs through :class:`_Int8MatMul`, which keeps the base
    int8 between the forward and the backward pass."""
    if isinstance(w, dict):
        if x.requires_grad and torch.is_grad_enabled():
            return _Int8MatMul.apply(x, w["q"], w["s"])
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def quantized_bytes(params: Params) -> int:
    """Bytes of every tensor in the tree (int8 groups at their int8 size)."""
    if isinstance(params, dict):
        return sum(quantized_bytes(leaf) for leaf in params.values())
    return params.numel() * params.element_size()


def init_params_quantized(
    config: ModelConfig, gen: torch.Generator, dtype: torch.dtype = torch.bfloat16,
    *, device: Union[str, torch.device] = "cuda",
) -> Params:
    """Random-init an already-quantized tree without the float tree ever
    existing whole: each layer matrix stack is drawn and quantized before
    the next is drawn, so the peak is the int8 tree plus one float stack
    (``models/llama.py:init_params(quantize=True)``)."""
    from .llama import init_params

    return init_params(config, gen, dtype, device=device, quantize=True)


def parity_report(
    params_float: Params,
    params_quant: Params,
    config: ModelConfig,
    prompts: "list[list[int]]",
    *,
    max_new_tokens: int = 16,
) -> dict:
    """The int8-by-default parity gate.

    Greedy-decodes each token-id prompt under the float and the quantized
    params and reports ``greedy_match`` (every prompt produced the same
    tokens), ``prompts``, ``mismatched_prompts`` and ``max_logit_diff``:
    the largest absolute difference between the two logit streams along
    the float path's greedy tokens (teacher-forced, so the comparison
    stays step-aligned even where an argmax near-tie flips a token).
    Tiny models must pass ``greedy_match``; 1B-class configs gate on
    ``max_logit_diff`` under an absolute threshold.  The tensors' device
    is the params' own."""
    from .llama import forward

    device = params_float["embed"].device

    @torch.no_grad()
    def last_logits(params: Params, ids: list) -> torch.Tensor:
        # cache-free full-sequence forward per step: O(T^2), but it runs
        # the serving numerics on the gate's short prompts
        arr = torch.tensor([ids], dtype=torch.int32, device=device)
        pos = torch.arange(len(ids), dtype=torch.int32, device=device)[None]
        logits, _ = forward(params, config, arr, pos)
        return logits[0, -1]

    def greedy(params: Params, prompt: list) -> "tuple[list[int], list[torch.Tensor]]":
        ids = list(prompt)
        toks: list[int] = []
        steps: list[torch.Tensor] = []
        for _ in range(max_new_tokens):
            logits = last_logits(params, ids)
            steps.append(logits)
            tok = int(torch.argmax(logits))
            toks.append(tok)
            ids.append(tok)
        return toks, steps

    def forced(params: Params, prompt: list, driven: list) -> "list[torch.Tensor]":
        # teacher-forced along the float path's tokens
        ids = list(prompt)
        steps: list[torch.Tensor] = []
        for tok in driven:
            steps.append(last_logits(params, ids))
            ids.append(tok)
        return steps

    matches = []
    max_diff = 0.0
    for prompt in prompts:
        float_toks, float_steps = greedy(params_float, prompt)
        quant_toks, _ = greedy(params_quant, prompt)
        matches.append(quant_toks == float_toks)
        quant_steps = forced(params_quant, prompt, float_toks)
        for a, b in zip(float_steps, quant_steps):
            diff = float((a.to(torch.float32) - b.to(torch.float32)).abs().max())
            max_diff = max(max_diff, diff)
    return {
        "greedy_match": all(matches),
        "prompts": len(prompts),
        "mismatched_prompts": sum(1 for m in matches if not m),
        "max_logit_diff": max_diff,
    }
