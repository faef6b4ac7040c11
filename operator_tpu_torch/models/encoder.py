"""BERT-style sentence encoder (all-MiniLM-L6-v2 class) in PyTorch.

Port of ``operator_tpu/models/encoder.py``: the encoder that embeds log
windows and pattern descriptions into one vector space for the semantic
pattern path.  Architecture per the public MiniLM config (6 post-LN
transformer layers, hidden 384, 12 heads of 32, exact-GELU MLP of 1,536,
512 positions), with the sentence-transformers convention on top: masked
mean pooling then L2 normalisation, so cosine similarity is a dot product
and the similarity kernel (``ops/similarity.py``) needs no normalisation
pass.

Plain functions over a params dict, as ``models/llama.py``: per-layer
params stacked on a leading axis (the JAX package's layout, so
:func:`params_from_jax` carries its trees across), and the JAX
``lax.scan`` over that axis becomes a loop.  Every projection is stored
``[in_features, out_features]``.  LayerNorm statistics are f32; the
attention is plain einsum/softmax (the JAX package has no Pallas kernel
here either).  The HF checkpoint conversion and its loader are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Union

import torch
import torch.nn.functional as F

from .llama import params_from_jax

Params = dict[str, Any]

__all__ = [
    "ENCODER_TINY_TEST",
    "MINILM_L6",
    "EncoderConfig",
    "encode",
    "encode_tokens",
    "init_encoder_params",
    "params_from_jax",
]

#: additive key mask of padded positions (finite, as in the JAX package)
_MASKED = -1e30


@dataclass(frozen=True)
class EncoderConfig:
    name: str
    vocab_size: int = 30522
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 6
    num_heads: int = 12
    max_positions: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


MINILM_L6 = EncoderConfig(name="minilm-l6")

#: laptop-sized config for tests (real architecture, tiny widths)
ENCODER_TINY_TEST = EncoderConfig(
    name="encoder-tiny-test",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    max_positions=128,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_encoder_params(
    config: EncoderConfig,
    gen: torch.Generator,
    dtype: torch.dtype = torch.float32,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Random init with the JAX package's shapes and scales (normal scaled
    by fan-in, the second-to-last axis; biases 0, norm scales 1).  The
    draws come from ``gen`` (a ``torch.Generator`` on ``device``), not the
    JAX draws from the same seed: tests that compare the two packages
    convert the JAX tree with :func:`params_from_jax`."""
    device = torch.device(device)
    h, f, n = config.hidden_size, config.intermediate_size, config.num_layers

    def dense(*shape: int) -> torch.Tensor:
        out = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return out.mul_(shape[-2] ** -0.5).to(dtype)

    def const(value: float, *shape: int) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {
        "wq": dense(n, h, h),
        "bq": const(0.0, n, h),
        "wk": dense(n, h, h),
        "bk": const(0.0, n, h),
        "wv": dense(n, h, h),
        "bv": const(0.0, n, h),
        "wo": dense(n, h, h),
        "bo": const(0.0, n, h),
        "ln_attn_scale": const(1.0, n, h),
        "ln_attn_bias": const(0.0, n, h),
        "w_in": dense(n, h, f),
        "b_in": const(0.0, n, f),
        "w_out": dense(n, f, h),
        "b_out": const(0.0, n, h),
        "ln_mlp_scale": const(1.0, n, h),
        "ln_mlp_bias": const(0.0, n, h),
    }
    return {
        "tok_embed": dense(config.vocab_size, h),
        "pos_embed": dense(config.max_positions, h),
        "type_embed": dense(config.type_vocab_size, h),
        "ln_embed_scale": const(1.0, h),
        "ln_embed_bias": const(0.0, h),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """f32 statistics regardless of the activation dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def encode_tokens(
    params: Params,
    config: EncoderConfig,
    token_ids: torch.Tensor,  # [B, T] integer
    attention_mask: torch.Tensor,  # [B, T] 1 for real tokens
) -> torch.Tensor:
    """Token-level hidden states [B, T, H] (post-LN BERT stack)."""
    b, t = token_ids.shape
    x = (
        params["tok_embed"][token_ids.long()]
        + params["pos_embed"][None, :t]
        + params["type_embed"][0][None, None, :]
    )
    x = _layer_norm(x, params["ln_embed_scale"], params["ln_embed_bias"], config.layer_norm_eps)

    nh, d = config.num_heads, config.head_dim
    # additive mask [B, 1, 1, T]: padded keys get -1e30 before the softmax
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, _MASKED).to(torch.float32)

    layers = params["layers"]
    for i in range(layers["wq"].shape[0]):
        w = {name: stacked[i] for name, stacked in layers.items()}
        q = (x @ w["wq"] + w["bq"]).reshape(b, t, nh, d)
        k = (x @ w["wk"] + w["bk"]).reshape(b, t, nh, d)
        v = (x @ w["wv"] + w["bv"]).reshape(b, t, nh, d)
        scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32), k.to(torch.float32))
        scores = scores * (d**-0.5) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, nh * d)
        x = _layer_norm(
            x + attn @ w["wo"] + w["bo"], w["ln_attn_scale"], w["ln_attn_bias"],
            config.layer_norm_eps,
        )
        mlp = F.gelu(x @ w["w_in"] + w["b_in"], approximate="none")
        x = _layer_norm(
            x + mlp @ w["w_out"] + w["b_out"], w["ln_mlp_scale"], w["ln_mlp_bias"],
            config.layer_norm_eps,
        )
    return x


def encode(
    params: Params,
    config: EncoderConfig,
    token_ids: torch.Tensor,
    attention_mask: torch.Tensor,
) -> torch.Tensor:
    """Sentence embeddings [B, H] f32: masked mean pool + L2 normalise
    (norm floored at 1e-12, so an all-padding row comes out as zeros)."""
    hidden = encode_tokens(params, config, token_ids, attention_mask)
    mask = attention_mask[..., None].to(torch.float32)
    summed = (hidden.to(torch.float32) * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1.0)
    pooled = summed / counts
    return pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
