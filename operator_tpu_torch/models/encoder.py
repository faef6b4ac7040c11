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
here either).  :func:`load_encoder_params` reads a HF BERT/MiniLM
safetensors checkpoint (``models/loader.py``'s reader) and
:func:`convert_hf_bert_state_dict` maps its names onto the tree.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .llama import params_from_jax

Params = dict[str, Any]

__all__ = [
    "ENCODER_TINY_TEST",
    "MINILM_L6",
    "EncoderConfig",
    "convert_hf_bert_state_dict",
    "encode",
    "encode_tokens",
    "encoder_config_from_hf_json",
    "init_encoder_params",
    "load_encoder_params",
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


# ---------------------------------------------------------------------------
# HF BERT checkpoint conversion (all-MiniLM-L6-v2 layout)
# ---------------------------------------------------------------------------

_BERT_LAYER_RE = re.compile(r"(?:bert\.)?encoder\.layer\.(\d+)\.(.+)")

#: HF sub-name -> (our stacked name, transpose?)
_BERT_LAYER_MAP = {
    "attention.self.query.weight": ("wq", True),
    "attention.self.query.bias": ("bq", False),
    "attention.self.key.weight": ("wk", True),
    "attention.self.key.bias": ("bk", False),
    "attention.self.value.weight": ("wv", True),
    "attention.self.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "attention.output.LayerNorm.weight": ("ln_attn_scale", False),
    "attention.output.LayerNorm.bias": ("ln_attn_bias", False),
    "intermediate.dense.weight": ("w_in", True),
    "intermediate.dense.bias": ("b_in", False),
    "output.dense.weight": ("w_out", True),
    "output.dense.bias": ("b_out", False),
    "output.LayerNorm.weight": ("ln_mlp_scale", False),
    "output.LayerNorm.bias": ("ln_mlp_bias", False),
}

_BERT_TOP_MAP = {
    "embeddings.word_embeddings.weight": "tok_embed",
    "embeddings.position_embeddings.weight": "pos_embed",
    "embeddings.token_type_embeddings.weight": "type_embed",
    "embeddings.LayerNorm.weight": "ln_embed_scale",
    "embeddings.LayerNorm.bias": "ln_embed_bias",
}


def convert_hf_bert_state_dict(
    state: "Mapping[str, torch.Tensor] | Iterable[tuple[str, torch.Tensor]]",
    config: EncoderConfig,
    dtype: torch.dtype = torch.float32,
    *,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """Map a HF BERT state dict to the stacked tree ``encode`` uses, on
    ``device`` (``cuda`` unless the caller asks for another)."""
    device = resolve_device(device)
    n = config.num_layers
    per_layer: dict[str, list[Optional[torch.Tensor]]] = {
        ours: [None] * n for ours, _ in _BERT_LAYER_MAP.values()
    }
    top: dict[str, torch.Tensor] = {}
    items = state.items() if hasattr(state, "items") else state
    for name, raw in items:
        bare = name.removeprefix("bert.")
        if bare in _BERT_TOP_MAP:
            top[_BERT_TOP_MAP[bare]] = raw.detach().to(device=device, dtype=dtype, copy=True)
            continue
        match = _BERT_LAYER_RE.fullmatch(name)
        if not match:
            continue
        idx, sub = int(match.group(1)), match.group(2)
        mapped = _BERT_LAYER_MAP.get(sub)
        if mapped is None or idx >= n:
            continue
        ours, transpose = mapped
        tensor = raw.detach()
        per_layer[ours][idx] = tensor.T if transpose else tensor

    missing = [
        f"{ours}[{i}]"
        for ours, slots in per_layer.items()
        for i, s in enumerate(slots)
        if s is None
    ]
    if missing:
        raise ValueError(f"encoder checkpoint missing {len(missing)} tensors, e.g. {missing[:4]}")
    layers = {
        ours: torch.stack(slots).to(device=device, dtype=dtype).contiguous()
        for ours, slots in per_layer.items()
    }
    missing_top = [k for k in _BERT_TOP_MAP.values() if k not in top]
    if missing_top:
        raise ValueError(f"encoder checkpoint missing {missing_top}")
    return {**top, "layers": layers}


def encoder_config_from_hf_json(checkpoint_dir: str) -> EncoderConfig:
    """Build an :class:`EncoderConfig` from a HF ``config.json`` (the
    all-MiniLM-L6-v2 layout); falls back to MINILM_L6 when absent."""
    path = os.path.join(checkpoint_dir, "config.json")
    if not os.path.exists(path):
        return MINILM_L6
    with open(path) as f:
        raw = json.load(f)
    return EncoderConfig(
        name=raw.get("_name_or_path") or os.path.basename(checkpoint_dir) or "hf-encoder",
        vocab_size=int(raw.get("vocab_size", MINILM_L6.vocab_size)),
        hidden_size=int(raw.get("hidden_size", MINILM_L6.hidden_size)),
        intermediate_size=int(raw.get("intermediate_size", MINILM_L6.intermediate_size)),
        num_layers=int(raw.get("num_hidden_layers", MINILM_L6.num_layers)),
        num_heads=int(raw.get("num_attention_heads", MINILM_L6.num_heads)),
        max_positions=int(raw.get("max_position_embeddings", MINILM_L6.max_positions)),
        type_vocab_size=int(raw.get("type_vocab_size", MINILM_L6.type_vocab_size)),
        layer_norm_eps=float(raw.get("layer_norm_eps", MINILM_L6.layer_norm_eps)),
    )


def load_encoder_params(
    checkpoint_dir: str,
    config: Optional[EncoderConfig] = None,
    dtype: torch.dtype = torch.float32,
    *,
    device: Union[str, torch.device, None] = None,
) -> tuple[Params, EncoderConfig]:
    """Load a MiniLM-class safetensors checkpoint directory onto
    ``device`` (``cuda`` unless the caller asks for another).  Returns
    ``(params, config)``, the config read from the directory's
    ``config.json`` unless one is passed."""
    from .loader import iter_safetensors

    config = config or encoder_config_from_hf_json(checkpoint_dir)
    params = convert_hf_bert_state_dict(
        iter_safetensors(checkpoint_dir), config, dtype, device=device
    )
    return params, config
