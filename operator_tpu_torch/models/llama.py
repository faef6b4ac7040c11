"""Llama-family model in PyTorch.

Port of ``operator_tpu/models/llama.py``: the building blocks the mixed
serving step runs (``rms_norm`` with f32 accumulation,
``rope_frequencies`` with Llama-3.1 ``rope_scaling``, ``apply_rope`` in HF
rotate-half, ``_PROJ_BIAS``, ``init_params``) and the wave engine's
passes: ``make_causal_mask``, the contiguous ``KVCache``, dense and
query-chunked attention, :func:`forward` (with a cache, and with the
flash-prefill branch) and :func:`decode_step_paged`.  LoRA is not ported
yet.  :func:`params_from_jax` turns a JAX parameter tree (as numpy arrays)
into the port's tensors so both packages can run the same weights.

Weight layout is the JAX package's: every projection is stored
``[in_features, out_features]`` and the seven layer matrices are stacked
on a leading ``num_layers`` axis, so the forward pass is always
``x @ W[layer]``.  Where the JAX functions return updated caches, the
port writes the cache tensors in place and returns the same objects.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .configs import ModelConfig
from .quant import mm

if TYPE_CHECKING:
    from ..ops.paged_attention import PagedKVCache

Params = dict[str, Any]

#: projections that carry a bias vector when config.attention_bias (Qwen2)
_PROJ_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv"}

__all__ = [
    "KVCache",
    "apply_rope",
    "decode_step_paged",
    "forward",
    "init_params",
    "layer_matrix_shapes",
    "make_causal_mask",
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


def make_causal_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    *,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """[B, Tq, S] boolean mask: causal + validity + optional sliding window.

    ``q_positions``: [B, Tq] absolute positions of the query tokens;
    ``kv_positions``: [B, S] absolute positions of cache slots;
    ``kv_valid``: [B, S] whether the slot holds a real token.
    """
    causal = kv_positions[:, None, :] <= q_positions[:, :, None]
    mask = causal & kv_valid[:, None, :]
    if sliding_window is not None:
        recent = kv_positions[:, None, :] > (q_positions[:, :, None] - sliding_window)
        mask = mask & recent
    return mask


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------


@dataclass
class KVCache:
    """Contiguous per-layer cache (the paged variant lives in ops/).  The
    wave engine's prefill runs its bucket through one of these as a mini
    cache before scattering it into the pages."""

    k: torch.Tensor  # [layers, B, max_seq, kv_heads, head_dim]
    v: torch.Tensor  # [layers, B, max_seq, kv_heads, head_dim]

    @classmethod
    def create(
        cls,
        config: ModelConfig,
        batch_size: int,
        max_seq_len: Optional[int] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ) -> "KVCache":
        shape = (
            config.num_layers,
            batch_size,
            max_seq_len or config.max_seq_len,
            config.num_kv_heads,
            config.head_dim,
        )
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _layer_weights(layers: dict[str, Any], index: int) -> dict[str, Any]:
    """Layer ``index``'s slice of the stacked weights (int8 groups stay
    groups)."""
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, dict):
            out[name] = {key: value[index] for key, value in leaf.items()}
        else:
            out[name] = leaf[index]
    return out


def _proj(h_in: torch.Tensor, weights: dict[str, Any], name: str) -> torch.Tensor:
    """``h_in @ W`` plus the projection's bias where the config has one."""
    y = mm(h_in, weights[name])
    bias = _PROJ_BIAS.get(name)
    if bias is not None and bias in weights:
        y = y + weights[bias].to(y.dtype)
    return y


def _mlp(x: torch.Tensor, weights: dict[str, Any], eps: float) -> torch.Tensor:
    """The residual SiLU-gated MLP block."""
    mlp_in = rms_norm(x, weights["ln_mlp"], eps)
    gate = F.silu(_proj(mlp_in, weights, "w_gate"))
    up = _proj(mlp_in, weights, "w_up")
    return x + _proj(gate * up, weights, "w_down")


def _logits(params: Params, config: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab head: [..., H] -> [..., vocab] float32."""
    x = rms_norm(x, params["ln_final"], config.rms_norm_eps)
    head = params["embed"].T if config.tie_embeddings else params["lm_head"]
    return (x @ head).to(torch.float32)


def _attention(
    q: torch.Tensor,  # [B, T, QH, D]
    k: torch.Tensor,  # [B, S, KH, D]
    v: torch.Tensor,  # [B, S, KH, D]
    mask: torch.Tensor,  # [B, T, S] bool
    config: ModelConfig,
) -> torch.Tensor:
    """Dense masked GQA attention, f32 scores.  Returns [B, T, QH * D]."""
    b, t, qh, d = q.shape
    kh = config.num_kv_heads
    g = config.q_per_kv
    q_grouped = q.reshape(b, t, kh, g, d).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", q_grouped, k.to(torch.float32))
    scores = scores * (d ** -0.5)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, qh * d)


#: f32 score-tensor budget for one prefill attention: above this the query
#: axis is chunked so the [B, KH, G, T, S] tensor never materialises whole
#: (the JAX package's default and environment name)
_SCORE_BUDGET_BYTES = int(
    float(os.environ.get("OPERATOR_TPU_SCORE_BUDGET_MB", "256")) * 2**20
)


def _pick_q_chunk(b: int, t: int, s: int, qh: int) -> Optional[int]:
    """Largest divisor-of-t query chunk whose f32 scores fit the budget;
    None means no chunking (the dense tensor already fits)."""
    row_bytes = max(1, b) * qh * s * 4  # score bytes per query position
    if row_bytes * t <= _SCORE_BUDGET_BYTES:
        return None
    target = max(1, _SCORE_BUDGET_BYTES // row_bytes)
    for chunk in range(min(t - 1, target), 0, -1):
        if t % chunk == 0:
            return chunk
    return 1


def _attention_chunked(
    q: torch.Tensor,  # [B, T, QH, D]
    k: torch.Tensor,  # [B, S, KH, D]
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T]
    kv_positions: torch.Tensor,  # [B, S]
    kv_valid: torch.Tensor,  # [B, S] bool
    config: ModelConfig,
    q_chunk: int,
) -> torch.Tensor:
    """Long-context prefill attention: a loop over query chunks (the JAX
    ``lax.scan``), each building its causal/window mask on the fly, so
    the peak is ONE chunk's f32 scores instead of the whole [T, S]
    plane."""
    b, t, qh, d = q.shape
    assert t % q_chunk == 0, (t, q_chunk)
    outs = []
    for start in range(0, t, q_chunk):
        q_c = q[:, start : start + q_chunk]
        mask = make_causal_mask(
            q_positions[:, start : start + q_chunk], kv_positions, kv_valid,
            sliding_window=config.sliding_window,
        )
        outs.append(_attention(q_c, k, v, mask, config))
    return torch.cat(outs, dim=1)


def forward(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int absolute positions
    cache: Optional[KVCache] = None,
    cache_offset: Union[int, torch.Tensor] = 0,
    attn_mask: Optional[torch.Tensor] = None,  # [B, T, S]; forces the dense path
    kv_valid: Optional[torch.Tensor] = None,  # [B, S] validity override
    q_chunk: Optional[int] = None,  # explicit prefill chunk (tests)
    prefill_lengths: Optional[torch.Tensor] = None,  # [B]; enables flash prefill
    logits_at: Optional[torch.Tensor] = None,  # [B]; logits of one position per row
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """One decoder pass (the JAX ``forward`` without LoRA and mesh).

    Without a cache: plain causal self-attention over the T tokens.  With
    a cache: the T tokens are written at ``cache_offset`` (a Python int
    or a per-sequence ``[B]`` tensor), in place, and attend over the
    whole cache.  Long prefills chunk the query axis (:func:`_pick_q_chunk`)
    so the f32 scores stay within a fixed budget; ``kv_valid`` masks
    cache slots that hold no real token; a full ``attn_mask`` forces the
    dense path.  Flash prefill (``ops/flash_prefill.py``) takes the
    attention when ``prefill_lengths`` is given, it is enabled, and the
    bucket is a self-attention one (``flash_prefill_supported``).

    Returns (logits [B, T, vocab] float32, the cache or None).  With
    ``logits_at`` only those positions reach the vocab head: logits
    [B, vocab], the same values without the [B, T, vocab] tensor.
    """
    from ..ops.flash_prefill import (
        flash_prefill_attention,
        flash_prefill_enabled,
        flash_prefill_supported,
    )

    device = token_ids.device
    inv_freq = rope_frequencies(config, device)
    x = params["embed"][token_ids.long()]  # [B, T, H]
    b, t, _ = x.shape
    qh, kh, hd = config.num_heads, config.num_kv_heads, config.head_dim

    use_cache = cache is not None
    if isinstance(cache_offset, int):
        offsets = torch.full((b,), cache_offset, dtype=torch.int64, device=device)
    else:
        offsets = cache_offset.to(torch.int64).expand(b)
    if use_cache:
        max_seq = cache.k.shape[2]
        kv_positions = torch.arange(max_seq, device=device)[None].expand(b, max_seq)
        if kv_valid is None:
            kv_valid = kv_positions < offsets[:, None] + t
        write_rows = torch.arange(b, device=device)[:, None]
        write_pos = offsets[:, None] + torch.arange(t, device=device)[None]  # [B, T]
    else:
        max_seq = t
        kv_positions = positions
        if kv_valid is None:
            kv_valid = torch.ones((b, t), dtype=torch.bool, device=device)

    # flash prefill: self-attention buckets where the kv range is exactly
    # the q range and per-row validity is `pos < length`
    use_flash = (
        prefill_lengths is not None
        and attn_mask is None
        and flash_prefill_enabled()
        and flash_prefill_supported(t, max_seq, cache_offset)
    )
    if use_flash:
        q_chunk = None
    elif attn_mask is None:
        q_chunk = q_chunk or _pick_q_chunk(b, t, max_seq, qh)
        if q_chunk is None:
            attn_mask = make_causal_mask(
                positions, kv_positions, kv_valid,
                sliding_window=config.sliding_window,
            )
    else:
        q_chunk = None  # explicit mask: dense semantics the mask encodes

    for index in range(config.num_layers):
        weights = _layer_weights(params["layers"], index)
        attn_in = rms_norm(x, weights["ln_attn"], config.rms_norm_eps)
        q = _proj(attn_in, weights, "wq").reshape(b, t, qh, hd)
        k = _proj(attn_in, weights, "wk").reshape(b, t, kh, hd)
        v = _proj(attn_in, weights, "wv").reshape(b, t, kh, hd)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if use_cache:
            layer_k, layer_v = cache.k[index], cache.v[index]
            layer_k[write_rows, write_pos] = k.to(layer_k.dtype)
            layer_v[write_rows, write_pos] = v.to(layer_v.dtype)
            k_att, v_att = layer_k.to(q.dtype), layer_v.to(q.dtype)
        else:
            k_att, v_att = k, v
        if use_flash:
            attn = flash_prefill_attention(
                q.contiguous(), k_att.contiguous(), v_att.contiguous(),
                prefill_lengths.to(torch.int32), sliding_window=config.sliding_window,
            )
        elif q_chunk is not None:
            attn = _attention_chunked(
                q, k_att, v_att, positions, kv_positions, kv_valid, config, q_chunk
            )
        else:
            attn = _attention(q, k_att, v_att, attn_mask, config)
        x = x + _proj(attn.to(x.dtype), weights, "wo")
        x = _mlp(x, weights, config.rms_norm_eps)

    if logits_at is not None:
        x = x[torch.arange(b, device=device), logits_at.long()]  # [B, H]
    return _logits(params, config, x), cache


def decode_step_paged(
    params: Params,
    config: ModelConfig,
    token_ids: torch.Tensor,  # [B, 1]
    paged: "PagedKVCache",
) -> tuple[torch.Tensor, "PagedKVCache"]:
    """Single-token decode over a paged KV cache (``ops/paged_attention.py``).

    Each sequence appends at its own ``lengths[b]`` position (the page
    table maps it to a page and slot, written in place) and attends over
    exactly its own pages through :func:`ops.paged_attention.paged_attention`;
    sliding-window configs mask to the last ``sliding_window`` tokens.

    Returns (last-token logits [B, vocab] float32, cache with lengths + 1
    sharing the page tensors).
    """
    from ..ops.paged_attention import PagedKVCache, paged_attention, write_tokens

    inv_freq = rope_frequencies(config, token_ids.device)
    b = token_ids.shape[0]
    qh, kh, hd = config.num_heads, config.num_kv_heads, config.head_dim
    positions = paged.lengths[:, None]  # [B, 1] append position
    x = params["embed"][token_ids.long()]  # [B, 1, H]
    new_lengths = paged.lengths + 1

    for index in range(config.num_layers):
        weights = _layer_weights(params["layers"], index)
        attn_in = rms_norm(x, weights["ln_attn"], config.rms_norm_eps)
        q = _proj(attn_in, weights, "wq").reshape(b, 1, qh, hd)
        k = _proj(attn_in, weights, "wk").reshape(b, 1, kh, hd)
        v = _proj(attn_in, weights, "wv").reshape(b, 1, kh, hd)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        k_pages = write_tokens(paged.k_pages[index], paged.page_table, k, paged.lengths)
        v_pages = write_tokens(paged.v_pages[index], paged.page_table, v, paged.lengths)
        attn = paged_attention(
            q[:, 0].to(k_pages.dtype).contiguous(), k_pages, v_pages,
            paged.page_table, new_lengths, sliding_window=config.sliding_window,
        )  # [B, QH, D]
        x = x + _proj(attn.to(x.dtype).reshape(b, 1, -1), weights, "wo")
        x = _mlp(x, weights, config.rms_norm_eps)

    new_cache = PagedKVCache(
        k_pages=paged.k_pages, v_pages=paged.v_pages,
        page_table=paged.page_table, lengths=new_lengths,
    )
    return _logits(params, config, x[:, -1]), new_cache
