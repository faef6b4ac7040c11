"""Model configurations for the Llama family.

One decoder architecture covers every model the system serves (BASELINE
configs 2/4/5): RMSNorm + RoPE + grouped-query attention + SiLU-gated MLP.
Mistral adds a sliding attention window; Llama-3 a larger vocab and RoPE
theta.  Sizes are from the public model cards / HF config.json files.

The port's own copy of ``operator_tpu/models/configs.py`` (the port
imports nothing of the JAX package); the two registries must stay equal,
which ``tests/test_torch_model.py`` checks.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1-style ("llama3") NTK-by-parts RoPE scaling: low-frequency
    bands are slowed by ``factor``, high-frequency bands kept, and the bands
    between interpolated — how 3.1/3.2 stretch an 8k-trained RoPE to 128k."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_positions: int = 8192


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 2048
    sliding_window: Optional[int] = None  # Mistral-style local attention
    tie_embeddings: bool = False
    rope_scaling: Optional[RopeScaling] = None  # Llama-3.1+ long context
    attention_bias: bool = False  # Qwen2-style bias on the q/k/v projections

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def __post_init__(self) -> None:
        assert self.num_heads % self.num_kv_heads == 0, "heads must divide evenly into kv groups"


TINYLLAMA_1_1B = ModelConfig(
    name="tinyllama-1.1b",
    vocab_size=32000,
    hidden_size=2048,
    intermediate_size=5632,
    num_layers=22,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    rope_theta=10_000.0,
    max_seq_len=2048,
)

LLAMA_3_8B = ModelConfig(
    name="llama-3-8b",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    max_seq_len=8192,
)

LLAMA_3_1_8B = ModelConfig(
    name="llama-3.1-8b",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    max_seq_len=16384,  # serving cap; the model supports 128k
    rope_scaling=RopeScaling(factor=8.0),
)

# small modern targets: a 1B that outclasses TinyLlama at the same latency
# budget, and a 3B midpoint — both tie embeddings and use llama3 scaling
LLAMA_3_2_1B = ModelConfig(
    name="llama-3.2-1b",
    vocab_size=128256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    rope_theta=500_000.0,
    max_seq_len=16384,
    tie_embeddings=True,
    rope_scaling=RopeScaling(factor=32.0),
)

LLAMA_3_2_3B = ModelConfig(
    name="llama-3.2-3b",
    vocab_size=128256,
    hidden_size=3072,
    intermediate_size=8192,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    max_seq_len=16384,
    tie_embeddings=True,
    rope_scaling=RopeScaling(factor=32.0),
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10_000.0,
    sliding_window=4096,
    max_seq_len=8192,
)

# Qwen2 family: same decoder skeleton plus bias vectors on the q/k/v
# projections (HF Qwen2Config attention_bias); 2.5 generation sizes
QWEN2_5_7B = ModelConfig(
    name="qwen2.5-7b",
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    max_seq_len=16384,  # serving cap; the model supports 32k
    attention_bias=True,
)

QWEN2_5_1_5B = ModelConfig(
    name="qwen2.5-1.5b",
    vocab_size=151936,
    hidden_size=1536,
    intermediate_size=8960,
    num_layers=28,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    rope_theta=1_000_000.0,
    rms_norm_eps=1e-6,
    max_seq_len=16384,
    tie_embeddings=True,
    attention_bias=True,
)

#: small config for tests and the compile-check entry point: real arrays,
#: real architecture, laptop-sized
TINY_TEST = ModelConfig(
    name="tiny-test",
    vocab_size=512,
    hidden_size=128,
    intermediate_size=352,
    num_layers=3,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    rope_theta=10_000.0,
    max_seq_len=256,
)

_REGISTRY = {
    cfg.name: cfg
    for cfg in (
        TINYLLAMA_1_1B,
        LLAMA_3_8B,
        LLAMA_3_1_8B,
        LLAMA_3_2_1B,
        LLAMA_3_2_3B,
        MISTRAL_7B,
        QWEN2_5_7B,
        QWEN2_5_1_5B,
        TINY_TEST,
    )
}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}") from None


def scaled(config: ModelConfig, *, num_layers: Optional[int] = None,
           max_seq_len: Optional[int] = None) -> ModelConfig:
    """A reduced variant (fewer layers / shorter context) for smoke tests."""
    kwargs = {}
    if num_layers is not None:
        kwargs["num_layers"] = num_layers
    if max_seq_len is not None:
        kwargs["max_seq_len"] = max_seq_len
    return replace(config, name=f"{config.name}-scaled", **kwargs)
