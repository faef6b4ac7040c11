from .configs import (
    TINY_TEST,
    TINYLLAMA_1_1B,
    ModelConfig,
    RopeScaling,
    get_config,
    register_config,
    scaled,
)
from .encoder import ENCODER_TINY_TEST, MINILM_L6, EncoderConfig, encode, init_encoder_params
from .llama import (
    KVCache,
    decode_step,
    forward,
    init_params,
    param_count,
    params_from_jax,
    rms_norm,
)
from .quant import quantize_params
from .tokenizer import ByteTokenizer

__all__ = [
    "ENCODER_TINY_TEST",
    "KVCache",
    "MINILM_L6",
    "TINY_TEST",
    "TINYLLAMA_1_1B",
    "ByteTokenizer",
    "EncoderConfig",
    "ModelConfig",
    "RopeScaling",
    "decode_step",
    "encode",
    "forward",
    "get_config",
    "init_encoder_params",
    "init_params",
    "param_count",
    "params_from_jax",
    "quantize_params",
    "register_config",
    "rms_norm",
    "scaled",
]
