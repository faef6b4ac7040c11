from .configs import TINY_TEST, TINYLLAMA_1_1B, ModelConfig, RopeScaling, get_config, scaled
from .encoder import ENCODER_TINY_TEST, MINILM_L6, EncoderConfig, encode, init_encoder_params
from .llama import init_params, params_from_jax
from .quant import quantize_params
from .tokenizer import ByteTokenizer

__all__ = [
    "ENCODER_TINY_TEST",
    "MINILM_L6",
    "TINY_TEST",
    "TINYLLAMA_1_1B",
    "ByteTokenizer",
    "EncoderConfig",
    "ModelConfig",
    "RopeScaling",
    "encode",
    "get_config",
    "init_encoder_params",
    "init_params",
    "params_from_jax",
    "quantize_params",
    "scaled",
]
