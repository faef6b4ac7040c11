from .configs import TINY_TEST, TINYLLAMA_1_1B, ModelConfig, RopeScaling, get_config, scaled
from .llama import init_params, params_from_jax
from .quant import quantize_params
from .tokenizer import ByteTokenizer

__all__ = [
    "TINY_TEST",
    "TINYLLAMA_1_1B",
    "ByteTokenizer",
    "ModelConfig",
    "RopeScaling",
    "get_config",
    "init_params",
    "params_from_jax",
    "quantize_params",
    "scaled",
]
