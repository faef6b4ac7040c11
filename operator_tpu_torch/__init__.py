"""PyTorch/CUDA port of operator-tpu's operator control plane, serving
and semantic analysis paths, for NVIDIA Hopper.

The JAX package (``operator_tpu``) is the reference; this package mirrors
its layout module by module and imports nothing of it.  Plain tensor code
is PyTorch; every Pallas kernel on the ported path is a hand-written
CUDA kernel under ``ops/csrc/``, built with ``nvcc`` on first use
(``ops/_build.py``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (``utils/device.py``); on the CPU every kernel
wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
