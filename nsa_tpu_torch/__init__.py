"""nsa_tpu_torch: the PyTorch and CUDA port of ``nsa_tpu``.

The JAX package ``nsa_tpu`` is the reference; this package mirrors its
layout module by module, imports only ``torch`` and ``numpy``, and runs its
kernels as CUDA C++ written for Hopper (``csrc/``).  Entry points run on
``cuda`` unless the caller asks for ``device="cpu"``; on CPU tensors every
kernel wrapper runs its plain PyTorch version.
"""

from .config import (
    MeshConfig,
    ModelConfig,
    NSAConfig,
    model_config_from_json,
    reference_model_config,
    tiny_test_config,
)

__all__ = [
    "MeshConfig",
    "ModelConfig",
    "NSAConfig",
    "model_config_from_json",
    "reference_model_config",
    "tiny_test_config",
]
