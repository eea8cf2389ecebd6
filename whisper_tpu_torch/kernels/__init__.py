"""Hand-written CUDA kernels (csrc/) with their wrappers and plain PyTorch versions.

``flash_attention`` is re-exported as in the JAX package. The kernel layer
imports nothing of the model, runtime, api or cli packages above it.
"""

from whisper_tpu_torch.kernels.attention import flash_attention

__all__ = ["flash_attention"]
