"""Hand-written CUDA kernels (csrc/) with their wrappers and plain PyTorch versions.

``flash_attention`` is re-exported as in the JAX package, resolved at first
use: ``kernels.attention`` imports ``model.layers``, whose package leads
back here.
"""


def __getattr__(name):
    if name == "flash_attention":
        from whisper_tpu_torch.kernels.attention import flash_attention

        return flash_attention
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["flash_attention"]
