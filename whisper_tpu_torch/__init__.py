"""whisper_tpu_torch — the PyTorch/CUDA port of whisper_tpu.

A second package beside the JAX one (``whisper_tpu``), with the same module
names and layout so each piece has an obvious counterpart there. Plain
tensor code is PyTorch; the two attention kernels that the JAX package
wrote in Pallas for the TPU are CUDA C++ kernels for Hopper (``csrc/``),
each with a plain PyTorch version beside it. The package never imports
``jax`` or ``whisper_tpu``. Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``.

Public API shape: ``load_model`` -> ``Model`` -> ``Context`` ->
``TranscribeResult``.
"""

__version__ = "0.1.0"

from whisper_tpu_torch.api.params import (
    Flags,
    FullParams,
    SamplingStrategy,
    full_default_params,
)
from whisper_tpu_torch.api.result import Segment, Token, TranscribeResult
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.languages import (
    LANGUAGES,
    find_language_id,
    language_name,
    supported_languages,
)


def __getattr__(name):
    # Model/load_model pull in torch and the runtime; import lazily so that
    # light-weight uses (tokenizer, ggml tools) stay fast.
    if name in ("Model", "load_model"):
        from whisper_tpu_torch.api import model as _model

        return getattr(_model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ModelDims",
    "FullParams",
    "Flags",
    "SamplingStrategy",
    "full_default_params",
    "Model",
    "load_model",
    "Segment",
    "Token",
    "TranscribeResult",
    "LANGUAGES",
    "find_language_id",
    "language_name",
    "supported_languages",
]
