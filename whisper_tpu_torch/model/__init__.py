"""Parameters, layers, encoder and decoder of the PyTorch port.

The JAX package's re-exports, resolved at first use: ``kernels.attention``
imports ``model.layers``, and ``model.encoder`` imports the kernel, so an
eager import here would close a cycle.
"""

import importlib

_EXPORTS = {
    "DtypePolicy": "whisper_tpu_torch.model.params",
    "load_params": "whisper_tpu_torch.model.params",
    "params_from_checkpoint": "whisper_tpu_torch.model.params",
    "encode": "whisper_tpu_torch.model.encoder",
    "precompute_cross_kv": "whisper_tpu_torch.model.encoder",
    "decode_step": "whisper_tpu_torch.model.decoder",
    "init_self_kv": "whisper_tpu_torch.model.decoder",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_EXPORTS)
