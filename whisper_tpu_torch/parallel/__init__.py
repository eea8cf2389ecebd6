"""Tensor and data parallelism over torch.distributed.

The JAX package's re-exports, resolved at first use: ``model.params``
imports ``parallel.group``, and ``parallel.sharding`` imports
``model.params``, so an eager import here would close a cycle.
"""

import importlib

_EXPORTS = {
    "make_mesh": "whisper_tpu_torch.parallel.mesh",
    "param_shardings": "whisper_tpu_torch.parallel.sharding",
    "shard_params": "whisper_tpu_torch.parallel.sharding",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_EXPORTS)
