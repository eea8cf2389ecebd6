"""NaN sanitizer — the DBG_TEST_NAN analogue (Whisper/stdafx.h:41-44,
dbgFindNaN shader, Whisper/ML/DbgNanTest.h:5-21).

Counterpart of ``whisper_tpu.obs.nandebug``. Usage:

  with nan_debug():            # every op checked for NaN in the scope
      run...

  check_pytree_finite(params)  # one-shot scan of the port's params, or of
                               # any dict / list / tuple of tensors and arrays

The JAX package flips ``jax_debug_nans``, which makes every primitive that
produces a NaN raise ``FloatingPointError``. ``torch.autograd.
set_detect_anomaly`` checks only the backward pass, so ``nan_debug`` is a
``TorchDispatchMode`` instead: it sees every aten op of the forward pass
(the kernels' wrappers too, through their torch ops) and raises
``FloatingPointError`` naming the first op whose floating output holds a
NaN. Like ``jax_debug_nans`` it looks for NaN only, not Inf. Each check
reads a flag back from the device, so the scope runs synchronously: a
debugging tool, not a serving mode.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_debug():
    with _NaNCheck():
        yield


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs, paths in jax.tree_util.keystr's form."""
    if isinstance(tree, torch.nn.Module):
        for name, t in (*tree.named_parameters(), *tree.named_buffers()):
            yield path + "".join(f".{p}" for p in name.split(".")), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_pytree_finite(tree, name: str = "pytree") -> None:
    """Raises with the offending leaf path when any floating leaf has
    NaN/Inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        elif hasattr(leaf, "dtype") and np.issubdtype(np.asarray(leaf).dtype, np.floating):
            if not bool(np.all(np.isfinite(leaf))):
                bad.append(path)
    if bad:
        raise FloatingPointError(f"{name}: non-finite values in {bad}")
