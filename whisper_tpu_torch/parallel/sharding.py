"""Parameter/activation sharding rules (tensor and data parallelism).

Counterpart of ``whisper_tpu.parallel.sharding``. The same Megatron-style
layout for the transformer blocks:

  - q/k/v projections  [d, d]   -> output (head) dim on "model"
  - out projection     [d, d]   -> input dim on "model" (all-reduce after)
  - fc1                [d, 4d]  -> hidden dim on "model"
  - fc2                [4d, d]  -> input (hidden) dim on "model"
  - token embedding    [V, d]   -> vocab dim on "model" (sharded logits)
  - layernorms, biases of reduced outputs, conv stem, positions: replicated

A spec is a tuple of mesh axis names, one per tensor dim (``None``:
not split; dims past its end are not split either), like the JAX
package's ``PartitionSpec``. The JAX rules are for the stacked [L, ...]
tensors; the port's ``Block``s hold one layer, so its rules leave out the
leading layer axis. Where GSPMD places shards and inserts collectives,
here ``shard_params`` keeps this rank's contiguous slice of each leaf and
the model code runs the collectives (``parallel/group.py``).

A vocabulary that does not split evenly (large-v2's 51865 over 2 ranks)
is padded with zero rows to a multiple of the axis, as GSPMD pads an
uneven shard; the gathered logits are cut back to ``n_vocab``.

Activations keep batch on "data": ``shard_batch`` gives this rank its
lanes and ``gather_batch`` collects every rank's. As in the JAX package,
``Context`` does not split lanes by itself.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tpu_torch.model.params import WhisperParams, params_from_tensors
from whisper_tpu_torch.parallel.group import AxisGroup
from whisper_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

# leaf name -> spec of one layer's tensor
_BLOCK_RULES = {
    # fused head-major QKV: splitting the 3d axis assigns whole heads/rank
    "qkv_w": (None, MODEL_AXIS),
    "qkv_b": (MODEL_AXIS,),
    "o_w": (MODEL_AXIS, None),
    "o_b": (),
    "xq_w": (None, MODEL_AXIS),
    "xq_b": (MODEL_AXIS,),
    "xk_w": (None, MODEL_AXIS),
    "xv_w": (None, MODEL_AXIS),
    "xv_b": (MODEL_AXIS,),
    "xo_w": (MODEL_AXIS, None),
    "xo_b": (),
    "fc1_w": (None, MODEL_AXIS),
    "fc1_b": (MODEL_AXIS,),
    "fc2_w": (MODEL_AXIS, None),
    "fc2_b": (),
    # int8-weight scales [1, out] follow their weight's OUTPUT-dim shard
    # (params.quantize_decoder_weights); in-dim-sharded weights (o/xo/fc2)
    # have replicated per-output scales
    "qkv_w_s": (None, MODEL_AXIS),
    "xq_w_s": (None, MODEL_AXIS),
    "fc1_w_s": (None, MODEL_AXIS),
    "o_w_s": (),
    "xo_w_s": (),
    "fc2_w_s": (),
}

_TOP_RULES = {
    "tok": (MODEL_AXIS, None),  # vocab-sharded logits matmul
    "tok_s": (MODEL_AXIS, None),  # per-vocab-row int8 scales follow tok
}


def _buffers(module) -> dict[str, torch.Tensor]:
    return dict(module.named_buffers(recurse=False))


def param_shardings(params: WhisperParams, mesh) -> dict:
    """Each leaf's spec, in the JAX package's tree layout:
    ``{"enc": {key: spec, ..., "blocks": {key: spec}}, "dec": {...}}``
    (block keys once, for every layer). The specs name mesh axes and do
    not depend on the mesh, which is taken for the JAX package's
    signature."""
    tree = {}
    for name, sub in (("enc", params.enc), ("dec", params.dec)):
        specs = {k: _TOP_RULES.get(k, ()) for k in _buffers(sub)}
        specs["blocks"] = {k: _BLOCK_RULES.get(k, ()) for k in _buffers(sub.blocks[0])}
        tree[name] = specs
    return tree


def local_part(x, spec: tuple, mesh, pad: bool = False):
    """This rank's contiguous slice of ``x`` (a tensor or a numpy array)
    under ``spec``. A dim that does not split evenly raises, or with
    ``pad`` (tensors only) is padded with zeros to a multiple first."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        g = AxisGroup.of(mesh, axis)
        n, r = g.size, g.rank
        size = x.shape[dim]
        if size % n:
            if not pad:
                raise ValueError(f"dim {dim} of size {size} does not split over {n} ranks of {axis!r}")
            extra = list(x.shape)
            extra[dim] = -size % n
            x = torch.cat([x, x.new_zeros(extra)], dim=dim)
        step = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(r * step, (r + 1) * step),)]
    return x


def shard_params(params: WhisperParams, mesh) -> WhisperParams:
    """This rank's parameters: each leaf's contiguous slice under
    ``param_shardings``, copied (the full tensors can be freed), with the
    mesh's "model" group as ``tp``, which the model code runs its
    collectives on. Shard after ``params_from_checkpoint`` has quantized:
    the int8 scales then come from the whole weight. With a "model" axis
    of size 1 the parameters are returned as they are."""
    tp = AxisGroup.of(mesh, MODEL_AXIS)
    if tp.size == 1:
        return params
    specs = param_shardings(params, mesh)

    def part(t, spec, pad=False):
        return local_part(t, spec, mesh, pad).contiguous().clone()

    tree = {}
    for name, sub in (("enc", params.enc), ("dec", params.dec)):
        leaves = {k: part(t, specs[name][k], pad=True) for k, t in _buffers(sub).items()}
        leaves["blocks"] = {k: torch.stack([part(_buffers(b)[k], spec) for b in sub.blocks])
                            for k, spec in specs[name]["blocks"].items()}
        tree[name] = leaves
    out = params_from_tensors(tree)
    out.tp = tp
    return out


def batch_sharding(mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """The spec putting the batch dim on the data axis."""
    spec = [None] * ndim
    spec[batch_axis] = DATA_AXIS
    return tuple(spec)


def kv_sharding(mesh) -> tuple:
    """[L, B, HD, C] transposed KV caches: batch on data, features
    (head-major rows) on model."""
    return (None, DATA_AXIS, MODEL_AXIS, None)


def shard_batch(x, mesh, batch_axis: int = 0):
    """This rank's lanes of ``x`` (a tensor or a numpy array): its
    contiguous share of ``batch_axis`` on the data axis."""
    return local_part(x, batch_sharding(mesh, np.ndim(x), batch_axis), mesh)


def gather_batch(x: torch.Tensor, mesh, batch_axis: int = 0) -> torch.Tensor:
    """Every data rank's lanes of ``x``, in rank order along ``batch_axis``
    (the inverse of ``shard_batch``)."""
    return AxisGroup.of(mesh, DATA_AXIS).gather(x, dim=batch_axis)
