"""Per-column int8 quantization for the decode KV caches.

Counterpart of ``whisper_tpu.kernels.quant``. Scales are per column (one
f32 per token, layer and lane):

  value[hd, s] = int8[hd, s] * scale[s]

so they fold into the decode-attention kernel (``csrc/decode_attention.cu``):
the raw q.K8 dot is multiplied by k_scale[s], and each softmax weight by
v_scale[s] before the P.V sum. Per-channel scales could not follow a cache
that grows one column at a time.

Symmetric, round-half-to-even, codes in [-127, 127], scale
max(amax, 1e-8) / 127: the same arithmetic as the JAX package, which gives
bit-identical codes and scales on the same f32 input.
"""

from __future__ import annotations

import torch


def quantize_cols(x: torch.Tensor, axis: int, reduce_max=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice along ``axis``.

    x [..., HD, S] with axis=-2 -> (int8 x, f32 scale [..., 1, S]).
    x [B, S, HD] with axis=-1   -> (int8 x, f32 scale [B, S, 1]).

    ``reduce_max`` takes the slices' maxima (f32, in place) before the
    scale: tensor parallelism's MAX all-reduce over the ranks that each
    hold part of the slice.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 + broadcastable scale -> dtype."""
    return (q.float() * scale).to(dtype)
