"""Audio encoder: conv stem + GELU + positional add, N pre-LN transformer
blocks, final layernorm, and the cross-attention K/V precompute.

Counterpart of ``whisper_tpu.model.encoder``:
  - conv stem: conv1d(k=3,s=1,p=1) -> GELU -> conv1d(k=3,s=2,p=1) -> GELU ->
    + positional embedding, each conv as unfold + one GEMM
  - block: x += attn(ln(x)); x += mlp(ln(x)) with GELU MLP; the attention is
    the fused kernel (``kernels.attention.flash_attention``)
  - after ln_post, cross-attention K (pre-scaled by (d/h)^-0.25, folded
    into ``xk_w`` at load) and V for ALL decoder layers, stored transposed
    as [L, B, H*Dh, T] so decode steps stream [Dh, T] rows; with ``quant``
    as int8 plus one f32 scale per column (``kernels/quant.py``)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.kernels.attention import flash_attention
from whisper_tpu_torch.kernels.quant import quantize_cols
from whisper_tpu_torch.kernels.w8a16 import dense
from whisper_tpu_torch.model.layers import gelu, layer_norm, merge_heads, qkv_proj
from whisper_tpu_torch.model.params import Block, WhisperParams
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup


def _unfold3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """k=3, pad=1 temporal unfold: [B, T, C] -> [B, T//stride, 3C]
    (tap-major concat matching the [3, in, out] kernel reshape)."""
    xp = F.pad(x, (0, 0, 1, 1))
    t = x.shape[1]
    t_out = t // stride
    taps = [xp[:, k : k + t : stride][:, :t_out] for k in range(3)]
    return torch.cat(taps, dim=-1)


def _conv_stem(enc, mel: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """mel [B, n_mels, 2*T] -> f32 [B, T, d].

    The convs stay GEMMs ([B,T,3C] @ [3C,d]) rather than ``F.conv1d``, so
    cuDNN's TF32 default for f32 convolutions never applies."""
    x = mel.to(compute_dtype).transpose(1, 2)                  # [B, 2T, n_mels]
    w1 = enc.conv1_w.reshape(-1, enc.conv1_w.shape[-1])        # [3*in, d]
    y = dense(_unfold3(x, 1), w1.to(compute_dtype), enc.conv1_b)
    x = gelu(y).to(compute_dtype)                              # [B, 2T, d]
    w2 = enc.conv2_w.reshape(-1, enc.conv2_w.shape[-1])
    y = dense(_unfold3(x, 2), w2.to(compute_dtype), enc.conv2_b)
    return gelu(y)


def _encoder_block(x: torch.Tensor, blk: Block, n_head: int, compute_dtype: torch.dtype,
                   tp: AxisGroup = SINGLE) -> torch.Tensor:
    """One pre-LN encoder block. x: [B, T, d] compute_dtype. ``n_head``:
    this rank's heads; the out projection and fc2 are row-parallel over
    ``tp``."""
    h = layer_norm(x, blk.attn_ln_w, blk.attn_ln_b).to(compute_dtype)
    # q, k, v: strided views of one [B, T, H, 3, Dh] tensor, read in place
    q, k, v = qkv_proj(h, blk.qkv_w, blk.qkv_b, n_head, dtype=compute_dtype)
    att = merge_heads(flash_attention(q, k, v)).to(compute_dtype)
    x = x + dense(att, blk.o_w, blk.o_b, tp=tp).to(compute_dtype)

    h = layer_norm(x, blk.mlp_ln_w, blk.mlp_ln_b).to(compute_dtype)
    h = gelu(dense(h, blk.fc1_w, blk.fc1_b)).to(compute_dtype)
    return x + dense(h, blk.fc2_w, blk.fc2_b, tp=tp).to(compute_dtype)


def encode(
    params: WhisperParams,
    dims: ModelDims,
    mel: torch.Tensor,                 # [B, n_mels, 2*audio_ctx]
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Full encoder forward -> audio features [B, audio_ctx, d] (f32)."""
    enc = params.enc
    x = _conv_stem(enc, mel, compute_dtype)
    t = x.shape[1]
    x = (x + enc.pos[:t]).to(compute_dtype)
    n_head = params.tp.part(dims.n_audio_head)
    for blk in enc.blocks:
        x = _encoder_block(x, blk, n_head, compute_dtype, params.tp)
    return layer_norm(x, enc.ln_post_w, enc.ln_post_b)


class CrossKV(NamedTuple):
    """Per-window cross-attention K/V for all decoder layers; k_s/v_s are
    the per-column int8 scales [L, B, 1, T], or None."""

    k: torch.Tensor                  # [L, B, HD, T]
    v: torch.Tensor
    k_s: torch.Tensor | None = None
    v_s: torch.Tensor | None = None


def precompute_cross_kv(
    params: WhisperParams,
    dims: ModelDims,
    audio_features: torch.Tensor,      # [B, T, d] f32 (encode output)
    compute_dtype: torch.dtype = torch.bfloat16,
    quant: bool = False,
) -> CrossKV:
    """Cross-attention K/V for every decoder layer, K pre-scaled, stored
    TRANSPOSED (features-major) [L, B, H*Dh, T] in compute_dtype, or with
    ``quant`` as int8 with f32 scales [L, B, 1, T] (each column quantized
    from its compute_dtype values): decode reads this array on every token
    step, so int8 halves the step's largest stream. Under tensor
    parallelism a rank holds its heads' HD/n rows; each column's int8
    scale is the max over all ranks' rows (a MAX all-reduce), as GSPMD
    reduces over the sharded axis, so the scales stay replicated and the
    codes are the unsharded ones."""
    xf = audio_features.to(compute_dtype)
    b, t, _ = xf.shape
    blocks = params.dec.blocks
    shape = (len(blocks), b, blocks[0].xk_w.shape[-1], t)
    k = torch.empty(shape, dtype=torch.int8 if quant else compute_dtype, device=xf.device)
    v = torch.empty_like(k)
    if quant:
        k_s = torch.empty((len(blocks), b, 1, t), dtype=torch.float32, device=xf.device)
        v_s = torch.empty_like(k_s)
    for li, blk in enumerate(blocks):
        kl = dense(xf, blk.xk_w).to(compute_dtype).transpose(1, 2)       # [B, HD, T]
        vl = dense(xf, blk.xv_w, blk.xv_b).to(compute_dtype).transpose(1, 2)
        if quant:
            k[li], k_s[li] = quantize_cols(kl, axis=-2, reduce_max=params.tp.max)
            v[li], v_s[li] = quantize_cols(vl, axis=-2, reduce_max=params.tp.max)
        else:
            k[li], v[li] = kl, vl
    return CrossKV(k, v, k_s, v_s) if quant else CrossKV(k, v)
