"""Shared transformer building blocks (plain PyTorch).

Counterpart of ``whisper_tpu.model.layers``. Shapes use B=batch, T=query
length, S=key length, H=heads, Dh=head dim, d=model dim. Matmuls give an f32
result (JAX's ``preferred_element_type=f32``), layernorm runs in f32, and
activations travel in the policy's compute dtype (bf16 on the card).
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.kernels.w8a16 import dense


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with GGML's eps=1e-5 (biased variance, eps inside the
    root). Computes in f32, returns f32; one fused op instead of the eight
    elementwise passes a literal transcription would launch."""
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in f32."""
    return torch.nn.functional.gelu(x.float(), approximate="none")


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, T, d]"""
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def qkv_proj(h: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor, n_head: int,
             dtype: torch.dtype = torch.float32, qkv_s: torch.Tensor | None = None):
    """Fused head-major QKV projection: h [B,S,d] -> (q, k, v) each
    [B,S,H,Dh] in ``dtype`` (the f32 product cast once). They are strided
    views of one [B,S,H,3,Dh] tensor. ``qkv_s``: int8 weight scales."""
    y = dense(h, qkv_w, qkv_b, s=qkv_s).to(dtype)   # [B, S, 3d]
    b, s, _ = y.shape
    y = y.reshape(b, s, n_head, 3, -1)
    return y[:, :, :, 0], y[:, :, :, 1], y[:, :, :, 2]
