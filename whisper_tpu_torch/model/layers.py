"""Shared transformer building blocks (plain PyTorch).

Counterpart of ``whisper_tpu.model.layers``. Shapes use B=batch, T=query
length, S=key length, H=heads, Dh=head dim, d=model dim. Matmuls give an f32
result (JAX's ``preferred_element_type=f32``), layernorm runs in f32, and
activations travel in the policy's compute dtype (bf16 on the card).
"""

from __future__ import annotations

import math

import torch

from whisper_tpu_torch.kernels.w8a16 import MAX_ROWS, w8a16_dense
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with GGML's eps=1e-5 (biased variance, eps inside the
    root). Computes in f32, returns f32; one fused op instead of the eight
    elementwise passes a literal transcription would launch."""
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def dense_route(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor | None,
                tp: AxisGroup = SINGLE) -> str:
    """Where ``dense`` sends a call, from what the call can see: "w8a16"
    (the W8A16 kernel with the scale and bias fused) for int8 codes with
    scales and a bf16 CUDA ``x`` of 1 to ``MAX_ROWS`` rows (the token
    steps); "w8a16_raw" for the same under a row-parallel ``tp`` of size
    > 1 (the kernel's raw product, all-reduced before the scale); else
    "converted" for any other int8 call, and "float" for the rest."""
    if s is None or w.dtype != torch.int8:
        return "float"
    rows = math.prod(x.shape[:-1])
    if x.is_cuda and x.dtype == torch.bfloat16 and 1 <= rows <= MAX_ROWS:
        return "w8a16_raw" if tp.size > 1 else "w8a16"
    return "converted"


def dense(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    s: torch.Tensor | None = None,
    tp: AxisGroup = SINGLE,
) -> torch.Tensor:
    """x @ w (+ b) with an f32 result.

    On the card a bf16 product goes to cuBLAS with an f32 output
    (``torch.mm(..., out_dtype=float32)``: bf16 operands, f32 accumulation
    and no bf16 rounding of the result, as XLA's ``preferred_element_type``).
    Elsewhere, and for f32 operands, the product runs in f32. TF32 is never
    used here: PyTorch's default keeps f32 CUDA matmuls in full f32.

    ``s`` dequantizes an int8 ``w`` as an epilogue: one f32 scale per output
    column (``params.quantize_weight``), applied BEFORE the bias. A call of
    at most ``MAX_ROWS`` bf16 rows on the card (a token step) takes the
    W8A16 kernel (``kernels/w8a16.py``), which reads the codes once and
    applies the scale and the bias in the same launch. Any other int8 call
    converts the weight to the activation dtype first, a separate pass that
    writes a bf16 copy of the weight (1 byte read, 2 written per weight),
    then multiplies. ``dense_route`` says which; ``TRACER`` counts each
    int8 call as ``int8_dense_kernel`` or ``int8_dense_converted``, once per
    call of this function (a captured graph's replays count nothing).

    ``tp`` is the group a row-parallel ``w`` is split over (its rows, and
    ``x``'s last dim): the rank's f32 partial product is all-reduced over
    it before the epilogue, so the scale and the replicated bias are
    applied once. At size 1 (the default) nothing is launched."""
    route = dense_route(x, w, s, tp)
    if route != "float":
        TRACER.count("int8_dense_converted" if route == "converted" else "int8_dense_kernel")
    if route == "w8a16":
        return w8a16_dense(x, w, s, b)
    if route == "w8a16_raw":
        y = w8a16_dense(x, w)
    elif x.is_cuda and x.dtype != torch.float32:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype), out_dtype=torch.float32)
        y = y.reshape(*lead, w.shape[-1])
    else:
        y = torch.matmul(x.float(), w.float())
    y = tp.sum(y)
    if s is not None:
        y = y * s
    if b is not None:
        y = y + b
    return y


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


def attention(
    q: torch.Tensor,  # [B, T, H, Dh], pre-scaled
    k: torch.Tensor,  # [B, S, H, Dh], pre-scaled
    v: torch.Tensor,  # [B, S, H, Dh]
    mask: torch.Tensor | None = None,  # broadcastable to [B, H, T, S], True=keep
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Naive attention: scores/softmax in f32, weights cast to
    ``compute_dtype`` for the PV product, which accumulates in f32.
    Returns f32 [B, T, H, Dh]."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bhts,bshd->bthd",
        probs.to(compute_dtype).float(),
        v.to(compute_dtype).float(),
    )

