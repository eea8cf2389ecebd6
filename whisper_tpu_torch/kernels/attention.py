"""Fused encoder self-attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``whisper_tpu/kernels/attention.py:flash_attention`` (Pallas,
body ``_attn_kernel``): unmasked softmax(q k^T) v over pre-scaled q, k in
[B, T, H, Dh], softmax in f32, P cast to v.dtype, f32 PV, v.dtype output.
The kernel is ``csrc/flash_attention.cu``; its header says what bounds it on
an H100 (operations: 11.5 GFLOP per large-v2 layer and lane) and how its
design answers that: consumer warpgroups of 64 q rows (two over 128-key
tiles where there are few blocks, as at B=1; three over 64-key tiles where
there are many, as at B=8), K/V tiles that a producer warp loads by TMA
into a multi-stage mbarrier ring, both products on wgmma, f32 online
softmax. TMA reads q, k and v in place through their strides, which must be
multiples of 16 bytes on 16-byte aligned bases; the wrapper refuses
anything else.

f32 q/k/v (``DtypePolicy.f32()``) go to a second kernel,
``csrc/flash_attention_f32.cu``: f32 scores, softmax, P and PV on the CUDA
cores (no tensor-core type holds the f32 tier's 1e-5). Blocks of 256 q rows,
8 warps whose lanes compute 8 x 8 register tiles from broadcast
shared-memory reads, 64-key K/V tiles streamed by every thread's cp.async
into a 3-stage mbarrier ring, read through the same strides (16-byte
aligned bases and strides of 16-byte multiples);
``flash_attention_f32_geometry`` reports its launch geometry.

On a CPU tensor ``flash_attention`` runs ``flash_attention_ref``. On a CUDA
tensor it launches the kernel of v's dtype (bf16 or f32) or raises; it never
falls back. ``LAUNCHES["flash_attention"]`` counts every launch,
``LAUNCHES["flash_attention_f32"]`` those of the f32 kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.kernels._build import LAUNCHES, load_library


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 scores and softmax, P cast to v.dtype, f32 PV,
    v.dtype output [B, Tq, H, Dh]."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float()).to(v.dtype)


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.wtt_flash_attention_bf16
    fn.argtypes = _ARGS + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_f32() -> ctypes.CDLL:
    lib = load_library("flash_attention_f32")
    fn = lib.wtt_flash_attention_f32
    fn.argtypes = _ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    geo = lib.wtt_flash_attention_f32_geometry
    geo.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    geo.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v must lie on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or v.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"flash_attention on CUDA takes bf16 or f32 q/k/v (all of one dtype), got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, T, H, Dh]")
    b, _, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if dh != 64:
        raise NotImplementedError(f"flash_attention kernel is built for Dh=64, got {dh}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"flash_attention: empty q or k (Tq {q.shape[1]}, Tk {k.shape[1]})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # TMA's tensor map (bf16) and the 16-byte loads (f32): a 16-byte
        # aligned base, strides of 16-byte multiples
        isz = t.element_size()
        if t.stride(3) != 1 or any(s * isz % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} needs unit stride along Dh, B/T/H strides of "
                f"16-byte multiples and a 16-byte aligned base (strides {t.stride()}, "
                f"base {t.data_ptr():#x})"
            )


SHAPES = {"auto": 0, "wide": 1, "deep": 2}  # csrc/flash_attention.cu's block shapes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked fused attention -> [B, Tq, H, Dh] in v.dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if v.dtype == torch.float32:
        return _flash_attention_f32(q, k, v)
    return flash_attention_shape(q, k, v, "auto")


def _flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    _check(q, k, v)
    b, tq, h, dh = q.shape
    out = torch.empty((b, tq, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib_f32().wtt_flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, tq, k.shape[1],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention f32 kernel launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_f32"] += 1
    return out


def flash_attention_f32_geometry(b: int, h: int, tq: int) -> dict:
    """The f32 kernel's launch for [B, Tq, H, 64] on the current card: q rows
    and threads a block, dynamic shared memory, blocks per SM (the card's
    occupancy), the grid's blocks and its rounds over the card's SMs."""
    vals = [ctypes.c_int() for _ in range(4)]
    rc = _lib_f32().wtt_flash_attention_f32_geometry(*(ctypes.byref(x) for x in vals))
    if rc != 0:
        raise RuntimeError(f"flash_attention f32 geometry query failed: CUDA error {rc}")
    rows, threads, smem, per_sm = (x.value for x in vals)
    blocks = -(-tq // rows) * b * h
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return dict(rows_per_block=rows, threads=threads, smem_bytes=smem, blocks_per_sm=per_sm,
                blocks=blocks, rounds=blocks / (per_sm * sms) if per_sm else None)


def flash_attention_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          shape: str) -> torch.Tensor:
    """The kernel in one block shape: "wide" (two consumer warpgroups,
    128-key tiles), "deep" (three, 64-key tiles) or "auto" (the kernel
    chooses by the number of blocks per SM), so the choice can be timed.
    bf16 only: the f32 kernel has one shape."""
    _check(q, k, v)
    if v.dtype != torch.bfloat16:
        raise NotImplementedError(f"flash_attention_shape takes bf16 q/k/v, got {v.dtype}")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, dh), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().wtt_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, tq, tk,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], SHAPES[shape], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
