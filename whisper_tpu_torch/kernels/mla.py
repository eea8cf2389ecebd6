"""Latent attention for one token a lane: the token step's ``mla_decode``. The CUDA kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no latent attention. The
LongCat-Flash-Omni token step (``model/longcat.py:step``) attends with the
absorbed form of MLA: every query head reads one latent "head" of
``kv_rank + rope_dim`` columns a position (the normed latent, then the
rotated shared key), its keys being whole rows and its values their first
``v_dim`` columns. ``mla_decode`` computes, per lane b and head h,

    out[b, h] = softmax_t(scale * q[b, h] . c[b, t]) @ c[b, t, :v_dim],   t in [start_b, valid_b)

with q [B, H, D] (the absorbed ``q_nope`` and the rotated ``q_rope``), the
lane's cache rows c [B, C, D] (a view whose rows are contiguous; lanes may
lie any 16-byte multiple apart), ``start`` and ``valid`` [B] int32 on the
device. Returns [B, H, v_dim] f32.

The kernel is ``csrc/mla_decode.cu`` (H = 64, D = 576, v_dim = 512, bf16);
its header says what bounds it and what its design does about it. A lane's
keys may be split over ``mla_splits`` ranges of blocks, whose partial sums a
second launch adds. On a CPU tensor ``mla_decode`` runs ``mla_decode_ref``;
on a CUDA tensor it launches the kernel or raises. Both refuse what they do
not take. ``LAUNCHES["mla_decode"]`` counts kernel launches (1 a call, 2
where the keys are split; a captured CUDA graph's replays add what its
capture recorded: ``runtime/graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from whisper_tpu_torch.kernels._build import LAUNCHES, load_library

HEADS, DIM, V_DIM = 64, 576, 512     # the kernel's shape: LongCat-Flash's latent attention
KEY_TILE = 32                        # keys a block stage (kTile in the .cu)


def mla_decode_ref(q: torch.Tensor, cache: torch.Tensor, start: torch.Tensor, valid: torch.Tensor,
                   scale: float, v_dim: int) -> torch.Tensor:
    """Plain version: f32 scores of the lane's keys [start, valid), a
    softmax, the weighted sum of the rows' first ``v_dim`` columns (no host
    read)."""
    cols = torch.arange(cache.shape[1], device=cache.device)
    live = (cols[None, :] >= start[:, None].long()) & (cols[None, :] < valid[:, None].long())   # [B, C]
    scores = torch.einsum("bhd,bcd->bhc", q.float(), cache.float()) * scale
    probs = torch.softmax(scores.masked_fill(~live[:, None], float("-inf")), dim=-1)
    return torch.einsum("bhc,bcd->bhd", probs, cache[..., :v_dim].float())


def mla_splits(b: int, capacity: int, sms: int) -> int:
    """Key ranges a lane's keys are split over: enough blocks (two a lane
    and range) to give each of the card's ``sms`` multiprocessors one
    (the kernel runs one block an SM), each range at least two 32-key
    tiles of a ``capacity``-column cache."""
    return max(1, min(sms // (2 * b), math.ceil(capacity / KEY_TILE) // 2))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, cache, start, valid, v_dim) -> None:
    if q.dim() != 3 or cache.dim() != 3 or cache.shape[0] != q.shape[0] or cache.shape[2] != q.shape[2]:
        raise ValueError(f"mla_decode takes q [B, H, D] and cache [B, C, D], got {list(q.shape)}, "
                         f"{list(cache.shape)}")
    if not 0 < v_dim <= q.shape[2]:
        raise ValueError(f"mla_decode: v_dim {v_dim} outside the {q.shape[2]} columns")
    if q.dtype != cache.dtype or not q.is_floating_point():
        raise ValueError(f"mla_decode: q {q.dtype} and cache {cache.dtype} must be one floating dtype")
    for t, name in ((start, "start"), (valid, "valid")):
        if t.dtype != torch.int32 or t.shape != (q.shape[0],) or t.device != q.device:
            raise ValueError(f"mla_decode: {name} must be int32 [{q.shape[0]}] on {q.device}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
    if cache.device != q.device:
        raise ValueError(f"mla_decode: cache on {cache.device}, q on {q.device}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("mla_decode")
    fn = lib.wtt_mla_decode
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def mla_decode(q: torch.Tensor, cache: torch.Tensor, start: torch.Tensor, valid: torch.Tensor,
               scale: float, v_dim: int) -> torch.Tensor:
    """Each lane's query heads over its latent rows [start, valid) ->
    [B, H, v_dim] f32 (see the module's docstring)."""
    _check(q, cache, start, valid, v_dim)
    if q.device.type == "cpu":
        return mla_decode_ref(q, cache, start, valid, scale, v_dim)
    if not q.is_cuda:
        raise ValueError(f"mla_decode: q on {q.device}, neither the CPU nor a CUDA device")
    b, h, d = q.shape
    if q.dtype != torch.bfloat16 or (h, d, v_dim) != (HEADS, DIM, V_DIM):
        raise NotImplementedError(f"mla_decode on CUDA takes bf16 q [B, {HEADS}, {DIM}] and v_dim {V_DIM}, got "
                                  f"{q.dtype} {list(q.shape)}, v_dim {v_dim}")
    if cache.stride(2) != 1 or cache.stride(1) != d or cache.stride(0) % 8 or cache.data_ptr() % 16:
        raise ValueError(f"mla_decode: cache rows must be contiguous and 16-byte aligned, strides "
                         f"{tuple(cache.stride())}")
    q = q.contiguous()
    splits = mla_splits(b, cache.shape[1], _sms(q.device.index if q.device.index is not None else 0))
    out = torch.empty((b, h, v_dim), dtype=torch.float32, device=q.device)
    o_part = ml_part = None
    if splits > 1:
        o_part = torch.empty((b, splits, h, v_dim), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((b, splits, 2, h), dtype=torch.float32, device=q.device)
    rc = _lib().wtt_mla_decode(
        q.data_ptr(), cache.data_ptr(), cache.stride(0), start.data_ptr(), valid.data_ptr(), out.data_ptr(),
        None if o_part is None else o_part.data_ptr(), None if ml_part is None else ml_part.data_ptr(),
        b, splits, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: CUDA error {rc}")
    LAUNCHES["mla_decode"] += 1 + (splits > 1)
    return out
