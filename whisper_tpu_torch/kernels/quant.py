"""Per-column int8 quantization for the decode KV caches, and the int8 self
cache's column write: the CUDA kernel's wrapper and its plain PyTorch version.

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

The decoder's int8 self cache takes each new column through ``kv_write``:
the qkv product's f32 rows [B, S, H, 3, Dh] in, K and V quantized and their
codes and scales written in place at the cache column, q returned in the
compute dtype. ``kv_write_route`` says where a call goes, from what it can
see: "kernel" (``kv_quant_write``, one launch of ``csrc/kv_quant_write.cu``)
for an int8 cache on the card at tensor-parallel size 1; "split"
(``kv_quant_write_ref``: ``quantize_cols`` and ``write_cols`` for K and V,
and q's cast) on the CPU and where the column scales take the MAX over
every rank's rows, which has to sit between the amax and the scale; "cast"
for a bf16 or f32 cache, which the decoder writes itself. On the card the
kernel's codes, scales and q equal the split path's bit for bit.
``LAUNCHES["kv_quant_write"]`` counts the kernel's launches (a captured
CUDA graph's replays add what its capture recorded: ``runtime/graph.py``);
``TRACER`` counts each int8 call of ``kv_write`` as ``kv_write_kernel`` or
``kv_write_split``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.kernels._build import LAUNCHES, load_library
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup

MAX_HD = 8192        # values of a K or V row the kernel takes: 8 a thread, 1,024 threads


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


def write_cols(cache: torch.Tensor, new: torch.Tensor, col) -> None:
    """In-place column write: cache [B, HD, C] (one layer), new [B, S, HD] at
    columns col..col+S-1. A host ``col`` is checked: where JAX's
    dynamic_update_slice would clamp the start (and silently overwrite the
    last columns), this raises. A device ``col`` (int64 [1], S = 1) is
    written by ``index_copy_`` unchecked; its caller checks the range."""
    if isinstance(col, torch.Tensor):
        cache.index_copy_(2, col, new.transpose(1, 2))
        return
    s, c = new.shape[1], cache.shape[-1]
    if col < 0 or col + s > c:
        raise ValueError(f"cache write at columns [{col}, {col + s}) outside cache length {c}")
    cache[:, :, col : col + s] = new.transpose(1, 2)


def kv_quant_write_ref(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_s: torch.Tensor,
                       v_s: torch.Tensor, col, n_head: int, q_dtype: torch.dtype,
                       reduce_max=None) -> torch.Tensor:
    """Plain version: qkv f32 [B, S, H, 3, Dh] (as [B, S, 3 HD]); K's and V's
    rows quantized (``quantize_cols``, each scale the max over the ranks'
    rows where ``reduce_max`` is given) and written, codes into k / v [B,
    HD, C] and scales into k_s / v_s [B, 1, C], at columns col..col+S-1
    (``write_cols``). Returns q [B, S, H, Dh] in ``q_dtype``."""
    b, s, _ = qkv.shape
    y = qkv.reshape(b, s, n_head, 3, -1)
    for cache, scales, part in ((k, k_s, 1), (v, v_s, 2)):
        codes, sc = quantize_cols(y[:, :, :, part].reshape(b, s, -1), axis=-1,
                                  reduce_max=reduce_max)          # int8 [B,S,HD], f32 [B,S,1]
        write_cols(cache, codes, col)
        write_cols(scales, sc, col)
    return y[:, :, :, 0].to(q_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("kv_quant_write")
    fn = lib.wtt_kv_quant_write
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kv_quant_write(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_s: torch.Tensor,
                   v_s: torch.Tensor, col, n_head: int,
                   q_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``kv_quant_write_ref`` at tensor-parallel size 1, in one launch on the
    card: qkv f32 [B, S, 3 HD] contiguous; k, v int8 [B, HD, C] and k_s,
    v_s f32 [B, 1, C], contiguous; ``col`` a host int (checked, as
    ``write_cols`` checks it) or a device int64 [1] (unchecked). Returns q
    [B, S, H, Dh] contiguous, bf16 or f32."""
    if qkv.device.type == "cpu":
        return kv_quant_write_ref(qkv, k, v, k_s, v_s, col, n_head, q_dtype)
    if qkv.dim() != 3 or qkv.dtype != torch.float32 or not qkv.is_contiguous():
        raise ValueError(f"kv_quant_write: qkv must be a contiguous f32 [B, S, 3 HD], got "
                         f"{qkv.dtype} {list(qkv.shape)} with strides {qkv.stride()}")
    b, s, w = qkv.shape
    hd = w // 3
    if w % 3 or hd % n_head or not 1 <= hd <= MAX_HD:
        raise ValueError(f"kv_quant_write: qkv width {w} is not 3 x {n_head} heads of a row "
                         f"of at most {MAX_HD}")
    c = k.shape[-1]
    for name, t, dtype, shape in (("k", k, torch.int8, (b, hd, c)), ("v", v, torch.int8, (b, hd, c)),
                                  ("k_s", k_s, torch.float32, (b, 1, c)),
                                  ("v_s", v_s, torch.float32, (b, 1, c))):
        if (t.device != qkv.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"kv_quant_write: {name} must be a contiguous {dtype} {list(shape)} on "
                             f"{qkv.device}, got {t.dtype} {list(t.shape)} on {t.device}")
    if q_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"kv_quant_write writes q in bf16 or f32, not {q_dtype}")
    if isinstance(col, torch.Tensor):
        if col.device != qkv.device or col.dtype != torch.int64 or col.numel() != 1:
            raise ValueError(f"kv_quant_write: a device column is one int64 on {qkv.device}, got "
                             f"{col.dtype} {list(col.shape)} on {col.device}")
        col_dev, col_host = col.data_ptr(), 0
    else:
        if col < 0 or col + s > c:
            raise ValueError(f"cache write at columns [{col}, {col + s}) outside cache length {c}")
        col_dev, col_host = None, int(col)
    q = torch.empty((b, s, hd), dtype=q_dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = _lib().wtt_kv_quant_write(
        qkv.data_ptr(), k.data_ptr(), v.data_ptr(), k_s.data_ptr(), v_s.data_ptr(), q.data_ptr(),
        col_dev, col_host, b, s, n_head, hd // n_head, c, int(q_dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"kv_quant_write kernel launch failed: CUDA error {rc}")
    LAUNCHES["kv_quant_write"] += 1
    return q.view(b, s, n_head, hd // n_head)


def kv_write_route(qkv: torch.Tensor, cache: torch.Tensor, tp: AxisGroup = SINGLE) -> str:
    """Where a self cache's column write goes, from what the call can see:
    "kernel" (``kv_quant_write``) for an int8 cache on the card at
    tensor-parallel size 1; "split" (``kv_quant_write_ref``) for an int8
    cache on the CPU, or under a ``tp`` of size > 1, whose MAX all-reduce
    sits between the amax and the scale; "cast" for a bf16 or f32 cache,
    cast and written by the decoder itself."""
    if cache.dtype != torch.int8:
        return "cast"
    return "kernel" if qkv.is_cuda and tp.size == 1 else "split"


def kv_write(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_s: torch.Tensor,
             v_s: torch.Tensor, col, n_head: int, q_dtype: torch.dtype,
             tp: AxisGroup = SINGLE) -> torch.Tensor:
    """An int8 self cache's column write on the route ``kv_write_route``
    names: the kernel, or the split path with ``tp``'s MAX over the ranks'
    rows. Counts the call in ``TRACER`` (once per call of this function: a
    captured graph's replays count nothing). Returns q [B, S, H, Dh]."""
    route = kv_write_route(qkv, k, tp)
    if route == "cast":
        raise ValueError(f"kv_write takes an int8 cache, got {k.dtype}")
    TRACER.count(f"kv_write_{route}")
    if route == "kernel":
        return kv_quant_write(qkv, k, v, k_s, v_s, col, n_head, q_dtype)
    return kv_quant_write_ref(qkv, k, v, k_s, v_s, col, n_head, q_dtype, reduce_max=tp.max)
