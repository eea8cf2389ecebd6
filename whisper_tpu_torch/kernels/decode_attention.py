"""Single-token decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``whisper_tpu/kernels/decode_attention.py:decode_attention_hd``
(Pallas, body ``_kernel``): per lane and head, one pre-scaled query against
transposed K/V [B/G, H*Dh, S], keys outside [start_b, valid_len_b) masked to
-1e30, f32 softmax, f32 output [B, H*Dh, 1]; lane b reads K/V lane b // G.
K/V are of q's dtype, or int8 with per-column f32 scales ``k_scale`` /
``v_scale`` [B/G, 1, S] (``kernels/quant.py``; the serving tier's caches),
folded in where the TPU body folds them: the raw dot times k_scale before
the mask, the softmax sum over p before the V fold, P.V over p * v_scale.
The kernel is ``csrc/decode_attention.cu``; its header says what bounds it
on an H100 (bytes: 7.7 MB of bf16 cross K/V per large-v2 layer and lane,
3.85 MB in int8) and how its design answers that: split-S flash decoding
(128-key chunks, 256 on int8, x heads x lanes) in which each thread reads
4 consecutive keys of a row in one load and the warps split the Dh rows,
then a combine.
Where a row of S keys (or a base) is not aligned to that vector,
``vector_keys`` picks the 2- or 1-key instantiation of the same kernel.

On a CPU tensor ``decode_attention_hd`` runs ``decode_attention_hd_ref``.
On a CUDA tensor it launches the kernel or raises; it never falls back.
``decode_attention_hd.launches`` counts every launch, ``launches_int8``
those on int8 K/V, ``launches_grouped`` those with ``kv_group`` > 1 (beam
search's cross-attention). Inside a token step captured as a CUDA graph
(``runtime/graph.py``) the wrapper runs once, at capture, and allocates
``out`` and its scratch from the graph's pool; every replay launches the
captured kernels at those addresses and adds to the counters what the
capture recorded.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.kernels._build import load_library


def _check_scales(k_t, v_t, k_scale, v_scale) -> bool:
    """True for int8 K/V with their column scales, False for unscaled K/V;
    raises on anything between. Scales are f32 [B/G, 1, S]."""
    int8 = k_t.dtype == torch.int8
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention_hd: k_scale and v_scale go together")
    if int8 != (v_t.dtype == torch.int8):
        raise ValueError(f"decode_attention_hd: K/V dtypes {k_t.dtype}/{v_t.dtype} differ")
    if int8 != (k_scale is not None):
        raise ValueError("decode_attention_hd: int8 K/V need k_scale/v_scale, and scales need int8 K/V")
    if int8:
        want = (k_t.shape[0], 1, k_t.shape[2])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"decode_attention_hd: {name} must be f32 {list(want)}, "
                                 f"got {t.dtype} {list(t.shape)}")
    return int8


def decode_attention_hd_ref(
    q: torch.Tensor,                 # [B, HD, 1] pre-scaled
    k_t: torch.Tensor,               # [B/G, HD, S] pre-scaled
    v_t: torch.Tensor,               # [B/G, HD, S]
    n_head: int,
    valid_len: torch.Tensor | None = None,  # [B] int32: keys < valid_len attended
    start: torch.Tensor | None = None,      # [B] int32: keys >= start attended
    k_scale: torch.Tensor | None = None,  # [B/G, 1, S] f32: int8 K column scales
    v_scale: torch.Tensor | None = None,  # [B/G, 1, S] f32: int8 V column scales
    kv_group: int = 1,
) -> torch.Tensor:
    """Plain version, the einsum formulation of the decoder's attention
    (``model/decoder.py``) over the kernel's interface: f32 scores (times
    k_scale), masked keys at -1e30, f32 softmax, then P (times v_scale).V
    in f32 -> [B, HD, 1] f32."""
    int8 = _check_scales(k_t, v_t, k_scale, v_scale)
    b, hd, _ = q.shape
    u, _, s = k_t.shape
    if b != u * kv_group:
        raise ValueError(f"q lanes {b} != K/V lanes {u} x kv_group {kv_group}")
    dh = hd // n_head
    q4 = q.float().reshape(u, kv_group, n_head, dh)
    k4 = k_t.float().reshape(u, n_head, dh, s)
    v4 = v_t.float().reshape(u, n_head, dh, s)
    scores = torch.einsum("ughd,uhds->ughs", q4, k4)           # [U, G, H, S]
    if int8:
        scores = scores * k_scale.reshape(u, 1, 1, s)
    if valid_len is not None or start is not None:
        col = torch.arange(s, device=q.device)
        lo = start if start is not None else torch.zeros(b, dtype=torch.int32, device=q.device)
        hi = valid_len if valid_len is not None else torch.full((b,), s, dtype=torch.int32, device=q.device)
        keep = (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])   # [B, S]
        scores = scores.masked_fill(~keep.reshape(u, kv_group, 1, s), -1e30)
    p = torch.softmax(scores, dim=-1)
    if int8:
        p = p * v_scale.reshape(u, 1, 1, s)
    out = torch.einsum("ughs,uhds->ughd", p, v4)
    return out.reshape(b, hd, 1)


_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc/decode_attention.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    fn = lib.wtt_decode_attention_hd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wtt_decode_attention_chunk.argtypes = [ctypes.c_int]
    lib.wtt_decode_attention_chunk.restype = ctypes.c_int
    return lib



def vector_keys(s: int, itemsize: int, *ptrs: int) -> int:
    """Keys per load for rows of ``s`` keys of ``itemsize`` bytes at the
    given base addresses: 4 (8 B of bf16, 4 B of int8, 16 B of f32) where
    every row start is aligned to it, else 2, else 1."""
    for vec in (4, 2):
        if s % vec == 0 and all(p % (vec * itemsize) == 0 for p in ptrs):
            return vec
    return 1


def _check_limits(t: torch.Tensor | None, name: str, b: int, device) -> int:
    if t is None:
        return 0
    if t.device != device or t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous():
        raise ValueError(f"decode_attention_hd: {name} must be a contiguous int32 [{b}] tensor on {device}")
    return t.data_ptr()


def decode_attention_hd(
    q: torch.Tensor,
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    n_head: int,
    valid_len: torch.Tensor | None = None,
    start: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    kv_group: int = 1,
) -> torch.Tensor:
    """Single-query attention in flat head-major layout -> [B, HD, 1] f32."""
    int8 = _check_scales(k_t, v_t, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_hd_ref(q, k_t, v_t, n_head, valid_len, start, k_scale, v_scale,
                                       kv_group)
    if not (q.is_cuda and k_t.device == q.device and v_t.device == q.device):
        raise ValueError("decode_attention_hd: q, k_t and v_t must lie on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (int8 or q.dtype == k_t.dtype == v_t.dtype):
        raise NotImplementedError(
            f"decode_attention_hd on CUDA takes bf16 or f32 q with K/V of q's dtype or int8, "
            f"got {q.dtype}/{k_t.dtype}/{v_t.dtype}"
        )
    b, hd, one = q.shape
    u, hd_k, s = k_t.shape
    if one != 1 or hd_k != hd or v_t.shape != k_t.shape or b != u * kv_group or hd % n_head:
        raise ValueError(
            f"decode_attention_hd: shapes q {tuple(q.shape)} k_t {tuple(k_t.shape)} "
            f"v_t {tuple(v_t.shape)} n_head {n_head} kv_group {kv_group}"
        )
    dh = hd // n_head
    if dh > 128:
        raise NotImplementedError(f"decode_attention_hd kernel takes Dh <= 128, got {dh}")
    if not (q.is_contiguous() and k_t.is_contiguous() and v_t.is_contiguous()):
        raise ValueError("decode_attention_hd: q, k_t and v_t must be contiguous")
    ks_p = vs_p = 0
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.device != q.device or not t.is_contiguous():
                raise ValueError(f"decode_attention_hd: {name} must be contiguous on {q.device}")
        ks_p, vs_p = k_scale.data_ptr(), v_scale.data_ptr()
    start_p = _check_limits(start, "start", b, q.device)
    valid_p = _check_limits(valid_len, "valid_len", b, q.device)

    lib = _lib()
    kv_type = _TYPE_CODES[k_t.dtype]
    n_splits = -(-s // lib.wtt_decode_attention_chunk(kv_type))
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, n_head, n_splits, 2), dtype=torch.float32, device=q.device)
    part_o = torch.empty((b, n_head, n_splits, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.wtt_decode_attention_hd(
        _TYPE_CODES[q.dtype], kv_type, q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), ks_p, vs_p,
        start_p, valid_p, out.data_ptr(), part_ml.data_ptr(), part_o.data_ptr(),
        b, hd, s, n_head, kv_group,
        vector_keys(s, k_t.element_size(), k_t.data_ptr(), v_t.data_ptr()), stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention_hd kernel launch failed: CUDA error {rc}")
    decode_attention_hd.launches += 1
    decode_attention_hd.launches_int8 += int8
    decode_attention_hd.launches_grouped += kv_group > 1
    return out


def decode_attention(
    q: torch.Tensor,                    # [B, H, Dh] (pre-scaled)
    k_t: torch.Tensor,                  # [B, H, Dh, S] (pre-scaled)
    v_t: torch.Tensor,                  # [B, H, Dh, S]
    valid_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """Convenience wrapper over decode_attention_hd -> [B, H, Dh] f32."""
    b, h, dh = q.shape
    s = k_t.shape[-1]
    out = decode_attention_hd(q.reshape(b, h * dh, 1), k_t.reshape(b, h * dh, s),
                              v_t.reshape(b, h * dh, s), h, valid_len)
    return out.reshape(b, h, dh)


decode_attention_hd.launches = 0
decode_attention_hd.launches_int8 = 0
decode_attention_hd.launches_grouped = 0
