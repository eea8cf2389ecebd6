"""Single-token decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``whisper_tpu/kernels/decode_attention.py:decode_attention_hd``
(Pallas, body ``_kernel``): per lane and head, one pre-scaled query against
transposed K/V [B/G, H*Dh, S], keys outside [start_b, valid_len_b) masked to
-1e30, f32 softmax, f32 output [B, H*Dh, 1]; lane b reads K/V lane b // G.
The kernel is ``csrc/decode_attention.cu``; its header says what bounds it
on an H100 (bytes: 7.7 MB of cross K/V per large-v2 layer and lane) and how
its split-S design answers that.

On a CPU tensor ``decode_attention_hd`` runs ``decode_attention_hd_ref``.
On a CUDA tensor it launches the kernel or raises; it never falls back.
The int8 K/V variant (``k_scale``/``v_scale``) waits for the int8 tier and
raises ``NotImplementedError`` on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.kernels._build import load_library


def _no_int8(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "decode_attention_hd: int8 K/V with k_scale/v_scale waits for the port's int8 tier"
        )


def decode_attention_hd_ref(
    q: torch.Tensor,                 # [B, HD, 1] pre-scaled
    k_t: torch.Tensor,               # [B/G, HD, S] pre-scaled
    v_t: torch.Tensor,               # [B/G, HD, S]
    n_head: int,
    valid_len: torch.Tensor | None = None,  # [B] int32: keys < valid_len attended
    start: torch.Tensor | None = None,      # [B] int32: keys >= start attended
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    kv_group: int = 1,
) -> torch.Tensor:
    """Plain version, the einsum formulation of the decoder's attention
    (``model/decoder.py``) over the kernel's interface: f32 scores, masked
    keys at -1e30, f32 softmax and f32 P.V -> [B, HD, 1] f32."""
    _no_int8(k_scale, v_scale)
    b, hd, _ = q.shape
    u, _, s = k_t.shape
    if b != u * kv_group:
        raise ValueError(f"q lanes {b} != K/V lanes {u} x kv_group {kv_group}")
    dh = hd // n_head
    q4 = q.float().reshape(u, kv_group, n_head, dh)
    k4 = k_t.float().reshape(u, n_head, dh, s)
    v4 = v_t.float().reshape(u, n_head, dh, s)
    scores = torch.einsum("ughd,uhds->ughs", q4, k4)           # [U, G, H, S]
    if valid_len is not None or start is not None:
        col = torch.arange(s, device=q.device)
        lo = start if start is not None else torch.zeros(b, dtype=torch.int32, device=q.device)
        hi = valid_len if valid_len is not None else torch.full((b,), s, dtype=torch.int32, device=q.device)
        keep = (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])   # [B, S]
        scores = scores.masked_fill(~keep.reshape(u, kv_group, 1, s), -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("ughs,uhds->ughd", p, v4)
    return out.reshape(b, hd, 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    fn = lib.wtt_decode_attention_hd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.wtt_decode_attention_chunk.argtypes = []
    lib.wtt_decode_attention_chunk.restype = ctypes.c_int
    return lib


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
    _no_int8(k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_hd_ref(q, k_t, v_t, n_head, valid_len, start, kv_group=kv_group)
    if not (q.is_cuda and k_t.device == q.device and v_t.device == q.device):
        raise ValueError("decode_attention_hd: q, k_t and v_t must lie on one CUDA device")
    if not (q.dtype == k_t.dtype == v_t.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"decode_attention_hd on CUDA takes bf16 or f32 q/k/v of one dtype, "
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
    start_p = _check_limits(start, "start", b, q.device)
    valid_p = _check_limits(valid_len, "valid_len", b, q.device)

    lib = _lib()
    n_splits = -(-s // lib.wtt_decode_attention_chunk())
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, n_head, n_splits, 2), dtype=torch.float32, device=q.device)
    part_o = torch.empty((b, n_head, n_splits, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.wtt_decode_attention_hd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
        start_p, valid_p, out.data_ptr(), part_ml.data_ptr(), part_o.data_ptr(),
        b, hd, s, n_head, kv_group, stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention_hd kernel launch failed: CUDA error {rc}")
    decode_attention_hd.launches += 1
    return out


decode_attention_hd.launches = 0
