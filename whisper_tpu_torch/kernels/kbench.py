"""The decode-attention microbenchmark's kernels: the CUDA wrappers and their
plain PyTorch versions.

Replaces the seven Pallas kernels of ``tools/kbench.py`` (K3-K9). All read
K/V in the decoder's transposed layout [slabs, HD, S_PAD]: S_PAD is the key
count S rounded up to the chunk CS, and the padded columns hold data.

- ``kernel_read`` (K3, ``make_pallas(kernel_read)``), ``kernel_rows`` (K5,
  ``rows_call``), ``kernel_read_all_layers`` (K6, ``read1_call``) and
  ``kernel_flatread`` (K9, ``flatread``): per row, the f32 sum of k + v over
  every stored column, padding included. K3 and K5 take one layer
  [B, HD, S_PAD]; K6 and K9 take all layers [L, B, HD, S_PAD] in one call
  and differ only in the shape of their output ([L, B, HD, 1] and
  [L * B, HD, 1], the same memory): on the card both are one launch
  configuration over L * B slabs. The TPU's ``SEMS`` (dimension semantics) and ``VMEM`` (VMEM
  limit) knobs of K9 have no meaning there and are gone.
- ``kernel_vpu`` (K4a) and ``kernel_vpu8`` (K8, int8 K/V with f32 column
  scales [B, 1, S_PAD]): per lane and head, softmax over the keys s < S of
  the unscaled q . K[:, s] (masked keys at -inf), all in f32, out [B, HD, 1];
  K8 multiplies the raw dot by ``k_scale[s]`` before the mask, sums l over p,
  then weighs V by ``p * v_scale[s]``.
- ``kernel_mxu`` (K4b, head-masked dense product) and ``kernel_mxub`` (K7,
  per-head products): the same attention on the tensor cores, p rounded to
  bf16 before P.V, l summed from the f32 p. K7's TPU output is [B, H, Dh],
  the same memory as [B, HD, 1].

Each softmax walks the CS-wide chunks in order with a running max, as the
TPU bodies do; the bf16 rounding of p happens at the chunk's running max,
so the plain versions walk the chunks too. The kernels are
``csrc/kbench.cu``; its header says what bounds them on an H100 (bytes:
2,013,265,920 B of bf16 K + V per large-v2 pass) and how each is laid out.

On a CPU tensor each wrapper runs its plain version (``KERNELS[name]``
holds both, the plain one taking the wrapper's arguments). On a CUDA tensor
it launches its kernel or raises; it never falls back. Each wrapper's
``launches`` counts the kernels it launches: two a call for the split
tiling of K3, K6 and K9 (the partial sums, then the combine; one where a
single chunk spans S_PAD), one for the others.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from whisper_tpu_torch.kernels._build import load_library

SPLIT_ROWS = 16          # rows per block of the split row-sum tiling (csrc/kbench.cu)
DENSE_SMEM_LIMIT = 232_448   # shared memory one H100 block may use, bytes


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rowsum_ref(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis of k + v, element by element as the TPU
    body adds them -> [..., 1]."""
    return (k.float() + v.float()).sum(-1, keepdim=True)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, s_valid: int,
                  cs: int, p_bf16: bool = False, k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The TPU bodies' chunk walk: per CS-wide chunk, f32 scores of the
    unscaled q (times k_scale), columns >= s_valid at -inf, running max m,
    l = l * alpha + sum(p) over the f32 p, then p (times v_scale; rounded to
    bf16 if ``p_bf16``) into acc = acc * alpha + P.V; out acc / l, f32
    [B, HD, 1]."""
    b, hd, s_pad = k.shape
    dh = hd // n_head
    q4 = q.float().reshape(b, n_head, dh)
    m = torch.full((b, n_head), float("-inf"), device=q.device)
    l = torch.zeros((b, n_head), device=q.device)
    acc = torch.zeros((b, n_head, dh), device=q.device)
    for c0 in range(0, s_pad, cs):
        kc = k[..., c0:c0 + cs].float().reshape(b, n_head, dh, -1)
        vc = v[..., c0:c0 + cs].float().reshape(b, n_head, dh, -1)
        sc = torch.einsum("bhd,bhds->bhs", q4, kc)
        if k_scale is not None:
            sc = sc * k_scale[..., c0:c0 + cs].float()
        col = torch.arange(c0, c0 + sc.shape[-1], device=q.device)
        sc = sc.masked_fill(col >= s_valid, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        if v_scale is not None:
            p = p * v_scale[..., c0:c0 + cs].float()
        if p_bf16:
            p = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("bhs,bhds->bhd", p, vc)
    return (acc / l[..., None]).reshape(b, hd, 1)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("kbench")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wtt_kb_rowsum.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.wtt_kb_attn_cuda_core.argtypes = [i] + [p] * 6 + [i] * 6 + [p]
    lib.wtt_kb_attn_mma.argtypes = [i] + [p] * 4 + [i] * 6 + [p]
    lib.wtt_kb_attn_mma_dense_smem.argtypes = [i, i]
    lib.wtt_kb_attn_mma_dense_smem.restype = ctypes.c_longlong
    for fn in (lib.wtt_kb_rowsum, lib.wtt_kb_attn_cuda_core, lib.wtt_kb_attn_mma):
        fn.restype = ctypes.c_int
    return lib


def _check_kv(name: str, dtype: torch.dtype, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous with 16-byte aligned bases")
    for t in ts[:2]:
        if t.dtype != dtype:
            raise NotImplementedError(f"{name} on CUDA takes {dtype} K/V, got {t.dtype}")
    if ts[0].shape != ts[1].shape:
        raise ValueError(f"{name}: K {tuple(ts[0].shape)} and V {tuple(ts[1].shape)} differ")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rowsum(wrapper, k: torch.Tensor, v: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Launch the row sum over [slabs, HD, S_PAD] -> f32 [slabs, HD], and
    count its launches on ``wrapper``: a combine follows when cols < S_PAD."""
    name = wrapper.__name__
    _check_kv(name, torch.bfloat16, k, v)
    hd, s_pad = k.shape[-2:]
    slabs = k.numel() // (hd * s_pad)
    if s_pad % 8 or cols % 8 or s_pad % cols:
        raise ValueError(f"{name}: S_PAD {s_pad} and the tile width {cols} must be multiples of 8, "
                         "and the width must divide S_PAD")
    if not 1 <= slabs <= 65_535:
        raise ValueError(f"{name}: {slabs} slabs; the kernel's grid takes 1 to 65535")
    out = torch.empty((slabs, hd), dtype=torch.float32, device=k.device)
    part = (torch.empty((slabs, s_pad // cols, hd), dtype=torch.float32, device=k.device)
            if cols < s_pad else out)
    _raise_on(_lib().wtt_kb_rowsum(k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
                                   slabs, hd, s_pad, rows, cols, _stream(k)), name)
    wrapper.launches += 1 if cols == s_pad else 2
    return out


def kernel_read(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K3: one layer's row sums [B, HD, S_PAD] -> [B, HD, 1], split tiling
    (CS-wide chunks, then a combine)."""
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    return _rowsum(kernel_read, k, v, SPLIT_ROWS, cs).reshape(*k.shape[:-1], 1)


def kernel_rows(k: torch.Tensor, v: torch.Tensor, rb: int) -> torch.Tensor:
    """K5: one layer's row sums, whole-row tiling: a block over RB rows
    walks all of S_PAD. HD % RB must be 0 (the TPU grid would drop rows)."""
    if k.shape[-2] % rb:
        raise ValueError(f"kernel_rows: HD {k.shape[-2]} is not a multiple of RB {rb}")
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    return _rowsum(kernel_rows, k, v, rb, k.shape[-1]).reshape(*k.shape[:-1], 1)


def kernel_read_all_layers(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K6: every layer's row sums in one call, [L, B, HD, S_PAD] ->
    [L, B, HD, 1], split tiling over L * B slabs."""
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    return _rowsum(kernel_read_all_layers, k, v, SPLIT_ROWS, cs).reshape(*k.shape[:-1], 1)


def _flat(out: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return out.reshape(-1, k.shape[-2], 1)


def kernel_flatread(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K9: K6's launches, their output flat: [L, B, HD, S_PAD] (or [L * B,
    HD, S_PAD]) -> [L * B, HD, 1]."""
    if k.device.type == "cpu":
        return _flat(rowsum_ref(k, v), k)
    return _flat(_rowsum(kernel_flatread, k, v, SPLIT_ROWS, cs), k)


def _check_attn(name: str, q, k, v, n_head: int, s_valid: int, cs: int) -> tuple[int, int, int]:
    b, hd, s_pad = k.shape
    if q.dtype != torch.bfloat16 or tuple(q.shape) != (b, hd, 1) or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 [{b}, {hd}, 1], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if q.device != k.device:
        raise ValueError(f"{name}: q must lie on K's device")
    if hd % n_head or s_pad % cs or not 1 <= s_valid <= s_pad:
        raise ValueError(f"{name}: HD {hd}, H {n_head}, S {s_valid}, S_PAD {s_pad}, CS {cs}: "
                         "H must divide HD, CS must divide S_PAD and 1 <= S <= S_PAD")
    return b, hd, s_pad


def _cuda_core(name: str, q, k, v, k_scale, v_scale, n_head, s_valid, cs) -> torch.Tensor:
    int8 = k_scale is not None
    _check_kv(name, torch.int8 if int8 else torch.bfloat16, k, v)
    b, hd, s_pad = _check_attn(name, q, k, v, n_head, s_valid, cs)
    if cs % 2 or hd // n_head > 128:
        raise NotImplementedError(f"{name} kernel takes an even CS and Dh <= 128")
    ks_p = vs_p = 0
    if int8:
        for sname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (b, 1, s_pad)
                    or not t.is_contiguous() or t.device != k.device):
                raise ValueError(f"{name}: {sname} must be contiguous f32 [{b}, 1, {s_pad}] "
                                 f"on {k.device}")
        ks_p, vs_p = k_scale.data_ptr(), v_scale.data_ptr()
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k.device)
    _raise_on(_lib().wtt_kb_attn_cuda_core(2 if int8 else 1, q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), ks_p, vs_p, out.data_ptr(), b, hd, s_pad,
                                           s_valid, n_head, cs, _stream(k)), name)
    return out


def kernel_vpu(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K4a: f32 single-query attention, one block per (head, lane) walking
    the chunks -> [B, HD, 1] f32."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs)
    out = _cuda_core("kernel_vpu", q, k, v, None, None, n_head, s_valid, cs)
    kernel_vpu.launches += 1
    return out


def kernel_vpu8(q, k8, v8, k_scale, v_scale, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K8: K4a on int8 K/V with f32 column scales [B, 1, S_PAD]."""
    if k8.device.type == "cpu":
        return attention_ref(q, k8, v8, n_head, s_valid, cs, k_scale=k_scale, v_scale=v_scale)
    if k_scale is None or v_scale is None:
        raise ValueError("kernel_vpu8: int8 K/V need k_scale and v_scale")
    out = _cuda_core("kernel_vpu8", q, k8, v8, k_scale, v_scale, n_head, s_valid, cs)
    kernel_vpu8.launches += 1
    return out


def _mma(name: str, dense: bool, q, k, v, n_head, s_valid, cs) -> torch.Tensor:
    _check_kv(name, torch.bfloat16, k, v)
    b, hd, s_pad = _check_attn(name, q, k, v, n_head, s_valid, cs)
    dh = hd // n_head
    if cs % 64 or (dh % 16 or hd % 32 if dense else dh != 64):
        raise NotImplementedError(
            f"{name} kernel takes CS % 64 == 0 and " +
            ("Dh % 16 == 0, HD % 32 == 0" if dense else "Dh == 64") + f"; got CS {cs}, Dh {dh}")
    lib = _lib()
    if dense and lib.wtt_kb_attn_mma_dense_smem(hd, cs) > DENSE_SMEM_LIMIT:
        raise NotImplementedError(f"{name}: HD {hd} and CS {cs} need more shared memory "
                                  f"than a block has ({DENSE_SMEM_LIMIT} B)")
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k.device)
    _raise_on(lib.wtt_kb_attn_mma(int(dense), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, hd, s_pad, s_valid, n_head, cs, _stream(k)),
              name)
    return out


def kernel_mxu(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K4b: the head-masked dense formulation on the tensor cores (scores
    = qm^T K over all HD rows, vp = V p^T then the head mask), bf16 p ->
    [B, HD, 1] f32."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs, p_bf16=True)
    out = _mma("kernel_mxu", True, q, k, v, n_head, s_valid, cs)
    kernel_mxu.launches += 1
    return out


def kernel_mxub(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K7: per-head tensor-core products q_h^T K_h and p_h V_h^T, bf16 p ->
    [B, HD, 1] f32 (the TPU's [B, H, Dh], same memory)."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs, p_bf16=True)
    out = _mma("kernel_mxub", False, q, k, v, n_head, s_valid, cs)
    kernel_mxub.launches += 1
    return out


def _rowsums(k, v, _tile):
    return rowsum_ref(k, v)     # the tile width (CS or RB) does not change the sums


# name -> (wrapper, plain version taking the wrapper's arguments)
KERNELS = {
    "kernel_read": (kernel_read, _rowsums),
    "kernel_rows": (kernel_rows, _rowsums),
    "kernel_read_all_layers": (kernel_read_all_layers, _rowsums),
    "kernel_flatread": (kernel_flatread, lambda k, v, cs: _flat(rowsum_ref(k, v), k)),
    "kernel_vpu": (kernel_vpu, attention_ref),
    "kernel_mxu": (kernel_mxu, functools.partial(attention_ref, p_bf16=True)),
    "kernel_mxub": (kernel_mxub, functools.partial(attention_ref, p_bf16=True)),
    "kernel_vpu8": (kernel_vpu8, lambda q, k8, v8, k_scale, v_scale, *rest: attention_ref(
        q, k8, v8, *rest, k_scale=k_scale, v_scale=v_scale)),
}
for _fn, _ in KERNELS.values():
    _fn.launches = 0
