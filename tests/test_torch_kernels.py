"""The port's attention kernels, held against the JAX package's Pallas
kernels (interpret mode), in f32 on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version, so
these tests check the plain versions' arithmetic and the wrappers' dispatch.
The CUDA kernels themselves are checked against the same plain versions on
the card (``chip_smoke.py`` and tests/test_torch_cuda.py).
Tolerance 1e-5: both sides compute in f32; only summation order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

TOL = 1e-5


def _flash_inputs(seed, b, tq, tk, h, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, tk, h, dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, tk, h, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("seed,b,tq,tk,h", [(0, 2, 96, 96, 4), (1, 1, 75, 150, 2)])
def test_flash_attention_ref_matches_pallas(seed, b, tq, tk, h):
    """Aligned 96x96 and the unaligned 75x150 case (tests/test_kernels.py)."""
    from whisper_tpu.kernels.attention import flash_attention as jax_flash
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    q, k, v = _flash_inputs(seed, b, tq, tk, h, 64)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_blk=32, interpret=True))
    tq_, tk_, tv_ = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_ref(tq_, tk_, tv_).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < TOL
    # the wrapper, given CPU tensors, returns the plain result
    before = flash_attention.launches
    np.testing.assert_array_equal(flash_attention(tq_, tk_, tv_).numpy(), got)
    assert flash_attention.launches == before


def test_flash_attention_ref_reads_strided_views():
    """q/k/v as views of one [B,T,H,3,Dh] tensor, the encoder's layout."""
    from whisper_tpu_torch.kernels.attention import flash_attention

    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((1, 40, 2, 3, 64)).astype(np.float32) * 0.3)
    q, k, v = qkv.unbind(3)
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _f32_kernel_mirror(q, k, v):
    """numpy mirror of csrc/flash_attention_f32.cu's tiling: blocks of 256 q
    rows, 8 warps of 32; lane (rg, kg) owns rows rg + 4r and keys kg + 8i of
    each 64-key tile (S), columns 4kg + c and 32 + 4kg + c (P.V); P goes
    through the warp's buffer in two halves of 32 keys, permuted as
    P'[row][4kg + t] = P[row][32 * half + kg + 8t], and is read back 4
    entries at a time as the kernel reads it; the running max is kept in
    log2 units, keys past Tk are -inf, row sums stay per lane until the end."""
    b_, tq, h_, dh = q.shape
    tk = k.shape[1]
    log2e = np.float32(1.4426950408889634)
    w, g, kg, r, i = np.ix_(*(range(n) for n in (8, 4, 8, 8, 8)))   # lane (w, g, kg), row r, key i
    rows = (w * 32 + g + 4 * r)[:, :, 0, :, 0]                      # [w, g, r]
    keys = (kg + 8 * i)[0, 0, :, 0, :]                              # [kg, i]
    cols = np.concatenate([4 * np.arange(8)[:, None] + np.arange(4),
                           32 + 4 * np.arange(8)[:, None] + np.arange(4)], axis=1)  # [kg, c]
    out = np.zeros_like(q)
    for b in range(b_):
        for h in range(h_):
            for q0 in range(0, tq, 256):
                qt = np.zeros((256, dh), np.float32)
                qt[:min(256, tq - q0)] = q[b, q0:q0 + 256, h]
                o = np.zeros((8, 4, 8, 8, 8), np.float32)       # w, g, kg, r, c
                m = np.full((8, 4, 8, 8), -np.inf, np.float32)  # w, g, kg, r
                l = np.zeros((8, 4, 8, 8), np.float32)
                for k0 in range(0, tk, 64):
                    kt, vt = (np.zeros((64, dh), np.float32) for _ in range(2))
                    kt[:min(64, tk - k0)] = k[b, k0:k0 + 64, h]
                    vt[:min(64, tk - k0)] = v[b, k0:k0 + 64, h]
                    sc = np.einsum("wgrd,kid->wgkri", qt[rows], kt[keys])
                    sc = np.where((keys < tk - k0)[None, None, :, None, :], sc, -np.inf)
                    m_new = np.maximum(m, sc.max(axis=4).max(axis=2, keepdims=True) * log2e)
                    alpha = np.exp2(m - m_new)
                    pr = np.exp2(sc * log2e - m_new[..., None]).astype(np.float32)
                    l = l * alpha + pr.sum(axis=4)
                    o = o * alpha[..., None]
                    m = m_new
                    for half in range(2):
                        pp = np.full((8, 32, 32), np.nan, np.float32)   # P', as the lanes write it
                        pp[w, g + 4 * r, 4 * kg + i[..., :4]] = pr[..., 4 * half:4 * half + 4]
                        for u in range(8):
                            for t in range(4):
                                key = 32 * half + u + 8 * t
                                pf = pp[:, np.arange(4)[:, None] + 4 * np.arange(8), 4 * u + t]
                                o += pf[:, :, None, :, None] * vt[key][cols][None, None, :, None, :]
                res = o / l.sum(axis=2, keepdims=True)[..., None]
                for rr in range(8):
                    row = q0 + rows[:, :, rr]
                    ok = row < tq
                    for kk in range(8):
                        out[b, row[ok][:, None], h, cols[kk][None, :]] = res[:, :, kk, rr][ok]
    return out


@pytest.mark.parametrize("b,tq,tk,h,scale", [(1, 257, 129, 2, 0.3), (2, 40, 65, 1, 1.2)])
def test_flash_attention_f32_tiling_matches_pallas(b, tq, tk, h, scale):
    """The f32 CUDA kernel's tiling, lane ownership, permuted P buffer and
    log2-unit online softmax, mirrored in numpy, against the Pallas kernel
    (interpret): two q tiles with a row past the first, a last key tile of
    1 key, a large-score case (x4). Tolerance 1e-5 x max(1, max |ref|)."""
    from whisper_tpu.kernels.attention import flash_attention as jax_flash

    q, k, v = (x * np.float32(scale / 0.3) for x in _flash_inputs(3, b, tq, tk, h, 64))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_blk=32, interpret=True))
    got = _f32_kernel_mirror(q, k, v)
    assert np.max(np.abs(got - want)) <= TOL * max(1.0, float(np.abs(want).max()))


def _decode_inputs(seed, b, u, h, dh, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h * dh, 1)).astype(np.float32) * 0.3
    kt = rng.standard_normal((u, h * dh, s)).astype(np.float32) * 0.3
    vt = rng.standard_normal((u, h * dh, s)).astype(np.float32)
    return q, kt, vt


@pytest.mark.parametrize(
    "case",
    ["unmasked", "valid_len", "start_and_valid_len", "kv_group"],
)
def test_decode_attention_ref_matches_pallas(case):
    """Mirrors tests/test_kernels.py:85-146, plus kv_group=2."""
    from whisper_tpu.kernels.decode_attention import decode_attention_hd as jax_dec
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )

    H, Dh, S = 4, 64, 150
    B, G = (4, 2) if case == "kv_group" else (3, 1)
    q, kt, vt = _decode_inputs(5, B, B // G, H, Dh, S)
    valid = start = None
    if case in ("valid_len", "start_and_valid_len", "kv_group"):
        valid = np.array([37, 150, 150, 90][:B], np.int32)
    if case in ("start_and_valid_len", "kv_group"):
        start = np.array([0, 12, 149, 30][:B], np.int32)

    want = np.asarray(jax_dec(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), H,
        valid_len=None if valid is None else jnp.asarray(valid),
        start=None if start is None else jnp.asarray(start),
        kv_group=G, interpret=True,
    ))
    args = (torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(vt), H)
    kw = dict(
        valid_len=None if valid is None else torch.from_numpy(valid),
        start=None if start is None else torch.from_numpy(start),
        kv_group=G,
    )
    got = decode_attention_hd_ref(*args, **kw).numpy()
    assert got.shape == want.shape == (B, H * Dh, 1) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < TOL
    before = decode_attention_hd.launches
    np.testing.assert_array_equal(decode_attention_hd(*args, **kw).numpy(), got)
    assert decode_attention_hd.launches == before


def test_decode_attention_ref_empty_lane_matches_pallas():
    """A lane with start >= valid_len attends no key: every score is -1e30,
    so the softmax weighs all S keys alike and the output is mean(V). S=256
    is a multiple of the Pallas kernel's 128-lane padding, so its padded
    columns do not enter that mean."""
    from whisper_tpu.kernels.decode_attention import decode_attention_hd as jax_dec
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd_ref

    H, Dh, S = 2, 64, 256
    q, kt, vt = _decode_inputs(7, 3, 3, H, Dh, S)
    start = np.array([0, 40, 200], np.int32)
    valid = np.array([256, 40, 100], np.int32)          # lanes 1 and 2 are empty
    want = np.asarray(jax_dec(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), H,
                              valid_len=jnp.asarray(valid), start=jnp.asarray(start),
                              interpret=True))
    got = decode_attention_hd_ref(torch.from_numpy(q), torch.from_numpy(kt),
                                  torch.from_numpy(vt), H, valid_len=torch.from_numpy(valid),
                                  start=torch.from_numpy(start)).numpy()
    assert np.max(np.abs(got - want)) < TOL
    np.testing.assert_allclose(got[1:, :, 0], vt[1:].mean(axis=-1), rtol=0, atol=TOL)


def test_decode_attention_int8_scales_raise():
    """int8 K/V and their column scales come together, f32 [B/G, 1, S];
    the wrapper and the plain version refuse anything else, on any device."""
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd
    from whisper_tpu_torch.kernels.quant import quantize_cols

    q, kt, vt = (torch.from_numpy(x) for x in _decode_inputs(0, 1, 1, 2, 64, 8))
    (k8, ks), (v8, vs) = quantize_cols(kt, axis=-2), quantize_cols(vt, axis=-2)
    assert decode_attention_hd(q, k8, v8, 2, k_scale=ks, v_scale=vs).shape == (1, 128, 1)
    bad = [
        (dict(k_t=kt, v_t=vt, k_scale=ks, v_scale=vs), "need int8"),     # scales without int8
        (dict(k_t=k8, v_t=v8), "need k_scale"),                          # int8 without scales
        (dict(k_t=k8, v_t=v8, k_scale=ks), "go together"),
        (dict(k_t=k8, v_t=vt, k_scale=ks, v_scale=vs), "differ"),
        (dict(k_t=k8, v_t=v8, k_scale=ks.double(), v_scale=vs), "must be f32"),
        (dict(k_t=k8, v_t=v8, k_scale=ks, v_scale=vs[..., :4]), r"must be f32 \[1, 1, 8\]"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            decode_attention_hd(q, kw.pop("k_t"), kw.pop("v_t"), 2, **kw)


@pytest.mark.parametrize(
    "s,itemsize,ptrs,want",
    [(1500, 2, (0, 3_840_000), 4), (1500, 1, (0, 1_920_000), 4), (448, 2, (512, 1024), 4),
     (150, 2, (0, 0), 2), (150, 1, (0, 0), 2), (151, 2, (0, 0), 1), (151, 1, (0, 0), 1),
     (1500, 2, (2, 0), 1), (1500, 2, (0, 4), 2), (1500, 4, (8, 0), 2), (1500, 4, (0, 16), 4)],
)
def test_decode_attention_vector_keys(s, itemsize, ptrs, want):
    """K2's load width: 4 keys where S and every base are aligned to 4
    elements, else 2, else 1 (bf16 cross rows are 3000 B: 8-byte aligned)."""
    from whisper_tpu_torch.kernels.decode_attention import vector_keys

    assert vector_keys(s, itemsize, *ptrs) == want


def test_build_ptxas_report_names_each_kernel():
    """chip_smoke.py's build log: one line per kernel with its registers,
    spills and static shared memory, from nvcc's -Xptxas -v output."""
    from whisper_tpu_torch.kernels._build import ptxas_report

    pre = "_ZN52_GLOBAL__N__e9d8e680_19_decode_attention_cu_449f9e72"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{pre}22decode_attention_kernelI13__nv_bfloat16"
        "aLi4ELi8EEEvNS_4ArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 9792 bytes smem",
        f"ptxas info    : Compiling entry function '{pre}24decode_attention_combineEPKfS1_Pfiii' "
        "for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
    ])
    assert ptxas_report(log) == [
        "22decode_attention_kernelI13__nv_bfloat16aLi4ELi8EE: 64 registers, 0 B spilled, "
        "9792 B static smem",
        "24decode_attention_combineEPKfS1_Pfiii: 40 registers, 8 B spilled, 0 B static smem",
    ]
