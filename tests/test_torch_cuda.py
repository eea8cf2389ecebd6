"""Card-only checks of the port's CUDA kernels: each kernel against its plain
PyTorch version, on the card. Marked ``cuda``; without a card every test
skips (the kernels have no CPU mode; the plain versions are held against
the JAX package by tests/test_torch_kernels.py).

On a machine with a card, which need not have JAX (hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 (bf16 output) 2e-2, one bf16 ulp being 7.8e-3 in [1, 2);
K1's f32 instance 1e-5 x max(1, max |plain|), f32 throughout; K2 (f32 output from identical inputs) 2e-3, bf16 inputs (int8 K/V with a
bf16 query too), and 1e-5 for f32 inputs, only the f32 summation order
differing.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from torch_parallel_cases import spawn_case


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk", [(1, 1500, 1500), (2, 75, 150), (1, 64, 1)])
def test_flash_attention_kernel_matches_plain(b, tq, tk):
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, tq, 20, 3, 64), generator=g, device="cuda").mul(0.5).bfloat16()[:, :, :, 0]
    k, v = torch.randn((2, b, tk, 20, 64), generator=g, device="cuda").mul(0.5).bfloat16().unbind(0)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before + 1
    err = (got.float() - flash_attention_ref(q, k, v).float()).abs().max().item()
    assert err < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,tq,tk,strided",
    [(1, 1500, 1500, True), (8, 1500, 1500, True), (1, 75, 150, False), (2, 150, 75, True),
     (1, 1, 1, False), (3, 129, 257, False), (1, 64, 65, True)],
)
def test_flash_attention_f32_kernel_matches_plain(b, tq, tk, strided):
    """K1's f32 instance (DtypePolicy.f32()): large-v2's shape on the strided
    views the encoder passes, ragged Tq and Tk off the q and key tiles, one
    row and one key. Tolerance 1e-5 x max(1, max |plain|): f32 throughout,
    only the summation order and the exponent's rounding differ."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(13)
    if strided and tq == tk:
        q, k, v = torch.randn((b, tq, 20, 3, 64), generator=g, device="cuda").mul(0.5).unbind(3)
    else:
        q = torch.randn((b, tq, 20, 64), generator=g, device="cuda").mul(0.5)
        k, v = torch.randn((2, b, tk, 20, 64), generator=g, device="cuda").mul(0.5)
        if strided:
            k, v = torch.stack((k, v), dim=3).unbind(3)
    before = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_f32"]
    got = flash_attention(q, k, v)
    assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_f32"]) == (before[0] + 1, before[1] + 1)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, tq, 20, 64)
    assert bool(torch.isfinite(got).all())
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_f32_refuses_what_it_cannot_read():
    """16-byte loads: 16-byte aligned bases and strides of 16-byte multiples
    (4 f32 elements)."""
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_shape

    x = torch.zeros((1, 16, 2, 64), device="cuda")
    odd = torch.zeros((1, 16, 2, 66), device="cuda")[..., :64]      # H stride 66 = 264 B
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(odd, x, x)
    flat = torch.zeros(16 * 2 * 64 + 4, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(x, flat[2:-2].view(1, 16, 2, 64), x)         # base 8 B past an aligned one
    flash_attention(x, flat[4:].view(1, 16, 2, 64), x)               # 16 B past: taken
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention_shape(x, x, x, "wide")                       # one shape only in f32


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,tq,tk,scale",
    [(1, 255, 300, 0.5), (1, 256, 300, 0.5), (2, 257, 300, 0.5), (1, 513, 64, 0.5),
     (1, 100, 63, 0.5), (1, 100, 65, 0.5), (1, 100, 191, 0.5), (1, 100, 192, 0.5),
     (1, 100, 193, 0.5), (3, 40, 384, 0.5), (1, 300, 129, 0.5), (1, 1500, 1500, 2.0),
     (2, 257, 129, 2.0)],
)
def test_flash_attention_f32_kernel_tile_edges(b, tq, tk, scale):
    """The f32 kernel's tiling: Tq at its 256-row q tile +-1 (and two tiles
    +1), Tk at a 64-key ring stage's end +-1, at the 3-stage ring's 192 +-1
    and at twice it, fewer tiles than stages (large-v2 at B=8 is a case of
    the test above); inputs x4 (scores up to ~+-30 and beyond) so the
    running max is rescaled across tiles and exp2 sees wide arguments.
    Tolerance 1e-5 x max(1, max |plain|)."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(17)
    if tq == tk:
        q, k, v = torch.randn((b, tq, 20, 3, 64), generator=g, device="cuda").mul(scale).unbind(3)
    else:
        q = torch.randn((b, tq, 20, 64), generator=g, device="cuda").mul(scale)
        k, v = torch.randn((b, tk, 20, 2, 64), generator=g, device="cuda").mul(scale).unbind(3)
    before = LAUNCHES["flash_attention_f32"]
    got = flash_attention(q, k, v)
    assert LAUNCHES["flash_attention_f32"] == before + 1
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, tq, 20, 64) and bool(torch.isfinite(got).all())
    tol = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_f32_geometry_fills_the_card():
    """One block of 256 q rows a SM; large-v2 at B=1 (6 q tiles x 20 heads)
    is one round on an H100's 132 SMs."""
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention_f32_geometry

    geo = flash_attention_f32_geometry(1, 20, 1500)
    assert geo["rows_per_block"] == 256 and geo["threads"] == 256
    assert geo["blocks_per_sm"] >= 1 and geo["blocks"] == 120
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert geo["rounds"] == pytest.approx(120 / (geo["blocks_per_sm"] * sms))


def _qkv(g, b, tq, tk, strided):
    """q, k, v [B, T, H, 64] bf16: strided views of one [B, T, H, 3, 64]
    tensor, as the encoder hands them over (tq == tk), or contiguous."""
    if strided and tq == tk:
        qkv = torch.randn((b, tq, 20, 3, 64), generator=g, device="cuda").mul(0.5).bfloat16()
        return qkv.unbind(3)
    q = torch.randn((b, tq, 20, 64), generator=g, device="cuda").mul(0.5).bfloat16()
    k, v = torch.randn((2, b, tk, 20, 64), generator=g, device="cuda").mul(0.5).bfloat16()
    if strided:   # k and v as strided views of one [B, Tk, H, 2, 64] tensor
        k, v = torch.stack((k, v), dim=3).unbind(3)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,tq,tk,strided",
    [(8, 1500, 1500, True), (8, 1500, 1500, False), (8, 1500, 1499, False),
     (8, 1499, 1500, True), (2, 75, 150, False), (1, 150, 75, True), (1, 1, 1500, True),
     (1, 1500, 1, False), (3, 129, 257, True), (1, 128, 128, False)],
)
def test_flash_attention_kernel_tile_edges(b, tq, tk, strided):
    """Tq and Tk off the tiles of both block shapes (Wide: 128 q rows,
    128-key tiles; Deep: 192 rows, 64 keys, taken at B=8 T=1500), one row or
    one key, on strided views and contiguous tensors."""
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = _qkv(g, b, tq, tk, strided)
    assert q.is_contiguous() != strided or tq != tk
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, tq, 20, 64) and bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["wide", "deep"])
@pytest.mark.parametrize("b,tq,tk", [(1, 75, 150), (3, 129, 257), (2, 193, 65), (1, 1, 1)])
def test_flash_attention_both_block_shapes_match_plain(shape, b, tq, tk):
    """Each block shape forced (Wide: 128 q rows, 128-key tiles; Deep: 192
    rows, 64-key tiles) on ragged edges, counted like the kernel's own
    choice."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import flash_attention_ref, flash_attention_shape

    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = _qkv(g, b, tq, tk, True)
    before = LAUNCHES["flash_attention"]
    got = flash_attention_shape(q, k, v, shape)
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_flash_attention_refuses_what_tma_cannot_read():
    """TMA needs 16-byte aligned bases and strides of 16-byte multiples; an
    empty key set has nothing to attend."""
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention

    x = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.bfloat16)
    wide = torch.zeros((1, 16, 2, 68), device="cuda", dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide, x, x)                  # H stride 68 elements = 136 B
    flat = torch.zeros(16 * 2 * 64 + 8, device="cuda", dtype=torch.bfloat16)
    shifted = flat[4:-4].view(1, 16, 2, 64)          # base 8 B past an aligned one
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(x, shifted, x)
    flash_attention(x, flat[8:].view(1, 16, 2, 64), x)   # 16 B past: taken
    with pytest.raises(ValueError, match="empty"):
        flash_attention(x, x[:, :0], x[:, :0])             # no key to attend


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,group,masked,dtype",
    [(1, 1500, 1, False, torch.bfloat16), (40, 1500, 5, False, torch.bfloat16),
     (8, 448, 1, True, torch.bfloat16), (3, 150, 1, True, torch.float32)],
)
def test_decode_attention_kernel_matches_plain(b, s, group, masked, dtype):
    _need_card()
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    hd = 20 * 64
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).to(dtype)
    kt = torch.randn((b // group, hd, s), generator=g, device="cuda").mul(0.5).to(dtype)
    vt = torch.randn((b // group, hd, s), generator=g, device="cuda").to(dtype)
    kw = dict(kv_group=group)
    if masked:
        kw["start"] = (torch.arange(b, dtype=torch.int32, device="cuda") * 37) % (s // 2)
        kw["valid_len"] = torch.full((b,), s - 3, dtype=torch.int32, device="cuda")
    got = decode_attention_hd(q, kt, vt, 20, **kw)
    err = (got - decode_attention_hd_ref(q, kt, vt, 20, **kw)).abs().max().item()
    assert err < (2e-3 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", [(448, torch.bfloat16), (1500, torch.float32)])
def test_decode_attention_kernel_empty_lane_matches_plain(s, dtype):
    """Lanes with start >= valid_len attend no key; the kernel, like the
    plain version, gives them mean(V) over [0, S)."""
    _need_card()
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    b, hd = 4, 20 * 64
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).to(dtype)
    kt = torch.randn((b, hd, s), generator=g, device="cuda").mul(0.5).to(dtype)
    vt = torch.randn((b, hd, s), generator=g, device="cuda").to(dtype)
    start = torch.tensor([0, 300, 100, s], dtype=torch.int32, device="cuda")
    valid = torch.tensor([s, 300, 50, s], dtype=torch.int32, device="cuda")
    got = decode_attention_hd(q, kt, vt, 20, valid_len=valid, start=start)
    want = decode_attention_hd_ref(q, kt, vt, 20, valid_len=valid, start=start)
    tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
    assert (got - want).abs().max().item() < tol
    mean_v = vt[1:].float().mean(dim=-1, keepdim=True)
    assert (got[1:] - mean_v).abs().max().item() < tol


def _int8_kv(g, u, hd, s):
    """int8 K/V and their column scales, quantized by the port from seeded
    bf16 tensors as the serving tier's caches are."""
    from whisper_tpu_torch.kernels.quant import quantize_cols

    kt = torch.randn((u, hd, s), generator=g, device="cuda").mul(0.5).bfloat16()
    vt = torch.randn((u, hd, s), generator=g, device="cuda").bfloat16()
    return quantize_cols(kt, axis=-2) + quantize_cols(vt, axis=-2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,group,masked,qdtype",
    [(1, 1500, 1, False, torch.bfloat16), (8, 1500, 1, False, torch.bfloat16),
     (40, 1500, 5, False, torch.bfloat16), (8, 448, 1, True, torch.bfloat16),
     (3, 150, 1, True, torch.float32)],
)
def test_decode_attention_int8_kernel_matches_plain(b, s, group, masked, qdtype):
    """K2's int8 branch: cross, kv_group=5 and masked self attention."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    hd = 20 * 64
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).to(qdtype)
    k8, ks, v8, vs = _int8_kv(g, b // group, hd, s)
    kw = dict(kv_group=group, k_scale=ks, v_scale=vs)
    if masked:
        kw["start"] = (torch.arange(b, dtype=torch.int32, device="cuda") * 7) % 40
        kw["valid_len"] = torch.full((b,), s - 120, dtype=torch.int32, device="cuda")
    counts = LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]
    got = decode_attention_hd(q, k8, v8, 20, **kw)
    assert (LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]) == \
        (counts[0] + 1, counts[1] + 1)
    err = (got - decode_attention_hd_ref(q, k8, v8, 20, **kw)).abs().max().item()
    assert err < (2e-3 if qdtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_decode_attention_int8_kernel_empty_lane_matches_plain():
    """int8 lanes with start >= valid_len get the mean of the dequantized V
    over [0, S), as the plain version does."""
    _need_card()
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )
    from whisper_tpu_torch.kernels.quant import dequantize

    g = torch.Generator(device="cuda").manual_seed(4)
    b, hd, s = 4, 20 * 64, 448
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).bfloat16()
    k8, ks, v8, vs = _int8_kv(g, b, hd, s)
    kw = dict(start=torch.tensor([0, 300, 100, s], dtype=torch.int32, device="cuda"),
              valid_len=torch.tensor([s, 300, 50, s], dtype=torch.int32, device="cuda"),
              k_scale=ks, v_scale=vs)
    got = decode_attention_hd(q, k8, v8, 20, **kw)
    assert (got - decode_attention_hd_ref(q, k8, v8, 20, **kw)).abs().max().item() < 2e-3
    mean_v = dequantize(v8[1:], vs[1:], torch.float32).mean(dim=-1, keepdim=True)
    assert (got[1:] - mean_v).abs().max().item() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s,shift", [(1500, 0), (448, 0), (150, 0), (151, 0), (1500, 1)])
def test_decode_attention_kernel_vector_widths(s, shift, int8):
    """K2 at each load width: S=1500 and 448 take 4 keys a load, 150 two, 151
    one, as does a base one element past an aligned one (shift). Lanes mix
    full, partial and empty intervals, and kv_group=5 shares each K/V lane."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
        vector_keys,
    )

    g = torch.Generator(device="cuda").manual_seed(10)
    hd, group, u = 20 * 64, 5, 2
    b = u * group
    if int8:
        k8, ks, v8, vs = _int8_kv(g, u, hd, s)
        kv = dict(k_scale=ks, v_scale=vs)
    else:
        k8 = torch.randn((u, hd, s), generator=g, device="cuda").mul(0.5).bfloat16()
        v8 = torch.randn((u, hd, s), generator=g, device="cuda").bfloat16()
        kv = {}
    if shift:   # the same values from a base `shift` elements past an aligned one
        k8, v8 = (torch.cat((t.new_zeros(shift), t.flatten()))[shift:].view(t.shape)
                  for t in (k8, v8))
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).bfloat16()
    start = torch.tensor([0, 3, 60, s - 1, 90, 0, 1, 7, s, 0], dtype=torch.int32, device="cuda")
    valid = torch.tensor([s, s - 5, 200, s, 40, 1, 129, 130, s, s - 2], dtype=torch.int32,
                         device="cuda")
    kw = dict(kv_group=group, start=start, valid_len=valid, **kv)
    want_vec = 1 if shift or s % 2 else 2 if s % 4 else 4
    assert vector_keys(s, k8.element_size(), k8.data_ptr(), v8.data_ptr()) == want_vec
    counts = LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]
    got = decode_attention_hd(q, k8, v8, 20, **kw)
    assert (LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]) == \
        (counts[0] + 1, counts[1] + int8)
    want = decode_attention_hd_ref(q, k8, v8, 20, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() < 2e-3


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_do_not_take():
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd

    x = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        flash_attention(x, x, x)                                # f16 on the card
    with pytest.raises(NotImplementedError, match="bf16 or f32"):
        flash_attention(x.float(), x.float(), x.bfloat16())    # mixed dtypes
    y = torch.zeros((1, 16, 2, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Dh=64"):
        flash_attention(y, y, y)
    q = torch.zeros((2, 128, 1), device="cuda")
    kt = torch.zeros((2, 128, 10), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_hd(q, kt.transpose(0, 1).contiguous().transpose(0, 1), kt, 2)
    with pytest.raises(ValueError, match="int32"):
        decode_attention_hd(q, kt, kt, 2, valid_len=torch.ones(2, device="cuda"))
    # int8 K/V and their scales come together, f32 [B/G, 1, S], on q's device
    k8 = torch.zeros((2, 128, 10), device="cuda", dtype=torch.int8)
    sc = torch.ones((2, 1, 10), device="cuda")
    with pytest.raises(ValueError, match="need k_scale"):
        decode_attention_hd(q, k8, k8, 2)                       # int8 without scales
    with pytest.raises(ValueError, match="need int8"):
        decode_attention_hd(q, kt, kt, 2, k_scale=sc, v_scale=sc)   # scales without int8
    with pytest.raises(ValueError, match="contiguous on"):
        decode_attention_hd(q, k8, k8, 2, k_scale=sc.cpu(), v_scale=sc)


# ---------------------------------------------------------------------------
# the microbenchmark's kernels (kernels/kbench.py): kernel against plain,
# at a small ragged shape (S=200, CS=128) and at large-v2's per-layer one.
# Tolerances: f32 p (K4a, K8) 1e-5; bf16 p (K4b, K7) 2e-3 at S=200 and 1e-4
# at large-v2 (an ulp of exp can flip one bf16 rounding of p, which moves
# an output by about that p's ulp times |v| over l), and the mean error
# under a quarter of the mean gap between the bf16-p and f32-p plain
# versions, which a kernel that skipped the rounding would show in full;
# row sums 1e-5 relative to the row's sum of |k| + |v|.
# ---------------------------------------------------------------------------

KB_SHAPES = [dict(B=2, S=200, HD=128, H=2, CS=128, RB=64, L=2),
             dict(B=8, S=1500, HD=1280, H=20, CS=512, RB=256, L=2)]


def _kb_inputs(d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s_pad = -(-d["S"] // d["CS"]) * d["CS"]
    shape = (d["L"], d["B"], d["HD"], s_pad)
    q = torch.randn((d["B"], d["HD"], 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn(shape, generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn(shape, generator=g, device="cuda").bfloat16()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("d", KB_SHAPES, ids=["small", "large-v2"])
@pytest.mark.parametrize("kernel", ["kernel_read", "kernel_rows", "kernel_read_all_layers",
                                    "kernel_flatread"])
def test_kbench_rowsum_kernel_matches_plain(kernel, d):
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    _, k, v = _kb_inputs(d, 5)
    if kernel in ("kernel_read", "kernel_rows"):
        k, v = k[1], v[1]
    arg = d["RB"] if kernel == "kernel_rows" else d["CS"]
    wrapper, ref = kb.KERNELS[kernel]
    before = LAUNCHES[kernel]
    got = wrapper(k, v, arg)
    # the split tiling launches the partial sums and a combine
    assert LAUNCHES[kernel] == before + (1 if kernel == "kernel_rows" else 2)
    want = ref(k, v, arg)
    torch.cuda.synchronize()
    scale = (k.float().abs() + v.float().abs()).sum(-1, keepdim=True).reshape(want.shape)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert ((got - want).abs() / scale).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", KB_SHAPES, ids=["small", "large-v2"])
@pytest.mark.parametrize("kernel", ["kernel_vpu", "kernel_mxu", "kernel_mxub", "kernel_vpu8"])
def test_kbench_attention_kernel_matches_plain(kernel, d):
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    q, k, v = _kb_inputs(d, 6)
    k, v = k[1], v[1]
    if kernel == "kernel_vpu8":
        g = torch.Generator(device="cuda").manual_seed(7)
        k = torch.randint(-127, 128, k.shape, generator=g, device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, v.shape, generator=g, device="cuda", dtype=torch.int8)
        sk = torch.rand((k.shape[0], 1, k.shape[-1]), generator=g, device="cuda") * 9e-3 + 1e-3
        sv = torch.rand((k.shape[0], 1, k.shape[-1]), generator=g, device="cuda") * 9e-3 + 1e-3
        args = (q, k, v, sk, sv, d["H"], d["S"], d["CS"])
    else:
        args = (q, k, v, d["H"], d["S"], d["CS"])
    wrapper, ref = kb.KERNELS[kernel]
    before = LAUNCHES[kernel]
    got = wrapper(*args)
    assert LAUNCHES[kernel] == before + 1
    want = ref(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (d["B"], d["HD"], 1) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    if kernel in ("kernel_vpu", "kernel_vpu8"):
        assert err.max().item() < 1e-5
    else:
        assert err.max().item() < (2e-3 if d["S"] == 200 else 1e-4)
        gap = (want - kb.attention_ref(*args)).abs()           # the rounding's whole effect
        assert err.mean().item() <= 0.25 * gap.mean().item()


# K4b's cluster geometry (kernels.kbench.mxu_geometry) at its edges, each
# case's geometry pinned on the CPU by tests/test_torch_kbench.py:
# (B, H, Dh, S, S_PAD, CS)
MXU_EDGES = [
    (8, 20, 64, 1, 1536, 512),       # one key: blocks 1 and 2 wholly past S
    (8, 20, 64, 511, 1536, 512),     # one below, at and one above block 0's 512 keys
    (8, 20, 64, 512, 1536, 512),
    (8, 20, 64, 513, 1536, 512),
    (8, 20, 64, 100, 1536, 512),     # blocks wholly past S
    (8, 20, 64, 1500, 1536, 64),     # 24 chunks over 4 blocks: 6 whole chunks a block
    (8, 2, 64, 1500, 1536, 512),     # H = 2
    (8, 20, 16, 1500, 1536, 512),    # Dh = 16
    (8, 20, 128, 1500, 1536, 512),   # Dh = 128
    (4, 20, 128, 200, 256, 128),     # groups of 3 heads (the last of 2), 3 row blocks
    (1, 20, 80, 1000, 1024, 512),    # groups of 3 heads, a partial row block, chunks in 4 parts
    (64, 20, 16, 100, 128, 128),     # groups of 10 heads: two n-tiles; clusters of 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,dh,s,s_pad,cs", MXU_EDGES)
def test_kbench_mxu_kernel_geometry_edges(b, h, dh, s, s_pad, cs):
    """K4b against its plain version where its key ranges, head groups and
    chunk exchange meet their edges: 1e-4 of the output's size at most, and
    the mean error under a quarter of the bf16 rounding's mean effect, which
    a p rounded at a block's own max or at the global max would exceed."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(12)
    hd = h * dh
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = LAUNCHES["kernel_mxu"]
    got = kb.kernel_mxu(q, k, v, h, s, cs)
    assert LAUNCHES["kernel_mxu"] == before + 1
    want = kb.KERNELS["kernel_mxu"][1](q, k, v, h, s, cs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, hd, 1) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert err.max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    gap = (want - kb.attention_ref(q, k, v, h, s, cs)).abs()
    assert err.mean().item() <= 0.25 * gap.mean().item()


# K7's cluster over the keys (kernels.kbench.mxub_geometry) at its edges,
# each case's geometry pinned on the CPU by tests/test_torch_kbench.py
# (MXUB_SHAPES): (B, H, S, S_PAD, CS), Dh = 64
MXUB_EDGES = [
    (8, 20, 1, 1536, 512),       # one key: blocks 1 and 2 wholly past S, no tile of theirs read
    (8, 20, 100, 1536, 512),     # a partial tile, then blocks wholly past S
    (8, 20, 511, 1536, 512),     # one below, at and one above block 0's 512 keys
    (8, 20, 512, 1536, 512),
    (8, 20, 513, 1536, 512),
    (8, 20, 1500, 1536, 512),    # the tool's shape: clusters of 3, a chunk a block
    (8, 20, 1500, 1536, 64),     # CS = 64: several whole chunks a block
    (8, 2, 1500, 1536, 512),     # H = 2: chunks cut in parts
    (1, 20, 1500, 1536, 512),    # B = 1
    (8, 20, 1500, 1536, 1536),   # a single chunk, cut in parts
    (1, 2, 6000, 6144, 6144),    # a single chunk cut in 8 parts: the widest cluster
    (1, 2, 6000, 6144, 512),     # 12 chunks, two whole chunks a block
    (8, 2, 60, 64, 64),          # one tile, four keys of it past S: clusters of 1
    (1, 1, 250000, 2**18, 2**18),  # 32768 keys a block: a ring of 2 tiles, all that fits
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,s_pad,cs", MXUB_EDGES)
def test_kbench_mxub_kernel_edges(b, h, s, s_pad, cs):
    """K7 against its plain version where its key ranges, skipped tiles and
    chunk exchange meet their edges: 1e-4 of the output's size at most, and
    the mean error under a quarter of the bf16 rounding's mean effect, which
    a p rounded at a block's own max or at the global max would exceed."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(15)
    hd = 64 * h
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = LAUNCHES["kernel_mxub"]
    got = kb.kernel_mxub(q, k, v, h, s, cs)
    assert LAUNCHES["kernel_mxub"] == before + 1
    want = kb.KERNELS["kernel_mxub"][1](q, k, v, h, s, cs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, hd, 1) and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert err.max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    gap = (want - kb.attention_ref(q, k, v, h, s, cs)).abs()
    assert err.mean().item() <= 0.25 * gap.mean().item()


@pytest.mark.cuda
def test_kbench_mxub_many_pairs_few_keys():
    """K7 at 64 lanes x 20 heads, S = 100 keys of one 128-key chunk
    (clusters of 1): 1280 (head, lane) pairs with a small l each, so a bf16
    rounding of p that two f32 score orders take to different sides weighs
    in full, and the plain version itself lies further than 1e-4 from the
    function taken in f64. So each output may differ from the plain version
    by 1e-4 of the output's size plus the effect of every p whose rounding
    lies within 1 % of a bf16 spacing of its tie, |v| times that spacing
    over l; and the mean error stays under a quarter of the bf16
    rounding's mean effect."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb

    b, h, s, s_pad, cs = 64, 20, 100, 128, 128
    g = torch.Generator(device="cuda").manual_seed(15)
    q = torch.randn((b, 64 * h, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, 64 * h, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, 64 * h, s_pad), generator=g, device="cuda").bfloat16()
    assert kb.mxub_geometry(b, h, s_pad, cs).cluster == 1
    got = kb.kernel_mxub(q, k, v, h, s, cs)
    want = kb.attention_ref(q, k, v, h, s, cs, p_bf16=True)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    # one chunk: p = exp(s - max) over the keys < S, its scores in f64
    q4 = q.double().view(b, h, 64)
    k4, v4 = (x.double().view(b, h, 64, s_pad)[..., :s] for x in (k, v))
    sc = torch.einsum("bhd,bhds->bhs", q4, k4)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    spacing = torch.exp2(torch.floor(torch.log2(p)) - 7)        # bf16's, at p
    near_tie = ((p / spacing) % 1 - 0.5).abs() < 0.01
    flips = torch.einsum("bhs,bhds->bhd", near_tie * spacing, v4.abs()) / p.sum(-1)[..., None]
    limit = 1e-4 * max(1.0, want.abs().max().item()) + flips.reshape(b, 64 * h, 1)
    assert bool((err <= limit).all())
    gap = (want - kb.attention_ref(q, k, v, h, s, cs)).abs()
    assert err.mean().item() <= 0.25 * gap.mean().item()


@pytest.mark.cuda
def test_kbench_mxub_refuses_a_block_too_large():
    """K7 needs a block's scores and p in shared memory: one chunk of 2^19
    keys over at most 8 blocks leaves 65536 keys a block, which do not fit
    beside the ring."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    q = torch.zeros((1, 64, 1), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2**19), device="cuda", dtype=torch.bfloat16)
    before = LAUNCHES["kernel_mxub"]
    with pytest.raises(NotImplementedError, match="no K7 block fits"):
        kb.kernel_mxub(q, k, k, 1, 100, 2**19)
    assert LAUNCHES["kernel_mxub"] == before


# K8's cluster over the keys (kernels.kbench.vpu8_geometry) at its edges,
# each case's geometry pinned on the CPU by tests/test_torch_kbench.py:
# (B, H, Dh, S, S_PAD, CS, the largest scores in the last key range, the
# K/V bases 2 bytes past a 16-byte boundary)
VPU8_EDGES = [
    (8, 20, 64, 1, 1536, 512, False, False),      # one key: a cluster of 1
    (8, 20, 64, 15, 1536, 512, False, False),     # one 16-key group, part of it
    (8, 20, 64, 16, 1536, 512, False, False),
    (8, 20, 64, 17, 1536, 512, False, False),     # two 16-key groups, the second of one key
    (8, 20, 64, 1500, 1536, 512, False, False),   # the tool's shape: clusters of 3
    (8, 20, 64, 1500, 1536, 64, False, False),    # CS does not move the kernel's split
    (8, 20, 64, 200, 200, 200, False, False),     # S_PAD % 16 != 0: 2-byte loads
    (1, 20, 64, 1500, 1536, 512, False, False),   # B = 1
    (8, 2, 64, 1500, 1536, 512, False, False),    # H = 2
    (8, 20, 16, 1500, 1536, 512, False, False),   # Dh = 16
    (8, 20, 128, 1500, 1536, 512, False, False),  # Dh = 128: 16 rows a thread
    (2, 3, 72, 300, 304, 16, False, False),       # Dh = 72: rows past Dh in the warps
    (2, 2, 128, 200, 200, 200, False, False),     # 2-byte loads and 16 rows a thread
    (1, 2, 64, 6000, 6144, 512, False, False),    # a cluster of 8, 752 keys a block: two passes
    (8, 20, 64, 6000, 6144, 512, False, False),   # 752 keys a block, many clusters
    (8, 20, 64, 1500, 1536, 512, True, False),    # the peak in the last range
    (1, 2, 64, 6000, 6144, 512, True, False),     # ... and in a block's second pass
    (8, 20, 64, 1500, 1536, 512, False, True),    # unaligned bases: 2-byte loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,dh,s,s_pad,cs,peak,offset", VPU8_EDGES)
def test_kbench_vpu8_kernel_edges(b, h, dh, s, s_pad, cs, peak, offset):
    """K8 against its plain version where its key ranges, passes, rows a
    thread and load widths meet their edges, within 1e-5 of the output's
    size (f32 p on both sides; only the order of the f32 sums differs). With
    ``peak`` the last keys score far above the rest, so a block weight
    e^(m_j - M) taken wrong shows in full."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(14)
    hd = h * dh
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    n = b * hd * s_pad
    k8, v8 = (torch.randint(-127, 128, (n + 16,), generator=g, device="cuda", dtype=torch.int8)
              for _ in range(2))
    k8, v8 = (x[2:n + 2] if offset else x[:n] for x in (k8, v8))
    k8, v8 = k8.view(b, hd, s_pad), v8.view(b, hd, s_pad)
    sk, sv = (torch.rand((b, 1, s_pad), generator=g, device="cuda") * 9e-3 + 1e-3
              for _ in range(2))
    if peak:
        # q . K at its largest, times the largest scale, on the last 3 keys
        assert kb.vpu8_geometry(b, h, s, s_pad).ranges[-1][0] <= s - 3
        k8[..., s - 3:s] = torch.where(q > 0, 127, -127).to(torch.int8)
        sk[..., s - 3:s] = 1e-2
    before = LAUNCHES["kernel_vpu8"]
    got = kb.kernel_vpu8(q, k8, v8, sk, sv, h, s, cs)
    assert LAUNCHES["kernel_vpu8"] == before + 1
    want = kb.KERNELS["kernel_vpu8"][1](q, k8, v8, sk, sv, h, s, cs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, hd, 1) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


# K4a's cluster over the keys (kernels.kbench.vpu_geometry) at its edges,
# each case's geometry pinned on the CPU by tests/test_torch_kbench.py
# (VPU_SHAPES): (B, H, Dh, S, S_PAD, CS, the largest scores in the last key
# range)
VPU_EDGES = [
    (8, 20, 64, 1, 1536, 512, False),      # one key: a cluster of 1, one tile
    (8, 20, 64, 63, 1536, 512, False),     # one below, at and one above a tile
    (8, 20, 64, 64, 1536, 512, False),
    (8, 20, 64, 65, 1536, 512, False),     # two tiles, the second of one key
    (8, 20, 64, 1500, 1536, 512, False),   # the tool's shape: clusters of 4
    (8, 20, 64, 1500, 1536, 64, False),    # CS does not move the kernel's split
    (1, 20, 64, 1500, 1536, 512, False),   # B = 1: clusters of 6
    (8, 2, 64, 1500, 1536, 512, False),    # H = 2: clusters of 8
    (8, 20, 16, 1500, 1536, 512, False),   # Dh = 16: a ring of 8 stages
    (2, 3, 72, 300, 304, 16, False),       # Dh = 72: 3 stages, rows past Dh in the warps
    (8, 20, 128, 1500, 1536, 512, False),  # Dh = 128: 2 stages, 32 rows a warp
    (2, 4, 13, 100, 104, 8, False),        # an odd Dh: boxes of 13 rows
    (64, 20, 64, 100, 128, 128, False),    # many pairs with few keys: clusters of 1
    (1, 2, 64, 6000, 6144, 512, False),    # a cluster of 8, two passes a block
    (8, 20, 64, 1500, 1536, 512, True),    # the peak in the last range
    (1, 2, 64, 6000, 6144, 512, True),     # ... and in a block's second pass
    (2, 3, 72, 300, 306, 18, False),       # S_PAD % 8 != 0: the producer's 4-byte copies
    (2, 2, 128, 200, 202, 2, False),       # ... with 32 rows a warp
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,dh,s,s_pad,cs,peak", VPU_EDGES)
def test_kbench_vpu_kernel_edges(b, h, dh, s, s_pad, cs, peak):
    """K4a against its plain version where its key ranges, passes, ring
    depths, rows a warp and load paths meet their edges, within 1e-5 of the
    output's size (f32 p on both sides; only the order of the f32 sums
    differs). With ``peak`` the last keys score far above the rest, so a
    block weight e^(m_j - M) taken wrong shows in full."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(16)
    hd = h * dh
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    if peak:
        # q . K at its largest on the last 3 keys
        assert kb.vpu_geometry(b, h, s, s_pad).ranges[-1][0] <= s - 3
        k[..., s - 3:s] = torch.where(q > 0, 2.0, -2.0).bfloat16()
    before = LAUNCHES["kernel_vpu"]
    got = kb.kernel_vpu(q, k, v, h, s, cs)
    assert LAUNCHES["kernel_vpu"] == before + 1
    want = kb.KERNELS["kernel_vpu"][1](q, k, v, h, s, cs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, hd, 1) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("lead,hd,s_pad", [((3,), 13, 8), ((2,), 128, 208), ((1,), 100, 3000),
                                           ((8,), 1280, 1536)])
def test_kbench_rows_kernel_edges(lead, hd, s_pad):
    """K5 at S_PAD off a lane's 6 + 6 loads (8 and 208 in one partial pass,
    3000 in two with a tail) and at row counts off a block's 8 (39, 100)."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(13)
    k = torch.randn((*lead, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((*lead, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = LAUNCHES["kernel_rows"]
    got = kb.kernel_rows(k, v, hd)
    assert LAUNCHES["kernel_rows"] == before + 1
    want = kb.rowsum_ref(k, v)
    torch.cuda.synchronize()
    scale = (k.float().abs() + v.float().abs()).sum(-1, keepdim=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert ((got - want).abs() / scale).max().item() <= 1e-5


@pytest.mark.cuda
def test_kbench_mxu_refuses_what_it_cannot_take():
    """K4b needs Dh % 16 == 0, and a block's scores in shared memory: one
    chunk of 2^18 keys over at most 8 blocks leaves 32768 keys a block, whose
    f32 scores and bf16 p do not fit beside the ring."""
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb

    q = torch.zeros((1, 16, 1), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 16, 2**18), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no K4b block fits"):
        kb.kernel_mxu(q, k, k, 1, 100, 2**18)
    k = torch.zeros((1, 16, 128), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Dh % 16"):
        kb.kernel_mxu(q, k, k, 2, 100, 64)            # Dh = 8


@pytest.mark.cuda
def test_kbench_wrappers_refuse_what_they_do_not_take():
    _need_card()
    from whisper_tpu_torch.kernels import kbench as kb

    q, k, v = _kb_inputs(KB_SHAPES[0], 8)
    k, v = k[0], v[0]
    with pytest.raises(NotImplementedError, match="bfloat16 K/V"):
        kb.kernel_read(k.float(), v.float(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        kb.kernel_read(k[..., :128], v[..., :128], 128)
    with pytest.raises(ValueError, match="multiple of RB"):
        kb.kernel_rows(k, v, 48)
    with pytest.raises(NotImplementedError, match="CS % 64"):
        kb.kernel_mxub(q, k, v, 2, 200, 32)
    with pytest.raises(ValueError, match="k_scale"):
        kb.kernel_vpu8(q, k.to(torch.int8), v.to(torch.int8), None, None, 2, 200, 128)


# ---------------------------------------------------------------------------
# beam search and the batched scheduler: the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1 bf16", "k1 f32", "k2 bf16 cross", "k2 bf16 self",
                                  "k2 int8 cross", "k2 int8 self"])
def test_kernels_at_a_ranks_share_of_the_heads(case):
    """K1 and K2 at H=10: a rank's share of large-v2's 20 heads under
    tensor parallelism at n_model = 2 (K1: 60 blocks at B=1; K2: U = B x 10
    lanes of heads), against their plain versions, with the tolerances of
    the H=20 tests above."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(21)
    if case.startswith("k1"):
        qkv = torch.randn((1, 1500, 10, 3, 64), generator=g, device="cuda").mul(0.5)
        q, k, v = (qkv if case == "k1 f32" else qkv.bfloat16()).unbind(3)
        got, want = flash_attention(q, k, v), flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        assert got.shape == (1, 1500, 10, 64) and got.dtype == q.dtype
        tol = 1e-5 * max(1.0, want.abs().max().item()) if case == "k1 f32" else 2e-2
        assert (got.float() - want.float()).abs().max().item() <= tol
        return
    b, s = (1, 1500) if case.endswith("cross") else (8, 448)
    hd = 10 * 64
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.5).bfloat16()
    if "int8" in case:
        k8, ks, v8, vs = _int8_kv(g, b, hd, s)
        kt, vt, kw = k8, v8, dict(k_scale=ks, v_scale=vs)
    else:
        kt = torch.randn((b, hd, s), generator=g, device="cuda").mul(0.5).bfloat16()
        vt = torch.randn((b, hd, s), generator=g, device="cuda").bfloat16()
        kw = {}
    if case.endswith("self"):
        kw["start"] = (torch.arange(b, dtype=torch.int32, device="cuda") * 7) % 40
        kw["valid_len"] = torch.full((b,), 328, dtype=torch.int32, device="cuda")
    before = LAUNCHES["decode_attention_hd"]
    got = decode_attention_hd(q, kt, vt, 10, **kw)
    assert LAUNCHES["decode_attention_hd"] == before + 1
    err = (got - decode_attention_hd_ref(q, kt, vt, 10, **kw)).abs().max().item()
    assert err < 2e-3


SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>


@pytest.fixture(scope="module")
def scripted_path(tmp_path_factory):
    """A scripted checkpoint with head dim 64 (d=256, 4 heads), so the card
    runs K1 and K2, written by chip_smoke.py's own writer (no JAX here)."""
    import chip_smoke
    from whisper_tpu_torch.hparams import ModelDims

    dims = ModelDims(51_864, 96, 256, 4, 2, 48, 256, 4, 2, 80, 1)
    path = str(tmp_path_factory.mktemp("cuda") / "scripted.bin")
    chip_smoke.write_checkpoint(path, dims, chip_smoke.scripted_tensors(dims, SCRIPT, 0))
    return path


def _model(path, device, tier):
    if tier == "serving":
        import chip_smoke

        return chip_smoke.serving_model(path, device)
    from whisper_tpu_torch.api.model import Model

    return Model(path, device=device)


def _segments(results):
    return [[(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in r.segments] for r in results]


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "serving"])
def test_beam_run_full_on_card_matches_cpu(scripted_path, tier):
    """Beam 5 through run_full: the scripted transcript on card and CPU,
    with K2's grouped cross-attention launched on the card (half of its
    launches, int8 on the serving tier)."""
    _need_card()
    import numpy as np

    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
    from whisper_tpu_torch.kernels._build import LAUNCHES

    params = FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=5)
    audio = np.zeros(16_000 * 2, np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        LAUNCHES.clear()
        out[device] = _segments([_model(scripted_path, device, tier).create_context()
                                 .run_full(params, audio)])
        counts = tuple(LAUNCHES[k] for k in ("decode_attention_hd", "decode_attention_hd_grouped",
                                             "decode_attention_hd_int8"))
        if device == "cuda":
            assert counts[0] > 0 and 2 * counts[1] == counts[0]
            assert counts[2] == (counts[0] if tier == "serving" else 0)
        else:
            assert counts == (0, 0, 0)
    assert out["cuda"] == out["cpu"] == [[(" hi", 0, 192, SCRIPT[:5])]]


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [0, 5], ids=["greedy", "beam5"])
def test_batch_transcriber_on_card_matches_cpu(scripted_path, beam):
    """BatchTranscriber(batch=4) over 6 scripted clips (two rounds, the
    second with two dead lanes): card and CPU give the same segments."""
    _need_card()
    import numpy as np

    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    params = FullParams(language="en")
    if beam:
        params.strategy, params.beam_width = SamplingStrategy.BEAM_SEARCH, beam
    rng = np.random.default_rng(0)
    clips = [(0.1 * rng.standard_normal(int(16_000 * s))).astype(np.float32)
             for s in (1.2, 2.5, 1.6, 2.0, 2.2, 1.4)]
    got = {device: _segments(BatchTranscriber(_model(scripted_path, device, "bf16"), batch=4)
                             .transcribe(clips, params)) for device in ("cuda", "cpu")}
    assert got["cuda"] == got["cpu"] == [[(" hi", 0, 192, SCRIPT[:5])]] * 6


@pytest.mark.cuda
def test_run_full_f32_policy_on_card_matches_cpu(scripted_path):
    """DtypePolicy.f32() through run_full: the encoder runs K1's f32
    instance (one launch per encoder layer and window), and the card gives
    the CPU's transcript."""
    _need_card()
    import numpy as np

    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.model.params import DtypePolicy

    audio = np.zeros(16_000 * 2, np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        LAUNCHES.clear()
        model = Model(scripted_path, policy=DtypePolicy.f32(), device=device)
        out[device] = _segments([model.create_context().run_full(FullParams(language="en"), audio)])
        if device == "cuda":
            assert LAUNCHES["flash_attention"] == LAUNCHES["flash_attention_f32"] == model.dims.n_audio_layer
        else:
            assert LAUNCHES["flash_attention"] == 0
    assert out["cuda"] == out["cpu"] == [[(" hi", 0, 192, SCRIPT[:5])]]


@pytest.mark.cuda
def test_run_capture_on_card_matches_cpu(scripted_path):
    """run_capture over a paced source: run_full runs on the runner's worker
    thread, where the kernels launch on that thread's current stream; the
    card gives the CPU's buffers and segments, with K1 and K2 counted from
    the worker thread (L_enc K1 launches per encode, 2 L_dec K2 per token
    step the card ran). The source is tests/test_torch_capture.py's, from chip_smoke.py
    (no JAX here)."""
    _need_card()
    import numpy as np

    from chip_smoke import chunks_of, counting, noise_floor, recorded_capture, speechy
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import Flags, FullParams
    from whisper_tpu_torch.audio.capture import CaptureParams
    from whisper_tpu_torch.kernels._build import LAUNCHES

    sr = 16_000
    chunks = chunks_of(np.concatenate([noise_floor(sr), speechy(sr * 4, 0), noise_floor(sr),
                                       speechy(sr * 2, 2)]))
    out = {}
    for device in ("cuda", "cpu"):
        LAUNCHES.clear()
        model = Model(scripted_path, device=device)
        with counting(model.runtime) as rec:
            buffers, _, res = recorded_capture(
                model.create_context(), FullParams(language="en", flags=Flags.NO_CONTEXT), chunks,
                CaptureParams(min_duration=1.0, max_duration=2.0))
        out[device] = (buffers, _segments([res]))
        k1, k2 = LAUNCHES["flash_attention"], LAUNCHES["decode_attention_hd"]
        if device == "cuda":
            assert k1 == model.dims.n_audio_layer * rec.encodes and rec.encodes >= 2
            assert k2 == 2 * model.dims.n_text_layer * rec.launched
        else:
            assert k1 == k2 == 0
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0][:2] == [32_000, 32_000]
    assert out["cuda"][1] == [[(" hi", 0, 192, SCRIPT[:5])] * 2]



# ---------------------------------------------------------------------------
# the token loops' steps replayed as CUDA graphs against the eager steps
# ---------------------------------------------------------------------------

GRAPH_DIMS = {  # TINY_TEST_DIMS of tests/helpers.py, and large-v2's widths with one layer each
    "tiny": (51_864, 96, 64, 4, 2, 48, 64, 4, 2, 80, 1),
    "large-v2-1": (51_865, 1500, 1280, 20, 1, 448, 1280, 20, 1, 80, 1),
}
W8A16_DIMS = {  # TINY widths at large-v2's decoder depth: 193 int8 products a token step
    "tiny-32": (51_864, 96, 64, 4, 2, 48, 64, 4, 32, 80, 1),
}
GRAPH_CASES = {  # loop, lanes (utterances for beam 5), force_steps
    "greedy-B1-natural": ("greedy", 1, 0), "greedy-B1-forced": ("greedy", 1, 17),
    "greedy-B3-natural": ("greedy", 3, 0), "greedy-B3-forced": ("greedy", 3, 17),
    "beam-U1": ("beam", 1, 0), "beam-U2": ("beam", 2, 0),
}


@pytest.fixture(scope="module")
def graph_runtimes(tmp_path_factory):
    """Runtimes on the card by (dims, tier), made at first use: random
    weights from chip_smoke.py's writer (no JAX here); the int8 tier with
    int8 decoder weights and int8 K/V caches."""
    made = {}

    def get(dims_name, tier):
        if (dims_name, tier) not in made:
            import chip_smoke
            from whisper_tpu_torch.hparams import ModelDims

            path = tmp_path_factory.mktemp("graph") / f"{dims_name}.bin"
            dims = ModelDims(*{**GRAPH_DIMS, **W8A16_DIMS}[dims_name])
            chip_smoke.write_checkpoint(str(path), dims, chip_smoke.random_tensors(dims, 5))
            made[(dims_name, tier)] = _model(str(path), "cuda",
                                             "serving" if tier == "int8" else "bf16").runtime
        return made[(dims_name, tier)]

    return get


def _graph_inputs(rt, lanes, seed):
    """Seeded right-padded prompts of lengths 1, 4, 2, ... and a seeded
    cross K/V [L, lanes, HD, T] of the runtime's tier (int8 codes with
    column scales from ``quantize_cols``), made on the card."""
    from whisper_tpu_torch.kernels.quant import quantize_cols
    from whisper_tpu_torch.model.encoder import CrossKV

    dims = rt.dims
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (dims.n_text_layer, lanes, dims.n_text_state, dims.n_audio_ctx)
    k, v = (torch.randn(shape, generator=g, device="cuda") * 0.5 for _ in range(2))
    if rt.kv_int8:
        (k, ks), (v, vs) = (quantize_cols(x, axis=-2) for x in (k, v))
        cross = CrossKV(k, v, ks, vs)
    else:
        cross = CrossKV(k.to(rt.compute_dtype), v.to(rt.compute_dtype))
    prompts = np.zeros((lanes, rt.prompt_capacity), np.int32)
    plens = np.array([[1, 4, 2][i % 3] for i in range(lanes)], np.int32)
    for i, n in enumerate(plens):
        prompts[i, :n] = [rt.ids.sot, 300 + i, 400, rt.ids.transcribe][-n:]
    return prompts, plens, cross


def _captured(rt):
    return [st for slot in rt.graphs.slots.values() for st in slot.steps.values()]


def _graph_window(rt, case, prompts, plens, cross, seek_end=10**6):
    """One window of ``case``, the launches it adds, the token steps the
    card ran for it (replays on the graph, else the window's steps) and
    the captured launches of each step it replayed: (WindowResult as
    numpy arrays, a Counter by wrapper name, steps run, [Counter])."""
    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    loop, lanes, force = case
    before = LAUNCHES.copy()
    replays = rt.graphs.replays()
    was = {id(st): st.replays for st in _captured(rt)}
    seeks, ends = np.zeros(lanes, np.int32), np.full(lanes, seek_end, np.int32)
    if loop == "greedy":
        res = rt.run_window(prompts, plens, cross, seeks, ends, force_steps=force)
    else:
        params = FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=5)
        res = decode_window_beam(rt, params, prompts, plens, cross, seeks, ends, force_steps=force)
    torch.cuda.synchronize()
    run = rt.graphs.replays() - replays if rt.replays else int(res.steps)
    replayed = [st.launches for st in _captured(rt) if st.replays > was.get(id(st), 0)]
    return {k: v.cpu().numpy() for k, v in res._asdict().items()}, LAUNCHES - before, run, replayed


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES), ids=list(GRAPH_CASES))
@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("dims", list(GRAPH_DIMS))
def test_graph_window_matches_eager(graph_runtimes, dims, tier, case):
    """The window replayed as CUDA graphs gives every array of the eager
    window's WindowResult, bit for bit, and K2 counts of 2 L a step run (L
    of them grouped on the beam path; all int8 on the int8 tier). The
    graph's loop reads its flag one step behind, so a window that ends
    before its cap runs one more step, which changes nothing. Each replay
    adds exactly its capture's launches, for every wrapper: the graph's
    window counts the eager window's launches and its extra step's. A second
    window through the same graph (other prompts and cross K/V, and a
    short seek_end) equals a fresh eager window: the runtime's tensors are
    reset between windows."""
    _need_card()
    rt = graph_runtimes(dims, tier)
    loop, lanes, force = GRAPH_CASES[case]
    n_dec = rt.dims.n_text_layer
    out = {}
    for mode in ("graph", "eager"):
        rt.cuda_graphs = mode == "graph"
        try:
            first = _graph_window(rt, GRAPH_CASES[case], *_graph_inputs(rt, lanes, 1))
            second = _graph_window(rt, GRAPH_CASES[case], *_graph_inputs(rt, lanes, 2),
                                   seek_end=1_700)
        finally:
            rt.cuda_graphs = True
        out[mode] = (first, second)
    for (g_res, g_launches, g_run, g_steps), (e_res, e_launches, e_run, _) in zip(out["graph"], out["eager"]):
        _assert_identical(g_res, e_res)
        steps = int(g_res["steps"])
        assert steps == force if force else 1 <= steps <= rt.n_max_steps
        assert e_run == steps and g_run == steps + (steps < (force or rt.n_max_steps))
        for launches, run in ((g_launches, g_run), (e_launches, e_run)):
            counts = tuple(launches[k] for k in ("decode_attention_hd", "decode_attention_hd_int8",
                                                 "decode_attention_hd_grouped"))
            assert counts == (2 * n_dec * run, 2 * n_dec * run if tier == "int8" else 0,
                              n_dec * run if loop == "beam" else 0)
        assert g_steps and all(s == g_steps[0] for s in g_steps)
        assert g_launches == e_launches + Counter({k: n * (g_run - e_run) for k, n in g_steps[0].items()})
    assert not all(np.array_equal(out["graph"][0][0][k], out["graph"][1][0][k])
                   for k in out["graph"][0][0])


@pytest.mark.cuda
def test_graph_slots_hold_static_tensors(graph_runtimes):
    """The runtime keeps one slot per loop shape, whose graphs bake in its
    tensors: replayed windows reuse them (the slot's cache is the one the
    K2 launches read: ``vector_keys`` saw its addresses), and a window of
    other constants adds a graph, not a slot."""
    _need_card()
    from whisper_tpu_torch.kernels.decode_attention import vector_keys

    rt = graph_runtimes("tiny", "bf16")
    prompts, plens, cross = _graph_inputs(rt, 3, 3)
    _graph_window(rt, ("greedy", 3, 0), prompts, plens, cross)
    slots = dict(rt.graphs.slots)
    _graph_window(rt, ("greedy", 3, 5), prompts, plens, cross)
    assert rt.graphs.slots == slots
    slot = next(s for key, s in slots.items() if key[:2] == ("greedy", 3))
    assert set(slot.steps) >= {(0, False, 0), (0, False, 5)}
    assert slot.nbytes > sum(a.nbytes for a in slot.kv if a is not None) > 0
    assert vector_keys(slot.kv.k.shape[-1], 2, slot.kv.k[0].data_ptr(), slot.kv.v[0].data_ptr()) == 4
    launches = slot.steps[(0, False, 0)].launches
    assert launches["decode_attention_hd"] == 2 * rt.dims.n_text_layer and launches["flash_attention"] == 0
    replays = rt.graphs.replays()
    _, _, run, _ = _graph_window(rt, ("greedy", 3, 5), prompts, plens, cross)
    assert run == 5 == rt.graphs.replays() - replays and slot.steps[(0, False, 5)].replays >= 10


@pytest.mark.cuda
def test_graph_capture_failure_raises(graph_runtimes, monkeypatch):
    """A step that cannot be captured (here: a host read of the device
    state inside the step) makes run_window raise; nothing falls back to
    the eager step, and the kernel counters are left as they were."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.runtime import context

    rt = graph_runtimes("tiny", "bf16")
    real = context.greedy_step

    def reads_the_host(params, dims, ids, st, *args):
        real(params, dims, ids, st, *args)
        bool(st.stop)

    monkeypatch.setattr(context, "greedy_step", reads_the_host)
    prompts, plens, cross = _graph_inputs(rt, 2, 4)
    before = LAUNCHES.copy()
    with pytest.raises(RuntimeError):
        rt.run_window(prompts, plens, cross, np.zeros(2, np.int32), np.full(2, 10**6, np.int32),
                      force_steps=3)
    assert LAUNCHES == before


@pytest.fixture(scope="module")
def card_tp(scripted_path):
    """2 gloo ranks on the card at n_model = 2 (tests/torch_parallel_cases.py)."""
    _need_card()
    return spawn_case("card_tp_ranks", 2, args=(scripted_path,),
                      device="cuda", backend="gloo", timeout=300.0)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["bf16", "f32"])
def test_gloo_ranks_on_the_card_match_one_process(card_tp, tier):
    """Two ranks on one card over gloo, 2 of 4 heads each (K1 and K2 at a
    rank's share): run_full gives the script on both; the seeded window's
    tokens, result_len and seek_delta equal one process's, its features
    within 1e-3 x max(1, max |x|) on f32 (other reduction orders) and 5e-2
    on bf16 (activations rounded to bf16 after other f32 sums)."""
    for r in card_tp:
        got = r[tier, "sharded"]
        assert got["heads"] == 2
        assert got["segments"] == [(" hi", 0, 192, SCRIPT[:5])]
    one = card_tp[0][tier, "single"]
    for r in card_tp:
        feats, res = r[tier, "sharded"]["window"]
        want_feats, want = one["window"]
        tol = (1e-3 if tier == "f32" else 5e-2) * max(1.0, float(np.abs(want_feats).max()))
        assert float(np.abs(feats - want_feats).max()) <= tol
        n = int(want["result_len"][0])
        assert (res["result_len"] == want["result_len"]).all()
        assert (res["seek_delta"] == want["seek_delta"]).all()
        assert (res["tokens"][0, :n] == want["tokens"][0, :n]).all()


@pytest.mark.cuda
def test_graphs_on_a_gloo_model_group_raise(card_tp):
    """gloo's collectives cannot be captured: Model(mesh=) with the default
    cuda_graphs=True on a gloo group of 2 ranks on the card raises."""
    for r in card_tp:
        assert r["refused"] is not None and "cuda_graphs=False" in r["refused"]


@pytest.mark.cuda
def test_nccl_one_by_one_mesh_with_graphs_equals_no_mesh(scripted_path):
    """NCCL at world size 1: a 1x1 mesh, its token steps replayed as CUDA
    graphs, gives mesh=None's run_full and window bit for bit."""
    _need_card()
    (r,) = spawn_case("card_nccl_rank", 1, args=(scripted_path,),
                      device="cuda", backend="nccl", timeout=300.0)
    a, b = r["mesh=None"], r["1x1"]
    assert b["replays"] > 0 and a["replays"] > 0
    assert a["segments"] == b["segments"] == [(" hi", 0, 192, SCRIPT[:5])]
    assert np.array_equal(a["window"][0], b["window"][0])
    assert all(np.array_equal(a["window"][1][k], v) for k, v in b["window"][1].items())


# ---------------------------------------------------------------------------
# the W8A16 dense kernel (int8 weights of the serving tier's token steps)
# ---------------------------------------------------------------------------

W8A16_SHAPES = {  # large-v2's decode products: (K, N, layout)
    "qkv": (1280, 3840, "nn"), "o": (1280, 1280, "nn"), "xq": (1280, 1280, "nn"),
    "xo": (1280, 1280, "nn"), "fc1": (1280, 5120, "nn"), "fc2": (5120, 1280, "nn"),
    "logits": (1280, 51_865, "nt"),
}


def _w8a16_card_inputs(m, k, n, layout, seed, bias=True, offset=0):
    """Seeded bf16 x [m, k], int8 codes read as [k, n] (contiguous, or the
    transpose of a contiguous [n, k]), f32 [1, n] scales, f32 [n] bias;
    ``offset`` > 0 shifts x's and the codes' bases off every load width."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbuf = torch.randn((m * k + offset,), generator=g, device="cuda").bfloat16()
    x = xbuf[offset:].view(m, k)
    wbuf = torch.randint(-127, 128, (k * n + offset,), generator=g, device="cuda",
                         dtype=torch.int8)
    w = wbuf[offset:].view(k, n) if layout == "nn" else wbuf[offset:].view(n, k).T
    s = torch.rand((1, n), generator=g, device="cuda") * 1e-2 + 1e-3
    b = torch.randn((n,), generator=g, device="cuda") * 0.1 if bias else None
    return x, w, s, b


def _w8a16_check(x, w, s, b):
    """The kernel against its plain version on the card: within 1e-5 of the
    product's magnitude sum (|x| @ |w|, scaled) plus 1e-6 of |b|. Both sum
    exact bf16 x bf16 products in f32, in other orders: a bf16 rounding
    anywhere would be ~4e-3 of it."""
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.w8a16 import w8a16_dense, w8a16_dense_ref

    before = LAUNCHES["w8a16_dense"]
    got = w8a16_dense(x, w, s, b)
    assert LAUNCHES["w8a16_dense"] == before + 1
    want = w8a16_dense_ref(x, w, s, b)
    mag = (x.float().abs() @ w.float().abs()) * (1.0 if s is None else s.abs())
    tol = 1e-5 * mag + (0.0 if b is None else 1e-6 * b.abs()) + 1e-30
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    excess = ((got - want).abs() - tol).max().item()
    assert excess <= 0, f"error above tolerance by {excess}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("name", list(W8A16_SHAPES))
def test_w8a16_kernel_matches_plain_at_large_v2(name, m):
    """Every large-v2 decode product (the blocks' [in, out] codes and the
    51,865-row table read transposed) at a greedy step's rows (1, 8) and a
    beam step's (U = 8 x 5 = 40), scale and bias fused."""
    _need_card()
    k, n, layout = W8A16_SHAPES[name]
    _w8a16_check(*_w8a16_card_inputs(m, k, n, layout, seed=m))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,k,n,layout,bias,offset",
    [(5, 1003, 777, "nn", True, 0), (8, 131, 1001, "nt", True, 0), (17, 70, 33, "nn", False, 0),
     (33, 300, 45, "nt", True, 0), (64, 257, 129, "nn", True, 0), (3, 1280, 1280, "nn", True, 1),
     (8, 1280, 200, "nt", False, 1), (1, 5, 1, "nn", True, 0), (2, 1, 7, "nt", True, 0),
     (12, 5120, 64, "nn", True, 0)],
    ids=["nn-ragged", "nt-ragged", "nn-17-no-bias", "nt-33", "nn-64", "nn-unaligned",
         "nt-unaligned-no-bias", "nn-one-column", "nt-k1", "nn-long-k"],
)
def test_w8a16_kernel_ragged_and_unaligned(m, k, n, layout, bias, offset):
    """Ragged N and K (byte loads at the edges), bases off the load widths
    (byte loads throughout), batch tiles past M, one column, one k row."""
    _need_card()
    _w8a16_check(*_w8a16_card_inputs(m, k, n, layout, seed=k + n, bias=bias, offset=offset))


@pytest.mark.cuda
def test_w8a16_kernel_raw_product():
    """Without a scale the kernel writes the raw product (a row-parallel
    call's, summed over the ranks before the scale): the scaled call is the
    raw one times s plus b, within f32 rounding."""
    _need_card()
    from whisper_tpu_torch.kernels.w8a16 import w8a16_dense

    x, w, s, b = _w8a16_card_inputs(8, 640, 1280, "nn", seed=3)
    raw = _w8a16_check(x, w, None, None)
    fused = w8a16_dense(x, w, s, b)
    torch.testing.assert_close(fused, raw * s + b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fc2", "logits"])
def test_w8a16_kernel_replayed_equals_eager(name):
    """A call captured in a CUDA graph and replayed on new activations gives
    the eager call's result bit for bit (a fixed summation order), and the
    capture launches it once."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.w8a16 import w8a16_dense

    k, n, layout = W8A16_SHAPES[name]
    x, w, s, b = _w8a16_card_inputs(8, k, n, layout, seed=11)
    x_new = _w8a16_card_inputs(8, k, n, layout, seed=12)[0]
    static_x = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        w8a16_dense(static_x, w, s, b)          # warm-up, as the graph recipe asks
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["w8a16_dense"]
    with torch.cuda.graph(graph):
        static_y = w8a16_dense(static_x, w, s, b)
    assert LAUNCHES["w8a16_dense"] == before + 1
    for inp in (x, x_new):
        static_x.copy_(inp)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_y, w8a16_dense(inp, w, s, b))


@pytest.mark.cuda
def test_w8a16_carries_every_int8_product_of_a_serving_token_step(graph_runtimes):
    """A serving greedy window on a 32-layer decoder (TINY widths, the
    large-v2 depth): each replayed token step launches the W8A16 kernel
    6 x 32 + 1 = 193 times (every block product and the logits), the
    prompt ingest's 228-row products alone convert their weights (192
    int8 -> bf16 copies, none in the step's body, which runs in Python at
    its warm-up and capture), and the TRACER counts the calls so."""
    _need_card()
    from torch.utils._python_dispatch import TorchDispatchMode

    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.obs.profiler import TRACER

    class Conversions(TorchDispatchMode):
        """Counts the int8 -> bf16 conversions dispatched."""

        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            # Tensor.to dispatches as aten.to.dtype under inference mode, else as _to_copy
            if (func.overloadpacket in (torch.ops.aten._to_copy, torch.ops.aten.to)
                    and args[0].dtype == torch.int8 and out.dtype == torch.bfloat16):
                Conversions.n += 1
            return out

    rt = graph_runtimes("tiny-32", "int8")
    lanes, steps = 3, 9
    n_dec = rt.dims.n_text_layer
    assert n_dec == 32
    for window in range(2):                   # the first captures; the second only replays
        before = (LAUNCHES["w8a16_dense"], TRACER.counters.get("int8_dense_kernel", 0),
                  TRACER.counters.get("int8_dense_converted", 0))
        Conversions.n = 0
        replays = rt.graphs.replays()
        with Conversions():
            _graph_window(rt, ("greedy", lanes, steps), *_graph_inputs(rt, lanes, window))
        run = rt.graphs.replays() - replays
        assert run == steps
        launches = LAUNCHES["w8a16_dense"] - before[0]
        assert launches == (6 * n_dec + 1) * run + 1      # + the ingest's last-row logits
        captured = 3 if window == 0 else 0                # 2 warm-up steps and the capture
        assert TRACER.counters.get("int8_dense_kernel", 0) - before[1] == \
            (6 * n_dec + 1) * captured + 1
        assert TRACER.counters.get("int8_dense_converted", 0) - before[2] == 6 * n_dec
        assert Conversions.n == 6 * n_dec                 # the ingest's, and no step's


# Uni-MoE-2.0-Omni's audio-to-text path (model/omni.py, runtime/omni.py) on the card

OMNI_CARD = {
    # the published attention (28 query heads over 4 K/V heads of 128: K2 at Dh = 128 with
    # kv_group 7) and expert layer (4 routed + 1 null + 2 shared, top-p 0.7 capped at 2) at two
    # layers, narrow experts, a small vocabulary and a small Whisper encoder (K1's heads of 64)
    "hidden_size": 3584, "num_hidden_layers": 2, "num_attention_heads": 28, "num_key_value_heads": 4,
    "vocab_size": 1000, "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
    "mlp_fixed_expert_num": 2, "dynamic_intermediate_size": 256, "shared_intermediate_size": 64,
    "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
    "rope_scaling": {"mrope_section": [16, 24, 24]}, "use_sliding_window": False,
    "whisper_hidden_size": 128, "whisper_encoder_layers": 2, "whisper_encoder_attention_heads": 2,
    "whisper_num_mel_bins": 128, "whisper_max_source_positions": 100, "whisper_audio_time": 20,
    "whisper_query_tokens_size": 200, "audio_token_id": 999,
}


def _omni_card_model(seed=3):
    from whisper_tpu_torch.model.omni_params import OmniDims, params_from_tensors, tensor_names

    dims = OmniDims.from_config(OMNI_CARD)
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = {}
    for name, shape in tensor_names(dims).items():
        x = torch.randn(shape, generator=g, device="cuda")
        if name.endswith("bias"):
            raw[name] = x * 0.02
        elif "norm" in name:
            raw[name] = 1 + 0.05 * x
        else:
            raw[name] = (x * int(np.prod(shape[1:])) ** -0.5).bfloat16()
    return dims, params_from_tensors(dims, raw)


def _omni_inputs(dims, seed, lanes=3):
    """Each lane's prompt (ids, its audio placeholders among them) and the mel."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 999, 5 + 7 * b).tolist() + [999] * dims.audio_tokens + rng.integers(0, 999, 4).tolist()
            for b in range(lanes)]
    return seqs, torch.from_numpy(rng.normal(size=(lanes, 128, 200)).astype(np.float32))


def _omni_window(ctx, dims, seed, lanes=3, width=64, steps=9):
    seqs, mel = _omni_inputs(dims, seed, lanes)
    prompt = np.zeros((lanes, width), np.int32)
    for b, seq in enumerate(seqs):
        prompt[b, : len(seq)] = seq
    plen = np.array([len(s) for s in seqs], np.int32)
    return ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=steps)


@pytest.mark.cuda
def test_omni_window_replayed_as_a_graph_matches_eager():
    """The omni token step captured and replayed (two windows over one
    graph) gives the eager step's tokens, probabilities and routing record
    bit for bit; the record's routed choices are the counters' own."""
    _need_card()
    from whisper_tpu_torch.obs.profiler import TRACER
    from whisper_tpu_torch.runtime.omni import OmniContext

    dims, params = _omni_card_model()
    out = {}
    for graphs in (True, False):
        ctx = OmniContext(params, dims, cuda_graphs=graphs, prompt_capacity=64, max_new_tokens=12)
        before = dict(TRACER.counters)
        out[graphs] = [_omni_window(ctx, dims, seed) for seed in (1, 2)]
        if graphs:
            assert len(ctx.graphs.slots) == 1 and ctx.graphs.replays() == 18
        routed = sum(int(((r.routes >= 0) & (r.routes < 4)).sum()) for r in out[graphs])
        assert TRACER.counters["moe.routed_slots"] - before.get("moe.routed_slots", 0) == routed
    for g, e in zip(out[True], out[False]):
        for k in ("tokens", "p", "routes", "attn_start", "touched"):
            assert np.array_equal(getattr(g, k), getattr(e, k)), k
    assert not np.array_equal(out[True][0].tokens, out[True][1].tokens)


@pytest.mark.cuda
def test_omni_routing_record_matches_an_eager_recomputation():
    """At each step column, the record's kept experts are those the router
    gives for the hidden state of the token fed there, recomputed eagerly
    from the cache the window left (prefill over the prompt and the served
    tokens, the same layers, no graph)."""
    _need_card()
    from whisper_tpu_torch.model.omni import prefill
    from whisper_tpu_torch.runtime.omni import OmniContext, OmniState

    dims, params = _omni_card_model(4)
    ctx = OmniContext(params, dims, prompt_capacity=64, max_new_tokens=12)
    res = _omni_window(ctx, dims, 5, steps=8)
    lanes = res.tokens.shape[0]
    # the whole sequence (prompt, then the first 7 served tokens) as one prompt of 71 columns
    prompts, mel = _omni_inputs(dims, 5, lanes)
    seqs = [p + res.tokens[b, :7].tolist() for b, p in enumerate(prompts)]
    width = 71
    ids = torch.zeros((lanes, width), dtype=torch.int32, device="cuda")
    plen = torch.tensor([len(s) for s in seqs], dtype=torch.int32, device="cuda")
    for b, s in enumerate(seqs):
        ids[b, width - len(s):] = torch.tensor(s, dtype=torch.int32, device="cuda")
    audio = ctx.encode_window(mel)

    st = OmniState.zeros(dims, lanes, 1, width + 1, "cuda")
    st.routes.fill_(-1)
    kv = ctx.self_kv(lanes)
    with torch.inference_mode():
        # the recomputation's cache is [..., 64 + 12]: the sequence fits in its first 71 columns
        prefill(params, dims, ids, audio, width - plen, kv, st.routes, st.counts, torch.bfloat16)
    got = st.routes[:, :, width - 7: width].cpu().numpy()            # the served tokens' columns
    want = res.routes[:, :, 64: 64 + 7]
    agree = (np.sort(got, -1) == np.sort(want, -1)).all(-1)
    # bf16 prefill and cached steps sum in other orders: a rare near-tie may flip
    assert agree.mean() >= 0.97, agree.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 560), (1, 449), (3, 64)])
def test_decode_attention_kernel_dh128_group7_matches_plain(b, s):
    """K2 as the omni step calls it: 7 query heads of 128 over each of 4 K/V
    heads folded into lanes (kv_group 7), per-lane [start, valid)."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd, decode_attention_hd_ref

    g = torch.Generator(device="cuda").manual_seed(11)
    hd = 4 * 128
    q = torch.randn((b * 7, hd, 1), generator=g, device="cuda").mul(128 ** -0.5).bfloat16()
    kt = torch.randn((b, hd, s), generator=g, device="cuda").bfloat16()
    vt = torch.randn((b, hd, s), generator=g, device="cuda").bfloat16()
    start = (torch.arange(b, dtype=torch.int32, device="cuda") * 53 % (s // 2)).repeat_interleave(7)
    valid = torch.full((b * 7,), s - 5, dtype=torch.int32, device="cuda")
    before = LAUNCHES["decode_attention_hd_grouped"]
    got = decode_attention_hd(q, kt, vt, 4, valid_len=valid, start=start, kv_group=7)
    assert LAUNCHES["decode_attention_hd_grouped"] == before + 1
    want = decode_attention_hd_ref(q, kt, vt, 4, valid_len=valid, start=start, kv_group=7)
    assert (got - want).abs().max().item() < 2e-3


# The omni step's expert layer on the grouped kernel pair (kernels/moe.py, csrc/moe_lanes.cu)

MOE_D, MOE_W, MOE_SHARED = 3584, 18944, 4736   # Uni-MoE-2.0-Omni's widths: d, a routed expert, the shared SwiGLU


@pytest.fixture(scope="module")
def moe_weights():
    """One layer's expert weights at the published widths, as omni_params
    lays them out: gate_up the transposed view of a contiguous [2w, d],
    down of a contiguous [d, w]; N(0, 1/fan_in) in bf16."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(21)

    def pair(w):
        gate_up = (torch.randn((2 * w, MOE_D), generator=g, device="cuda") * MOE_D ** -0.5).bfloat16()
        down = (torch.randn((MOE_D, w), generator=g, device="cuda") * w ** -0.5).bfloat16()
        return gate_up.T, down.T

    return pair(MOE_SHARED), [pair(MOE_W) for _ in range(4)]


def _moe_gates(b, kept, seed):
    """f32 gates [b, 5] (the router's width; column 4 the null expert's):
    each routed expert in ``kept`` kept by one lane alone where it is even,
    by every lane where it is odd, with a probability in (0.05, 0.95)."""
    rng = np.random.default_rng(seed)
    gates = np.zeros((b, 5), np.float32)
    for e in kept:
        lanes = [(5 * e + 1) % b] if e % 2 == 0 else list(range(b))
        gates[lanes, e] = rng.uniform(0.05, 0.95, len(lanes))
    return torch.from_numpy(gates).cuda()


def _moe_magnitude(h, gates, shared, routed):
    """Per output, sum over the entries of |gate| x (|a| @ |W_down|), with a
    the plain version's bf16 activations: the magnitude sum of the down
    products."""
    from whisper_tpu_torch.kernels.w8a16 import dense

    def act(gate_up):
        gv, uv = dense(h, gate_up).chunk(2, dim=-1)
        return (torch.nn.functional.silu(gv) * uv).bfloat16().float().abs()

    mag = act(shared[0]) @ shared[1].float().abs()
    for e, (gate_up, down) in enumerate(routed):
        mag += gates[:, e:e + 1].abs() * (act(gate_up) @ down.float().abs())
    return mag


@pytest.mark.cuda
@pytest.mark.parametrize("kept", range(16), ids=lambda m: "kept-" + "".join(str(e) for e in range(4) if m >> e & 1))
@pytest.mark.parametrize("b", [1, 3, 8])
def test_moe_experts_kernel_matches_plain_at_the_step_shapes(moe_weights, b, kept):
    """Every subset of the 4 routed experts kept (even experts by one lane
    alone), at B = 1, 3 and 8 and the published widths, against the plain
    version: within 1e-4 of the magnitude sum of the down products. The
    kernel sums each product's f32 terms in another order (~1e-7 of that
    sum) and so may round a bf16 activation to its neighbour where the
    reordered f32 value crosses a rounding point (2^-8 of that one term; a
    few of an expert's 18,944 a lane): ~1e-6 of the sum. A dropped 256-k
    chunk of one expert moves an output by ~1e-3 of it. Two calls give the
    same bits; the counter adds the experts kept."""
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.moe import moe_experts, moe_experts_ref

    shared, routed = moe_weights
    subset = [e for e in range(4) if kept >> e & 1]
    g = torch.Generator(device="cuda").manual_seed(100 * b + kept)
    h = torch.randn((b, MOE_D), generator=g, device="cuda").bfloat16()
    gates = _moe_gates(b, subset, 100 * b + kept)[:, :4]          # a view of the router's [b, 5]
    read = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = LAUNCHES["moe_experts"]
    got = moe_experts(h, gates, shared, routed, read)
    again = moe_experts(h, gates, shared, routed, read)
    assert LAUNCHES["moe_experts"] == before + 4
    want = moe_experts_ref(h, gates, shared, routed)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, MOE_D)
    assert torch.equal(got, again)
    assert int(read.item()) == 2 * len(subset)
    excess = ((got - want).abs() - 1e-4 * _moe_magnitude(h, gates, shared, routed)).max().item()
    assert excess <= 0, f"error above tolerance by {excess}"


@pytest.mark.cuda
def test_moe_experts_kernel_skips_the_weights_of_unkept_experts(moe_weights):
    """An expert no lane kept is not read: its weights may hold NaN and the
    output is the same bits as with finite ones."""
    from whisper_tpu_torch.kernels.moe import moe_experts

    shared, routed = moe_weights
    h = torch.randn((8, MOE_D), generator=torch.Generator(device="cuda").manual_seed(5), device="cuda").bfloat16()
    gates = _moe_gates(8, [0, 3], 5)[:, :4]
    want = moe_experts(h, gates, shared, routed)
    poisoned = [(torch.full_like(gu.T, float("nan")).T, torch.full_like(dn.T, float("nan")).T)
                if e in (1, 2) else (gu, dn) for e, (gu, dn) in enumerate(routed)]
    got = moe_experts(h, gates, shared, poisoned)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_moe_experts_replayed_equals_eager(moe_weights):
    """The pair captured in a CUDA graph as the omni step is
    (``runtime/graph.py:CapturedStep``) and replayed on new lanes and gates
    gives the eager call's bits, the kept experts decided on the device.
    The capture records the pair's 2 launches and takes them back from the
    ledger; each replay adds exactly those, for every wrapper."""
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.moe import moe_experts
    from whisper_tpu_torch.runtime.graph import CapturedStep

    shared, routed = moe_weights
    g = torch.Generator(device="cuda").manual_seed(9)
    h = torch.randn((8, MOE_D), generator=g, device="cuda").bfloat16()
    gates = _moe_gates(8, [0, 1, 2, 3], 9)[:, :4]
    static_h, static_g = h.clone(), gates.clone()
    read = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_experts(static_h, static_g, shared, routed, read)     # warm-up, as the graph recipe asks
    torch.cuda.current_stream().wait_stream(stream)
    out = {}

    def body():
        out["y"] = moe_experts(static_h, static_g, shared, routed, read)

    before = LAUNCHES.copy()
    graph = CapturedStep(body, torch.cuda.graph_pool_handle(), stream)
    assert LAUNCHES == before and graph.launches == Counter(moe_experts=2)
    static_out = out["y"]
    read.zero_()
    for seed, subset in ((9, [0, 1, 2, 3]), (10, [2]), (11, [])):
        new_h = torch.randn((8, MOE_D), generator=torch.Generator(device="cuda").manual_seed(seed),
                            device="cuda").bfloat16()
        new_g = _moe_gates(8, subset, seed)[:, :4]
        static_h.copy_(new_h)
        static_g.copy_(new_g)
        before = LAUNCHES.copy()
        graph()
        assert LAUNCHES == before + graph.launches
        torch.cuda.synchronize()
        assert torch.equal(static_out, moe_experts(new_h, new_g, shared, routed))
    assert int(read.item()) == 4 + 1 + 0


@pytest.mark.cuda
def test_moe_experts_calls_on_two_streams_at_once_share_no_scratch(moe_weights):
    """Calls in flight together on two streams (each its own scratch and
    tile tickets) give the bits each gives alone."""
    from whisper_tpu_torch.kernels.moe import moe_experts

    shared, routed = moe_weights
    inputs = [(torch.randn((8, MOE_D), generator=torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda").bfloat16(), _moe_gates(8, subset, seed)[:, :4])
              for seed, subset in ((31, [0, 1, 2, 3]), (32, [1, 3]))]
    want = [moe_experts(h, gates, shared, routed) for h, gates in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        got = []
        for s, (h, gates) in zip(streams, inputs):
            with torch.cuda.stream(s):
                got.append(moe_experts(h, gates, shared, routed))
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_moe_experts_refuses_what_the_kernel_cannot_take(moe_weights):
    """f32 on the card, a width off the kernel's step of 64, more than 8
    lanes, gates whose rows are not contiguous."""
    from whisper_tpu_torch.kernels.moe import moe_experts

    shared, routed = moe_weights
    h = torch.zeros((2, MOE_D), dtype=torch.bfloat16, device="cuda")
    gates = torch.zeros((2, 4), device="cuda")
    with pytest.raises(NotImplementedError):
        moe_experts(h.float(), gates, tuple(w.float() for w in shared), [tuple(w.float() for w in p) for p in routed])
    odd = (torch.zeros((2 * 100, MOE_D), dtype=torch.bfloat16, device="cuda").T,
           torch.zeros((MOE_D, 100), dtype=torch.bfloat16, device="cuda").T)
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_experts(h, gates, odd, routed)
    with pytest.raises(ValueError, match="lanes"):
        moe_experts(torch.zeros((9, MOE_D), dtype=torch.bfloat16, device="cuda"), torch.zeros((9, 4), device="cuda"),
                    shared, routed)
    with pytest.raises(ValueError, match="contiguous"):
        moe_experts(h, torch.zeros((4, 2), device="cuda").T, shared, routed)


@pytest.mark.cuda
def test_omni_window_reads_only_the_experts_kept():
    """Over a window's replayed steps, the expert layers read exactly the
    routed experts some lane kept (``moe.experts_read`` against the routing
    record's ``moe.experts_touched``), through the kernel pair: 2 launches
    a layer and step, and no cuBLAS product of an expert."""
    _need_card()
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.obs.profiler import TRACER
    from whisper_tpu_torch.runtime.omni import OmniContext

    dims, params = _omni_card_model(6)
    ctx = OmniContext(params, dims, prompt_capacity=64, max_new_tokens=12)
    for seed in (1, 2):        # the first captures; the second only replays
        before = dict(TRACER.counters)
        launches = LAUNCHES["moe_experts"]
        res = _omni_window(ctx, dims, seed, steps=10)
        delta = {k: TRACER.counters.get(k, 0) - before.get(k, 0)
                 for k in ("moe.experts_read", "moe.experts_touched", "moe.step_layers")}
        assert delta["moe.experts_read"] == delta["moe.experts_touched"] == int(res.touched.sum())
        assert delta["moe.step_layers"] == 10 * dims.n_layer
        assert LAUNCHES["moe_experts"] - launches == 2 * dims.n_layer * 10
