"""Card-only checks of the port's CUDA kernels: each kernel against its plain
PyTorch version, on the card. Marked ``cuda``; without a card every test
skips (the kernels have no CPU mode; the plain versions are held against
the JAX package by tests/test_torch_kernels.py).

On a machine with a card, which need not have JAX (hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 (bf16 output) 2e-2, one bf16 ulp being 7.8e-3 in [1, 2);
K2 (f32 output from identical inputs) 2e-3, bf16 inputs (int8 K/V with a
bf16 query too), and 1e-5 for f32 inputs, only the f32 summation order
differing.
"""

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk", [(1, 1500, 1500), (2, 75, 150), (1, 64, 1)])
def test_flash_attention_kernel_matches_plain(b, tq, tk):
    _need_card()
    from whisper_tpu_torch.kernels.attention import flash_attention, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((b, tq, 20, 3, 64), generator=g, device="cuda").mul(0.5).bfloat16()[:, :, :, 0]
    k, v = torch.randn((2, b, tk, 20, 64), generator=g, device="cuda").mul(0.5).bfloat16().unbind(0)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    err = (got.float() - flash_attention_ref(q, k, v).float()).abs().max().item()
    assert err < 2e-2


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
    from whisper_tpu_torch.kernels.attention import (
        flash_attention,
        flash_attention_ref,
        flash_attention_shape,
    )

    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = _qkv(g, b, tq, tk, True)
    before = flash_attention.launches
    got = flash_attention_shape(q, k, v, shape)
    assert flash_attention.launches == before + 1
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
    counts = decode_attention_hd.launches, decode_attention_hd.launches_int8
    got = decode_attention_hd(q, k8, v8, 20, **kw)
    assert (decode_attention_hd.launches, decode_attention_hd.launches_int8) == \
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
    counts = decode_attention_hd.launches, decode_attention_hd.launches_int8
    got = decode_attention_hd(q, k8, v8, 20, **kw)
    assert (decode_attention_hd.launches, decode_attention_hd.launches_int8) == \
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

    x = torch.zeros((1, 16, 2, 64), device="cuda")
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention(x, x, x)                                # f32 on the card
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

    _, k, v = _kb_inputs(d, 5)
    if kernel in ("kernel_read", "kernel_rows"):
        k, v = k[1], v[1]
    arg = d["RB"] if kernel == "kernel_rows" else d["CS"]
    wrapper, ref = kb.KERNELS[kernel]
    before = wrapper.launches
    got = wrapper(k, v, arg)
    # the split tiling launches the partial sums and a combine
    assert wrapper.launches == before + (1 if kernel == "kernel_rows" else 2)
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
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
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

    g = torch.Generator(device="cuda").manual_seed(12)
    hd = h * dh
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = kb.kernel_mxu.launches
    got = kb.kernel_mxu(q, k, v, h, s, cs)
    assert kb.kernel_mxu.launches == before + 1
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

    g = torch.Generator(device="cuda").manual_seed(15)
    hd = 64 * h
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = kb.kernel_mxub.launches
    got = kb.kernel_mxub(q, k, v, h, s, cs)
    assert kb.kernel_mxub.launches == before + 1
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

    q = torch.zeros((1, 64, 1), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2**19), device="cuda", dtype=torch.bfloat16)
    before = kb.kernel_mxub.launches
    with pytest.raises(NotImplementedError, match="no K7 block fits"):
        kb.kernel_mxub(q, k, k, 1, 100, 2**19)
    assert kb.kernel_mxub.launches == before


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
    before = kb.kernel_vpu8.launches
    got = kb.kernel_vpu8(q, k8, v8, sk, sv, h, s, cs)
    assert kb.kernel_vpu8.launches == before + 1
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

    g = torch.Generator(device="cuda").manual_seed(16)
    hd = h * dh
    q = torch.randn((b, hd, 1), generator=g, device="cuda").mul(0.3).bfloat16()
    k = torch.randn((b, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((b, hd, s_pad), generator=g, device="cuda").bfloat16()
    if peak:
        # q . K at its largest on the last 3 keys
        assert kb.vpu_geometry(b, h, s, s_pad).ranges[-1][0] <= s - 3
        k[..., s - 3:s] = torch.where(q > 0, 2.0, -2.0).bfloat16()
    before = kb.kernel_vpu.launches
    got = kb.kernel_vpu(q, k, v, h, s, cs)
    assert kb.kernel_vpu.launches == before + 1
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

    g = torch.Generator(device="cuda").manual_seed(13)
    k = torch.randn((*lead, hd, s_pad), generator=g, device="cuda").mul(0.3).bfloat16()
    v = torch.randn((*lead, hd, s_pad), generator=g, device="cuda").bfloat16()
    before = kb.kernel_rows.launches
    got = kb.kernel_rows(k, v, hd)
    assert kb.kernel_rows.launches == before + 1
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
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd as k2

    params = FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=5)
    audio = np.zeros(16_000 * 2, np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        k2.launches = k2.launches_grouped = k2.launches_int8 = 0
        out[device] = _segments([_model(scripted_path, device, tier).create_context()
                                 .run_full(params, audio)])
        counts = (k2.launches, k2.launches_grouped, k2.launches_int8)
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
