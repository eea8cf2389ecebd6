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
