"""The port's int8 serving tier against the JAX package, on the CPU.

The serving tier is int8 decoder weights (``DtypePolicy.serving()``: one f32
scale per output column, ``tok_s`` per vocabulary row) plus int8 K/V caches
(``WhisperRuntime(kv_int8=True)``: one f32 scale per cache column), read by
the decode-attention kernel's int8 branch.

Tolerances:
  - quantization (``quantize_cols``, ``quantize_weight``) and parameter
    assembly: exact. Both sides round the same f32 values half to even.
  - int8 decode attention, plain version vs Pallas (interpret): 1e-5, f32
    on both sides, only the summation order differs.
  - cross K/V and decode steps: 1e-4 on f32 logits, as
    tests/test_torch_model.py; cache codes exact and cache scales 1e-5
    relative. The codes come from f32 projections summed in another order
    than XLA's, so a value within an ulp of a half step could round the
    other way; on these inputs none does (0 of 12,288 cross and 6,144 self
    codes per tensor differ).
  - window loops: integer fields identical, probabilities 1e-5.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint
from tests.test_torch_model import _leaves

TOL_KERNEL = 1e-5
TOL_MODEL = 1e-4
TOL_P = 1e-5


def _f32_serving(mod):
    """The f32 policy with int8 decoder weights, in the JAX or the port's dtypes."""
    if mod == "jax":
        from whisper_tpu.model.params import DtypePolicy

        return DtypePolicy(jnp.float32, jnp.float32, jnp.float32, weights_int8=True)
    from whisper_tpu_torch.model.params import DtypePolicy

    return DtypePolicy(torch.float32, torch.float32, torch.float32, weights_int8=True)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "shape,axis,scale",
    [((2, 64, 10), -2, 3.0),       # cross cache [B, HD, T], per column
     ((3, 5, 64), -1, 0.2),        # new self-cache columns [B, S, HD]
     ((4, 128, 33), -2, 1e-3)],    # small values, plus an all-zero column below
)
def test_quantize_cols_matches_jax(shape, axis, scale):
    from whisper_tpu.kernels.quant import dequantize as jdequant
    from whisper_tpu.kernels.quant import quantize_cols as jquant
    from whisper_tpu_torch.kernels.quant import dequantize, quantize_cols

    rng = np.random.default_rng(7)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[..., 0] = 0.0 if axis == -2 else x[..., 0]
    jq, js = jquant(jnp.asarray(x), axis=axis)
    q, s = quantize_cols(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for jdt, dt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(dequantize(q, s, dt).float().numpy(),
                                      np.asarray(jdequant(jq, js, jdt), np.float32))
    # half a quantization step at most, as tests/test_kernels.py:150 asks of JAX
    amax = np.abs(x).max(axis=axis, keepdims=True)
    assert np.all(np.abs(dequantize(q, s, torch.float32).numpy() - x) <= amax / 254 + 1e-7)


def test_quantize_weight_and_decoder_weights_match_jax(tmp_path):
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model import params as jp
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model import params as tp

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((4, 64, 96)) * 0.7).astype(np.float32)
    for axis in (1, 2):
        for got, want in zip(tp.quantize_weight(w, axis), jp.quantize_weight(w, axis)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)

    path = str(tmp_path / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=2)
    host = tp.host_tree_from_checkpoint(load_checkpoint(path))
    # the JAX package's own host decoder tree, assembled by its own loader
    dims, jt = TINY_TEST_DIMS, jload(path).tensors
    jdec = {
        "tok": jp._get(jt, "decoder.token_embedding.weight", (dims.n_vocab, dims.n_text_state)),
        "blocks": jp._stack_blocks(jt, "decoder", dims.n_text_layer, dims.n_text_state,
                                   dims.n_text_head, cross=True),
    }
    got = tp.quantize_decoder_weights({"tok": host["dec"]["tok"],
                                       "blocks": dict(host["dec"]["blocks"])})
    want = jp.quantize_decoder_weights(jdec)
    assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
    assert {k for k in got["blocks"] if k.endswith("_s")} == {k + "_s" for k in tp._QUANT_KEYS}
    assert tp._QUANT_KEYS == jp._QUANT_KEYS
    for key in got["blocks"]:
        np.testing.assert_array_equal(got["blocks"][key], want["blocks"][key], err_msg=key)
        assert got["blocks"][key].dtype == want["blocks"][key].dtype, key
    for key in ("tok", "tok_s"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["tok"].dtype == np.int8 and got["tok_s"].shape == (TINY_TEST_DIMS.n_vocab, 1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _jax_leaves(jparams):
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}


@pytest.fixture(scope="module")
def serving_trees(tmp_path_factory):
    """The same checkpoint under DtypePolicy.serving() in both packages."""
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model import params as jp
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint

    path = str(tmp_path_factory.mktemp("s") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=4)
    jparams = jp.params_from_checkpoint(jload(path), jp.DtypePolicy.serving())
    tparams = params_from_checkpoint(load_checkpoint(path), DtypePolicy.serving(), "cpu")
    return jparams, tparams


def test_params_from_checkpoint_serving_equals_jax(serving_trees):
    """int8 weights and f32 scales exactly; every other leaf in the same
    dtype (bf16 matmul weights, f32 norms and biases) and value."""
    jparams, tparams = serving_trees
    jflat, tflat = _jax_leaves(jparams), _leaves(tparams)
    assert set(jflat) == set(tflat)
    dtypes = {jnp.int8: torch.int8, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    n_int8 = 0
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == dtypes[want.dtype.type], key
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=str(key))
        n_int8 += got.dtype == torch.int8
    assert n_int8 == 7                        # the six _QUANT_KEYS and tok
    assert tflat[("enc", "blocks", "qkv_w")].dtype == torch.bfloat16   # encoder stays bf16
    assert tflat[("dec", "blocks", "xk_w")].dtype == torch.bfloat16    # cross K/V projections too


def test_params_from_numpy_carries_jax_serving_tree(serving_trees, tmp_path):
    """The JAX serving pytree crosses over as int8 codes and f32 scales,
    never quantized a second time; an f32 host tree is quantized once,
    without touching the caller's arrays."""
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import (
        DtypePolicy,
        host_tree_from_checkpoint,
        params_from_numpy,
    )

    jparams, tparams = serving_trees
    host = jax.tree_util.tree_map(np.asarray, jparams)
    for policy in (DtypePolicy.serving(), DtypePolicy()):
        a, b = _leaves(params_from_numpy(host, "cpu", policy)), _leaves(tparams)
        assert set(a) == set(b)
        for key in a:
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)

    path = str(tmp_path / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=4)          # serving_trees' checkpoint
    f32_tree = host_tree_from_checkpoint(load_checkpoint(path))
    a = _leaves(params_from_numpy(f32_tree, "cpu", DtypePolicy.serving()))
    for key, t in _leaves(tparams).items():
        torch.testing.assert_close(a[key], t, rtol=0, atol=0)
    assert "tok_s" not in f32_tree["dec"] and f32_tree["dec"]["blocks"]["qkv_w"].dtype == np.float32


# ---------------------------------------------------------------------------
# K2's int8 branch: plain version against Pallas (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "case", ["unmasked", "valid_len", "start_and_valid_len", "kv_group", "empty_lane"],
)
def test_decode_attention_int8_ref_matches_pallas(case):
    """tests/test_kernels.py:162 on the port, plus the masks, kv_group=2 and
    lanes that attend no key. The empty-lane case takes S=256: the Pallas
    kernel pads int8 S <= 1536 to a multiple of 128 and averages a lane
    with no key over the padded length."""
    from whisper_tpu.kernels.decode_attention import decode_attention_hd as jax_dec
    from whisper_tpu.kernels.quant import quantize_cols as jquant
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )
    from whisper_tpu_torch.kernels.quant import dequantize

    H, Dh = 4, 64
    S = 256 if case == "empty_lane" else 200
    B, G = (4, 2) if case == "kv_group" else (3, 1)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, H * Dh, 1)).astype(np.float32) * 0.3
    k8, ks = (np.asarray(a) for a in jquant(
        jnp.asarray(rng.standard_normal((B // G, H * Dh, S)).astype(np.float32) * 0.5), axis=-2))
    v8, vs = (np.asarray(a) for a in jquant(
        jnp.asarray(rng.standard_normal((B // G, H * Dh, S)).astype(np.float32)), axis=-2))
    valid = start = None
    if case != "unmasked":
        valid = np.array([37, 200, 200, 90][:B], np.int32)
    if case in ("start_and_valid_len", "kv_group"):
        start = np.array([0, 12, 199, 30][:B], np.int32)
    if case == "empty_lane":
        start = np.array([0, 40, 200], np.int32)
        valid = np.array([256, 40, 100], np.int32)      # lanes 1 and 2 attend no key

    want = np.asarray(jax_dec(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), H,
        valid_len=None if valid is None else jnp.asarray(valid),
        start=None if start is None else jnp.asarray(start),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_group=G, interpret=True,
    ))
    t = {n: torch.tensor(a) for n, a in dict(q=q, k8=k8, v8=v8, ks=ks, vs=vs).items()}
    kw = dict(valid_len=None if valid is None else torch.from_numpy(valid),
              start=None if start is None else torch.from_numpy(start),
              k_scale=t["ks"], v_scale=t["vs"], kv_group=G)
    got = decode_attention_hd_ref(t["q"], t["k8"], t["v8"], H, **kw).numpy()
    assert got.shape == want.shape == (B, H * Dh, 1) and got.dtype == np.float32
    assert np.max(np.abs(got - want)) < TOL_KERNEL
    if case == "empty_lane":               # mean of the dequantized V over [0, S)
        mean_v = dequantize(t["v8"], t["vs"], torch.float32).mean(dim=-1).numpy()
        np.testing.assert_allclose(got[1:, :, 0], mean_v[1:], rtol=0, atol=TOL_KERNEL)
    counts = LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]
    np.testing.assert_array_equal(
        decode_attention_hd(t["q"], t["k8"], t["v8"], H, **kw).numpy(), got)
    assert (LAUNCHES["decode_attention_hd"], LAUNCHES["decode_attention_hd_int8"]) == counts


# ---------------------------------------------------------------------------
# model: cross K/V and decode steps on int8 weights and caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_model(tmp_path_factory):
    from whisper_tpu.config import KernelConfig
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model import params as jp
    from whisper_tpu.model.encoder import encode as jencode
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import params_from_checkpoint

    path = str(tmp_path_factory.mktemp("q") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=1)
    jparams = jp.params_from_checkpoint(jload(path), _f32_serving("jax"))
    tparams = params_from_checkpoint(load_checkpoint(path), _f32_serving("torch"), "cpu")
    kernels = KernelConfig(flash_attention=True, interpret=True, kv_int8=True)
    mel = np.random.default_rng(7).standard_normal(
        (1, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)
    feats = np.array(jencode(jparams, TINY_TEST_DIMS, jnp.asarray(mel),
                               compute_dtype=jnp.float32, kernels=kernels))
    return jparams, tparams, kernels, feats


def test_precompute_cross_kv_int8_matches_jax(int8_model):
    """Both sides quantize K and V per column from the same encoder output:
    the same codes, scales [L, B, 1, T] within f32 rounding."""
    from whisper_tpu.model.encoder import precompute_cross_kv as jcross
    from whisper_tpu_torch.kernels.quant import dequantize
    from whisper_tpu_torch.model.encoder import precompute_cross_kv

    jparams, tparams, _, feats = int8_model
    L, T, d = TINY_TEST_DIMS.n_text_layer, TINY_TEST_DIMS.n_audio_ctx, TINY_TEST_DIMS.n_text_state
    jkv = jcross(jparams, TINY_TEST_DIMS, jnp.asarray(feats), compute_dtype=jnp.float32, quant=True)
    kv = precompute_cross_kv(tparams, TINY_TEST_DIMS, torch.from_numpy(feats),
                             compute_dtype=torch.float32, quant=True)
    plain = precompute_cross_kv(tparams, TINY_TEST_DIMS, torch.from_numpy(feats),
                                compute_dtype=torch.float32)
    assert plain.k_s is None and plain.k.dtype == torch.float32
    for name in ("k", "v"):
        codes, scales = getattr(kv, name), getattr(kv, name + "_s")
        assert codes.dtype == torch.int8 and tuple(codes.shape) == (L, 1, d, T)
        assert scales.dtype == torch.float32 and tuple(scales.shape) == (L, 1, 1, T)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(getattr(jkv, name)), name)
        np.testing.assert_allclose(scales.numpy(), np.asarray(getattr(jkv, name + "_s")),
                                   rtol=1e-5, atol=0)
        # the codes dequantize to the unquantized K/V within half a step
        step = scales.numpy() / 2 + 1e-6
        assert np.all(np.abs(dequantize(codes, scales, torch.float32).numpy()
                             - getattr(plain, name).numpy()) <= step)


def test_decode_step_int8_matches_jax(int8_model):
    """int8 weights, int8 self cache and int8 cross K/V (the same codes on
    both sides): a left-padded prompt ingest (einsum path over the
    dequantized caches), then single-token steps (K2's int8 branch, Pallas
    interpret vs plain version)."""
    from whisper_tpu.model.decoder import decode_step as jstep
    from whisper_tpu.model.decoder import init_self_kv as jinit
    from whisper_tpu.model.encoder import precompute_cross_kv as jcross
    from whisper_tpu_torch.model.decoder import decode_step, init_self_kv
    from whisper_tpu_torch.model.encoder import CrossKV

    jparams, tparams, kernels, feats = int8_model
    dims = TINY_TEST_DIMS
    jx = jcross(jparams, dims, jnp.asarray(feats), compute_dtype=jnp.float32, quant=True)
    tx = CrossKV(*(torch.tensor(np.asarray(a)) for a in jx))
    prompt = [50257, 100, 200, 300]
    cap = 7
    lead = cap - len(prompt)
    padded = np.zeros((1, cap), np.int32)
    padded[0, lead:] = prompt
    start = np.array([lead], np.int32)

    jkv = jinit(dims, 1, dtype=jnp.float32, quant=True)
    tkv = init_self_kv(dims, 1, dtype=torch.float32, device="cpu", quant=True)
    assert tkv.k.dtype == torch.int8 and tuple(tkv.k_s.shape) == (dims.n_text_layer, 1, 1, dims.n_text_ctx)
    steps = [(padded, np.array([-lead], np.int32), 0)]
    steps += [(np.array([[tok]], np.int32), np.array([len(prompt) + i], np.int32), cap + i)
              for i, tok in enumerate([400, 500, 600])]
    for tokens, pos0, col in steps:
        jl, jkv = jstep(jparams, dims, jnp.asarray(tokens), jnp.asarray(pos0), jkv, jx,
                        write_pos=col, attn_start=jnp.asarray(start), compute_dtype=jnp.float32,
                        kernels=kernels)
        tl, tkv = decode_step(tparams, dims, torch.from_numpy(tokens), torch.from_numpy(pos0), tkv,
                              tx, write_pos=col, attn_start=torch.from_numpy(start),
                              compute_dtype=torch.float32)
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < TOL_MODEL, col
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(tkv, name).numpy(), np.asarray(getattr(jkv, name)),
                                      name)
        np.testing.assert_allclose(getattr(tkv, name + "_s").numpy(),
                                   np.asarray(getattr(jkv, name + "_s")), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# window loops on the scripted checkpoint
# ---------------------------------------------------------------------------

SCRIPT = [50_363, 32, 104, 105, 32, 116, 112, 117, 50_363 + 96, 50_256]


@pytest.fixture(scope="module")
def scripted():
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu_torch.ggml import load_checkpoint

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.bin")
        make_scripted_checkpoint(path, SCRIPT)
        return jload(path), load_checkpoint(path)


def _window(rt, mel):
    _, cross = rt.encode_window(mel)
    padded = np.zeros((1, rt.prompt_capacity), np.int32)
    padded[0, 0] = rt.ids.sot
    return rt.run_window(padded, np.ones((1,), np.int32), cross,
                         np.zeros((1,), np.int32), np.full((1,), 10**6, np.int32))


@pytest.mark.parametrize(
    "tier,seed",
    [("kv_int8", 21),          # tests/test_kernels.py:193-240
     ("weights_int8", 11)],    # tests/test_quant_weights.py:56-74
)
def test_window_int8_matches_jax_and_script(scripted, tier, seed):
    """The window loop on int8 caches (f32 weights) or on int8 weights (f32
    caches) gives JAX's WindowResult, and its tokens are the script minus
    the EOT."""
    from whisper_tpu.config import KernelConfig
    from whisper_tpu.model import params as jp
    from whisper_tpu.runtime.context import WhisperRuntime as JRuntime
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu.vocab import Vocabulary as JVocab
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu_torch.runtime.context import WhisperRuntime
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary
    from tests.helpers import make_vocab_words

    jcp, tcp = scripted
    kv_int8 = tier == "kv_int8"
    words = make_vocab_words(tcp.dims.n_vocab)
    if kv_int8:
        jpol, tpol = jp.DtypePolicy.f32(), DtypePolicy.f32()
        kcfg = KernelConfig(flash_attention=True, interpret=True, kv_int8=True)
    else:
        jpol, tpol = _f32_serving("jax"), _f32_serving("torch")
        kcfg = KernelConfig.reference()
    jrt = JRuntime(jp.params_from_checkpoint(jcp, jpol), jcp.dims,
                   JIds.from_vocab(JVocab(words, jcp.dims.n_vocab)),
                   compute_dtype=jnp.float32, kernels=kcfg)
    trt = WhisperRuntime(params_from_checkpoint(tcp, tpol, "cpu"), tcp.dims,
                         SpecialIds.from_vocab(Vocabulary(words, tcp.dims.n_vocab)),
                         compute_dtype=torch.float32, device="cpu", kv_int8=kv_int8)
    mel = np.random.default_rng(seed).standard_normal(
        (1, 80, 2 * tcp.dims.n_audio_ctx)).astype(np.float32)
    want, got = _window(jrt, mel), _window(trt, mel)
    for name in ("tokens", "tid", "result_len", "seek_delta", "failed", "steps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL_P, err_msg=name)
    n = int(got.result_len[0])
    assert got.tokens[0, :n].tolist() == SCRIPT[:-1] and not bool(got.failed[0])


# ---------------------------------------------------------------------------
# the W8A16 dense kernel's plain version and dense's dispatch rule
# ---------------------------------------------------------------------------

def _w8a16_inputs(m, k, n, layout, bias, seed=0):
    """Seeded bf16 x [m, k], int8 codes read as [k, n] (contiguous, or the
    transpose of a contiguous [n, k] as the token table), f32 [1, n] column
    scales and an optional f32 [n] bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).bfloat16()
    codes = torch.randint(-127, 128, (k, n) if layout == "nn" else (n, k), generator=g,
                          dtype=torch.int8)
    w = codes if layout == "nn" else codes.T
    s = torch.rand((1, n), generator=g) * 1e-2 + 1e-3
    b = torch.randn((n,), generator=g) * 0.1 if bias else None
    return x, w, s, b


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("layout", ["nn", "nt"])
def test_w8a16_plain_equals_dense(layout, m, bias):
    """The W8A16 kernel's plain version (codes to bf16, f32 product, scale,
    then bias) equals today's ``dense(s=...)`` bit for bit on the CPU, in
    both weight layouts the program stores (the blocks' [in, out], the
    token table read transposed), and holds the exact f64 product within
    f32 rounding."""
    from whisper_tpu_torch.kernels.w8a16 import dense, w8a16_dense, weight_layout

    x, w, s, b = _w8a16_inputs(m, 96, 72, layout, bias, seed=m)
    assert weight_layout(w) == layout
    got = w8a16_dense(x, w, s, b)
    want = dense(x, w, b, s=s)
    assert got.dtype == torch.float32 and got.shape == (m, 72)
    assert torch.equal(got, want)
    exact = (x.double() @ w.double()) * s.double() + (0 if b is None else b.double())
    assert torch.allclose(got.double(), exact, rtol=1e-5, atol=1e-6)


def _fake_call(rows, x_dtype=torch.bfloat16, device="cuda", w_dtype=torch.int8, scaled=True):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((rows, 1, 1280), dtype=x_dtype, device=device)
        w = torch.empty((1280, 5120), dtype=w_dtype, device=device)
        s = torch.empty((1, 5120), dtype=torch.float32, device=device) if scaled else None
    return x, w, s


W8A16_ROUTES = {   # name: (call, tensor-parallel size, route)
    "token-step-B8": (dict(rows=8), 1, "w8a16"),
    "one-row": (dict(rows=1), 1, "w8a16"),
    "beam-U8": (dict(rows=40), 1, "w8a16"),
    "rows-64": (dict(rows=64), 1, "w8a16"),
    "rows-65": (dict(rows=65), 1, "converted"),
    "ingest-8x228": (dict(rows=8 * 228), 1, "converted"),
    "no-scale": (dict(rows=8, scaled=False), 1, "float"),
    "bf16-weights": (dict(rows=8, w_dtype=torch.bfloat16, scaled=False), 1, "float"),
    "f32-x": (dict(rows=8, x_dtype=torch.float32), 1, "converted"),
    "cpu": (dict(rows=8, device="cpu"), 1, "converted"),
    "row-parallel": (dict(rows=8), 2, "w8a16_raw"),
    "row-parallel-65": (dict(rows=65), 2, "converted"),
}


@pytest.mark.parametrize("case", list(W8A16_ROUTES), ids=list(W8A16_ROUTES))
def test_dense_route_sends_token_steps_to_w8a16(case):
    """dense's rule, on fake tensors (no card needed): int8 codes with
    scales and a bf16 CUDA x of 1-64 rows take the kernel, its raw product
    under a row-parallel group (the all-reduce runs before the scale);
    more rows, f32 or CPU activations keep the converted product; calls
    without scales are no int8 calls."""
    from whisper_tpu_torch.kernels.w8a16 import dense_route
    from whisper_tpu_torch.parallel.group import AxisGroup

    call, tp_size, route = W8A16_ROUTES[case]
    x, w, s = _fake_call(**call)
    assert dense_route(x, w, s, AxisGroup(size=tp_size)) == route
