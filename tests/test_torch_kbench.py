"""The port's decode-attention microbenchmark (``whisper_tpu_torch.tools.
kbench`` and ``whisper_tpu_torch.kernels.kbench``) against the JAX tool
``tools/kbench.py``, on the CPU.

The JAX tool reads its dimensions at import, keeps five of its Pallas
kernels as closures inside ``main()`` and passes no ``interpret=``; so the
tests load it by path under small dimensions with a ragged S (S=200, CS=128:
the padded columns [200, 256) are summed by the read family and masked by
the attention family) and wrap its module-level bodies in ``pallas_call``s
of their own, in interpret mode. The closure kernels are held against the
JAX function that computes the same thing: K5, K6 and K9 against
``kernel_read``; K7 against ``kernel_mxu`` (same rounding points); K8
against ``whisper_tpu.kernels.decode_attention.decode_attention_hd``.

Tolerances:
  - f32-p attention (K4a, K8): 1e-5, only the summation order differs.
  - read family: 1e-5 relative to the row's sum of |k| + |v|, f32 sums of
    bf16 data in another order.
  - bf16-p attention (K4b, K7): 2e-3 at most; exp may differ by an ulp
    between XLA and torch, which can flip one bf16 rounding of p. That
    limit is above the rounding's whole effect (~1.4e-4 here), so the mean
    error must also stay under a quarter of the mean gap between JAX's
    bf16-p and f32-p bodies: a version that skipped the rounding, or
    rounded at another max, shows the gap in full.
On a CPU tensor every wrapper runs its plain version; the CUDA kernels are
held against the same plain versions on the card (tests/test_torch_cuda.py,
``chip_smoke.py``).
"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "kbench.py"
DIMS = dict(B=2, S=200, HD=128, H=2, L=2, CS=128, RB=64)
TOL_F32 = 1e-5
TOL_READ = 1e-5
TOL_BF16_P = 2e-3
ROUNDING_SHARE = 0.25


@pytest.fixture(scope="module")
def jkb():
    """tools/kbench.py loaded under DIMS, as a module of its own."""
    with pytest.MonkeyPatch.context() as mp:
        for name, val in DIMS.items():
            mp.setenv(name, str(val))
        spec = importlib.util.spec_from_file_location("tools_kbench_under_test", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _make_pallas(jkb, body, scratch):
    """``make_pallas``'s call, in interpret mode: grid (B, chunks)."""
    hd, cs = jkb.HD, jkb.CS
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(jkb.B, jkb.N_CHUNKS),
        in_specs=[
            pl.BlockSpec((1, hd, 1), lambda i, c, *_: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, hd, cs), lambda i, c, *_: (i, 0, c), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, hd, cs), lambda i, c, *_: (i, 0, c), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, hd, 1), lambda i, c, *_: (i, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=scratch,
    )
    call = pl.pallas_call(body, grid_spec=grid_spec, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((jkb.B, hd, 1), jnp.float32))
    return lambda q, k, v: np.asarray(call(jnp.zeros((jkb.B, 2), jnp.int32), q, k, v))


def _jax_read(jkb, q, k, v):
    return _make_pallas(jkb, jkb.kernel_read, [pltpu.VMEM((jkb.HD, 1), jnp.float32)])(q, k, v)


def _jax_attention(jkb, body, q, k, v):
    scratch = [pltpu.VMEM((jkb.H, 1), jnp.float32), pltpu.VMEM((jkb.H, 1), jnp.float32),
               pltpu.VMEM((jkb.HD, 1), jnp.float32)]
    return _make_pallas(jkb, body, scratch)(q, k, v)


def _inputs(seed, lead=(DIMS["B"],)):
    """bf16 q [B, HD, 1] and K/V [*lead, HD, S_PAD] (padded columns hold
    data), as (numpy f32 of the bf16 values, torch bf16, jax bf16)."""
    rng = np.random.default_rng(seed)
    s_pad = -(-DIMS["S"] // DIMS["CS"]) * DIMS["CS"]
    shapes = dict(q=(DIMS["B"], DIMS["HD"], 1), k=(*lead, DIMS["HD"], s_pad),
                  v=(*lead, DIMS["HD"], s_pad))
    out = {}
    for name, shape in shapes.items():
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3).bfloat16()
        out[name] = (x.float().numpy(), x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    return out


def _assert_rowsums(got, want, k, v):
    scale = np.abs(k).sum(-1, keepdims=True) + np.abs(v).sum(-1, keepdims=True)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / scale) <= TOL_READ


@pytest.mark.parametrize("kernel", ["kernel_read", "kernel_rows", "kernel_read_all_layers",
                                    "kernel_flatread"])
def test_read_family_plain_matches_pallas(jkb, kernel):
    """K3, K5, K6 and K9 against kernel_read (interpret), layer by layer,
    over every stored column; the wrapper on CPU tensors gives the plain
    result and launches nothing."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    L, cs, rb = DIMS["L"], DIMS["CS"], DIMS["RB"]
    x = _inputs(1, lead=(L, DIMS["B"]))
    (k_np, k, k_j), (v_np, v, v_j), q_j = x["k"], x["v"], x["q"][2]
    want = np.stack([_jax_read(jkb, q_j, k_j[li], v_j[li]) for li in range(L)])
    wrapper, ref = kb.KERNELS[kernel]
    if kernel in ("kernel_read", "kernel_rows"):
        arg = cs if kernel == "kernel_read" else rb
        calls = [(lambda f, li=li: f(k[li], v[li], arg)) for li in range(L)]
        got = np.stack([c(ref).numpy() for c in calls])
        before = LAUNCHES[kernel]
        via = np.stack([c(wrapper).numpy() for c in calls])
    else:
        got = ref(k, v, cs).numpy()
        before = LAUNCHES[kernel]
        via = wrapper(k, v, cs).numpy()
        want = want.reshape(got.shape)
    _assert_rowsums(got, want.reshape(got.shape), k_np.reshape(*got.shape[:-1], -1),
                    v_np.reshape(*got.shape[:-1], -1))
    np.testing.assert_array_equal(via, got)
    assert LAUNCHES[kernel] == before


@pytest.mark.parametrize("kernel,body,tol", [
    ("kernel_vpu", "kernel_vpu", TOL_F32),
    ("kernel_mxu", "kernel_mxu", TOL_BF16_P),
    ("kernel_mxub", "kernel_mxu", TOL_BF16_P),
])
def test_attention_plain_matches_pallas(jkb, kernel, body, tol):
    """K4a, K4b and K7 against the TPU bodies (interpret): unscaled q,
    columns >= S at -inf, chunked online softmax."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    x = _inputs(2)
    want = _jax_attention(jkb, getattr(jkb, body), x["q"][2], x["k"][2], x["v"][2])
    args = (x["q"][1], x["k"][1], x["v"][1], DIMS["H"], DIMS["S"], DIMS["CS"])
    wrapper, ref = kb.KERNELS[kernel]
    got = ref(*args).numpy()
    assert got.shape == want.shape == (DIMS["B"], DIMS["HD"], 1) and got.dtype == np.float32
    err = np.abs(got - want)
    assert np.max(err) < tol
    if body == "kernel_mxu":
        f32_p = _jax_attention(jkb, jkb.kernel_vpu, x["q"][2], x["k"][2], x["v"][2])
        assert np.mean(err) <= ROUNDING_SHARE * np.mean(np.abs(want - f32_p))
    before = LAUNCHES[kernel]
    np.testing.assert_array_equal(wrapper(*args).numpy(), got)
    assert LAUNCHES[kernel] == before


def test_mxu_plain_rounds_p_to_bf16():
    """K4b/K7's plain version differs from K4a's by p's bf16 rounding alone."""
    from whisper_tpu_torch.kernels import kbench as kb

    x = _inputs(3)
    args = (x["q"][1], x["k"][1], x["v"][1], DIMS["H"], DIMS["S"], DIMS["CS"])
    plain = {n: kb.KERNELS[n][1](*args).numpy()
             for n in ("kernel_mxu", "kernel_mxub", "kernel_vpu")}
    np.testing.assert_array_equal(plain["kernel_mxu"], plain["kernel_mxub"])
    diff = np.max(np.abs(plain["kernel_mxu"] - plain["kernel_vpu"]))
    assert 0 < diff < TOL_BF16_P


def test_vpu8_plain_matches_decode_attention():
    """K8 against the JAX package's decode_attention_hd on int8 K/V with
    column scales (interpret), over the S real keys."""
    from whisper_tpu.kernels.decode_attention import decode_attention_hd as jax_dec
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES

    rng = np.random.default_rng(4)
    b, hd, h, s, cs = DIMS["B"], DIMS["HD"], DIMS["H"], DIMS["S"], DIMS["CS"]
    s_pad = -(-s // cs) * cs
    q = torch.from_numpy(rng.standard_normal((b, hd, 1)).astype(np.float32) * 0.3).bfloat16()
    k8, v8 = (rng.integers(-127, 128, (b, hd, s_pad)).astype(np.int8) for _ in range(2))
    sk, sv = (rng.uniform(1e-3, 1e-2, (b, 1, s_pad)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_dec(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(k8[..., :s]), jnp.asarray(v8[..., :s]), h,
                              k_scale=jnp.asarray(sk[..., :s]), v_scale=jnp.asarray(sv[..., :s]),
                              interpret=True))
    args = (q, *(torch.from_numpy(a) for a in (k8, v8, sk, sv)), h, s, cs)
    got = kb.KERNELS["kernel_vpu8"][1](*args).numpy()
    assert got.shape == want.shape and np.max(np.abs(got - want)) < TOL_F32
    before = LAUNCHES["kernel_vpu8"]
    np.testing.assert_array_equal(kb.kernel_vpu8(*args).numpy(), got)
    assert LAUNCHES["kernel_vpu8"] == before


def test_kernel_rows_refuses_rows_the_grid_would_drop():
    from whisper_tpu_torch.kernels import kbench as kb

    x = _inputs(5)
    with pytest.raises(ValueError, match="multiple of RB"):
        kb.kernel_rows(x["k"][1], x["v"][1], 48)


# (lanes, H, Dh, S_PAD, CS): large-v2 at B=8 and B=1, the card tests' edge
# shapes (tests/test_torch_cuda.py MXU_EDGES) and a few more
GEOMETRY_SHAPES = [
    (8, 20, 64, 1536, 512), (1, 20, 64, 1536, 512), (8, 20, 64, 1536, 64),
    (8, 2, 64, 1536, 512), (8, 20, 16, 1536, 512), (8, 20, 128, 1536, 512),
    (4, 20, 128, 256, 128), (1, 20, 80, 1024, 512), (64, 20, 16, 128, 128),
    (2, 2, 64, 256, 128), (8, 20, 64, 704, 64), (3, 5, 48, 1536, 1536),
]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_mxu_geometry_covers_keys_and_heads(shape):
    """K4b's launch geometry: the key ranges cover [0, S_PAD) once, each
    inside one chunk or over whole chunks, in whole 64-key tiles; at most 8
    blocks a cluster; the head groups cover [0, H); a block fits."""
    from whisper_tpu_torch.kernels import kbench as kb

    lanes, h, dh, s_pad, cs = shape
    geo = kb.mxu_geometry(lanes, h * dh, h, s_pad, cs)
    assert 1 <= geo.cluster <= 8 and len(geo.ranges) == geo.cluster
    assert geo.ranges[0][0] == 0 and geo.ranges[-1][1] == s_pad
    assert all(a[1] == b[0] for a, b in zip(geo.ranges, geo.ranges[1:]))
    for lo, hi in geo.ranges:
        assert lo < hi and lo % 64 == 0 and hi % 64 == 0
        assert lo // cs == (hi - 1) // cs or (lo % cs == 0 and hi % cs == 0)
    assert geo.heads * (geo.groups - 1) < h <= geo.heads * geo.groups
    assert geo.heads <= 16
    assert geo.smem <= kb.SMEM_LIMIT
    assert geo.blocks == geo.groups * geo.cluster * lanes


def test_mxu_geometry_fills_the_card_at_large_v2():
    """At the tool's large-v2 shape: 96 to 264 blocks (132 SMs), each of one
    512-key chunk and 4 heads' rows, all of them on the card at once (two
    blocks fit an SM)."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.tools.kbench import Dims

    d = Dims()
    geo = kb.mxu_geometry(d.B, d.HD, d.H, d.s_pad, d.CS)
    assert 96 <= geo.blocks <= 2 * kb.SMS
    assert (geo.heads, geo.cluster, geo.ranges) == (4, 3, ((0, 512), (512, 1024), (1024, 1536)))
    assert geo.blocks <= kb.blocks_at_once(geo.cluster, geo.smem)


def test_mxu_geometry_reaches_the_kernels_edges():
    """The card tests' edge shapes reach what they are there for: several
    whole chunks a block, a last head group that is partial, three row
    blocks, a partial last row block, chunks cut in parts, two n-tiles of
    heads, a cluster of one."""
    from whisper_tpu_torch.kernels import kbench as kb

    def geo(lanes, h, dh, s_pad, cs):
        return kb.mxu_geometry(lanes, h * dh, h, s_pad, cs)

    g = geo(8, 20, 64, 1536, 64)
    assert all((hi - lo) // 64 > 1 for lo, hi in g.ranges)
    g = geo(4, 20, 128, 256, 128)
    assert 20 % g.heads and g.heads * 128 > 2 * kb.DENSE_TILE_ROWS
    g = geo(1, 20, 80, 1024, 512)
    assert 20 % g.heads and g.cluster > 1024 // 512
    assert kb.DENSE_TILE_ROWS < g.heads * 80 < 2 * kb.DENSE_TILE_ROWS
    g = geo(64, 20, 16, 128, 128)
    assert g.n_tiles == 2 and g.cluster == 1


def test_key_ranges_refuse_cuts_off_the_tiles():
    from whisper_tpu_torch.kernels import kbench as kb

    assert kb.key_ranges(1536, 512, 6) == [(i * 256, (i + 1) * 256) for i in range(6)]
    assert kb.key_ranges(1536, 64, 5) == [(0, 256), (256, 576), (576, 896), (896, 1216),
                                         (1216, 1536)]
    assert kb.key_ranges(1536, 512, 8) is None       # 8 blocks do not cut 3 chunks evenly
    assert kb.key_ranges(256, 128, 8) is None        # parts of 32 keys: not whole tiles


def test_mxu_geometry_refuses_a_block_too_large():
    from whisper_tpu_torch.kernels import kbench as kb

    with pytest.raises(NotImplementedError, match="no K4b block fits"):
        kb.mxu_geometry(1, 16, 1, 2**18, 2**18)


# (lanes, H, S, S_PAD): K8's geometry at the card tests' edge shapes
# (tests/test_torch_cuda.py VPU8_EDGES) and a few more
VPU8_SHAPES = [
    (8, 20, 1, 1536), (8, 20, 15, 1536), (8, 20, 16, 1536), (8, 20, 17, 1536),
    (8, 20, 200, 256), (8, 20, 200, 200), (8, 20, 1500, 1536), (1, 20, 1500, 1536),
    (8, 2, 1500, 1536), (1, 2, 1500, 1536), (1, 2, 1, 256), (1, 2, 17, 200),
    (1, 20, 200, 256), (2, 3, 300, 304), (1, 2, 6000, 6144), (8, 20, 6000, 6144),
]


@pytest.mark.parametrize("shape", VPU8_SHAPES)
def test_vpu8_geometry_covers_the_keys(shape):
    """K8's launch geometry: the key ranges cover [0, S) once, none empty,
    each starting on a 16-key group; at most 8 blocks a cluster; 16-byte
    loads exactly where S_PAD % 16 == 0."""
    from whisper_tpu_torch.kernels import kbench as kb

    lanes, h, s, s_pad = shape
    geo = kb.vpu8_geometry(lanes, h, s, s_pad)
    assert 1 <= geo.cluster <= 8 and len(geo.ranges) == geo.cluster
    assert geo.ranges[0][0] == 0 and geo.ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(geo.ranges, geo.ranges[1:]))
    assert all(lo < hi and lo % 16 == 0 for lo, hi in geo.ranges)
    assert geo.ranges == tuple(kb.vpu8_ranges(s, geo.cluster))
    assert geo.vec == (16 if s_pad % 16 == 0 else 2)
    assert geo.blocks == h * geo.cluster * lanes


def test_vpu8_geometry_fills_the_card_at_large_v2():
    """At the tool's large-v2 shape: clusters of 3, one pass of at most 512
    keys a block, 480 blocks for the 132 SMs."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.tools.kbench import Dims

    d = Dims()
    geo = kb.vpu8_geometry(d.B, d.H, d.S, d.s_pad)
    assert geo.blocks >= kb.SMS
    assert geo.cluster == 3 and geo.ranges == ((0, 496), (496, 992), (992, 1500))
    assert all(hi - lo <= kb.VPU8_PASS for lo, hi in geo.ranges)


def test_vpu8_geometry_reaches_the_kernels_edges():
    """The card tests' edge shapes reach what they are there for: a cluster
    of 1 and of 8, a last 16-key group of one key, 2-byte loads, and blocks
    that take two passes, few of them and many."""
    from whisper_tpu_torch.kernels import kbench as kb

    assert kb.vpu8_geometry(8, 20, 16, 1536).cluster == 1
    assert kb.vpu8_geometry(8, 20, 17, 1536).ranges == ((0, 17),)
    assert kb.vpu8_geometry(1, 20, 1500, 1536).cluster == 3
    assert kb.vpu8_geometry(8, 20, 200, 200).vec == 2
    geo = kb.vpu8_geometry(1, 2, 6000, 6144)
    assert geo.cluster == 8 and min(hi - lo for lo, hi in geo.ranges) > kb.VPU8_PASS
    geo = kb.vpu8_geometry(8, 20, 6000, 6144)
    assert geo.blocks == 1280 and min(hi - lo for lo, hi in geo.ranges) > kb.VPU8_PASS


def _tool_closure(name, ns):
    """A closure of the JAX tool's ``main()``, compiled from its source in
    the namespace ``ns`` (which supplies the module-level names it reads)."""
    tree = ast.parse(TOOL.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(TOOL), "exec"), ns)
    return ns[name]


# ---------------------------------------------------------------------------
# K7: the keys of each (head, lane) split over a cluster
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def _emulate_mxub(q, k, v, n_head, s_valid, cs, ranges, exchange=True):
    """numpy emulation of K7's cluster (csrc/kbench.cu kb_attn_mma_head):
    block r scores the tiles of keys ``ranges[r]`` that hold a key < S, keys
    >= S at -inf; the blocks exchange prefix maxima per chunk; each rounds
    p = exp(s - m_c) to bf16 at m_c, the max over every block's keys in
    chunks 0..c, and adds its chunks' l and P.V times exp(m_c - M); the
    cluster sums acc and l and divides. f32 throughout, [B, HD, 1]. Without
    ``exchange`` each block takes m_c from its own keys alone."""
    b, hd, s_pad = k.shape
    dh, tile = hd // n_head, 64
    q4 = q.reshape(b, n_head, dh).astype(np.float32)
    k4, v4 = (x.reshape(b, n_head, dh, s_pad).astype(np.float32) for x in (k, v))
    blocks = []
    for lo, hi in ranges:
        n_t = min((hi - lo) // tile, max(0, s_valid - lo + tile - 1) // tile)  # tiles read
        keys = np.arange(lo, lo + tile * n_t)
        sc = np.einsum("bhd,bhds->bhs", q4, k4[..., keys]).astype(np.float32)
        sc = np.where(keys < s_valid, sc, np.float32(-np.inf))
        chunks = list(range(lo // cs, (hi - 1) // cs + 1))
        run, prefix = np.full((b, n_head), -np.inf, np.float32), []
        for c in chunks:
            sel = keys // cs == c
            if sel.any():
                run = np.maximum(run, sc[..., sel].max(-1))
            prefix.append(run)
        blocks.append((keys, sc, chunks, prefix))

    def m_at(c):   # the running max at chunk c from every block's prefix maxima
        m = np.full((b, n_head), -np.inf, np.float32)
        for _, _, chunks, prefix in blocks:
            if chunks[0] <= c:
                m = np.maximum(m, prefix[min(c, chunks[-1]) - chunks[0]])
        return m

    big_m = m_at(s_pad // cs - 1)
    acc = np.zeros((b, n_head, dh), np.float32)
    l = np.zeros((b, n_head), np.float32)
    for keys, sc, chunks, prefix in blocks:
        for c in chunks:
            sel = keys // cs == c
            if not sel.any():
                continue
            m_c = m_at(c) if exchange else prefix[c - chunks[0]]
            f = np.exp(m_c - big_m)
            p = np.exp(sc[..., sel] - m_c[..., None])
            l += p.sum(-1) * f
            acc += np.einsum("bhs,bhds->bhd", _bf16(p), v4[..., keys[sel]]) * f[..., None]
    return (acc / l[..., None]).reshape(b, hd, 1)


def _jax_mxub(q, k, v, n_head, s_valid, cs):
    """The JAX tool's K7 body (``kernel_mxub``, a closure of its ``main()``)
    in ``mxub_inner``'s pallas_call, in interpret mode, at this shape."""
    b, hd, s_pad = k.shape
    dh, n_chunks = hd // n_head, s_pad // cs
    body = _tool_closure("kernel_mxub", {"jax": jax, "jnp": jnp, "pl": pl, "H": n_head, "DH": dh,
                                         "CS": cs, "S": s_valid, "N_CHUNKS": n_chunks})
    vmem = pltpu.VMEM
    call = pl.pallas_call(
        body,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(b, n_chunks),
            in_specs=[
                pl.BlockSpec((1, hd, 1), lambda i, c, *_: (i, 0, 0), memory_space=vmem),
                pl.BlockSpec((1, hd, cs), lambda i, c, *_: (i, 0, c), memory_space=vmem),
                pl.BlockSpec((1, hd, cs), lambda i, c, *_: (i, 0, c), memory_space=vmem),
            ],
            out_specs=pl.BlockSpec((1, n_head, dh), lambda i, c, *_: (i, 0, 0),
                                   memory_space=vmem),
            scratch_shapes=[vmem((n_head, 1), jnp.float32), vmem((n_head, 1), jnp.float32),
                            vmem((n_head, dh), jnp.float32)],
        ),
        out_shape=jax.ShapeDtypeStruct((b, n_head, dh), jnp.float32),
        interpret=True,
    )
    args = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    return np.asarray(call(jnp.zeros((b, 2), jnp.int32), *args)).reshape(b, hd, 1)


def _mxub_inputs(seed, b, n_head, s_pad):
    """bf16-valued f32 q [B, HD, 1], K and V [B, HD, S_PAD] at Dh = 64."""
    rng = np.random.default_rng(seed)
    hd = 64 * n_head
    return (_bf16(rng.standard_normal((b, hd, 1)) * 0.3),
            _bf16(rng.standard_normal((b, hd, s_pad)) * 0.3),
            _bf16(rng.standard_normal((b, hd, s_pad))))


# (B, H, S, S_PAD, CS, cluster): small shapes at the split's edges
MXUB_SPLITS = [
    (2, 2, 200, 256, 128, 2),    # whole chunks, the second block's last keys past S
    (2, 2, 1, 256, 128, 2),      # S = 1: the second block wholly past S, no tile of it read
    (2, 2, 100, 256, 64, 4),     # CS = 64: a chunk a block, blocks 2 and 3 wholly past S
    (1, 2, 450, 512, 64, 3),     # several whole chunks a block, unevenly
    (2, 2, 200, 512, 512, 8),    # one chunk cut in 8 parts, 5 of them past S
    (1, 2, 500, 512, 128, 8),    # 4 chunks cut in 2 parts each
    (1, 2, 300, 512, 64, 1),     # a cluster of 1: the sequential walk
    (2, 2, 256, 256, 256, 1),    # one chunk, one block, no key masked
]


@pytest.mark.parametrize("b,h,s,s_pad,cs,cluster", MXUB_SPLITS)
def test_mxub_split_emulation_matches_pallas(b, h, s, s_pad, cs, cluster):
    """K7's split over a cluster (the numpy emulation) against the JAX
    tool's K7 body (interpret): 2e-3 at most, and the mean error under a
    quarter of the bf16 rounding's mean effect, which p rounded at a block's
    own max or at the global max would exceed. The port's plain version
    meets the same bounds."""
    from whisper_tpu_torch.kernels import kbench as kb

    q, k, v = _mxub_inputs(20, b, h, s_pad)
    ranges = kb.key_ranges(s_pad, cs, cluster)
    assert ranges is not None and len(ranges) == cluster
    want = _jax_mxub(q, k, v, h, s, cs)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    f32_p = kb.attention_ref(tq, tk, tv, h, s, cs).numpy()
    gap = np.mean(np.abs(want - f32_p))
    for got in (_emulate_mxub(q, k, v, h, s, cs, ranges),
                kb.attention_ref(tq, tk, tv, h, s, cs, p_bf16=True).numpy()):
        assert got.shape == want.shape == (b, 64 * h, 1) and np.all(np.isfinite(got))
        err = np.abs(got - want)
        assert np.max(err) <= TOL_BF16_P
        assert np.mean(err) <= ROUNDING_SHARE * gap


def test_mxub_split_emulation_needs_the_exchange():
    """The bounds above see the exchange: the same split with each block
    rounding p at its own running max (no exchange of maxima) exceeds the
    rounding bound against the JAX body, where the cluster's stays within
    it."""
    from whisper_tpu_torch.kernels import kbench as kb

    b, h, s, s_pad, cs = 2, 2, 512, 512, 64
    q, k, v = _mxub_inputs(21, b, h, s_pad)
    ranges = kb.key_ranges(s_pad, cs, 8)
    want = _jax_mxub(q, k, v, h, s, cs)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    gap = np.mean(np.abs(want - kb.attention_ref(tq, tk, tv, h, s, cs).numpy()))
    exchanged = np.mean(np.abs(_emulate_mxub(q, k, v, h, s, cs, ranges) - want))
    own = np.mean(np.abs(_emulate_mxub(q, k, v, h, s, cs, ranges, exchange=False) - want))
    assert exchanged <= ROUNDING_SHARE * gap < own


# (lanes, H, S_PAD, CS): K7's geometry at the card tests' shapes
# (tests/test_torch_cuda.py MXUB_EDGES and the many-pairs case) and a few more
MXUB_SHAPES = [
    (8, 20, 1536, 512), (8, 20, 1536, 64), (8, 2, 1536, 512), (1, 20, 1536, 512),
    (8, 20, 1536, 1536), (1, 2, 6144, 6144), (1, 2, 6144, 512), (8, 2, 64, 64),
    (1, 1, 2**18, 2**18), (64, 20, 128, 128),
    (2, 2, 256, 128), (1, 1, 64, 64), (8, 20, 704, 64), (3, 5, 2048, 1024),
]


@pytest.mark.parametrize("shape", MXUB_SHAPES)
def test_mxub_geometry_covers_the_keys(shape):
    """K7's launch geometry: the key ranges cover [0, S_PAD) once, each
    inside one chunk or over whole chunks, in whole 64-key tiles; at most 8
    blocks a cluster; a ring of 4 tiles, fewer only where a deeper one does
    not fit; a block fits."""
    from whisper_tpu_torch.kernels import kbench as kb

    lanes, h, s_pad, cs = shape
    geo = kb.mxub_geometry(lanes, h, s_pad, cs)
    assert 1 <= geo.cluster <= 8 and len(geo.ranges) == geo.cluster
    assert geo.ranges == tuple(kb.key_ranges(s_pad, cs, geo.cluster))
    assert geo.ranges[0][0] == 0 and geo.ranges[-1][1] == s_pad
    assert all(a[1] == b[0] for a, b in zip(geo.ranges, geo.ranges[1:]))
    for lo, hi in geo.ranges:
        assert lo < hi and lo % 64 == 0 and hi % 64 == 0
        assert lo // cs == (hi - 1) // cs or (lo % cs == 0 and hi % cs == 0)
    assert kb.MXUB_MIN_STAGES <= geo.stages <= kb.MXUB_STAGES == 4
    keys, chunks = kb.range_extent(geo.ranges, cs)
    assert (geo.stages == kb.MXUB_STAGES
            or kb.mxub_smem(keys, chunks, geo.cluster, geo.stages + 1) > kb.SMEM_LIMIT)
    assert geo.smem == kb.mxub_smem(keys, chunks, geo.cluster, geo.stages) <= kb.SMEM_LIMIT
    assert geo.blocks == h * geo.cluster * lanes


def test_mxub_geometry_fills_the_card_at_large_v2():
    """At the tool's large-v2 shape: clusters of 3, one 512-key chunk a
    block, 480 blocks for the 132 SMs, all of them on the card at once with
    cluster slots to spare."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.tools.kbench import Dims

    d = Dims()
    geo = kb.mxub_geometry(d.B, d.H, d.s_pad, d.CS)
    assert (geo.cluster, geo.ranges) == (3, ((0, 512), (512, 1024), (1024, 1536)))
    assert geo.blocks == 480 >= kb.SMS
    assert geo.blocks < kb.blocks_at_once(geo.cluster, geo.smem, kb.MXUB_BLOCKS_PER_SM)
    # the ring keeps well over 20 KB of a stream in flight on each SM
    per_sm = min(kb.MXUB_BLOCKS_PER_SM, kb.SMEM_PER_SM // (geo.smem + 1024))
    assert per_sm * geo.stages * kb.MXUB_TILE_BYTES > 4 * 20 * 1024


def test_mxub_geometry_reaches_the_kernels_edges():
    """The card tests' edge shapes reach what they are there for: several
    whole chunks a block, chunks cut in parts, a single chunk cut in 8
    parts (the widest cluster), a cluster of one, and a ring of 2 tiles
    where a block's 32768 keys leave no room for more."""
    from whisper_tpu_torch.kernels import kbench as kb

    g = kb.mxub_geometry(8, 20, 1536, 64)
    assert all((hi - lo) // 64 > 1 for lo, hi in g.ranges)
    g = kb.mxub_geometry(8, 2, 1536, 512)
    assert g.cluster > 1536 // 512
    g = kb.mxub_geometry(8, 20, 1536, 1536)
    assert g.cluster > 1
    g = kb.mxub_geometry(1, 2, 6144, 6144)
    assert g.cluster == 8 and g.ranges[-1] == (5376, 6144)
    g = kb.mxub_geometry(8, 2, 64, 64)
    assert g.cluster == 1
    g = kb.mxub_geometry(1, 1, 2**18, 2**18)
    assert (g.cluster, g.stages) == (8, 2)


def test_mxub_geometry_refuses_a_block_too_large():
    from whisper_tpu_torch.kernels import kbench as kb

    with pytest.raises(NotImplementedError, match="no K7 block fits"):
        kb.mxub_geometry(1, 1, 2**19, 2**19)


def _tool_fill():
    """The JAX tool's ``fill``."""
    return _tool_closure("fill", {"jax": jax, "jnp": jnp})


@pytest.mark.parametrize("shape", [(3, 2, 4, 1536), (2, 5, 1), (2, 64, 17920)])
def test_fill_matches_tool(shape):
    """Within one bf16 ulp: sin in f32 may differ by an ulp between XLA and
    torch, which can move a bf16 rounding."""
    from whisper_tpu_torch.tools.kbench import fill

    want = np.asarray(_tool_fill()(shape).astype(jnp.float32))
    got = fill(shape, "cpu").float().numpy()
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_run_every_variant_on_cpu(capsys):
    """The entry point's pass over every variant at small dimensions: a
    record with positive bytes each, and no device rate from a host clock."""
    from whisper_tpu_torch.tools.kbench import VARIANTS, D, Dims, run

    dims = Dims(**DIMS, N=16)
    records = run(dims, VARIANTS, device="cpu", reps=1)
    assert list(records) == list(VARIANTS)
    kv = 2 * dims.L * dims.B * dims.HD * dims.s_pad * 2
    for name, rec in records.items():
        assert rec["bytes"] > 0 and rec["ms"] > 0 and rec["device"] == "cpu", name
        assert rec["gbps"] is None and rec["share_of_bound"] is None
    assert records["read"]["bytes"] == kv + dims.L * dims.B * dims.HD * 4
    assert records["copy"]["bytes"] == kv
    assert records["vpu8"]["bytes"] == kv // 2 + 2 * dims.L * dims.B * dims.s_pad * 4 \
        + dims.B * dims.HD * 2 + dims.L * dims.B * dims.HD * 4
    w, x = dims.L * D * 14 * D, 2 * 8 * D * 2              # weights; x in and out, bf16
    assert records["w8mm"]["bytes"] == w + 14 * D * 4 + x   # int8 + f32 column scales
    assert records["wbfmm"]["bytes"] == 2 * w + x
    assert len(capsys.readouterr().out.splitlines()) == len(VARIANTS)


def test_tool_passes_match_plain_versions():
    """A pass of each kernel variant returns its kernel's plain result for
    every layer."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.tools.kbench import Dims, make_inputs, make_variants

    dims = Dims(**DIMS)
    names = ("read", "rows", "vpu", "mxub", "vpu8", "flatread", "read1")
    inp = make_inputs(dims, "cpu", names)
    var = make_variants(dims, inp, names)
    q, k, v = inp["q"], inp["k"], inp["v"]
    layer = 1
    torch.testing.assert_close(var["read"].fn()[layer], kb.rowsum_ref(k[layer], v[layer]))
    torch.testing.assert_close(var["vpu"].fn()[layer],
                               kb.attention_ref(q, k[layer], v[layer], dims.H, dims.S, dims.CS))
    torch.testing.assert_close(var["flatread"].fn(), kb.rowsum_ref(k, v).reshape(-1, dims.HD, 1))
    torch.testing.assert_close(var["read1"].fn(), kb.rowsum_ref(k, v).sum())
    assert inp["k8"].dtype == torch.int8 and int(inp["k8"].abs().max()) <= 127
    # the split row sums (read, flatread, read1) add a combine launch a call
    assert [var[n].launches_per_pass for n in names] == [2 * dims.L] + [dims.L] * 4 + [2, 2]


def test_main_raises_without_a_card(monkeypatch):
    from whisper_tpu_torch.tools.kbench import main

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    monkeypatch.setenv("VARIANTS", "read")
    with pytest.raises(RuntimeError, match="cuda"):
        main([])


# ---------------------------------------------------------------------------
# K4a: the keys of each (head, lane) split over a cluster
# ---------------------------------------------------------------------------

# (lanes, H, S, S_PAD): K4a's geometry at the card tests' edge shapes
# (tests/test_torch_cuda.py VPU_EDGES) and a few more
VPU_SHAPES = [
    (8, 20, 1, 1536), (8, 20, 63, 1536), (8, 20, 64, 1536), (8, 20, 65, 1536),
    (8, 20, 1500, 1536), (1, 20, 1500, 1536), (8, 2, 1500, 1536), (2, 3, 300, 304),
    (2, 4, 100, 104), (64, 20, 100, 128), (1, 2, 6000, 6144), (2, 3, 300, 306),
    (2, 2, 200, 202), (16, 20, 1500, 1536), (1, 1, 250000, 2**18), (3, 5, 1000, 1024),
]


@pytest.mark.parametrize("shape", VPU_SHAPES)
def test_vpu_geometry_covers_the_keys(shape):
    """K4a's launch geometry: the key ranges cover [0, S) once, none empty,
    each starting on a 64-key tile; 1 to 8 blocks a cluster, at most one a
    tile; TMA exactly where S_PAD % 8 == 0."""
    from whisper_tpu_torch.kernels import kbench as kb

    lanes, h, s, s_pad = shape
    geo = kb.vpu_geometry(lanes, h, s, s_pad)
    assert 1 <= geo.cluster <= 8 and len(geo.ranges) == geo.cluster
    assert geo.cluster <= -(-s // kb.VPU_TILE)
    assert geo.ranges[0][0] == 0 and geo.ranges[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(geo.ranges, geo.ranges[1:]))
    assert all(lo < hi and lo % kb.VPU_TILE == 0 for lo, hi in geo.ranges)
    assert geo.ranges == tuple(kb.vpu_ranges(s, geo.cluster))
    assert geo.tma == (s_pad % 8 == 0)
    assert geo.blocks == h * geo.cluster * lanes


def test_vpu_geometry_fills_the_card_at_large_v2():
    """At the tool's large-v2 shape: clusters of 3, one pass of 8 tiles a
    block, 480 blocks, all of them on the card in one round (the card's
    CLUSTER_SLOTS entry for clusters of 3 at 5 blocks an SM); clusters of
    4 would take two rounds there."""
    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.tools.kbench import Dims

    d = Dims()
    geo = kb.vpu_geometry(d.B, d.H, d.S, d.s_pad)
    assert geo.cluster == 3 and geo.ranges == ((0, 512), (512, 1024), (1024, 1500))
    assert all(hi - lo <= kb.VPU_PASS for lo, hi in geo.ranges)
    assert kb.SMEM_PER_SM // (kb.VPU_SMEM + 1024) == kb.VPU_BLOCKS_PER_SM == 5
    assert kb.SMS <= geo.blocks == 480 <= kb.CLUSTER_SLOTS[(3, 5)] * 3
    assert kb.CLUSTER_SLOTS[(4, 5)] * 4 < d.B * d.H * 4


def test_vpu_geometry_reaches_the_kernels_edges():
    """The card tests' edge shapes reach what they are there for: a cluster
    of 1 at one key, a last range of one key, larger clusters at B = 1, a
    cluster of 8 whose blocks take two passes, clusters of 1 over many
    pairs, the producer's 4-byte copies, and a last range that holds the
    peak's 3 keys."""
    from whisper_tpu_torch.kernels import kbench as kb

    assert kb.vpu_geometry(8, 20, 1, 1536).ranges == ((0, 1),)
    assert kb.vpu_geometry(8, 20, 65, 1536).ranges == ((0, 64), (64, 65))
    assert kb.vpu_geometry(8, 20, 64, 1536).cluster == 1
    assert kb.vpu_geometry(1, 20, 1500, 1536).cluster > kb.vpu_geometry(8, 20, 1500, 1536).cluster
    geo = kb.vpu_geometry(1, 2, 6000, 6144)
    assert geo.cluster == 8 and min(hi - lo for lo, hi in geo.ranges) > kb.VPU_PASS
    assert kb.vpu_geometry(64, 20, 100, 128).cluster == 1
    assert not kb.vpu_geometry(2, 3, 300, 306).tma and not kb.vpu_geometry(2, 2, 200, 202).tma
    assert kb.vpu_geometry(8, 20, 1500, 1536).ranges[-1][0] <= 1500 - 3


def _emulate_vpu(q, k, v, n_head, s_valid, ranges, pass_keys=512):
    """numpy emulation of K4a's cluster (csrc/kbench.cu kb_attn_f32_split):
    block r walks keys ``ranges[r]`` in passes of whole 64-key tiles, keys
    >= its hi at -inf, with the online softmax's (m, l, acc) in f32; the
    cluster combines the blocks as sum_j e^(m_j - M) acc_j / sum_j
    e^(m_j - M) l_j. [B, HD, 1]."""
    b, hd, _ = k.shape
    dh, tile = hd // n_head, 64
    q4 = q.reshape(b, n_head, dh).astype(np.float32)
    k4, v4 = (x.reshape(b, n_head, dh, -1).astype(np.float32) for x in (k, v))
    parts = []
    for lo, hi in ranges:
        m = np.full((b, n_head), -np.inf, np.float32)
        l = np.zeros((b, n_head), np.float32)
        acc = np.zeros((b, n_head, dh), np.float32)
        for p0 in range(lo, hi, pass_keys):
            keys = np.arange(p0, p0 + min(pass_keys, -(-(hi - p0) // tile) * tile))
            sc = np.einsum("bhd,bhds->bhs", q4, k4[..., keys]).astype(np.float32)
            sc = np.where(keys < hi, sc, np.float32(-np.inf))
            m_new = np.maximum(m, sc.max(-1))
            alpha = np.exp(m - m_new)
            p = np.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + np.einsum("bhs,bhds->bhd", p, v4[..., keys])
            m = m_new
        parts.append((m, l, acc))
    big_m = np.max([m for m, _, _ in parts], axis=0)
    num = sum(np.exp(m - big_m)[..., None] * acc for m, _, acc in parts)
    den = sum(np.exp(m - big_m) * l for m, l, _ in parts)
    return (num / den[..., None]).reshape(b, hd, 1)


_TOOLS = {}


def _tool_at(b, s, hd, h, cs):
    """tools/kbench.py loaded under these dimensions, once each."""
    key = (b, s, hd, h, cs)
    if key not in _TOOLS:
        with pytest.MonkeyPatch.context() as mp:
            for name, val in dict(B=b, S=s, HD=hd, H=h, CS=cs).items():
                mp.setenv(name, str(val))
            spec = importlib.util.spec_from_file_location(f"tools_kbench_{len(_TOOLS)}", TOOL)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _TOOLS[key] = mod
    return _TOOLS[key]


# (B, H, Dh, S, S_PAD, CS, cluster): small shapes at the split's edges
VPU_SPLITS = [
    (2, 2, 64, 1, 128, 64, 1),        # S = 1: one key, one block
    (2, 2, 64, 65, 128, 64, 2),       # the second block's range a tile of one key
    (1, 2, 32, 1000, 1024, 256, 8),   # a cluster of 8, two tiles a block
    (1, 2, 16, 1100, 1152, 128, 1),   # a cluster of 1 over 18 tiles: three passes
    (2, 2, 64, 300, 320, 64, 3),      # CS = 64: chunks cut across the ranges
    (2, 3, 24, 200, 256, 128, 4),     # a last range of 8 keys past whole chunks
]


@pytest.mark.parametrize("b,h,dh,s,s_pad,cs,cluster", VPU_SPLITS)
def test_vpu_split_emulation_matches_pallas(b, h, dh, s, s_pad, cs, cluster):
    """K4a's split over a cluster (the numpy emulation) and its plain
    version against the JAX tool's K4a body (``kernel_vpu``, interpret)
    within 1e-5: p is f32 and never rounded, so only the order of the f32
    sums differs from the TPU's chunk walk."""
    from whisper_tpu_torch.kernels import kbench as kb

    rng = np.random.default_rng(22)
    hd = h * dh
    q, k, v = (_bf16(rng.standard_normal(shape) * sc) for shape, sc in (
        ((b, hd, 1), 0.3), ((b, hd, s_pad), 0.3), ((b, hd, s_pad), 1.0)))
    ranges = kb.vpu_ranges(s, cluster)
    assert len(ranges) == cluster and all(lo < hi for lo, hi in ranges)
    jkb_ = _tool_at(b, s, hd, h, cs)
    want = _jax_attention(jkb_, jkb_.kernel_vpu, *(jnp.asarray(x).astype(jnp.bfloat16)
                                                   for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    for got in (_emulate_vpu(q, k, v, h, s, ranges),
                kb.attention_ref(tq, tk, tv, h, s, cs).numpy()):
        assert got.shape == want.shape == (b, hd, 1) and np.all(np.isfinite(got))
        assert np.max(np.abs(got - want)) <= TOL_F32 * max(1.0, np.max(np.abs(want)))
