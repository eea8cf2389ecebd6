"""The port's token loops with their step counter on the device, against the
JAX package's ``lax.while_loop`` loops, on the CPU.

``runtime/decode.py:greedy_step`` and ``runtime/beam.py:beam_step`` read
and write tensors alone (the counter ``i`` is a device int32 scalar, the
token column and the cache column are written by ``index_copy_``), which is
what lets the card capture them as CUDA graphs; on the CPU the same steps
run one by one. Here they run on the tiny random and scripted checkpoints
against the JAX package's ``run_window`` and beam search, over
tests/test_torch_runtime.py's grid (seek, seek_end, max_tokens,
single_segment, force_steps), greedy at 1 and 2 lanes and beam 2 and 5 at
U = 1 and 2, on the f32 tier and the int8 one (int8 weights and caches).
Tokens, tid, result_len, seek_delta, failed and steps must be identical;
p, pt and ptsum agree within TOL, f32 softmax sums in another order (the
int8 tier: the decoder's 1e-4, as tests/test_torch_beam.py holds it). The
pieces the device step is made of are held against what they replace: the
``index_copy_`` cache write against the slice write, the range check made
once on the host where ``write_cols`` raises, and the beam reorder over
whole column ranges against ``reorder_self_kv`` over the written columns.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint, make_vocab_words

TOL = 1e-5
TOL_INT8 = 1e-4
SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>
GRID = [  # seek, seek_end, max_tokens, single_segment, force_steps
    (0, 100_000, 0, False, 0),   # long audio: normal rules
    (0, 1_500, 0, False, 0),     # short audio: end-of-audio path
    (0, 100_000, 5, False, 0),   # max_tokens cutoff
    (0, 2_000, 0, True, 0),      # single segment
    (0, 100_000, 0, False, 9),   # bench mode: fixed step count
]
GRID_IDS = ["long", "short", "max_tokens", "single", "forced"]


def _ids():
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary

    return SpecialIds.from_vocab(Vocabulary(make_vocab_words(51_864), 51_864))


def _runtimes(path, int8=False):
    """(JAX runtime, port runtime on the CPU) on one checkpoint, f32
    compute; ``int8``: int8 decoder weights and int8 K/V caches on both
    sides (the JAX side's kernels in interpret mode)."""
    from whisper_tpu.config import KernelConfig
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model import params as jp
    from whisper_tpu.runtime.context import WhisperRuntime as JRuntime
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    ids = _ids()
    if int8:
        jpol = jp.DtypePolicy(jnp.float32, jnp.float32, jnp.float32, weights_int8=True)
        tpol = DtypePolicy(torch.float32, torch.float32, torch.float32, weights_int8=True)
        kernels = KernelConfig(flash_attention=True, interpret=True, kv_int8=True)
    else:
        jpol, tpol, kernels = jp.DtypePolicy.f32(), DtypePolicy.f32(), None
    jrt = JRuntime(jp.params_from_checkpoint(jload(path), jpol), TINY_TEST_DIMS, JIds(*ids),
                   compute_dtype=jnp.float32, kernels=kernels)
    trt = WhisperRuntime(params_from_checkpoint(load_checkpoint(path), tpol, "cpu"), TINY_TEST_DIMS,
                         ids, compute_dtype=torch.float32, device="cpu", kv_int8=int8)
    return jrt, trt


def _cross(jrt, seed, u):
    """JAX's cross K/V for a seeded mel [U, 80, 2T], and the same arrays as
    the port's CrossKV."""
    from whisper_tpu_torch.model.encoder import CrossKV

    mel = np.random.default_rng(seed).standard_normal(
        (u, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)
    _, jcross = jrt.encode_window(mel)
    return jcross, CrossKV(*(None if a is None else torch.tensor(np.asarray(a)) for a in jcross))


def _prompts(rt, u):
    """U right-padded prompts of different lengths: [sot], [prev, 300, 400, sot]."""
    rows = [[rt.ids.sot], [rt.ids.prev, 300, 400, rt.ids.sot]][:u]
    padded = np.zeros((u, rt.prompt_capacity), np.int32)
    for r, row in enumerate(rows):
        padded[r, : len(row)] = row
    return padded, np.array([len(r) for r in rows], np.int32)


def _assert_same(got, want, tol, n=None):
    """WindowResult-shaped ``got`` against ``want``: integer fields
    identical, probabilities within ``tol``; ``n``: compare only that many
    columns of the [B, n_max] arrays (the rest of ``got`` must be zero)."""
    for name in ("tokens", "tid", "result_len", "seek_delta", "failed", "steps", "p", "pt", "ptsum"):
        if not hasattr(want, name):
            continue
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if n is not None and g.ndim == 2:
            assert not g[:, n:].any(), name
            g = g[:, :n]
        if name in ("p", "pt", "ptsum"):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def random_setup(tmp_path_factory):
    """A random tiny checkpoint (seed 3, tests/test_torch_runtime.py's) with
    JAX's cross K/V of seeded mels at U = 1 and 2."""
    path = str(tmp_path_factory.mktemp("graph_loop") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=3)
    jrt, trt = _runtimes(path)
    return jrt, trt, {u: _cross(jrt, 11 + u, u) for u in (1, 2)}


def _greedy(jrt, trt, jcross, tcross, u, case):
    seek, seek_end, max_tokens, single, force_steps = case
    padded, plens = _prompts(trt, u)
    lim = (np.full((u,), seek, np.int32), np.full((u,), seek_end, np.int32))
    kw = dict(max_tokens=max_tokens, single_segment=single, force_steps=force_steps)
    return (trt.run_window(padded, plens, tcross, *lim, **kw),
            jrt.run_window(padded, plens, jcross, *lim, **kw))


@pytest.mark.parametrize("u", [1, 2])
@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_greedy_device_step_matches_jax(random_setup, case, u):
    jrt, trt, cross = random_setup
    got, want = _greedy(jrt, trt, *cross[u], u, case)
    _assert_same(got, want, TOL)
    if case[-1]:
        assert int(got.steps) == case[-1]


def _beam_params(width, max_tokens=0, single=False):
    from whisper_tpu.api.params import Flags as JFlags
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu.api.params import SamplingStrategy as JStrategy
    from whisper_tpu_torch.api.params import Flags, FullParams, SamplingStrategy

    jp = JParams(strategy=JStrategy.BEAM_SEARCH, beam_width=width, max_tokens=max_tokens)
    tp = FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=width, max_tokens=max_tokens)
    if single:
        jp.flags |= JFlags.SINGLE_SEGMENT
        tp.flags |= Flags.SINGLE_SEGMENT
    return jp, tp


def _beam(jrt, trt, jcross, tcross, u, width, case):
    """The port's beam window against JAX's. Natural cases: both
    ``decode_window_beam``s (loop and host replay of the window rules).
    The forced case: the port's loop of ``force_steps`` steps against
    JAX's loop with that step cap (JAX's beam has no forced mode; a loop
    whose beams never all finish runs to its cap either way). Returns
    (got, want, compared columns)."""
    from whisper_tpu.runtime.beam import _beam_window as jwindow
    from whisper_tpu.runtime.beam import decode_window_beam as jbeam
    from whisper_tpu_torch.runtime.beam import _beam_window, decode_window_beam

    seek, seek_end, max_tokens, single, force_steps = case
    padded, plens = _prompts(trt, u)
    jp, tp = _beam_params(width, max_tokens, single)
    if not force_steps:
        lim = (np.full((u,), seek, np.int32), np.full((u,), seek_end, np.int32))
        return (decode_window_beam(trt, tp, padded, plens, tcross, *lim),
                jbeam(jrt, jp, padded, plens, jcross, *lim), None)
    (tokens, p, pt, ptsum, tid, length), steps = _beam_window(
        trt, torch.as_tensor(padded), torch.as_tensor(plens), tcross, width, trt.n_max_steps,
        force_steps)
    want = jwindow(jrt.params, jrt.dims, jrt.ids, jnp.asarray(padded), jnp.asarray(plens), jcross,
                   width, force_steps, jrt.compute_dtype, jrt.kernels)
    names = ("tokens", "p", "pt", "ptsum", "tid", "result_len", "steps")
    got = dict(zip(names, (tokens, p, pt, ptsum, tid, length, torch.tensor(steps))))
    return (type("Got", (), got), type("Want", (), dict(zip(names, want))), force_steps)


@pytest.mark.parametrize("u", [1, 2])
@pytest.mark.parametrize("width", [2, 5])
@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_beam_device_step_matches_jax(random_setup, case, width, u):
    jrt, trt, cross = random_setup
    got, want, n = _beam(jrt, trt, *cross[u], u, width, case)
    _assert_same(got, want, TOL_INT8, n)
    if case[-1]:
        assert int(got.steps) == case[-1]


@pytest.mark.parametrize("columns", [1, 8])
def test_beam_reorder_range_width_keeps_the_tokens(random_setup, monkeypatch, columns):
    """The reorder's column ranges cut below the tiny model's 20 steps
    (one range at the default width): the window is JAX's whatever the
    ranges."""
    from whisper_tpu_torch.runtime import beam

    monkeypatch.setattr(beam, "REORDER_COLUMNS", columns)
    jrt, trt, cross = random_setup
    got, want, _ = _beam(jrt, trt, *cross[2], 2, 5, GRID[0])
    _assert_same(got, want, TOL_INT8)


@pytest.fixture(scope="module")
def int8_setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graph_loop8") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=1)
    jrt, trt = _runtimes(path, int8=True)
    return jrt, trt, {u: _cross(jrt, 7 + u, u) for u in (1, 2)}


@pytest.mark.parametrize("case", [GRID[0], GRID[4]], ids=["long", "forced"])
@pytest.mark.parametrize("loop", ["greedy", "beam5"])
def test_int8_tier_device_step_matches_jax(int8_setup, loop, case):
    """int8 weights and int8 K/V caches: each step quantizes its new column
    and writes codes and scales by ``index_copy_``; beam search reorders
    the scale columns with the codes."""
    jrt, trt, cross = int8_setup
    assert cross[2][1].k.dtype == torch.int8
    if loop == "greedy":
        got, want = _greedy(jrt, trt, *cross[2], 2, case)
        _assert_same(got, want, TOL_INT8)
    else:
        got, want, n = _beam(jrt, trt, *cross[2], 2, 5, case)
        _assert_same(got, want, TOL_INT8, n)


@pytest.fixture(scope="module")
def scripted_setup():
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "scripted.bin")
        make_scripted_checkpoint(path, SCRIPT)
        jrt, trt = _runtimes(path)
        return jrt, trt, _cross(jrt, 3, 2)


@pytest.mark.parametrize("loop", ["greedy", "beam5"])
def test_scripted_checkpoint_device_step_gives_the_script(scripted_setup, loop):
    """Both lanes of the scripted checkpoint decode its script (the second
    lane's longer prompt shifts the script by its length, as in JAX)."""
    jrt, trt, (jcross, tcross) = scripted_setup
    if loop == "greedy":
        got, want = _greedy(jrt, trt, jcross, tcross, 2, GRID[0])
        _assert_same(got, want, TOL)
    else:
        got, want, _ = _beam(jrt, trt, jcross, tcross, 2, 5, GRID[0])
        _assert_same(got, want, TOL_INT8)
    n = int(got.result_len[0])
    assert got.tokens[0, :n].tolist() == SCRIPT[:-1] and not bool(got.failed[0])


def test_greedy_state_reuse_equals_a_fresh_window(random_setup):
    """A window run over a previous window's state and cache (as a captured
    step runs over its runtime's tensors) equals a fresh window: every
    field of the state is reset, the cache is zeroed."""
    from whisper_tpu_torch.runtime.decode import GreedyState, decode_window

    _, trt, cross = random_setup
    padded, plens = _prompts(trt, 2)

    def window(seek_end, state=None, kv=None):
        kv = trt.self_kv(2) if kv is None else kv
        for a in (kv.k, kv.v):
            a.zero_()
        return decode_window(trt.params, trt.dims, trt.ids, torch.as_tensor(padded),
                             torch.as_tensor(plens), kv, cross[2][1],
                             torch.zeros(2, dtype=torch.int32),
                             torch.full((2,), seek_end, dtype=torch.int32),
                             compute_dtype=torch.float32, state=state)

    state = GreedyState.zeros(2, trt.n_max_steps, trt.dims.n_vocab, "cpu")
    kv = trt.self_kv(2)
    first = window(1_500, state, kv)
    fresh = window(100_000)
    again = window(100_000, state, kv)
    assert not torch.equal(first.tokens, fresh.tokens)   # the reuse has something to reset
    _assert_same(again, fresh, 0.0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_index_copy_cache_write_matches_slice_write(quant):
    """The single-token step's cache write (``index_copy_`` at a device
    column) against the prompt ingest's (slice assignment at a host
    column): codes and, for int8, the scale columns, bit for bit."""
    from whisper_tpu_torch.kernels.quant import quantize_cols, write_cols
    from whisper_tpu_torch.model.decoder import init_self_kv

    g = torch.Generator().manual_seed(0)
    dims = TINY_TEST_DIMS
    b, col = 3, 31
    by_index = init_self_kv(dims, b, dtype=torch.bfloat16, device="cpu", quant=quant)
    by_slice = init_self_kv(dims, b, dtype=torch.bfloat16, device="cpu", quant=quant)
    for li in range(dims.n_text_layer):
        new = torch.randn((b, 1, dims.n_text_state), generator=g)
        if quant:
            codes, sc = quantize_cols(new, axis=-1)
            writes = ((by_index.k, by_slice.k, codes), (by_index.k_s, by_slice.k_s, sc))
        else:
            writes = ((by_index.k, by_slice.k, new.to(torch.bfloat16)),)
        for a, s, x in writes:
            write_cols(a[li], x, torch.tensor([col]))
            write_cols(s[li], x, col)
            assert bool(a[li, ..., col].float().abs().sum() > 0)
    for a, s in zip(by_index, by_slice):
        if a is not None:
            assert torch.equal(a, s)


def test_decode_step_device_column_matches_host_column(random_setup):
    """decode_step with ``write_pos`` a device int32 scalar gives the
    logits and the cache of ``write_pos`` a host int."""
    from whisper_tpu_torch.model.decoder import decode_step

    _, trt, cross = random_setup
    tcross = cross[2][1]
    out = []
    for wp in (5, torch.tensor(5, dtype=torch.int32)):
        kv = trt.self_kv(2)
        logits, kv = decode_step(trt.params, trt.dims, torch.tensor([[300], [400]], dtype=torch.int32),
                                 torch.tensor([5, 7], dtype=torch.int32), kv, tcross, write_pos=wp,
                                 attn_start=torch.tensor([0, 2], dtype=torch.int32),
                                 compute_dtype=torch.float32)
        out.append((logits, kv))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        if a is not None:
            assert torch.equal(a, b)


def test_host_range_check_raises_before_any_step(random_setup):
    """A device column is not range-checked where it is written; the loops
    check p_max + n_max <= n_text_ctx once, on the host, before they write
    anything, and raise where ``write_cols`` raises at the first column
    past the cache. A single-token step at a host column still checks it."""
    from whisper_tpu_torch.model.decoder import decode_step
    from whisper_tpu_torch.runtime.beam import _beam_window

    _, trt, cross = random_setup
    tcross = cross[1][1]
    too_long = np.zeros((1, trt.prompt_capacity + 1), np.int32)
    too_long[0, 0] = trt.ids.sot
    args = (np.ones(1, np.int32), tcross, np.zeros(1, np.int32), np.full(1, 10**6, np.int32))
    with pytest.raises(ValueError, match="exceeds cache length"):
        trt.run_window(too_long, *args)
    with pytest.raises(ValueError, match="exceeds cache length"):
        _beam_window(trt, torch.as_tensor(too_long), torch.ones(1, dtype=torch.int32), tcross, 2,
                     trt.n_max_steps)
    # the largest capacity that fits: the last step writes the cache's last column
    fits = too_long[:, :-1]
    res = trt.run_window(fits, *args, force_steps=trt.n_max_steps)
    assert int(res.steps) == trt.n_max_steps == trt.dims.n_text_ctx - fits.shape[1]
    with pytest.raises(ValueError, match="outside cache length"):
        decode_step(trt.params, trt.dims, torch.tensor([[11]], dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int32), trt.self_kv(1), tcross,
                    write_pos=trt.dims.n_text_ctx, compute_dtype=torch.float32)


@pytest.mark.parametrize("i", [0, 1, 31, 32, 33, 100, 219])
def test_beam_reorder_ranges_match_reorder_self_kv(i):
    """Step i's reorder over whole ranges (``reorder_columns``) leaves the
    cache as ``reorder_self_kv`` over the i written columns does: the
    columns past the last write are zero in the loop, so moving them
    changes nothing. The ranges cover [0, i) and stop at n_max."""
    from whisper_tpu_torch.model.decoder import init_self_kv, reorder_self_kv
    from whisper_tpu_torch.runtime.beam import REORDER_COLUMNS, reorder_columns

    n_max, p_max = 220, 224                     # large-v2's step cap and prompt capacity
    n = reorder_columns(i, n_max)
    assert i < n <= n_max and (n == n_max or n % REORDER_COLUMNS == 0)
    assert len({reorder_columns(j, n_max) for j in range(n_max)}) == -(-n_max // REORDER_COLUMNS)
    g = torch.Generator().manual_seed(i)
    ranged = init_self_kv(TINY_TEST_DIMS, 6, device="cpu", cache_len=448, quant=True)
    for a in ranged:
        a[..., : p_max + i].copy_(torch.randint(-100, 100, a[..., : p_max + i].shape,
                                                generator=g).to(a.dtype))
    exact = [a.clone() for a in ranged]
    parent = torch.tensor([2, 2, 0, 4, 4, 5])
    reorder_self_kv(ranged, parent, p_max, n)
    reorder_self_kv(type(ranged)(*exact), parent, p_max, i)
    for a, b in zip(ranged, exact):
        assert torch.equal(a, b)
