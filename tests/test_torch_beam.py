"""The port's beam search against the JAX package's, on the CPU.

Both sides decode from the same cross K/V (JAX's encoder output, carried
across as numpy), so the comparison isolates the beam loop. Tokens, tid,
result_len, seek_delta, failed and steps must be identical; p, pt and ptsum
agree within 1e-4, the decoder's tolerance (f32 softmax and products summed
in another order). Candidates are chosen as ``jax.lax.top_k`` chooses them,
the lower flat index first among equal scores: the scripted checkpoint's
case below has thousands of such ties every step.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint, make_vocab_words

TOL = 1e-4
SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>


def _ids():
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary

    return SpecialIds.from_vocab(Vocabulary(make_vocab_words(51_864), 51_864))


def _runtimes(path, int8=False):
    """(JAX runtime, port runtime) on one checkpoint, f32 compute; ``int8``:
    int8 decoder weights and int8 K/V caches on both sides (the JAX side's
    kernels in interpret mode, as tests/test_torch_quant.py sets it up)."""
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


def _cross(jrt, seed, u=1):
    """JAX's cross K/V for a seeded mel [U, 80, 2T], and the same arrays as
    the port's CrossKV."""
    from whisper_tpu_torch.model.encoder import CrossKV

    mel = np.random.default_rng(seed).standard_normal(
        (u, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32)
    _, jcross = jrt.encode_window(mel)
    return jcross, CrossKV(*(None if a is None else torch.tensor(np.asarray(a)) for a in jcross))


def _prompts(rt, u=1):
    padded = np.zeros((u, rt.prompt_capacity), np.int32)
    padded[:, 0] = rt.ids.sot
    return padded, np.ones((u,), np.int32)


def _params(width):
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu.api.params import SamplingStrategy as JStrategy
    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy

    return (JParams(strategy=JStrategy.BEAM_SEARCH, beam_width=width),
            FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=width))


def _both(jrt, trt, jcross, tcross, width, seek_end=10**6, u=1):
    from whisper_tpu.runtime.beam import decode_window_beam as jbeam
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    jparams, tparams = _params(width)
    padded, plens = _prompts(trt, u)
    seeks, ends = np.zeros((u,), np.int32), np.full((u,), seek_end, np.int32)
    want = jbeam(jrt, jparams, padded, plens, jcross, seeks, ends)
    got = decode_window_beam(trt, tparams, padded, plens, tcross, seeks, ends)
    return got, want


def _assert_same(got, want):
    for name in ("tokens", "tid", "result_len", "seek_delta", "failed", "steps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def random_setup(tmp_path_factory):
    """tests/test_beam.py's setup: random checkpoint seed 21, mel seed 31."""
    path = str(tmp_path_factory.mktemp("beam") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=21)
    jrt, trt = _runtimes(path)
    return jrt, trt, *_cross(jrt, 31)


@pytest.mark.parametrize("width,seek_end", [(1, 10**6), (3, 10**6), (5, 10**6), (3, 1_500)])
def test_beam_window_matches_jax(random_setup, width, seek_end):
    jrt, trt, jcross, tcross = random_setup
    got, want = _both(jrt, trt, jcross, tcross, width, seek_end)
    _assert_same(got, want)
    assert tuple(got.tokens.shape) == (1, trt.n_max_steps)


def test_beam1_matches_port_greedy(random_setup):
    """Beam 1 is greedy up to the window's end (same masking rules, one lane)."""
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    _, trt, _, tcross = random_setup
    padded, plens = _prompts(trt)
    g = trt.run_window(padded, plens, tcross, np.zeros(1, np.int32), np.full(1, 10**6, np.int32))
    b = decode_window_beam(trt, _params(1)[1], padded, 1, tcross, 0, 10**6)
    n = int(g.result_len[0])
    assert int(b.result_len[0]) == n
    assert b.tokens[0, :n].tolist() == g.tokens[0, :n].tolist()
    assert int(b.seek_delta[0]) == int(g.seek_delta[0]) and bool(b.failed[0]) == bool(g.failed[0])


def test_beam_two_utterances_match_jax_and_single(random_setup):
    """U=2 in one call (six lanes, cross K/V [L, 2, HD, T] read with
    kv_group=3) equals JAX's U=2 call and two U=1 calls of the port."""
    from whisper_tpu_torch.model.encoder import CrossKV
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    jrt, trt, _, _ = random_setup
    jcross, tcross = _cross(jrt, 77, u=2)
    got, want = _both(jrt, trt, jcross, tcross, 3, u=2)
    _assert_same(got, want)
    _, tparams = _params(3)
    padded, plens = _prompts(trt)
    for u in range(2):
        cross_u = CrossKV(tcross.k[:, u : u + 1], tcross.v[:, u : u + 1])
        one = decode_window_beam(trt, tparams, padded, plens, cross_u, 0, 10**6)
        n = int(one.result_len[0])
        assert int(got.result_len[u]) == n
        assert got.tokens[u].tolist() == one.tokens[0].tolist()
        assert int(got.seek_delta[u]) == int(one.seek_delta[0])
        assert bool(got.failed[u]) == bool(one.failed[0])


@pytest.mark.parametrize("width", [3, 5])
def test_beam_int8_tier_matches_jax(tmp_path_factory, width):
    """int8 decoder weights and int8 K/V caches: the self cache's scale
    columns are reordered with its codes."""
    path = str(tmp_path_factory.mktemp("beam8") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=1)
    jrt, trt = _runtimes(path, int8=True)
    jcross, tcross = _cross(jrt, 7)
    assert tcross.k.dtype == torch.int8 and tcross.k_s is not None
    got, want = _both(jrt, trt, jcross, tcross, width)
    _assert_same(got, want)


@pytest.mark.parametrize("is_initial", [True, False])
def test_masked_logprobs_matches_jax(is_initial):
    from whisper_tpu.runtime.beam import _masked_logprobs as jmasked
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu_torch.runtime.beam import _masked_logprobs

    ids = _ids()
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 51_864)).astype(np.float32) * 4
    logits[1, ids.beg + 5] = logits[1, ids.beg + 50] = 30.0       # timestamp tie
    logits[2, ids.beg:] += 5.0                                      # timestamp mass wins
    logits[3, ids.sot] = 40.0                                       # banned token on top
    logits[4, ids.beg + 150] = 35.0                                 # past the initial window
    logits[5, :] = -3.0                                             # flat: many equal scores
    want = jmasked(jnp.asarray(logits), JIds(*ids), is_initial)
    got = _masked_logprobs(torch.from_numpy(logits), ids, is_initial)
    logp_w, logp_g = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(logp_g == -1e30, logp_w == np.float32(-1e30))   # the same bans
    np.testing.assert_allclose(logp_g, logp_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))             # tid
    for a, b in zip(got[1:], want[1:]):         # probs, tid, pt, ptsum: f32 softmax sums
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_replay_window_rules_matches_jax():
    """200 seeded token sequences: text, timestamps (some going back in
    time), EOT, with varied seek, seek_end, max_tokens and single segment."""
    from whisper_tpu.runtime.beam import _replay_window_rules as jreplay
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu_torch.runtime.beam import _replay_window_rules

    ids = _ids()
    rng = np.random.default_rng(0)
    n_max = 20
    for case in range(200):
        n = int(rng.integers(0, n_max + 1))
        kind = rng.integers(0, 3, size=n)
        toks = np.where(kind == 0, rng.integers(0, 50_000, size=n),
                        np.where(kind == 1, ids.beg + rng.integers(0, 1_501, size=n), ids.eot))
        seek = int(rng.integers(0, 3_000))
        args = (seek, seek + int(rng.integers(0, 6_000)), n_max, int(rng.integers(0, 4)) * 3,
                bool(rng.integers(0, 2)))
        assert _replay_window_rules(toks, ids, *args) == jreplay(toks, JIds(*ids), *args), case


@pytest.fixture(scope="module")
def scripted_paths():
    """The scripted checkpoint, and a tied one: embedding scale 16 (every
    probability but the script's underflows to the 1e-30 floor, so the
    losing beams' candidates tie by the thousand at log(1e-30)), and token
    100's embedding row equal to token 105's, so the two tie exactly at
    the top of every step, in every beam."""
    from whisper_tpu.ggml import MelFilters, write_checkpoint_file
    from tests.helpers import mel_filterbank, scripted_weights

    with tempfile.TemporaryDirectory() as td:
        plain = os.path.join(td, "scripted.bin")
        make_scripted_checkpoint(plain, SCRIPT)
        tied = os.path.join(td, "tied.bin")
        w = scripted_weights(TINY_TEST_DIMS, SCRIPT, emb_scale=16.0)
        emb = w["decoder.token_embedding.weight"]
        emb[100] = emb[105]
        write_checkpoint_file(tied, TINY_TEST_DIMS, MelFilters(80, 201, mel_filterbank(80)),
                              make_vocab_words(TINY_TEST_DIMS.n_vocab), w, use_f16=True)
        yield {"scripted": plain, "tied": tied}


@pytest.mark.parametrize("u", [1, 2])
@pytest.mark.parametrize("which", ["scripted", "tied"])
def test_beam_scripted_checkpoint_matches_jax(scripted_paths, which, u):
    """Beam 5 on the scripted checkpoints gives JAX's steps and tokens. On
    the tied one the winner is decided by the order among equal scores:
    ``jax.lax.top_k`` puts token 100 (the lower index) first, so the winner
    reads 100 where the script has 105; a ``torch.topk``, whose order among
    ties is unspecified, gives 105 here and fails."""
    jrt, trt = _runtimes(scripted_paths[which])
    jcross, tcross = _cross(jrt, 3, u=u)
    got, want = _both(jrt, trt, jcross, tcross, 5, u=u)
    _assert_same(got, want)
    script = SCRIPT[:-1] if which == "scripted" else [t if t != 105 else 100 for t in SCRIPT[:-1]]
    for uu in range(u):
        n = int(got.result_len[uu])
        assert got.tokens[uu, :n].tolist() == script and not bool(got.failed[uu])


@pytest.mark.parametrize("case", ["one_max", "floor_ties", "dead_beams"])
def test_top_k_order_matches_lax_top_k(case):
    """Candidate selection: values and indices equal ``jax.lax.top_k``'s,
    equal values in ascending index order."""
    import jax

    from whisper_tpu_torch.runtime.beam import _top_k_lower_index_first

    rng = np.random.default_rng(1)
    x = np.full((3, 5 * 51_865), -3.0, np.float32)
    x[:, 7] = 0.0                                       # torch.topk gives [7, 1, 3, 4, 0] here
    if case == "floor_ties":                            # a few distinct scores, then the floor
        x[:] = np.float32(np.log(1e-30))
        x[:, rng.integers(0, x.shape[1], 3)] = -1.0
    elif case == "dead_beams":                          # -1e30 + logp == -1e30 in f32
        x[:] = np.float32(-1e30) + rng.uniform(-80, 0, x.shape).astype(np.float32)
        x[:, :51_865] = -2.0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = _top_k_lower_index_first(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_reorder_self_kv_moves_codes_and_scales():
    """Only columns [col0, col0 + n) move, on every tensor of the cache."""
    from whisper_tpu_torch.model.decoder import init_self_kv, reorder_self_kv

    kv = init_self_kv(TINY_TEST_DIMS, 4, device="cpu", quant=True)
    g = torch.Generator().manual_seed(0)
    for a in kv:
        a.copy_(torch.randint(-100, 100, a.shape, generator=g).to(a.dtype))
    before = [a.clone() for a in kv]
    parent = torch.tensor([2, 2, 0, 3])
    reorder_self_kv(kv, parent, 10, 5)
    for a, b in zip(kv, before):
        assert torch.equal(a[..., 10:15], b[..., 10:15][:, parent])
        assert torch.equal(a[..., :10], b[..., :10]) and torch.equal(a[..., 15:], b[..., 15:])
