"""The port's sampler and window loop against the JAX package, in f32 on
the CPU.

``sample_best`` must pick the same tokens as JAX, ties included (both
argmaxes return the first maximum). ``WhisperRuntime.run_window`` must give
a WindowResult whose integer fields (tokens, tid, result_len, seek_delta,
failed, steps) are identical to JAX's and whose probabilities (p, pt,
ptsum) agree within 1e-5 (f32 softmax sums in another order). Both loops
read the same cross K/V, so the comparison isolates the decode loop; the
encoder's parity is tests/test_torch_model.py's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_vocab_words

TOL = 1e-5


def _ids():
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary

    return SpecialIds.from_vocab(Vocabulary(make_vocab_words(51_864), 51_864))


@pytest.mark.parametrize("is_initial,force", [(False, False), (True, True), (True, False),
                                              ("lanes", "lanes")])
def test_sample_best_matches_jax(is_initial, force):
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu.runtime.sampler import sample_best as jsample
    from whisper_tpu_torch.runtime.sampler import sample_best

    ids = _ids()
    rng = np.random.default_rng(0)
    b, v = 6, 51_864
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    logits[1, ids.beg + 5] = logits[1, ids.beg + 50] = 40.0      # timestamp tie
    logits[2, 77] = logits[2, 900] = 30.0                          # text tie
    logits[3, ids.beg :] += 6.0                                    # timestamp mass wins
    logits[4, ids.sot] = 50.0                                      # banned token on top
    logits[5, ids.beg + 150] = 45.0                                # past the initial window
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if is_initial == "lanes":
        is_initial = np.array([True, False, True, False, True, False])
        force = np.array([False, False, True, True, False, True])

    want = jsample(jnp.asarray(probs), JIds(*ids), jnp.asarray(is_initial), jnp.asarray(force))
    got = sample_best(torch.from_numpy(probs), ids, torch.as_tensor(is_initial),
                      torch.as_tensor(force))
    np.testing.assert_array_equal(got.id.numpy(), np.asarray(want.id))
    np.testing.assert_array_equal(got.tid.numpy(), np.asarray(want.tid))
    for name in ("p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    from whisper_tpu.ggml import load_checkpoint as jload
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu.model.params import params_from_checkpoint as jparams_from
    from whisper_tpu.runtime.context import WhisperRuntime as JRuntime
    from whisper_tpu.runtime.sampler import SpecialIds as JIds
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.model.encoder import CrossKV
    from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    path = str(tmp_path_factory.mktemp("d") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=3)
    ids = _ids()
    jrt = JRuntime(jparams_from(jload(path), JPolicy.f32()), TINY_TEST_DIMS, JIds(*ids),
                   compute_dtype=jnp.float32)
    cp = load_checkpoint(path)
    trt = WhisperRuntime(params_from_checkpoint(cp, DtypePolicy.f32(), "cpu"), cp.dims, ids,
                         compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((1, 80, 2 * cp.dims.n_audio_ctx)).astype(np.float32)
    _, jcross = jrt.encode_window(mel)
    tcross = CrossKV(torch.tensor(np.asarray(jcross.k)), torch.tensor(np.asarray(jcross.v)))
    return jrt, jcross, trt, tcross


@pytest.mark.parametrize(
    "seek,seek_end,max_tokens,single,force_steps",
    [
        (0, 100_000, 0, False, 0),   # long audio: normal rules
        (0, 1_500, 0, False, 0),     # short audio: end-of-audio path
        (0, 100_000, 5, False, 0),   # max_tokens cutoff
        (0, 2_000, 0, True, 0),      # single segment
        (0, 100_000, 0, False, 9),   # bench mode: fixed step count
    ],
)
def test_window_result_matches_jax(runtimes, seek, seek_end, max_tokens, single, force_steps):
    jrt, jcross, trt, tcross = runtimes
    prompt = [trt.ids.sot]
    padded = np.zeros((1, trt.prompt_capacity), np.int32)
    padded[0, : len(prompt)] = prompt
    args = (np.full((1,), len(prompt), np.int32),)
    lim = (np.full((1,), seek, np.int32), np.full((1,), seek_end, np.int32))
    kw = dict(max_tokens=max_tokens, single_segment=single, force_steps=force_steps)
    want = jrt.run_window(padded, *args, jcross, *lim, **kw)
    got = trt.run_window(padded, *args, tcross, *lim, **kw)
    for name in ("tokens", "tid", "result_len", "seek_delta", "failed", "steps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("p", "pt", "ptsum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    if force_steps:
        assert int(got.steps) == force_steps


def test_window_batch_lanes_match_single(runtimes):
    """Two lanes with different prompt lengths decode as each would alone
    (left-aligned prompt, per-lane attn_start)."""
    _, _, trt, tcross = runtimes
    cap = trt.prompt_capacity
    prompts = [[trt.ids.sot], [trt.ids.prev, 300, 400, trt.ids.sot]]
    lim = (np.zeros(1, np.int32), np.full(1, 100_000, np.int32))
    singles = []
    for pr in prompts:
        padded = np.zeros((1, cap), np.int32)
        padded[0, : len(pr)] = pr
        singles.append(trt.run_window(padded, np.array([len(pr)], np.int32), tcross, *lim))
    padded = np.zeros((2, cap), np.int32)
    for i, pr in enumerate(prompts):
        padded[i, : len(pr)] = pr
    both_cross = type(tcross)(tcross.k.expand(-1, 2, -1, -1).contiguous(),
                              tcross.v.expand(-1, 2, -1, -1).contiguous())
    both = trt.run_window(padded, np.array([len(p) for p in prompts], np.int32), both_cross,
                          np.zeros(2, np.int32), np.full(2, 100_000, np.int32))
    for lane, one in enumerate(singles):
        n = int(one.result_len[0])
        assert int(both.result_len[lane]) == n
        assert bool(both.failed[lane]) == bool(one.failed[0])
        np.testing.assert_array_equal(both.tokens[lane, :n].numpy(), one.tokens[0, :n].numpy())
