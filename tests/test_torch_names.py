"""The public names the port keeps from the JAX package, each against the
JAX package's on the same inputs, on the CPU: ``decode_attention``,
``load_params``, ``Model.clone``, ``log_mel_spectrogram``,
``features.filters`` and the packages' re-exports.

Tolerances: 1e-5 for the kernel wrapper (f32; only the summation order
differs), 1e-4 for normalised log-mel (tests/test_torch_mel.py says why),
parameters and filters exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint


def _decode_inputs():
    rng = np.random.default_rng(5)
    B, H, Dh, S = 2, 4, 64, 150
    q = rng.standard_normal((B, H, Dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, S, H, Dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    kt = np.ascontiguousarray(k.transpose(0, 2, 3, 1))
    vt = np.ascontiguousarray(v.transpose(0, 2, 3, 1))
    return q, k, v, kt, vt


def _einsum_ref(q, k, v, valid=None):
    s = np.einsum("bhd,bshd->bhs", q, k)
    if valid is not None:
        for b in range(q.shape[0]):
            s[b, :, valid[b]:] = -np.inf
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhs,bshd->bhd", p, v)


@pytest.mark.parametrize("valid", [None, [37, 150]], ids=["whole", "valid_len"])
def test_decode_attention_matches_jax_and_einsum(valid):
    """Mirrors tests/test_kernels.py:85-116 through the port's [B, H, Dh]
    wrapper (its plain version on CPU tensors; no launch counted)."""
    from whisper_tpu.kernels.decode_attention import decode_attention as jax_dec
    from whisper_tpu_torch.kernels.decode_attention import decode_attention, decode_attention_hd

    q, k, v, kt, vt = _decode_inputs()
    vl = None if valid is None else np.array(valid, np.int32)
    want = np.asarray(jax_dec(jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
                              None if vl is None else jnp.asarray(vl), interpret=True))
    before = decode_attention_hd.launches
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(vt),
                           None if vl is None else torch.from_numpy(vl))
    assert decode_attention_hd.launches == before
    assert got.shape == (2, 4, 64) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) < 1e-5
    assert np.max(np.abs(got.numpy() - _einsum_ref(q, k, v, vl))) < 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("names") / "tiny.bin")
    make_random_checkpoint(path, TINY_TEST_DIMS, seed=11)
    return path


def test_load_params_matches_jax(ckpt):
    """The same dims, and every parameter leaf equal to the JAX package's in
    f32 (tests/test_torch_model.py's leaf mapping)."""
    from tests.test_torch_model import _leaves
    from whisper_tpu.model import load_params as jax_load_params
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.model import DtypePolicy, load_params

    jdims, jparams, jcp = jax_load_params(ckpt, JPolicy.f32())
    dims, params, cp = load_params(ckpt, DtypePolicy.f32(), device="cpu")
    assert (dims.n_audio_state, dims.n_text_layer, dims.n_vocab) == \
        (jdims.n_audio_state, jdims.n_text_layer, jdims.n_vocab)
    assert cp.vocab_words == jcp.vocab_words
    jflat = {tuple(p.key for p in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = _leaves(params)
    assert set(jflat) == set(tflat)
    for key, want in jflat.items():
        np.testing.assert_array_equal(tflat[key].numpy(), want, err_msg=str(key))


def test_load_params_defaults_to_the_card(ckpt):
    from whisper_tpu_torch.model.params import load_params

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        load_params(ckpt)


def test_model_clone_shares_weights(ckpt):
    """A clone is another Model over the same tensors (nothing copied) and
    transcribes as the original does."""
    from whisper_tpu_torch.api.model import Model

    model = Model(ckpt, device="cpu")
    clone = model.clone()
    assert clone is not model and clone.runtime is model.runtime
    for (n, a), (_, b) in zip(model.runtime.params.named_buffers(), clone.runtime.params.named_buffers()):
        assert a.data_ptr() == b.data_ptr(), n
    audio = (0.1 * np.random.default_rng(0).standard_normal(16_000 * 2)).astype(np.float32)
    segs = [[(s.text, s.t0, s.t1) for s in m.create_context().run_full(None, audio).segments]
            for m in (model, clone)]
    assert segs[0] == segs[1]


@pytest.mark.parametrize("mode", ["openai", "reference"])
def test_log_mel_spectrogram_matches_jax(mode):
    from whisper_tpu.features import log_mel_spectrogram as jax_lms
    from whisper_tpu_torch.features import log_mel_spectrogram, mel_filter_bank

    rng = np.random.default_rng(3)
    t = np.arange(16_000 * 3 + 50) / 16_000
    audio = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    filters = mel_filter_bank(80)
    for normalize in (True, False):
        want = np.asarray(jax_lms(audio, filters, mode=mode, normalize=normalize))
        got = log_mel_spectrogram(audio, filters, mode=mode, normalize=normalize, device="cpu")
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want)) < 1e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filters_module_is_the_jax_filterbank(n_mels):
    from whisper_tpu.features import filters as jf
    from whisper_tpu_torch import ggml
    from whisper_tpu_torch.features import filters as tf

    np.testing.assert_array_equal(tf.mel_filter_bank(n_mels), jf.mel_filter_bank(n_mels))
    hz = np.array([0.0, 440.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(tf.hz_to_mel(hz), jf.hz_to_mel(hz))
    np.testing.assert_array_equal(tf.mel_to_hz(tf.hz_to_mel(hz)), jf.mel_to_hz(jf.hz_to_mel(hz)))
    assert tf.mel_filter_bank is ggml.mel_filter_bank      # one copy of the code


@pytest.mark.parametrize("pkg", ["features", "audio", "model", "kernels", "parallel"])
def test_package_reexports_match_jax(pkg):
    """Every name the JAX package's subpackage exports, the port's exports
    too, from the module of the same name."""
    jmod = importlib.import_module(f"whisper_tpu.{pkg}")
    tmod = importlib.import_module(f"whisper_tpu_torch.{pkg}")
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in jmod.__all__:
        obj = getattr(tmod, name)
        src = getattr(jmod, name).__module__.replace("whisper_tpu.", "whisper_tpu_torch.", 1)
        if pkg == "features" and name == "mel_filter_bank":
            src = "whisper_tpu_torch.ggml"             # the one copy, re-exported
        assert obj.__module__ == src, (name, obj.__module__)
    with pytest.raises(AttributeError):
        getattr(tmod, "no_such_name")
