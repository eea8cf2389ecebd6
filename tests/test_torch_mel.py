"""The port's log-mel front-end against the JAX package's, on synthetic
audio, in all three framing modes.

Tolerance 1e-4 on normalized log-mel. The port takes the DFT products and
the power spectrum in float64 and the filterbank in f32; JAX computes all
of it in f32 at Precision.HIGHEST, which is off from a float64 DFT by up
to 1.8e-5 after normalisation in mel bins some 60 dB below the test tone,
where the DFT's cancellation is worst. An f32 DFT summed in PyTorch's CPU
order was off by 2.2e-4 there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

TOL = 1e-4


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(42)
    t = np.arange(16_000 * 7 + 123) / 16_000.0
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)
    return sig.astype(np.float32)


@pytest.mark.parametrize("mode", ["openai", "reference", "causal"])
def test_log_mel_matches_jax(audio, mode):
    from whisper_tpu.features.mel import LogMelSpectrogram as JMel
    from whisper_tpu_torch.ggml import mel_filter_bank
    from whisper_tpu_torch.features.mel import LogMelSpectrogram

    filters = mel_filter_bank(80)
    want = np.asarray(JMel(filters, mode=mode)(audio))
    got = LogMelSpectrogram(filters, mode=mode, device="cpu")(audio)
    assert got.dtype == torch.float32 and got.shape == want.shape == (80, len(audio) // 160)
    assert np.max(np.abs(got.numpy() - want)) < TOL


def test_normalization_masking_matches_jax():
    from whisper_tpu.features.mel import normalize_log_mel as jnorm
    from whisper_tpu_torch.features.mel import normalize_log_mel

    lm = np.zeros((4, 10), np.float32)
    lm[:, :5] = -2.0
    lm[0, 0] = -11.0
    want = np.asarray(jnorm(jnp.asarray(lm), valid_frames=5))
    got = normalize_log_mel(torch.from_numpy(lm), valid_frames=5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 5:] == 0).all() and (got[:, :5] != 0).all()


def test_unknown_mode_raises():
    from whisper_tpu_torch.ggml import mel_filter_bank
    from whisper_tpu_torch.features.mel import LogMelSpectrogram

    with pytest.raises(ValueError, match="mode"):
        LogMelSpectrogram(mel_filter_bank(80), mode="stft", device="cpu")
