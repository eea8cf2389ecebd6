"""The port's streamed input: ``MelStreamer`` and ``Context.run_streamed``.

The streamer on irregular chunks must reproduce the port's own batch mel
bit for bit in every framing mode (tests/test_mel.py:69-104 asks the same
of the JAX package): both frame the same samples, take the DFT in f64 and
normalise in f32, and on the CPU the products give the same bits whatever
the number of frames in a call. Against the JAX streamer it agrees within
the mel tolerance of tests/test_torch_mel.py (1e-4). ``run_streamed`` over
``ChunkedReader`` gives the segments ``run_full`` gives.
"""

import numpy as np
import pytest

from tests.helpers import MULTILINGUAL_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint

TOL = 1e-4
SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(42)
    t = np.arange(16_000 * 7 + 123) / 16_000.0
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)
    return sig.astype(np.float32)


def _stream(streamer, sig, seed=7):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(sig):
        n = int(rng.integers(37, 5000))
        streamer.append(sig[i : i + n])
        i += n
    return streamer.finalize()


@pytest.mark.parametrize("mode", ["openai", "reference", "causal"])
def test_streaming_matches_batch(audio, mode):
    from whisper_tpu_torch.features.mel import LogMelSpectrogram
    from whisper_tpu_torch.features.stream import MelStreamer
    from whisper_tpu_torch.ggml import mel_filter_bank

    filters = mel_filter_bank(80)
    for sig in (audio, audio[: 16_000 * 3 + 77]):
        expect = LogMelSpectrogram(filters, mode=mode, device="cpu")(sig).numpy()
        got = _stream(MelStreamer(LogMelSpectrogram(filters, mode=mode, device="cpu")), sig)
        assert got.shape == expect.shape
        np.testing.assert_array_equal(got, expect)


def test_streaming_tiny_stream():
    from whisper_tpu_torch.features.mel import LogMelSpectrogram
    from whisper_tpu_torch.features.stream import MelStreamer
    from whisper_tpu_torch.ggml import mel_filter_bank

    streamer = MelStreamer(LogMelSpectrogram(mel_filter_bank(80), mode="openai", device="cpu"))
    streamer.append(np.random.default_rng(3).standard_normal(190).astype(np.float32) * 0.1)
    mel = streamer.finalize()
    assert mel.shape == (80, 190 // 160) and np.isfinite(mel).all()


@pytest.mark.parametrize("mode", ["openai", "reference"])
def test_streamer_matches_jax_streamer(audio, mode):
    """Windows and the final mel against the JAX streamer, fed the same chunks."""
    from whisper_tpu.features.mel import LogMelSpectrogram as JMel
    from whisper_tpu.features.stream import MelStreamer as JStreamer
    from whisper_tpu_torch.features.mel import LogMelSpectrogram
    from whisper_tpu_torch.features.stream import MelStreamer
    from whisper_tpu_torch.ggml import mel_filter_bank

    filters = mel_filter_bank(80)
    got_s = MelStreamer(LogMelSpectrogram(filters, mode=mode, device="cpu"))
    want_s = JStreamer(JMel(filters, mode=mode))
    rng = np.random.default_rng(11)
    i = 0
    while i < len(audio):
        n = int(rng.integers(37, 5000))
        got_s.append(audio[i : i + n])
        want_s.append(audio[i : i + n])
        i += n
        assert got_s.n_frames == want_s.n_frames
        if got_s.n_frames >= 250:
            assert np.max(np.abs(got_s.window(50, 300) - want_s.window(50, 300))) < TOL
    got, want = got_s.finalize(), want_s.finalize()
    assert got.shape == want.shape and np.max(np.abs(got - want)) < TOL


def test_chunked_reader_matches_jax():
    from whisper_tpu.audio.load import ChunkedReader as JReader
    from whisper_tpu_torch.audio.load import ChunkedReader

    pcm = np.random.default_rng(0).standard_normal(1_234).astype(np.float32)
    got, want = list(ChunkedReader(pcm)), list(JReader(pcm))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ml_models(tmp_path_factory):
    """The multilingual f32 model (seed 50) of the JAX package's feature
    tests, in both packages."""
    from whisper_tpu.api.model import Model as JModel
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.model.params import DtypePolicy

    path = str(tmp_path_factory.mktemp("ml") / "ml.bin")
    make_random_checkpoint(path, MULTILINGUAL_TEST_DIMS, seed=50)
    return JModel(path, policy=JPolicy.f32()), Model(path, policy=DtypePolicy.f32(), device="cpu")


def _segments(result):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in result.segments]


def test_run_streamed_matches_jax_and_run_full(ml_models):
    """The JAX package's streamed-run test (ChunkedReader over 4 s of noise)
    for the port, held to JAX's segments and to the port's run_full."""
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu.audio.load import ChunkedReader as JReader
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.audio.load import ChunkedReader

    jmodel, tmodel = ml_models
    rng = np.random.default_rng(3)
    audio = (0.05 * rng.standard_normal(16_000 * 4)).astype(np.float32)
    got = tmodel.create_context().run_streamed(FullParams(language="en"), ChunkedReader(audio))
    want = jmodel.create_context().run_streamed(JParams(language="en"), JReader(audio))
    full = tmodel.create_context().run_full(FullParams(language="en"), audio)
    assert _segments(got) == _segments(want) == _segments(full)


@pytest.mark.parametrize("flags", ["", "SPEEDUP_AUDIO"])
def test_run_streamed_scripted_matches_run_full(tmp_path, flags):
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import Flags, FullParams
    from whisper_tpu_torch.audio.load import ChunkedReader
    from whisper_tpu_torch.model.params import DtypePolicy

    path = str(tmp_path / "scripted.bin")
    make_scripted_checkpoint(path, SCRIPT)
    model = Model(path, policy=DtypePolicy.f32(), device="cpu")
    rng = np.random.default_rng(5)
    audio = (0.1 * rng.standard_normal(int(16_000 * (4.6 if flags else 2.3)))).astype(np.float32)
    params = FullParams(language="en", flags=Flags[flags] if flags else Flags.NONE)
    got = model.create_context().run_streamed(params, ChunkedReader(audio))
    want = model.create_context().run_full(params, audio)
    assert _segments(got) == _segments(want) == [(" hi", 0, 192 * (2 if flags else 1), SCRIPT[:5])]
