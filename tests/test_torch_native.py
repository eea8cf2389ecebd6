"""The port's native host library and compressed-audio paths against the
JAX package's.

tests/test_native.py's three checks, on the port's library (built with g++
at first use) and on its NumPy versions (the library taken away), against
the JAX package's NumPy path and its LogMelSpectrogram: fp16 exactly,
energy within 1e-4, mel within 2e-3. Then load_audio_file's chain (WAV,
the native decoder, an ffmpeg binary) in both packages: the same error
when nothing can decode a file, the same arrays from an ffmpeg on the
PATH, and, where the FFmpeg headers let the decoder build, its output
against scipy's read and the PCM an AU file holds.
"""

import os
import shutil
import struct
import sys

import numpy as np
import pytest


@pytest.fixture(params=["library", "numpy"])
def native(request, monkeypatch):
    """The port's native module, with its library, or without (its NumPy
    versions)."""
    from whisper_tpu_torch import native

    if request.param == "library":
        if shutil.which("g++") is None:
            pytest.skip("g++ is not installed: the native library cannot be built")
        assert native.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert not native.available()
    return native


def test_fp16_conversion(native):
    from whisper_tpu import native as jnative

    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_000).astype(np.float16)
    got = native.fp16_to_f32(x)
    np.testing.assert_array_equal(got, x.astype(np.float32))
    np.testing.assert_array_equal(got, jnative.fp16_to_f32(x))
    sp = np.array([0.0, -0.0, np.inf, -np.inf, 65504, 6e-8], np.float16)
    np.testing.assert_array_equal(native.fp16_to_f32(sp), sp.astype(np.float32))


def test_signal_energy_matches_python(native):
    from whisper_tpu.api.timestamps import compute_signal_energy

    rng = np.random.default_rng(1)
    pcm = rng.standard_normal(50_000).astype(np.float32)
    got = native.signal_energy(pcm, 32)
    assert np.max(np.abs(got - compute_signal_energy(pcm, 32))) < 1e-4


@pytest.mark.parametrize("mode", ["openai", "reference"])
def test_log_mel_matches_device(native, mode):
    """Against the JAX package's LogMelSpectrogram and its NumPy path."""
    from whisper_tpu import native as jnative
    from whisper_tpu.features import LogMelSpectrogram, mel_filter_bank

    rng = np.random.default_rng(2)
    pcm = (0.3 * rng.standard_normal(16_000 * 3)).astype(np.float32)
    filters = mel_filter_bank()
    dev = np.asarray(LogMelSpectrogram(filters, mode=mode)(pcm, normalize=False))
    host = native.log_mel_raw(pcm, filters, mode=mode)
    assert host.shape == dev.shape
    assert np.max(np.abs(host - dev)) < 2e-3
    assert np.max(np.abs(host - jnative.log_mel_raw(pcm, filters, mode=mode))) < 2e-3


def test_log_mel_of_a_clip_shorter_than_a_hop(native):
    filters = np.ones((80, 201), np.float32)
    assert native.log_mel_raw(np.zeros(100, np.float32), filters).shape == (80, 0)


def _no_decoder(monkeypatch, tmp_path):
    """Neither package has its native decoder; the PATH has no ffmpeg."""
    from whisper_tpu.audio import ffdecode as jff
    from whisper_tpu_torch.audio import ffdecode

    monkeypatch.setattr(ffdecode, "_load", lambda: None)
    monkeypatch.setattr(jff, "_load", lambda: None)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))


def test_non_wav_without_a_decoder_raises_as_jax_does(monkeypatch, tmp_path):
    from whisper_tpu.audio.load import load_audio_file as jload
    from whisper_tpu_torch.audio.load import load_audio_file

    clip = tmp_path / "clip.mp3"
    clip.write_bytes(b"not audio at all")
    _no_decoder(monkeypatch, tmp_path)
    errors = []
    for load in (jload, load_audio_file):
        with pytest.raises(RuntimeError) as e:
            load(str(clip))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"cannot decode {str(clip)!r}: not a WAV file and ffmpeg is unavailable"


FAKE_FFMPEG = """#!{python}
# Stands in for ffmpeg: writes a seeded f32le signal with the channel count
# after -ac, 16 kHz, to stdout, whatever the input.
import sys
import numpy as np
ch = int(sys.argv[sys.argv.index("-ac") + 1])
x = np.random.default_rng(7).standard_normal(4_000 * ch).astype(np.float32) * 0.25
sys.stdout.buffer.write(x.astype("<f4").tobytes())
"""


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_ffmpeg_binary_path_matches_jax(monkeypatch, tmp_path, stereo):
    """A fake ffmpeg on the PATH: both packages' load_audio_file give the
    same arrays (mono, and the stereo pair for diarization)."""
    from whisper_tpu.audio.load import load_audio_file as jload
    from whisper_tpu_torch.audio.load import load_audio_file

    clip = tmp_path / "clip.ogg"
    clip.write_bytes(b"not audio at all")
    _no_decoder(monkeypatch, tmp_path)
    fake = tmp_path / "bin" / "ffmpeg"
    fake.write_text(FAKE_FFMPEG.format(python=sys.executable))
    fake.chmod(0o755)
    want = jload(str(clip), want_stereo=stereo)
    got = load_audio_file(str(clip), want_stereo=stereo)
    assert got.mono.shape == (4_000,) and got.mono.dtype == np.float32
    np.testing.assert_array_equal(got.mono, want.mono)
    if stereo:
        assert got.stereo.shape == (2, 4_000)
        np.testing.assert_array_equal(got.stereo, want.stereo)
    else:
        assert got.stereo is None and want.stereo is None


def _need_decoder():
    from whisper_tpu_torch.audio import ffdecode

    if not ffdecode.available():
        pytest.skip("the FFmpeg headers are not installed: libwhisper_audio.so cannot be built")
    return ffdecode


@pytest.mark.parametrize("channels", [1, 2])
def test_native_decoder_reads_a_wav_as_scipy_does(tmp_path, channels):
    from scipy.io import wavfile

    ffdecode = _need_decoder()
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal((16_000, channels)) * 6_000).astype(np.int16)
    path = str(tmp_path / "clip.wav")
    wavfile.write(path, 16_000, pcm if channels == 2 else pcm[:, 0])
    _, want = wavfile.read(path)
    got = ffdecode.decode_file(path, 16_000, channels)
    np.testing.assert_array_equal(got, want.astype(np.float32) / 32768.0)


def test_load_audio_file_decodes_a_non_wav_file_natively(tmp_path):
    """An AU file (big-endian 16-bit PCM), which scipy cannot read, through
    load_audio_file's native path: its samples exactly."""
    _need_decoder()
    from whisper_tpu_torch.audio.load import load_audio_file

    pcm = (np.random.default_rng(4).standard_normal(8_000) * 6_000).astype(np.int16)
    path = tmp_path / "clip.au"
    # .snd header: offset 24, size, encoding 3 (16-bit linear), 16 kHz, mono
    path.write_bytes(struct.pack(">4s5I", b".snd", 24, pcm.nbytes, 3, 16_000, 1)
                     + pcm.astype(">i2").tobytes())
    got = load_audio_file(str(path))
    np.testing.assert_array_equal(got.mono, pcm.astype(np.float32) / 32768.0)


def test_library_files_carry_their_source_hash():
    """Two builds of one source and flags share a file; the decoder and the
    host runtime do not."""
    from whisper_tpu_torch import native

    a, b = native.library_path("whisper_native"), native.library_path("audio_decode")
    assert a == native.library_path("whisper_native") and a != b
    assert a.parent == b.parent and a.parent.name == "whisper_tpu_torch"
    assert os.path.basename(a).startswith("libwhisper_native-")
