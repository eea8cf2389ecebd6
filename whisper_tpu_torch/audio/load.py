"""Audio file decode to float32 PCM @ 16 kHz.

Counterpart of ``whisper_tpu.audio.load``: WAV files through scipy, any
other format through the native libavformat decoder (``audio/ffdecode.py``,
where it is built) or else an ``ffmpeg`` binary on the PATH; plus the
SpeedupAudio 2x compression and the chunked reader of streamed input
(``ChunkedReader``).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import NamedTuple, Optional

import numpy as np

from whisper_tpu_torch.hparams import SAMPLE_RATE


class AudioBuffer(NamedTuple):
    """iAudioBuffer analogue: mono PCM + optional stereo pair."""

    mono: np.ndarray              # [N] float32 @ 16 kHz
    stereo: Optional[np.ndarray]  # [2, N] float32 or None

    @property
    def duration_s(self) -> float:
        return len(self.mono) / SAMPLE_RATE


def resample_to_16k(pcm: np.ndarray, rate: int) -> np.ndarray:
    if rate == SAMPLE_RATE:
        return pcm.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(rate, SAMPLE_RATE)
    return resample_poly(pcm, SAMPLE_RATE // g, rate // g, axis=-1).astype(np.float32)


def speedup_2x(pcm: np.ndarray) -> np.ndarray:
    """Time-compress audio 2x for the SpeedupAudio flag: a 2-tap boxcar
    lowpass + decimate (time-domain analogue of the reference CPU path's
    bin-pair averaging, whisper.cpp:2130-2135)."""
    pcm = np.asarray(pcm, np.float32)
    n = pcm.shape[-1] // 2 * 2
    return 0.5 * (pcm[..., 0:n:2] + pcm[..., 1:n:2])


def _load_wav(path: str) -> tuple[np.ndarray, int]:
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, rate


def _load_via_ffmpeg(path: str, stereo: bool) -> tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError(
            f"cannot decode {path!r}: not a WAV file and ffmpeg is unavailable"
        )
    channels = "2" if stereo else "1"
    out = subprocess.run(
        [
            ffmpeg, "-nostdin", "-i", path, "-f", "f32le", "-ac", channels,
            "-ar", str(SAMPLE_RATE), "-",
        ],
        capture_output=True,
        check=True,
    ).stdout
    data = np.frombuffer(out, np.float32)
    if stereo:
        data = data.reshape(-1, 2)
    return data, SAMPLE_RATE


def _load_via_native(path: str, stereo: bool) -> tuple[np.ndarray, int]:
    """Native libavformat decoder (native/audio_decode.cpp); raises when the
    library is unavailable so the caller can try the ffmpeg binary."""
    from whisper_tpu_torch.audio import ffdecode

    data = ffdecode.decode_file(path, SAMPLE_RATE, 2 if stereo else 1)
    if data is None:
        raise RuntimeError("libwhisper_audio.so not built")
    return data, SAMPLE_RATE


def load_audio_file(path: str, want_stereo: bool = False) -> AudioBuffer:
    """Decode any supported file to 16 kHz float32: WAV, else the native
    decoder, else the ffmpeg binary; when none can read it, the ffmpeg
    path's error."""
    try:
        data, rate = _load_wav(path)
    except Exception:
        try:
            data, rate = _load_via_native(path, want_stereo)
        except Exception:
            data, rate = _load_via_ffmpeg(path, want_stereo)

    if data.ndim == 2:  # [N, C]
        stereo = None
        if want_stereo and data.shape[1] >= 2:
            stereo = resample_to_16k(data[:, :2].T, rate)
        mono = resample_to_16k(data.mean(axis=1), rate)
        return AudioBuffer(mono, stereo)
    return AudioBuffer(resample_to_16k(data, rate), None)


class ChunkedReader:
    """Streaming PCM source (PcmReader analogue, Whisper/MF/PcmReader.h:27-66):
    yields fixed 10 ms chunks, zero-padding the tail."""

    def __init__(self, mono: np.ndarray, chunk: int = SAMPLE_RATE // 100):
        self.mono = mono
        self.chunk = chunk

    def __iter__(self):
        n = len(self.mono)
        for i in range(0, n, self.chunk):
            c = self.mono[i : i + self.chunk]
            if len(c) < self.chunk:
                c = np.pad(c, (0, self.chunk - len(c)))
            yield c
