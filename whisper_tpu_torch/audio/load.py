"""Audio file decode to float32 PCM @ 16 kHz.

Counterpart of ``whisper_tpu.audio.load`` for WAV files (scipy), plus the
SpeedupAudio 2x compression and the chunked reader of streamed input
(``ChunkedReader``). Compressed formats (the JAX package's native
libavformat and ffmpeg paths) are not ported yet and raise.
"""

from __future__ import annotations

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


def load_audio_file(path: str, want_stereo: bool = False) -> AudioBuffer:
    """Decode a WAV file to 16 kHz float32."""
    try:
        data, rate = _load_wav(path)
    except ValueError as e:
        raise NotImplementedError(
            f"cannot read {path!r} as WAV ({e}); other formats are not ported to "
            "whisper_tpu_torch yet"
        ) from e

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
