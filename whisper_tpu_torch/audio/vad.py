"""Voice activity detection — Moattar & Homayounpour algorithm.

A copy of ``whisper_tpu.audio.vad`` (numpy only, so the port's detections
are the JAX package's on the same samples). Behavioral port of the reference's incremental VAD
(Whisper/Whisper/voiceActivityDetection.cpp:9-205; constants
voiceActivityDetection.h:51-52): 256-sample frames, three features per frame
(RMS energy in int16 scale, dominant frequency, spectral flatness), adaptive
minima with silence-run energy update. ``detect`` is incremental — it
consumes only frames added since the previous call and carries state, so the
capture loop can poll it on a growing buffer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from whisper_tpu_torch.hparams import SAMPLE_RATE

FFT_POINTS = 256
FFT_STEP_HZ = SAMPLE_RATE / FFT_POINTS
_INT16 = 32768.0


@dataclasses.dataclass
class _Feature:
    energy: float = 0.0
    f: float = 0.0
    sfm: float = 0.0


class VAD:
    # primary thresholds (defaultPrimaryThresholds, vad.cpp:9-16)
    PRIM_ENERGY = 40.0
    PRIM_F = 185.0
    PRIM_SFM = 5.0

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self._min = _Feature()
        self._last_speech = 0
        self._silence_run = 0.0
        self._i = 0

    def detect(self, samples: np.ndarray) -> int:
        """Feed the WHOLE buffer so far; returns 0 (no speech) or the sample
        index just past the last detected speech frame."""
        frames = len(samples) // FFT_POINTS
        if frames <= 0:
            self.clear()
            return 0

        i = self._i
        while i < frames:
            frame = samples[i * FFT_POINTS : (i + 1) * FFT_POINTS].astype(np.float64) * _INT16
            spectrum = np.fft.fft(frame)

            energy = float(np.sqrt(np.mean(frame * frame)))
            half = np.abs(spectrum[: FFT_POINTS // 2])
            f_dom = float(np.argmax(half * half)) * FFT_STEP_HZ
            mag = np.abs(spectrum)
            mag = np.maximum(mag, 1e-20)
            sfm = -10.0 * np.log10(
                np.exp(np.mean(np.log(mag))) / max(np.mean(mag), 1e-20)
            )

            if i == 0:
                self._min = _Feature(energy, f_dom, sfm)
            elif i < 30:
                self._min.energy = min(self._min.energy, energy)
                self._min.f = min(self._min.f, f_dom)
                self._min.sfm = min(self._min.sfm, sfm)

            thresh_energy = self.PRIM_ENERGY * np.log10(max(self._min.energy, 1e-10))

            counter = 0
            if energy - self._min.energy >= thresh_energy:
                counter += 1
            if f_dom - self._min.f >= self.PRIM_F:
                counter += 1
            if sfm - self._min.sfm >= self.PRIM_SFM:
                counter += 1

            if counter > 1:
                self._last_speech = (i + 1) * FFT_POINTS
                self._silence_run = 0.0
            else:
                self._silence_run += 1.0
                self._min.energy = (
                    self._silence_run * self._min.energy + energy
                ) / (self._silence_run + 1.0)
            i += 1

        self._i = i
        return self._last_speech
