"""Stereo-energy speaker detection (ContextImpl.diarize.cpp:17-108).

Per-channel sum of |pcm| over the interval; a channel 1.1x louder than the
other wins, otherwise Unsure.

A copy of ``whisper_tpu.api.diarize`` (numpy only), on the port's own
``Speaker`` and ``SAMPLE_RATE``.
"""

from __future__ import annotations

import numpy as np

from whisper_tpu_torch.api.result import Speaker
from whisper_tpu_torch.hparams import SAMPLE_RATE


def detect_speaker(stereo: np.ndarray, t0_cs: int, t1_cs: int) -> Speaker:
    """stereo: [2, N] float32; t0/t1 in centiseconds."""
    if stereo is None or stereo.ndim != 2 or stereo.shape[0] != 2:
        return Speaker.NO_STEREO_DATA
    n = stereo.shape[1]
    s0 = max(0, min(n, t0_cs * SAMPLE_RATE // 100))
    s1 = max(0, min(n, t1_cs * SAMPLE_RATE // 100))
    if s1 <= s0:
        return Speaker.UNSURE
    e = np.sum(np.abs(stereo[:, s0:s1]), axis=1)
    if e[0] > 1.1 * e[1]:
        return Speaker.LEFT
    if e[1] > 1.1 * e[0]:
        return Speaker.RIGHT
    return Speaker.UNSURE
