"""The port's VAD and capture runner against the JAX package's, on the CPU.

The VAD is numpy in both packages, so its detections must be equal on the
same seeded audio, in one call and incrementally. The capture runner cuts
buffers differently when its worker thread is still busy (``STALLED``), so
a slower transcription would change the buffers, not a fault. The sources
here are paced (``chip_smoke.paced``): each chunk is handed over only once
no worker thread is alive, and both runners then see the same buffers,
whose lengths must be equal. The sources (``chip_smoke.speechy``, a loud
modulated tone, and ``noise_floor``, a quiet hum) are
tests/test_vad_capture.py's. Mirrors tests/test_vad_capture.py.
"""

import threading
import time

import numpy as np
import pytest

from chip_smoke import chunks_of, noise_floor, paced, speechy
from whisper_tpu.audio import capture as jcap
from whisper_tpu.audio.vad import VAD as JVAD
from whisper_tpu_torch.audio import capture as tcap
from whisper_tpu_torch.audio.vad import VAD
from whisper_tpu_torch.hparams import SAMPLE_RATE


@pytest.mark.parametrize("case", ["speech_after_silence", "silence_only", "speech_then_silence"])
def test_vad_detects_as_jax_does(case):
    audio = {
        "speech_after_silence": lambda: np.concatenate([noise_floor(SAMPLE_RATE), speechy(SAMPLE_RATE, 0)]),
        "silence_only": lambda: noise_floor(SAMPLE_RATE * 2),
        "speech_then_silence": lambda: np.concatenate([noise_floor(8000), speechy(16000, 0), noise_floor(8000)]),
    }[case]()
    got, want = VAD().detect(audio), JVAD().detect(audio)
    assert got == want
    if case == "speech_after_silence":
        assert got > SAMPLE_RATE       # speech detected in the second half
    if case == "silence_only":
        assert got == 0


@pytest.mark.parametrize("step", [4000, 1600, 256])
def test_vad_incremental_matches_batch_and_jax(step):
    buf = np.concatenate([noise_floor(8000), speechy(16000, 0), noise_floor(8000), speechy(8000, seed=3)])
    batch = VAD().detect(buf)
    inc, jinc = VAD(), JVAD()
    got, want = [], []
    for end in range(step, len(buf) + 1, step):
        got.append(inc.detect(buf[:end]))
        want.append(jinc.detect(buf[:end]))
    assert got == want
    assert got[-1] == batch == JVAD().detect(buf)


def _run_runner(module, audio, params_kw, delay=0.0):
    lengths, statuses = [], []

    def on_transcribe(pcm):
        time.sleep(delay)          # a transcription that takes time
        lengths.append(len(pcm))

    runner = module.CaptureRunner(on_transcribe, module.CaptureParams(**params_kw),
                                  on_status=statuses.append)
    runner.run(paced(chunks_of(audio)))
    return lengths, statuses


@pytest.mark.parametrize("delay", [0.0, 0.05])
def test_capture_buffers_match_jax(delay):
    """1 s of noise floor, then speech, a pause and speech again, in 100 ms
    chunks: the same buffers as the JAX runner's, however long each
    transcription takes."""
    audio = np.concatenate([noise_floor(SAMPLE_RATE), speechy(SAMPLE_RATE * 4, 0), noise_floor(SAMPLE_RATE),
                            speechy(SAMPLE_RATE * 2, seed=2)])
    kw = dict(min_duration=1.0, max_duration=2.0)
    got, statuses = _run_runner(tcap, audio, kw, delay)
    want, _ = _run_runner(jcap, audio, kw, delay)
    assert got == want
    assert got and sum(got) <= len(audio)
    assert any(s & tcap.CaptureStatus.VOICE for s in statuses)
    assert any(s & tcap.CaptureStatus.TRANSCRIBING for s in statuses)
    assert not any(s & tcap.CaptureStatus.STALLED for s in statuses)
    assert statuses[-1] == tcap.CaptureStatus.NONE


def test_capture_drops_leading_silence_as_jax_does():
    audio = noise_floor(SAMPLE_RATE * 3)
    kw = dict(min_duration=0.5, max_duration=1.0, drop_start_silence=0.25)
    got, _ = _run_runner(tcap, audio, kw)
    want, _ = _run_runner(jcap, audio, kw)
    assert got == want
    assert got == [] or all(c < SAMPLE_RATE for c in got)


def test_capture_stalls_while_the_worker_is_busy():
    """Unpaced, with a worker slower than the source: the runner sets
    STALLED and drops chunks, so the buffers hold less than the source
    gave."""
    audio = np.concatenate([np.concatenate([noise_floor(SAMPLE_RATE // 2, seed=i),
                                            speechy(SAMPLE_RATE * 2, seed=i)]) for i in range(4)])
    chunks = chunks_of(audio)
    lengths, statuses = [], []
    release = threading.Event()

    def on_transcribe(pcm):
        lengths.append(len(pcm))
        release.wait(timeout=30)

    def source():
        for i, chunk in enumerate(chunks):
            if i == len(chunks) - 1:
                release.set()        # the worker finishes with the last chunk
            yield chunk

    runner = tcap.CaptureRunner(on_transcribe, tcap.CaptureParams(min_duration=1.0, max_duration=2.0),
                                on_status=statuses.append)
    runner.run(source())
    assert any(s & tcap.CaptureStatus.STALLED for s in statuses)
    assert sum(lengths) < len(audio)


def test_capture_cancel_and_worker_error():
    audio = np.concatenate([noise_floor(SAMPLE_RATE), speechy(SAMPLE_RATE * 4, 0)])
    seen = []
    runner = tcap.CaptureRunner(seen.append, should_cancel=lambda: True)
    runner.run(chunks_of(audio))
    assert seen == [] and runner.status == tcap.CaptureStatus.NONE

    def fail(pcm):
        raise ValueError("transcription failed")

    runner = tcap.CaptureRunner(fail, tcap.CaptureParams(min_duration=1.0, max_duration=2.0))
    with pytest.raises(ValueError, match="transcription failed"):
        runner.run(paced(chunks_of(audio)))


def test_capture_devices_without_sounddevice():
    """sounddevice stays an optional import: without it there is no capture
    device, and the microphone source raises when first read."""
    import importlib.util

    names = tcap.list_capture_devices()
    assert isinstance(names, list) and all(isinstance(n, str) for n in names)
    if importlib.util.find_spec("sounddevice") is None:
        assert names == []
        with pytest.raises(ImportError):
            next(tcap.sounddevice_source())
