"""Real-time capture loop: VAD segmentation + background transcription.

A copy of ``whisper_tpu.audio.capture``; ``on_transcribe`` runs on a worker
thread, so on the card the transcription's kernels launch from that thread
(on its current stream, the device's default one).

Behavioral port of the reference capture state machine
(ContextImpl.capture.cpp:212-288): grow a PCM buffer from a source, run
incremental VAD, and on segmentation boundaries hand the buffer to a
transcription worker thread; when the worker can't keep up past maxDuration,
set Stalled and drop samples.

The audio source is any iterable of float32 mono chunks @ 16 kHz — a real
microphone (``sounddevice_source`` when the optional sounddevice module
exists), a file reader, or a test generator. Parameters mirror
sCaptureParams (MfStructs.h:25-33) in seconds.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from whisper_tpu_torch.audio.vad import VAD
from whisper_tpu_torch.hparams import SAMPLE_RATE


class CaptureStatus(enum.IntFlag):
    NONE = 0
    LISTENING = 1
    VOICE = 2
    TRANSCRIBING = 4
    STALLED = 0x80


@dataclasses.dataclass
class CaptureParams:
    min_duration: float = 2.0
    max_duration: float = 3.0
    drop_start_silence: float = 0.25
    pause_duration: float = 0.333


class CaptureRunner:
    """run_capture engine. ``on_transcribe(pcm)`` is called on a worker
    thread with each segmented buffer (typically ctx.run_full + user
    callbacks); ``on_status`` observes flag changes."""

    def __init__(
        self,
        on_transcribe: Callable[[np.ndarray], None],
        params: CaptureParams = CaptureParams(),
        on_status: Optional[Callable[[CaptureStatus], None]] = None,
        should_cancel: Optional[Callable[[], bool]] = None,
    ):
        self.params = params
        self.on_transcribe = on_transcribe
        self.on_status = on_status
        self.should_cancel = should_cancel or (lambda: False)
        self.status = CaptureStatus.NONE
        self.vad = VAD()
        self._pcm = np.zeros(0, np.float32)
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None

    # ------------------------------------------------------------------

    def _set(self, flag: CaptureStatus, on: bool) -> None:
        new = (self.status | flag) if on else (self.status & ~flag)
        if new != self.status:
            self.status = new
            if self.on_status:
                self.on_status(new)

    def _worker_busy(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def _post_work(self) -> None:
        if self._worker_error:
            raise self._worker_error
        buf, self._pcm = self._pcm, np.zeros(0, np.float32)
        self.vad.clear()

        def job():
            self._set(CaptureStatus.TRANSCRIBING, True)
            try:
                self.on_transcribe(buf)
            except BaseException as e:  # propagate to the capture loop
                self._worker_error = e
            finally:
                self._set(CaptureStatus.TRANSCRIBING, False)

        self._worker = threading.Thread(target=job, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------

    def run(self, source: Iterable[np.ndarray]) -> None:
        """Consume the source until exhausted or cancelled."""
        p = self.params
        s = SAMPLE_RATE
        self._set(CaptureStatus.LISTENING, True)
        try:
            for chunk in source:
                if self.should_cancel():
                    break
                if self._worker_error:
                    raise self._worker_error

                if self.status & CaptureStatus.STALLED:
                    if self._worker_busy():
                        continue  # still stalled: drop this sample
                    self._set(CaptureStatus.STALLED, False)
                    self._post_work()
                    continue

                old = len(self._pcm)
                self._pcm = np.concatenate([self._pcm, np.asarray(chunk, np.float32)])
                new = len(self._pcm)

                last_voice = self.vad.detect(self._pcm)
                if last_voice == 0:
                    self._set(CaptureStatus.VOICE, False)
                    if new < p.drop_start_silence * s:
                        continue
                    self._pcm = np.zeros(0, np.float32)
                    self.vad.clear()
                    continue

                recent_voice = last_voice + p.pause_duration * s >= old
                if recent_voice:
                    self._set(CaptureStatus.VOICE, True)
                    if new < p.max_duration * s:
                        continue
                else:
                    self._set(CaptureStatus.VOICE, False)
                    if new < p.min_duration * s:
                        continue

                if not self._worker_busy():
                    self._post_work()
                    continue
                if new < p.max_duration * s:
                    continue
                self._set(CaptureStatus.STALLED, True)

            # flush the tail
            if len(self._pcm) and not self._worker_error:
                if self._worker_busy():
                    self._worker.join()
                self._post_work()
            if self._worker_busy():
                self._worker.join()
            if self._worker_error:
                raise self._worker_error
        finally:
            self._set(CaptureStatus.LISTENING, False)


def sounddevice_source(device=None, chunk_ms: int = 100):
    """Microphone source via the optional sounddevice package (the WASAPI
    capture analogue, Whisper/MF/AudioCapture.cpp). Raises if unavailable."""
    import queue

    import sounddevice as sd  # optional dependency

    q: "queue.Queue[np.ndarray]" = queue.Queue()

    def cb(indata, frames, t, status):
        q.put(indata[:, 0].copy())

    stream = sd.InputStream(
        samplerate=SAMPLE_RATE, channels=1, dtype="float32",
        blocksize=SAMPLE_RATE * chunk_ms // 1000, device=device, callback=cb,
    )
    stream.start()
    try:
        while True:
            yield q.get()
    finally:
        stream.stop()


def list_capture_devices() -> list[str]:
    """listCaptureDevices analogue; empty when sounddevice is absent."""
    try:
        import sounddevice as sd
    except Exception:
        return []
    return [d["name"] for d in sd.query_devices() if d.get("max_input_channels", 0) > 0]
