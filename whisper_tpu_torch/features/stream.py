"""Streaming mel front-end (MelStreamer analogue).

Counterpart of ``whisper_tpu.features.stream`` (the reference MelStreamer,
Whisper/Whisper/MelStreamer.h:15-104, MelStreamer.cpp:125-180): PCM chunks
are framed causally in batches of hops on the model's device, raw log10-mel
comes back to the host (``.cpu().numpy()``) and accumulates there, and a
window is normalized against the running max only when it is sliced.
"""

from __future__ import annotations

import numpy as np

from whisper_tpu_torch.features.mel import LogMelSpectrogram
from whisper_tpu_torch.hparams import HOP_LENGTH, N_FFT


class MelStreamer:
    """Append PCM chunks; read normalized mel windows as they become ready.

    Honors the engine's framing mode: "reference" streams causally like the
    reference MelStreamer; "openai" reproduces centered reflect-padded
    framing incrementally (a 200-sample reflected prefix is injected once
    enough PCM arrives, tail reflection at flush) so streamed mel matches
    the batch front-end.

    Exception: streams shorter than n_fft//2 + 1 samples (~12.5 ms) can't
    supply a full reflection, so flush() uses a truncated reflection
    (k = min(pad, len-1)) — graceful degradation, not a parity target: the
    batch openai path would raise on such inputs (reflect pad > len-1)."""

    def __init__(self, mel: LogMelSpectrogram, batch_hops: int = 100):
        self.out_mode = mel.mode
        if mel.mode == "openai":
            # centered framing == causal framing over a reflect-padded
            # stream; the streamer supplies the padding itself.
            mel = LogMelSpectrogram(mel.filters.cpu().numpy(), n_fft=mel.n_fft, hop=mel.hop,
                                    mode="causal", device=mel.device)
        self.mel = mel
        self.batch_hops = batch_hops
        self._pcm = np.zeros(0, np.float32)
        self._pending = np.zeros(0, np.float32)  # openai: pre-prefix buffer
        self._started = self.out_mode != "openai"
        self._total = 0                          # original samples appended
        self._chunks: list[np.ndarray] = []      # raw log-mel [n_mels, k]
        self._running_max = -1e20
        self._frames = 0

    @property
    def n_frames(self) -> int:
        return self._frames

    def append(self, pcm: np.ndarray) -> None:
        pcm = np.asarray(pcm, np.float32)
        self._total += len(pcm)
        if not self._started:
            pad = self.mel.n_fft // 2
            self._pending = np.concatenate([self._pending, pcm])
            if len(self._pending) <= pad:
                return  # reflection needs pad+1 samples
            # reflect-pad the stream head: frame i of the padded stream is
            # centered at sample i*hop of the original, i.e. openai framing
            self._pcm = np.concatenate([self._pending[pad:0:-1], self._pending])
            self._pending = np.zeros(0, np.float32)
            self._started = True
        else:
            self._pcm = np.concatenate([self._pcm, pcm])
        # process all complete hops, keeping n_fft-hop lookahead so frames
        # never see implicit zero padding mid-stream
        usable = (len(self._pcm) - (N_FFT - HOP_LENGTH)) // HOP_LENGTH
        while usable >= self.batch_hops:
            take = self.batch_hops
            seg = self._pcm[: take * HOP_LENGTH + (N_FFT - HOP_LENGTH)]
            self._emit(seg, take)
            self._pcm = self._pcm[take * HOP_LENGTH :]
            usable -= take

    def _emit(self, seg: np.ndarray, n_frames: int) -> None:
        lm = self.mel(seg, normalize=False).cpu().numpy()[:, :n_frames]
        self._chunks.append(lm)
        if lm.size:
            self._running_max = max(self._running_max, float(lm.max()))
        self._frames += n_frames

    def flush(self) -> None:
        """Process the remaining tail (end of stream): zero padding in
        reference mode, tail reflection in openai mode."""
        if self.out_mode == "openai":
            pad = self.mel.n_fft // 2
            if not self._started:
                # tiny stream — pad what we can (reflect needs len-1 >= pad)
                p = self._pending
                n = self._total // HOP_LENGTH
                if n > 0:
                    k = min(pad, len(p) - 1)
                    seg = np.concatenate([p[k:0:-1], p, p[-2 : -2 - k : -1]])
                    self._emit(seg, n)
            else:
                n = self._total // HOP_LENGTH - self._frames
                if n > 0:
                    # last 201 samples of _pcm are original stream samples
                    tail = self._pcm[-2 : -2 - pad : -1]
                    self._emit(np.concatenate([self._pcm, tail]), n)
            self._pending = np.zeros(0, np.float32)
        elif len(self._pcm) >= HOP_LENGTH:
            n = len(self._pcm) // HOP_LENGTH
            self._emit(self._pcm, n)
        self._pcm = np.zeros(0, np.float32)

    def finalize(self) -> np.ndarray:
        """End the stream and return the full normalized mel [n_mels, F]."""
        self.flush()
        if not self._chunks:
            return np.zeros((self.mel.n_mels, 0), np.float32)
        raw = np.concatenate(self._chunks, axis=1)
        return self._normalize(raw)

    def _normalize(self, raw: np.ndarray) -> np.ndarray:
        # f32 arithmetic throughout, as the batch path (normalize_log_mel)
        # computes it on f32 tensors — a Python float here would promote the
        # whole computation to f64.
        mmax = np.float32(self._running_max) - np.float32(8.0)
        out = (np.maximum(raw, mmax) + np.float32(4.0)) / np.float32(4.0)
        return out.astype(np.float32)

    def window(self, offset: int, length: int) -> np.ndarray:
        """Normalized mel slice [n_mels, length], zero-padded past the end —
        the iSpectrogram::makeBuffer contract (iSpectrogram.h:12-45)."""
        raw = np.concatenate(self._chunks, axis=1) if self._chunks else np.zeros(
            (self.mel.n_mels, 0), np.float32
        )
        out = np.zeros((self.mel.n_mels, length), np.float32)
        avail = raw[:, offset : offset + length]
        if avail.size:
            out[:, : avail.shape[1]] = self._normalize(avail)
        return out
