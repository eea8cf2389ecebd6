"""Log-mel spectrogram front-end on the runtime's device.

Counterpart of ``whisper_tpu.features.mel``: the 400-point real DFT as two
dense matmuls with precomputed cos/sin bases, then the filterbank, log10
and whisper's normalisation. Three framing modes:
  - "openai"    reflect-pad n_fft//2 on both sides (center=True), OpenAI
                whisper / transformers' WhisperFeatureExtractor framing
  - "reference" whisper.cpp framing: frame i covers [i*hop, i*hop + n_fft),
                zero-padded at the clip end, with the power-spectrum fold
                that doubles bins 1..n_fft/2-1 (melSpectrogram.cpp:355-366)
  - "causal"    reference framing without the fold

The DFT products and the power spectrum run in float64, the filterbank in
full f32. On the card full f32 means TF32 off, which the JAX package gets
from ``Precision.HIGHEST``; it is set explicitly around the products
(``_full_f32``), not taken from the process-wide default, because TF32's
~3 decimal digits are too coarse for a mel filterbank.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.hparams import HOP_LENGTH, N_FFT


def _hann_window(n_fft: int) -> np.ndarray:
    # Periodic Hann, same as the reference (melSpectrogram.cpp:12).
    i = np.arange(n_fft)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))).astype(np.float32)


def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases: returns (cos, -sin) matrices of shape [n_fft, n_bins]."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    theta = 2.0 * np.pi * n * k / n_fft
    return np.cos(theta).astype(np.float32), (-np.sin(theta)).astype(np.float32)


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls without TF32 on the card, restoring the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def normalize_log_mel(log_mel: torch.Tensor, valid_frames: int | None = None) -> torch.Tensor:
    """Whisper dynamic-range normalization (Spectrogram.cpp:90-103): clamp
    to global max - 8, then (x + 4) / 4. Frames at or past ``valid_frames``
    are zeroed."""
    mmax = log_mel.max() - 8.0
    out = (torch.maximum(log_mel, mmax) + 4.0) / 4.0
    if valid_frames is not None:
        frame_idx = torch.arange(log_mel.shape[-1], device=log_mel.device)
        out = torch.where(frame_idx[None, :] < valid_frames, out, 0.0)
    return out


class LogMelSpectrogram:
    """Holds the filterbank and DFT bases on the device.

    ``filters``: [n_mels, n_fft//2+1] (from the GGML checkpoint)."""

    def __init__(
        self,
        filters: np.ndarray,
        n_fft: int = N_FFT,
        hop: int = HOP_LENGTH,
        mode: str = "openai",
        device: str | torch.device = "cuda",
    ):
        if mode not in ("openai", "reference", "causal"):
            raise ValueError(f"unknown mel mode {mode!r}")
        self.device = resolve_device(device)
        self.n_mels = int(filters.shape[0])
        self.n_fft = n_fft
        self.hop = hop
        self.mode = mode
        self.filters = torch.as_tensor(np.asarray(filters, np.float32), device=self.device)
        self.window = torch.from_numpy(_hann_window(n_fft)).to(self.device)
        cos_b, sin_b = _dft_bases(n_fft)
        self.cos_b = torch.from_numpy(cos_b).to(self.device)
        self.sin_b = torch.from_numpy(sin_b).to(self.device)

    def _log_mel(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [n_samples] -> unnormalized log10-mel [n_mels, n_frames]."""
        n_fft, hop = self.n_fft, self.hop
        n_frames = audio.shape[0] // hop
        if self.mode == "openai":
            audio = F.pad(audio[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
        else:
            audio = F.pad(audio, (0, n_fft))
        frames = audio.unfold(0, n_fft, hop)[:n_frames] * self.window[None, :]   # [F, n_fft]
        with _full_f32():
            # f64 DFT: in f32 the cancellation in bins far below the loudest
            # tone costs up to 2e-4 of normalised log-mel (PyTorch's CPU sum
            # order; XLA's is closer to exact). ~1 GFLOP per 30 s window.
            f64 = frames.double()
            re = f64 @ self.cos_b.double()
            im = f64 @ self.sin_b.double()
            power = (re * re + im * im).float()                                    # [F, n_bins]
            if self.mode == "reference":
                n_bins = n_fft // 2 + 1
                scale = torch.ones(n_bins, device=power.device)
                scale[1 : n_bins - 1] = 2.0
                power = power * scale[None, :]
            mel = power @ self.filters.T
        return torch.log10(torch.clamp(mel, min=1e-10)).T                          # [n_mels, F]

    @torch.inference_mode()
    def __call__(self, audio, normalize: bool = True) -> torch.Tensor:
        """audio: [n_samples] float32 at 16 kHz -> [n_mels, n_frames]."""
        audio = torch.as_tensor(np.asarray(audio, np.float32)).to(self.device)
        lm = self._log_mel(audio)
        return normalize_log_mel(lm) if normalize else lm


def log_mel_spectrogram(audio, filters, mode: str = "openai", normalize: bool = True,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """One-shot helper (builds the bases on every call; prefer
    LogMelSpectrogram)."""
    return LogMelSpectrogram(np.asarray(filters), mode=mode, device=device)(audio, normalize)
