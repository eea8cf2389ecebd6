"""Log-mel front-end of the PyTorch port."""

from whisper_tpu_torch.features.filters import mel_filter_bank
from whisper_tpu_torch.features.mel import LogMelSpectrogram, log_mel_spectrogram

__all__ = ["mel_filter_bank", "LogMelSpectrogram", "log_mel_spectrogram"]
