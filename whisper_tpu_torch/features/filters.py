"""Slaney-style mel filterbank, computed on the host in numpy.

Counterpart of ``whisper_tpu.features.filters`` (librosa's
``filters.mel(sr, n_fft, n_mels, norm="slaney", htk=False)``, the filters
OpenAI whisper embeds in its checkpoints). The one copy of the code lives in
``whisper_tpu_torch.ggml``, beside the checkpoint writer that embeds it and
that needs no torch; it is re-exported here at the JAX package's path.
"""

from whisper_tpu_torch.ggml import hz_to_mel, mel_filter_bank, mel_to_hz

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filter_bank"]
