"""Audio file decode, live capture and VAD for the PyTorch port."""

from whisper_tpu_torch.audio.load import load_audio_file, resample_to_16k, speedup_2x

__all__ = ["load_audio_file", "resample_to_16k", "speedup_2x"]
