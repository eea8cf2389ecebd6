"""Command-line tools of the port (``python -m whisper_tpu_torch.tools.<name>``)."""
