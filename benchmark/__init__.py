"""The benchmark of ``whisper_tpu_torch`` on one NVIDIA card: ``python3 benchmark/run.py --help``."""
