"""Observability (phase profiler) of the PyTorch port."""
