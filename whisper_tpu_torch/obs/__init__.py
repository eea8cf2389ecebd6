"""Observability of the PyTorch port: the phase profiler and device traces,
tensor traces and their compare, the NaN sanitizer, the logger."""
