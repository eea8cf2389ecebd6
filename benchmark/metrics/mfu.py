"""The whole step: model operations of the windows completed in the measured
window (30 s encodes, cross K/V, real prompt tokens, forced token steps;
benchmark/counts.py) over the window's wall seconds times 989 TFLOP/s, in %."""

from benchmark.counts import BF16_FLOPS


def read(run):
    return 100.0 * run.flops / (run.window_s * BF16_FLOPS) if run.records else None
