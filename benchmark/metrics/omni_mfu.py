"""The omni family's whole step: model operations of the windows completed in
the measured window (encoder and connector over 30 s, the real prompt
positions, the forced steps, each with a row of logits; the routed experts
as chosen; benchmark/counts_omni.py) over the window's wall seconds times
989 TFLOP/s, in %. None outside the omni family."""

from benchmark.counts import BF16_FLOPS


def read(run):
    if "omni_step_bound_s" not in run.traced or not run.records:
        return None
    return 100.0 * run.flops / (run.window_s * BF16_FLOPS)
