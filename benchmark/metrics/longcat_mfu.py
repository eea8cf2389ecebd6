"""The longcat family's whole step: model operations of the windows
completed in the measured window (the stand-in encoder and connector over
30 s, the real prefill positions, the forced steps, each with a row of
logits; latent attention in its expanded form, the held and zero experts
as chosen; benchmark/counts_longcat.py) over the window's wall seconds
times 989 TFLOP/s, in %. None outside the longcat family."""

from benchmark.counts import BF16_FLOPS


def read(run):
    if "mla_calls" not in run.traced or not run.records:
        return None
    return 100.0 * run.flops / (run.window_s * BF16_FLOPS)
