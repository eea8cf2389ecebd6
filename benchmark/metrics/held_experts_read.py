"""The longcat token step's expert layer kernel: held experts streamed per
step and layer, from the program's counters ``moe.experts_read`` (counted
on the device by the kernel pair, each of this card's experts it read in a
step's layer) over ``moe.step_layers`` (the steps' layers), both from
whisper_tpu_torch.obs.profiler.TRACER, always on, over every window of the
run after the set-up's rounds that balance the router's bias (the family
leaves the counters as those rounds left them in ``run.counters_base``).
None where the program has no such counters."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    base = getattr(run, "counters_base", {})
    if "moe.step_layers" not in TRACER.counters or "moe.experts_read" not in TRACER.counters:
        return None
    layers = TRACER.counters["moe.step_layers"] - base.get("moe.step_layers", 0)
    read_ = TRACER.counters["moe.experts_read"] - base.get("moe.experts_read", 0)
    return read_ / layers if layers else None
