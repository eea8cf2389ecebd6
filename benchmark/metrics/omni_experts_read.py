"""The omni token step's expert layer kernel: routed experts streamed per
step and layer, from the program's counters ``moe.experts_read`` (counted
on the device by the kernel pair, each routed expert it read in a step's
layer) over ``moe.step_layers`` (the steps' layers), both from
whisper_tpu_torch.obs.profiler.TRACER, always on, over every window of the
run. None where the program has no such counters."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    layers = TRACER.counters.get("moe.step_layers")
    read_ = TRACER.counters.get("moe.experts_read")
    return read_ / layers if layers and read_ is not None else None
