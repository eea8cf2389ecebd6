"""The omni expert layer's routing: routed experts kept per token and layer
(a null expert kept is not counted), from the program's counters
``moe.routed_slots`` over ``moe.tokens`` (whisper_tpu_torch.obs.profiler.TRACER,
always on; every window of the run, prompt and token steps). None where the
program has no such counters."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    tokens = TRACER.counters.get("moe.tokens")
    return TRACER.counters.get("moe.routed_slots", 0) / tokens if tokens else None
