"""runtime/graph.py Slot.step: host ms of the set-up's build check, warm-up
steps and CUDA graph captures, the program's counter ``capture_ms``
(whisper_tpu_torch.obs.profiler.TRACER, always on). None where the program
has no tracer or captured nothing."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    return TRACER.counters.get("capture_ms") or None
