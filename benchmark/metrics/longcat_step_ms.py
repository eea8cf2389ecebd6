"""runtime/longcat.py replayed token step of the longcat family: device ms
of the program's own span ``longcat_steps`` (whisper_tpu_torch.obs.profiler.TRACER)
over the steps it launched, recorded in the traced rounds: an upper bound
under CUPTI. None where the program has no such span."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("longcat_steps")
    return st.device_ms / st.units if st and st.units else None
