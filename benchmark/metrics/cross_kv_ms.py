"""model/encoder.py cross K/V precompute (with the int8 quantize on the
serving tier): device ms per call of the program's own span ``cross_kv``
inside encode_window (whisper_tpu_torch.obs.profiler.TRACER), recorded in
the traced rounds, where the profiler turns the tracer on: an upper bound
under CUPTI. None where the program has no tracer or no such span."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("cross_kv")
    return st.device_ms / st.calls if st and st.calls else None
