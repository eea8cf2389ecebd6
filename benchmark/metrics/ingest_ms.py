"""runtime/decode.py prompt ingest (the eager ingest and the state reset of
decode_window): device ms per call of the program's own span ``ingest``
(whisper_tpu_torch.obs.profiler.TRACER), recorded in the traced rounds,
where the profiler turns the tracer on: an upper bound under CUPTI. None
where the program has no tracer or no such span."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("ingest")
    return st.device_ms / st.calls if st and st.calls else None
