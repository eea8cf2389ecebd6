"""runtime/longcat.py eager prefill (the prompt and audio positions of a
window into the latent cache, in groups of lanes, and the state reset):
device ms per call of the program's own span ``longcat_prefill``
(whisper_tpu_torch.obs.profiler.TRACER), recorded in the traced rounds,
where the profiler turns the tracer on: an upper bound under CUPTI. None
where the program has no such span."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("longcat_prefill")
    return st.device_ms / st.calls if st and st.calls else None
