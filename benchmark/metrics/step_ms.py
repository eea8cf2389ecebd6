"""runtime/graph.py replayed token step: device ms of the program's own span
``steps`` (runtime/decode.py run_steps, whisper_tpu_torch.obs.profiler.TRACER)
over the token steps it launched, recorded in the traced rounds, where the
profiler turns the tracer on: an upper bound under CUPTI. None where the
program has no tracer or no such span."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("steps")
    return st.device_ms / st.units if st and st.units else None
