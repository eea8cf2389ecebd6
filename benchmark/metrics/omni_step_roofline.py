"""The omni token step against its bound: the least time of the traced
rounds' token steps (benchmark/counts_omni.py: every weight but the routed
experts', each routed expert some lane chose in a layer once, the head,
the K/V columns read and written, at 3.35 TB/s) over the device time of the
program's span ``omni_steps`` in those rounds, in %. None where the program
has no such span, or where the span's steps are not the rounds' counted
ones."""


def read(run):
    try:
        from whisper_tpu_torch.obs.profiler import TRACER
    except ImportError:
        return None
    st = TRACER.stats("omni_steps")
    steps = run.traced.get("omni_steps")
    if not (st and st.device_ms and steps and st.units == steps):
        return None
    return 100.0 * run.traced["omni_step_bound_s"] / (st.device_ms / 1e3)
