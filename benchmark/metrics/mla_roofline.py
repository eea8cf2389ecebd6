"""The step's latent attention kernel (csrc/mla_decode.cu, 2L calls a
token step): the least time of the traced rounds' calls
(benchmark/counts_longcat.py: each lane's cache rows, query and output
once, or the scores' and values' operations, whichever takes longer) over
the device time of its kernels in the trace (the main kernel, and the
combine where a lane's keys are split), in %. Each call has one main
kernel; more of them in the trace than the rounds' calls means work that
counts_longcat.py does not count: no reading. Where the trace lost some,
the bound is taken over the calls whose main kernel it kept."""


def read(run):
    found = run.trace.get("found", {})
    secs = found.get("mla", (0.0, 0))[0]
    n = found.get("mla_main", (0.0, 0))[1]
    calls = run.traced.get("mla_calls")
    if not (n and secs and calls) or n > calls:
        return None
    return 100.0 * run.traced["mla_bound_s"] * n / calls / secs
