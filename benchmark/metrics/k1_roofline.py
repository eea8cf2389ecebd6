"""K1 (csrc/flash_attention.cu): the least time of the traced rounds' K1 work
(benchmark/counts.py, from the call shapes) over K1's device time in the
trace, in %. Each K1 kernel is one call of one shape, so a kernel the trace
lost takes its bound with it; more K1 kernels than the rounds' calls means
work that counts.py does not count: no reading."""


def read(run):
    secs, n = run.trace.get("found", {}).get("k1", (0.0, 0))
    if not n or not secs or n > run.traced["k1_kernels"]:
        return None
    per_kernel = run.traced["k1_bound_s"] / run.traced["k1_kernels"]
    return 100.0 * n * per_kernel / secs
