"""K2 (csrc/decode_attention.cu, self and cross attention of every token
step): the least time of the traced rounds' K2 work (benchmark/counts.py:
the keys each lane attends, bf16 or int8 bytes as the tier stores them)
over K2's device time in the trace (its split and combine kernels), in %.

Each K2 call is one split kernel and one combine. More of either in the
trace than the rounds' calls means work that counts.py does not count: no
reading (the trace line on stderr gives both counts). Where the trace lost
kernels, the bound is taken over the calls whose split and combine it
kept, and the device time is that of every K2 kernel it kept."""


def read(run):
    found = run.trace.get("found", {})
    secs, n = found.get("k2", (0.0, 0))
    calls = run.traced["k2_calls"]
    split, combine = found.get("k2_split", (0.0, 0))[1], found.get("k2_combine", (0.0, 0))[1]
    if not n or not secs or n != split + combine or max(split, combine) > calls:
        return None
    return 100.0 * run.traced["k2_bound_s"] * min(split, combine) / calls / secs
