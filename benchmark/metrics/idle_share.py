"""The device: share of the traced rounds in which no operation ran on the
card, in % (profiler on, so an upper bound)."""


def read(run):
    if not run.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
