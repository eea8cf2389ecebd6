"""95th percentile, over the window's windows, of the wall time from taking a
window's input (its item's mel when it is the item's first) to its result
on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency_ms, 95)) if run.latency_ms else None
