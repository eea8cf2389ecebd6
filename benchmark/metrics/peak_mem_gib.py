"""The device: torch.cuda.max_memory_allocated() over the measured window,
weights included, in GiB."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
