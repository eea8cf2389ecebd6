"""Seconds from the process's start to the end of the warm rounds: imports,
the card, the weights drawn and derived, the kernels loaded (built on a
checkout's first run), the graph captured, two rounds."""


def read(run):
    return run.setup_s
