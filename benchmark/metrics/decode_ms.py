"""runtime/context.py run_window (prompt ingest, the forced token steps as
replayed graphs, the result copied to the host): synchronised span ms per call."""


def read(run):
    ms = run.spans.get("decode", [])
    return sum(ms) / len(ms) if ms else None
