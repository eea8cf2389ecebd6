"""runtime/context.py encode_window (encoder and cross K/V): synchronised span ms per call."""


def read(run):
    ms = run.spans.get("encode", [])
    return sum(ms) / len(ms) if ms else None
