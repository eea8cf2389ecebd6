"""Audio seconds of the windows completed in the measured window, per wall second of it."""


def read(run):
    return run.audio_s / run.window_s if run.records else None
