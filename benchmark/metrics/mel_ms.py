"""features/mel.py: the program's log-mel, synchronised span ms per 30 s of audio."""


def read(run):
    ms = run.spans.get("mel", [])
    return sum(ms) / (run.mel_audio_s / 30.0) if ms and run.mel_audio_s else None
