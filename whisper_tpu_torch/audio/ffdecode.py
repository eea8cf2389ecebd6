"""Native audio decode bindings (libwhisper_audio.so over FFmpeg libs).

Counterpart of ``whisper_tpu.audio.ffdecode``. The compiled decoder
(native/audio_decode.cpp) covers every codec the reference's Media
Foundation layer handled (wav/wma/mp3/ogg/..., Whisper/MF/loadAudioFile.cpp:14-120).
This module is the thin ctypes layer; ``audio.load.load_audio_file`` uses
it as the preferred non-WAV path, before trying an ffmpeg binary
subprocess. The library is built at first use where the FFmpeg headers
are (``native.library``); elsewhere ``available()`` is False.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from whisper_tpu_torch.native import library


@functools.cache
def _load() -> ctypes.CDLL | None:
    lib = library("audio_decode")
    if lib is None:
        return None
    lib.wta_version.restype = ctypes.c_int
    if lib.wta_version() != 1:
        raise RuntimeError(f"libwhisper_audio version {lib.wta_version()}, expected 1")
    lib.wta_decode_file.restype = ctypes.c_int64
    lib.wta_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.wta_free.restype = None
    lib.wta_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    return lib


def available() -> bool:
    return _load() is not None


def decode_file(path: str, rate: int, channels: int) -> Optional[np.ndarray]:
    """Decode to float32 PCM: [N] when channels=1, [N, 2] when channels=2.
    Returns None when the native library is unavailable; raises on decode
    failure."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_float)()
    n = lib.wta_decode_file(path.encode(), rate, channels, ctypes.byref(buf))
    if n < 0:
        raise RuntimeError(f"native decode failed for {path!r} (code {n})")
    try:
        if n == 0:
            return np.zeros((0,) if channels == 1 else (0, 2), np.float32)
        flat = np.ctypeslib.as_array(buf, shape=(int(n) * channels,))
        out = np.array(flat, np.float32, copy=True)
    finally:
        lib.wta_free(buf)
    return out if channels == 1 else out.reshape(-1, 2)
