"""ctypes bindings for the native host runtime (whisper_native.cpp), and the
builds of both native libraries.

Counterpart of ``whisper_tpu.native``: ``available``, ``log_mel_raw``,
``fp16_to_f32`` and ``signal_energy``, each with a NumPy version (the plain
version, used when the library is not built). Where the JAX package
builds its libraries with ``tools/build_native.py``, the port builds them
with g++ at first use, with that tool's flags, into
``build/whisper_tpu_torch/`` (``library``):

  libwhisper_native  mel/fp16/energy host kernels, no external dependency:
                     built wherever g++ is
  libwhisper_audio   the audio file decoder over libavformat/libavcodec
                     (``audio/ffdecode.py``): built only where the FFmpeg
                     headers are, else unavailable

Each file name carries a hash of its source, its flags and the host's CPU
(``-march=native``), and is written to a temporary file and renamed, so
concurrent processes never load a half-written library. A build that
fails where it should work (g++ present; for the decoder, the headers
too) raises with g++'s log. This is host code, off the device path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "whisper_tpu_torch"
# tools/build_native.py's flags, per library: (flags before the source, after it)
FLAGS = {
    "whisper_native": (("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"), ()),
    "audio_decode": (("-O3", "-std=c++17", "-shared", "-fPIC"),
                     ("-lavformat", "-lavcodec", "-lswresample", "-lavutil")),
}
LIB_NAMES = {"whisper_native": "libwhisper_native", "audio_decode": "libwhisper_audio"}


def _cpu() -> bytes:
    """The host's CPU model and flags: what ``-march=native`` compiles for."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    return "\n".join(sorted({ln for ln in info if ln.startswith(("model name", "flags"))})).encode()


def library_path(name: str) -> Path:
    before, after = FLAGS[name]
    key = (SRC_DIR / f"{name}.cpp").read_bytes() + " ".join(before + after).encode() + _cpu()
    return BUILD_DIR / f"{LIB_NAMES[name]}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _have_libav(gxx: str) -> bool:
    """Whether g++ finds the FFmpeg headers (tools/build_native.py builds
    the decoder only where they are)."""
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"], input="#include <libavformat/avformat.h>\n",
                           capture_output=True, text=True)
    return probe.returncode == 0


@functools.cache
def library(name: str) -> ctypes.CDLL | None:
    """``<name>.cpp`` built (at first use) and loaded, or None where it
    cannot be built: no g++, or for the decoder no FFmpeg headers."""
    gxx = shutil.which("g++")
    if gxx is None or (name == "audio_decode" and not _have_libav(gxx)):
        return None
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        before, after = FLAGS[name]
        cmd = [gxx, *before, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp), *after]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {name}.cpp (exit {done.returncode}):\n"
                               f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.cache
def _load() -> ctypes.CDLL | None:
    lib = library("whisper_native")
    if lib is None:
        return None
    lib.wtn_version.restype = ctypes.c_int
    if lib.wtn_version() != 1:
        raise RuntimeError(f"libwhisper_native version {lib.wtn_version()}, expected 1")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.wtn_log_mel.restype = None
    lib.wtn_log_mel.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int, f32p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.wtn_fp16_to_f32.restype = None
    lib.wtn_fp16_to_f32.argtypes = [u16p, f32p, ctypes.c_int64]
    lib.wtn_signal_energy.restype = None
    lib.wtn_signal_energy.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, f32p]
    return lib


def available() -> bool:
    return _load() is not None


def log_mel_raw(
    pcm: np.ndarray, filters: np.ndarray, mode: str = "openai", n_threads: int = 4
) -> np.ndarray:
    """Unnormalized log10-mel [n_mel, n_frames] on the host CPU.

    Native when built; the NumPy version otherwise.
    Framing matches whisper_tpu_torch.features.mel (same two modes)."""
    pcm = np.ascontiguousarray(pcm, np.float32)
    filters = np.ascontiguousarray(filters, np.float32)
    n_mel = filters.shape[0]
    n_frames = len(pcm) // 160

    lib = _load()
    if lib is not None and n_frames > 0:
        out = np.empty((n_mel, n_frames), np.float32)
        lib.wtn_log_mel(
            pcm, len(pcm), filters, n_mel, out, n_frames,
            0 if mode == "openai" else 1, n_threads,
        )
        return out

    # the NumPy version
    from whisper_tpu_torch.features.mel import _dft_bases, _hann_window

    n_fft = 400
    if n_frames <= 0:
        return np.zeros((n_mel, 0), np.float32)
    if mode == "openai":
        padded = np.pad(pcm, (n_fft // 2, n_fft // 2), mode="reflect")
    else:
        padded = np.pad(pcm, (0, n_fft))
    idx = (np.arange(n_frames) * 160)[:, None] + np.arange(n_fft)[None, :]
    frames = padded[idx] * _hann_window(n_fft)[None, :]
    cos_b, sin_b = _dft_bases(n_fft)
    power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
    if mode == "reference":
        power[:, 1:-1] *= 2.0
    mel = power @ filters.T
    return np.log10(np.maximum(mel, 1e-10)).T.astype(np.float32)


def fp16_to_f32(src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src)
    lib = _load()
    if lib is not None:
        out = np.empty(src.shape, np.float32)
        lib.wtn_fp16_to_f32(src.view(np.uint16), out.reshape(-1), src.size)
        return out
    return src.view(np.float16).astype(np.float32)


def signal_energy(pcm: np.ndarray, half_window: int = 32) -> np.ndarray:
    pcm = np.ascontiguousarray(pcm, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(len(pcm), np.float32)
        lib.wtn_signal_energy(pcm, len(pcm), half_window, out)
        return out
    from whisper_tpu_torch.api.timestamps import compute_signal_energy

    return compute_signal_energy(pcm, half_window)
