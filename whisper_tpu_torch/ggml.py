"""GGML checkpoint reader (and writer, for tools/tests).

The classic whisper.cpp GGML format, as parsed by the reference loader
(Whisper/Whisper/WhisperModel.cpp:434-492 for header/filters/vocab,
:257-340 for the tensor stream):

    uint32    magic = 0x67676d6c ("ggml" read as LE uint32)
    int32[11] hparams  (sModelParams.h:5-18 field order)
    int32     n_mel, int32 n_fft_bins   # mel filterbank dims
    f32[n_mel*n_fft_bins]               # filterbank data
    int32     n_words                   # vocabulary
    { int32 len, bytes[len] } * n_words
    then tensors until EOF:
    { int32 n_dims (1..3), int32 name_len, int32 ftype (0=f32, 1=f16)
      int32 ne[n_dims]                  # ne[0] fastest-varying (GGML order)
      bytes name[name_len]
      bytes data[prod(ne) * elt_size] }

This module is pure host-side NumPy; conversion to torch tensors happens in
``whisper_tpu_torch.model.params``. It also carries the Slaney mel
filterbank (``mel_filter_bank``) used to synthesize checkpoints, which
``whisper_tpu_torch.features.filters`` re-exports.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator

import numpy as np

from whisper_tpu_torch.hparams import ModelDims

GGML_MAGIC = 0x67676D6C


@dataclasses.dataclass
class MelFilters:
    """Mel filterbank shipped inside the checkpoint."""

    n_mel: int
    n_fft_bins: int
    data: np.ndarray  # [n_mel, n_fft_bins] float32


@dataclasses.dataclass
class RawTensor:
    name: str
    ne: tuple[int, ...]     # GGML order: ne[0] fastest-varying
    ftype: int              # 0 = f32, 1 = f16
    data: np.ndarray        # numpy array with shape reversed(ne) (row-major)


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError(f"expected {n} bytes, got {len(b)}")
    return b


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", _read_exact(f, 4))[0]


def read_header(f: BinaryIO) -> tuple[ModelDims, MelFilters]:
    """Parse magic, hparams, and the mel filterbank."""
    magic = struct.unpack("<I", _read_exact(f, 4))[0]
    if magic != GGML_MAGIC:
        raise ValueError(f"bad GGML magic: 0x{magic:08x}")
    vals = struct.unpack("<11i", _read_exact(f, 44))
    dims = ModelDims(*vals)
    dims.validate()

    n_mel = _read_i32(f)
    n_fft_bins = _read_i32(f)
    if not (0 < n_mel <= 512 and 0 < n_fft_bins <= 8192):
        raise ValueError(f"implausible mel filterbank dims {n_mel}x{n_fft_bins}")
    filt = np.frombuffer(
        _read_exact(f, 4 * n_mel * n_fft_bins), dtype="<f4"
    ).reshape(n_mel, n_fft_bins).copy()
    return dims, MelFilters(n_mel, n_fft_bins, filt)


def read_vocab_strings(f: BinaryIO) -> list[bytes]:
    """Read the raw vocabulary byte-strings (synthesized specials are added by
    ``whisper_tpu_torch.vocab.Vocabulary``, reference Vocabulary.cpp:110-139)."""
    n_words = _read_i32(f)
    if n_words <= 0:
        raise ValueError(f"bad vocab size {n_words}")
    words = []
    for _ in range(n_words):
        n = _read_i32(f)
        if n < 0:
            raise ValueError("negative token length")
        # Zero-length tokens occur in ggml-large(-v1).bin (Vocabulary.cpp:93-99).
        words.append(_read_exact(f, n) if n else b"")
    return words


def iter_tensors(f: BinaryIO) -> Iterator[RawTensor]:
    """Stream tensors until EOF (reference loadGpu loop, WhisperModel.cpp:257-340)."""
    while True:
        head = f.read(12)
        if not head:
            return
        if len(head) != 12:
            raise EOFError("truncated tensor header")
        n_dims, name_len, ftype = struct.unpack("<3i", head)
        if not (1 <= n_dims <= 3):
            raise ValueError(f"bad n_dims {n_dims}")
        if not (0 < name_len < 256):
            raise ValueError(f"bad name length {name_len}")
        ne = struct.unpack(f"<{n_dims}i", _read_exact(f, 4 * n_dims))
        if any(x <= 0 for x in ne):
            raise ValueError(f"non-positive dim in {ne}")
        name = _read_exact(f, name_len).decode("utf-8")
        count = int(np.prod(ne))
        if ftype == 0:
            data = np.frombuffer(_read_exact(f, 4 * count), dtype="<f4")
        elif ftype == 1:
            data = np.frombuffer(_read_exact(f, 2 * count), dtype="<f2")
        else:
            raise ValueError(f"unsupported ftype {ftype} for tensor {name!r}")
        # numpy shape is reversed ne (ne[0] is the fastest-varying axis).
        yield RawTensor(name, ne, ftype, data.reshape(tuple(reversed(ne))).copy())


@dataclasses.dataclass
class Checkpoint:
    dims: ModelDims
    filters: MelFilters
    vocab_words: list[bytes]
    tensors: dict[str, RawTensor]


def load_checkpoint(path: str, progress=None) -> Checkpoint:
    """Load a full GGML checkpoint into host memory.

    ``progress``: optional callable(fraction: float) -> None, the analogue of
    the reference's sLoadModelCallbacks progress sink (WhisperModel.cpp:186-255).
    """
    import os

    total = os.path.getsize(path)
    tensors: dict[str, RawTensor] = {}
    with open(path, "rb") as f:
        dims, filters = read_header(f)
        words = read_vocab_strings(f)
        for t in iter_tensors(f):
            if t.name in tensors:
                raise ValueError(f"duplicate tensor {t.name!r}")
            tensors[t.name] = t
            if progress is not None:
                progress(f.tell() / total)
    return Checkpoint(dims, filters, words, tensors)


# ---------------------------------------------------------------------------
# Writer — used by chip_smoke.py and the test fixtures.
# ---------------------------------------------------------------------------


def write_checkpoint(
    f: BinaryIO,
    dims: ModelDims,
    filters: MelFilters,
    vocab_words: list[bytes],
    tensors: dict[str, np.ndarray],
    use_f16: bool = True,
) -> None:
    """Serialize a checkpoint in the exact format ``load_checkpoint`` reads.

    ``tensors`` maps GGML tensor name -> numpy array in *logical* (numpy)
    layout; ne is emitted reversed. 1-D tensors are kept f32 (matching the
    whisper.cpp conversion convention); >=2-D tensors are f16 when
    ``use_f16``.
    """
    f.write(struct.pack("<I", GGML_MAGIC))
    f.write(
        struct.pack(
            "<11i",
            dims.n_vocab,
            dims.n_audio_ctx,
            dims.n_audio_state,
            dims.n_audio_head,
            dims.n_audio_layer,
            dims.n_text_ctx,
            dims.n_text_state,
            dims.n_text_head,
            dims.n_text_layer,
            dims.n_mels,
            1 if use_f16 else 0,
        )
    )
    f.write(struct.pack("<2i", filters.n_mel, filters.n_fft_bins))
    f.write(np.ascontiguousarray(filters.data, dtype="<f4").tobytes())
    f.write(struct.pack("<i", len(vocab_words)))
    for w in vocab_words:
        f.write(struct.pack("<i", len(w)))
        f.write(w)
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        as_f16 = use_f16 and arr.ndim >= 2
        data = np.ascontiguousarray(arr, dtype="<f2" if as_f16 else "<f4")
        ne = tuple(reversed(arr.shape))
        name_b = name.encode("utf-8")
        f.write(struct.pack("<3i", arr.ndim, len(name_b), 1 if as_f16 else 0))
        f.write(struct.pack(f"<{arr.ndim}i", *ne))
        f.write(name_b)
        f.write(memoryview(data).cast("B"))  # no bytes copy of the tensor


def write_checkpoint_file(path: str, *args, **kwargs) -> None:
    """Stream the checkpoint straight to ``path`` (a large-v2 file is about
    3.1 GB, so it is never assembled in memory first)."""
    with open(path, "wb") as f:
        write_checkpoint(f, *args, **kwargs)


# ---------------------------------------------------------------------------
# Slaney-style mel filterbank (librosa ``filters.mel(norm="slaney",
# htk=False)``, the filters OpenAI whisper embeds in its checkpoints).
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3.0          # linear region: mels per Hz below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    return np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)),
        freq,
    )


def mel_filter_bank(
    n_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16_000,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular slaney-normalized filters, shape [n_mels, n_fft//2 + 1]."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney area normalization
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
