"""Model hyper-parameters and audio constants.

Mirrors the reference's ``sModelParams`` (Whisper/Whisper/sModelParams.h:5-18)
and audio constants (Whisper/Whisper/audioConstants.h:7-13), re-expressed as
frozen dataclasses (hashable, usable as cache keys).
"""

from __future__ import annotations

import dataclasses

# Audio front-end constants (reference: Whisper/Whisper/audioConstants.h:7-13).
SAMPLE_RATE = 16_000
N_FFT = 400          # 25 ms window
HOP_LENGTH = 160     # 10 ms hop
N_MEL = 80           # classic whisper models; large-v3 uses 128
CHUNK_SECONDS = 30   # WHISPER_CHUNK_SIZE
N_FRAMES = CHUNK_SECONDS * SAMPLE_RATE // HOP_LENGTH  # 3000 mel frames / window
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH         # 100


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Whisper checkpoint hyper-parameters.

    Field order matches the 11-int GGML header the reference reads in one
    struct (Whisper/Whisper/WhisperModel.cpp:452-468; sModelParams.h:5-18).
    Defaults are the "tiny" configuration.
    """

    n_vocab: int = 51_864
    n_audio_ctx: int = 1_500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80
    ftype: int = 1  # 0 = f32 weights, 1 = f16 weights

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def is_multilingual(self) -> bool:
        # Reference: Vocabulary.h:38-41 — multilingual vocab has one extra token.
        return self.n_vocab >= 51_865

    @property
    def n_mlp(self) -> int:
        return 4 * self.n_audio_state

    def validate(self) -> None:
        if self.n_audio_state != self.n_text_state:
            raise ValueError(
                "n_audio_state != n_text_state is unsupported "
                f"({self.n_audio_state} vs {self.n_text_state})"
            )
        if self.n_audio_state % self.n_audio_head:
            raise ValueError("n_audio_state must be divisible by n_audio_head")
        if self.n_text_state % self.n_text_head:
            raise ValueError("n_text_state must be divisible by n_text_head")


# Canonical whisper family configurations, keyed by common model name.
# (Useful for synthesizing checkpoints and sanity checks; real dims always
# come from the GGML header.)
KNOWN_MODELS: dict[str, ModelDims] = {
    "tiny.en": ModelDims(51864, 1500, 384, 6, 4, 448, 384, 6, 4, 80, 1),
    "tiny": ModelDims(51865, 1500, 384, 6, 4, 448, 384, 6, 4, 80, 1),
    "base.en": ModelDims(51864, 1500, 512, 8, 6, 448, 512, 8, 6, 80, 1),
    "base": ModelDims(51865, 1500, 512, 8, 6, 448, 512, 8, 6, 80, 1),
    "small.en": ModelDims(51864, 1500, 768, 12, 12, 448, 768, 12, 12, 80, 1),
    "small": ModelDims(51865, 1500, 768, 12, 12, 448, 768, 12, 12, 80, 1),
    "medium.en": ModelDims(51864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80, 1),
    "medium": ModelDims(51865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80, 1),
    "large-v1": ModelDims(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80, 1),
    "large-v2": ModelDims(51865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80, 1),
    # beyond the reference: v3 family (128 mel bins, +1 language "yue")
    "large-v3": ModelDims(51866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128, 1),
    "large-v3-turbo": ModelDims(51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128, 1),
}
