"""Run-time transcription parameters.

The PyTorch port's analogue of ``sFullParams`` (Whisper/API/sFullParams.h:21-108)
with defaults from ``fullDefaultParams`` (ContextImpl.misc.cpp:61-93). Flags
keep the reference's names; callbacks are plain Python callables.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence


class SamplingStrategy(enum.IntEnum):
    # Reference eSamplingStrategy (sFullParams.h:9-14). Unlike the reference,
    # beam search is actually implemented here (BASELINE.json config 3).
    GREEDY = 0
    BEAM_SEARCH = 1


class Flags(enum.IntFlag):
    """Mirrors eFullParamsFlags (sFullParams.h:23-44)."""

    NONE = 0
    TRANSLATE = 1 << 0
    NO_CONTEXT = 1 << 1
    SINGLE_SEGMENT = 1 << 2
    PRINT_SPECIAL = 1 << 3
    PRINT_PROGRESS = 1 << 4
    PRINT_REALTIME = 1 << 5
    PRINT_TIMESTAMPS = 1 << 6
    TOKEN_TIMESTAMPS = 1 << 7
    SPEEDUP_AUDIO = 1 << 8


# Callback signatures (reference sFullParams.h:84-108):
#   new_segment_callback(context, n_new) -> None
#   encoder_begin_callback(context) -> bool   (False aborts, like S_FALSE)
#   progress_callback(fraction: float) -> None
NewSegmentCallback = Callable[["object", int], None]
EncoderBeginCallback = Callable[["object"], bool]
ProgressCallback = Callable[[float], None]


@dataclasses.dataclass
class FullParams:
    strategy: SamplingStrategy = SamplingStrategy.GREEDY
    n_threads: int = 4                  # host-side mel/IO threads
    n_max_text_ctx: int = 16_384
    offset_ms: int = 0
    duration_ms: int = 0
    flags: Flags = Flags.NONE
    language: Optional[str] = "en"

    # token-level timestamp thresholds (sFullParams.h:64-70)
    thold_pt: float = 0.01
    thold_ptsum: float = 0.01
    max_len: int = 0
    max_tokens: int = 0

    # encoder context override (sFullParams.h:74-75); 0 = full 1500
    audio_ctx: int = 0

    prompt_tokens: Optional[Sequence[int]] = None

    # beam search (BeamSearch strategy)
    beam_width: int = 5

    # batching: number of 30 s windows encoded/decoded together (an addition
    # over the reference, which is strictly one window at a time)
    batch_windows: int = 1

    new_segment_callback: Optional[NewSegmentCallback] = None
    encoder_begin_callback: Optional[EncoderBeginCallback] = None
    progress_callback: Optional[ProgressCallback] = None

    def flag(self, f: Flags) -> bool:
        return bool(self.flags & f)


def full_default_params(strategy: SamplingStrategy = SamplingStrategy.GREEDY) -> FullParams:
    """Reference fullDefaultParams (ContextImpl.misc.cpp:61-93)."""
    p = FullParams(strategy=strategy)
    if strategy == SamplingStrategy.BEAM_SEARCH:
        p.beam_width = 5
    p.flags = Flags.PRINT_PROGRESS | Flags.PRINT_TIMESTAMPS
    return p
