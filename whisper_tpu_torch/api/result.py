"""Transcription result model.

Mirrors the reference's sSegment / sToken / eResultFlags
(Whisper/API/TranscribeStructs.h:49-125). Times are kept in centiseconds
internally (whisper's native unit) and exposed both as seconds and as the
reference's 100 ns ticks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

TICKS_PER_CS = 100_000  # 100 ns ticks per centisecond (10 ms)


class ResultFlags(enum.IntFlag):
    NONE = 0
    TOKENS = 1
    TIMESTAMPS = 2


class TokenFlags(enum.IntFlag):
    NONE = 0
    SPECIAL = 1


@dataclasses.dataclass
class Token:
    id: int
    text: str
    t0: int = 0          # centiseconds
    t1: int = 0
    probability: float = 0.0
    # timestamp-token diagnostics (reference sTokenData, ContextImpl.h:31-43)
    pt: float = 0.0      # probability of the timestamp token
    ptsum: float = 0.0   # sum of all timestamp token probabilities
    tid: int = 0         # best timestamp token id
    vlen: float = 0.0    # voice length heuristic
    flags: TokenFlags = TokenFlags.NONE

    @property
    def time_seconds(self) -> tuple[float, float]:
        return self.t0 / 100.0, self.t1 / 100.0

    @property
    def ticks(self) -> tuple[int, int]:
        return self.t0 * TICKS_PER_CS, self.t1 * TICKS_PER_CS


class Speaker(enum.IntEnum):
    # Reference eSpeakerChannel (diarization result)
    UNSURE = 0
    LEFT = 1
    RIGHT = 2
    NO_STEREO_DATA = 3


@dataclasses.dataclass
class Segment:
    text: str
    t0: int              # centiseconds
    t1: int
    tokens: List[Token] = dataclasses.field(default_factory=list)
    speaker: Speaker = Speaker.NO_STEREO_DATA

    @property
    def time_seconds(self) -> tuple[float, float]:
        return self.t0 / 100.0, self.t1 / 100.0

    @property
    def ticks(self) -> tuple[int, int]:
        return self.t0 * TICKS_PER_CS, self.t1 * TICKS_PER_CS


@dataclasses.dataclass
class TranscribeResult:
    segments: List[Segment] = dataclasses.field(default_factory=list)
    flags: ResultFlags = ResultFlags.TIMESTAMPS | ResultFlags.TOKENS

    @property
    def text(self) -> str:
        return "".join(s.text for s in self.segments)

    def __iter__(self):
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)
