"""Vocabulary: token strings, special ids, and the greedy tokenizer.

Behavioral spec from the reference (Whisper/Whisper/Vocabulary.cpp):
  - base special ids are the English-model values; a multilingual vocab
    (n_vocab == 51865) shifts eot/sot/prev/solm/not/beg by +1
    (Vocabulary.cpp:110-121); task tokens translate=50358 / transcribe=50359
    are fixed (Vocabulary.h:34-36). Beyond the reference: n_vocab > 51865
    (large-v3 family, 100 languages) derives every post-language special from
    the language count, matching openai's v3 tokenizer layout.
  - ids beyond the stored word list are synthesized: "[_TT_%i]" past
    token_beg, named specials, "[_extra_token_%i]" otherwise
    (Vocabulary.cpp:123-141)
  - ``tokenize`` is the whisper.cpp scheme: GPT-2-style regex word split,
    then greedy longest-prefix match against the vocab
    (Vocabulary.cpp:158-222)

Tokens are raw UTF-8 byte strings; segment text is assembled by concatenating
token bytes and decoding once (multi-byte codepoints may span tokens).
"""

from __future__ import annotations

import dataclasses
import re

# GPT-2 text splitter. The reference uses std::regex with ASCII classes
# (Vocabulary.cpp:166); unicode-aware classes here handle multilingual text
# identically for ASCII and strictly better otherwise.
_SPLIT_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+"      # optional space + letters
    r"| ?\d+"            # optional space + digits
    r"| ?[^\s\w]+"       # optional space + other non-space symbols
    r"|\s+(?!\S)|\s+",
    re.UNICODE,
)


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Mirrors the reference SpecialTokens struct (Whisper/API/SpecialTokens.h)."""

    transcription_end: int      # EOT
    transcription_start: int    # SOT
    previous_word: int          # [_PREV_]
    sentence_start: int         # solm
    not_token: int              # no-timestamps
    transcription_begin: int    # first timestamp token [_BEG_] = t0.00
    task_translate: int = 50_358
    task_transcribe: int = 50_359


class Vocabulary:
    """Token table + special ids, built from GGML vocab words."""

    def __init__(self, words: list[bytes], n_vocab: int):
        if n_vocab <= 0:
            raise ValueError("n_vocab must be positive")
        self.n_vocab = n_vocab
        self.multilingual = n_vocab >= 51_865

        if self.multilingual:
            # n_vocab == 51865: v1/v2 layout (reference Vocabulary.cpp:
            # 110-121, +1 shift). Each extra token beyond that is an extra
            # language slot (large-v3 adds "yue", n_vocab == 51866), pushing
            # every post-language special up by the same amount.
            self.num_languages = 99 + (n_vocab - 51_865)
            self.token_eot = 50_257
            self.token_sot = 50_258
            # languages occupy sot+1 .. sot+num_languages
            self.token_translate = self.token_sot + 1 + self.num_languages
            self.token_transcribe = self.token_translate + 1
            self.token_prev = self.token_transcribe + 2   # <|startofprev|>
            self.token_solm = self.token_transcribe + 3   # <|nospeech|> slot
            self.token_not = self.token_transcribe + 4    # <|notimestamps|>
            self.token_beg = self.token_transcribe + 5    # first timestamp
        else:
            # English-model base ids (Vocabulary.h:27-36)
            self.num_languages = 99
            self.token_eot = 50_256
            self.token_sot = 50_257
            self.token_prev = 50_360
            self.token_solm = 50_361
            self.token_not = 50_362
            self.token_beg = 50_363
            self.token_translate = 50_358
            self.token_transcribe = 50_359

        count = max(n_vocab, len(words))
        self.tokens: list[bytes] = list(words) + [b""] * (count - len(words))
        for i in range(len(words), count):
            if i > self.token_beg:
                self.tokens[i] = b"[_TT_%d]" % (i - self.token_beg)
            elif i == self.token_eot:
                self.tokens[i] = b"[_EOT_]"
            elif i == self.token_sot:
                self.tokens[i] = b"[_SOT_]"
            elif i == self.token_prev:
                self.tokens[i] = b"[_PREV_]"
            elif i == self.token_not:
                self.tokens[i] = b"[_NOT_]"
            elif i == self.token_beg:
                self.tokens[i] = b"[_BEG_]"
            else:
                self.tokens[i] = b"[_extra_token_%d]" % i

        self._id_from_token: dict[bytes, int] = {}
        for i, t in enumerate(self.tokens):
            self._id_from_token.setdefault(t, i)
        self._max_token_len = max((len(t) for t in self.tokens), default=0)

    def __len__(self) -> int:
        return len(self.tokens)

    def string(self, token_id: int) -> str | None:
        """Display string for a token id (lossy for partial UTF-8)."""
        b = self.bytes(token_id)
        return None if b is None else b.decode("utf-8", errors="replace")

    def bytes(self, token_id: int) -> bytes | None:
        if 0 <= token_id < len(self.tokens):
            return self.tokens[token_id]
        return None

    def find_id(self, token: bytes | str) -> int:
        if isinstance(token, str):
            token = token.encode("utf-8")
        return self._id_from_token.get(token, -1)

    @property
    def special_tokens(self) -> SpecialTokens:
        return SpecialTokens(
            transcription_end=self.token_eot,
            transcription_start=self.token_sot,
            previous_word=self.token_prev,
            sentence_start=self.token_solm,
            not_token=self.token_not,
            transcription_begin=self.token_beg,
        )

    def is_special(self, token_id: int) -> bool:
        return token_id >= self.token_eot

    def timestamp_token(self, seconds: float) -> int:
        """Timestamp token for t seconds (0.02 s granularity)."""
        return self.token_beg + int(round(seconds / 0.02))

    def timestamp_seconds(self, token_id: int) -> float:
        return (token_id - self.token_beg) * 0.02

    def tokenize(self, text: str) -> list[int]:
        """whisper.cpp greedy tokenizer (reference Vocabulary.cpp:158-222)."""
        out: list[int] = []
        for word in _SPLIT_RE.findall(text):
            wb = word.encode("utf-8")
            i, n = 0, len(wb)
            while i < n:
                # longest match first
                j = min(n, i + self._max_token_len)
                while j > i:
                    tid = self._id_from_token.get(wb[i:j], -1)
                    if tid >= 0:
                        out.append(tid)
                        i = j
                        break
                    j -= 1
                else:
                    # single byte fallback; unknown bytes are skipped with
                    # an error in the reference — raise here instead.
                    tid = self._id_from_token.get(wb[i : i + 1], -1)
                    if tid < 0:
                        raise ValueError(f"unknown token {wb[i:i+1]!r}")
                    out.append(tid)
                    i += 1
        return out

    def decode_text(self, token_ids, include_special: bool = False) -> str:
        """Concatenate token bytes and decode (text tokens only by default)."""
        parts = []
        for t in token_ids:
            t = int(t)
            if not include_special and t >= self.token_eot:
                continue
            b = self.bytes(t)
            if b:
                parts.append(b)
        return b"".join(parts).decode("utf-8", errors="replace")
