"""Token-level timestamps, segment wrapping, and signal energy.

Port of the reference's experimental token-timestamp pipeline:
  - ``voice_length`` pronunciation-cost heuristic (ContextImpl.cpp:173-207)
  - ``compute_signal_energy`` sliding |pcm| mean (Spectrogram.cpp:124-140)
  - ``compute_token_level_timestamps`` = whisper_exp_compute_token_level_
    timestamps: threshold-gated timestamp anchors, proportional interval
    fill by voice length, energy-based expand/contract
    (ContextImpl.cpp:218-419)
  - ``wrap_segment`` splits segments by a character budget
    (ContextImpl.misc.cpp:307-357)

Times are centiseconds throughout.

A copy of ``whisper_tpu.api.timestamps`` (numpy only), on the port's own
``SAMPLE_RATE``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from whisper_tpu_torch.hparams import SAMPLE_RATE


def voice_length(text: str) -> float:
    res = 0.0
    for c in text:
        if c.isdigit():
            res += 3.0
        elif c == " ":
            res += 0.01
        elif c == ",":
            res += 2.0
        elif c in ".!?":
            res += 3.0
        else:
            res += 1.0
    return res


def compute_signal_energy(samples: np.ndarray, half_window: int = 32) -> np.ndarray:
    """Mean |pcm| over a sliding window of 2*hw+1 samples."""
    a = np.abs(samples.astype(np.float32))
    kernel = np.ones(2 * half_window + 1, np.float32)
    s = np.convolve(a, kernel, mode="same")
    return s / len(kernel)


def _ts_to_sample(t: float, n_samples: int) -> int:
    return max(0, min(n_samples - 1, int(t * SAMPLE_RATE // 100)))


def _sample_to_ts(i: int) -> int:
    return (100 * i) // SAMPLE_RATE


@dataclasses.dataclass
class TimestampState:
    """Cross-segment carry-over (ContextImpl.h fields t_beg/t_last/tid_last)."""

    t_beg: int = 0
    t_last: int = 0
    tid_last: int = 0


def compute_token_level_timestamps(
    result_all,
    i_segment: int,
    vocab,
    thold_pt: float,
    thold_ptsum: float,
    energy: np.ndarray | None,
    state: TimestampState | None = None,
    n_samples=None,
) -> None:
    state = state if state is not None else TimestampState()
    segment = result_all[i_segment]
    tokens = segment.tokens
    if energy is None or len(energy) == 0:
        return
    n_samples = len(energy)

    t0, t1 = segment.t0, segment.t1
    n = len(tokens)
    if n == 0:
        return
    if n == 1:
        tokens[0].t0, tokens[0].t1 = t0, t1
        return

    for j, token in enumerate(tokens):
        if j == 0:
            if token.id == vocab.token_beg:
                tokens[0].t0 = t0
                tokens[0].t1 = t0
                tokens[1].t0 = t0
                state.t_beg = t0
                state.t_last = t0
                state.tid_last = vocab.token_beg
            else:
                tokens[0].t0 = state.t_last

        tt = state.t_beg + 2 * (token.tid - vocab.token_beg)
        token.vlen = voice_length(vocab.string(token.id) or "")

        if (
            token.pt > thold_pt
            and token.ptsum > thold_ptsum
            and token.tid > state.tid_last
            and tt <= t1
        ):
            if j > 0:
                tokens[j - 1].t1 = tt
            token.t0 = tt
            state.tid_last = token.tid

    tokens[n - 2].t1 = t1
    tokens[n - 1].t0 = t1
    tokens[n - 1].t1 = t1
    state.t_last = t1

    # proportional fill of unknown intervals by voice length
    p0 = 0
    p1 = 0
    while True:
        while p1 < n and tokens[p1].t1 < 0:
            p1 += 1
        if p1 >= n:
            p1 = n - 1
        if p1 > p0:
            psum = sum(tokens[j].vlen for j in range(p0, p1 + 1))
            dt = tokens[p1].t1 - tokens[p0].t0
            if psum > 0:
                for j in range(p0 + 1, p1 + 1):
                    ct = tokens[j - 1].t0 + dt * tokens[j - 1].vlen / psum
                    tokens[j - 1].t1 = int(ct)
                    tokens[j].t0 = int(ct)
        p1 += 1
        p0 = p1
        if p1 >= n:
            break

    # fix-up pass
    for j in range(n - 1):
        if tokens[j].t1 < 0:
            tokens[j + 1].t0 = tokens[j].t1
        if j > 0 and tokens[j - 1].t1 > tokens[j].t0:
            tokens[j].t0 = tokens[j - 1].t1
            tokens[j].t1 = max(tokens[j].t0, tokens[j].t1)

    # energy-based VAD expand/contract
    hw = SAMPLE_RATE // 8
    for j in range(n):
        if tokens[j].id >= vocab.token_eot:
            continue
        s0 = _ts_to_sample(tokens[j].t0, n_samples)
        s1 = _ts_to_sample(tokens[j].t1, n_samples)
        ss0 = max(s0 - hw, 0)
        ss1 = min(s1 + hw, n_samples)
        ns = ss1 - ss0
        if ns <= 0:
            continue
        thold = 0.5 * float(np.sum(energy[ss0:ss1])) / ns

        k = s0
        if energy[k] > thold and j > 0:
            while k > 0 and energy[k] > thold:
                k -= 1
            tokens[j].t0 = _sample_to_ts(k)
            if tokens[j].t0 < tokens[j - 1].t1:
                tokens[j].t0 = tokens[j - 1].t1
            else:
                s0 = k
        else:
            while k < s1 and energy[k] < thold:
                k += 1
            s0 = k
            tokens[j].t0 = _sample_to_ts(k)

        k = s1
        if energy[k] > thold:
            while k < n_samples - 1 and energy[k] > thold:
                k += 1
            tokens[j].t1 = _sample_to_ts(k)
            # (the reference compares against ns here — a bug it inherited
            # from whisper.cpp; we bound by the token count)
            if j < n - 1 and tokens[j].t1 > tokens[j + 1].t0:
                tokens[j].t1 = tokens[j + 1].t0
            else:
                s1 = k
        else:
            while k > s0 and energy[k] < thold:
                k -= 1
            s1 = k
            tokens[j].t1 = _sample_to_ts(k)


def wrap_segment(result_all, max_len: int, vocab) -> int:
    """Split the LAST segment so no piece exceeds ``max_len`` chars.
    Returns the number of segments the original became."""
    segment = result_all[-1]
    res = 1
    acc = 0
    text = ""
    i = 0
    tokens = segment.tokens
    while i < len(tokens):
        token = tokens[i]
        if token.id >= vocab.token_eot:
            i += 1
            continue
        txt = vocab.string(token.id) or ""
        cur = len(txt)
        if acc + cur > max_len and i > 0:
            cur_seg = result_all[-1]
            cur_seg.text = text
            cur_seg.t1 = token.t0
            rest = cur_seg.tokens[i:]
            cur_seg.tokens = cur_seg.tokens[:i]

            new_seg = type(segment)(text="", t0=token.t0, t1=segment.t1, tokens=rest)
            result_all.append(new_seg)

            acc = 0
            text = ""
            segment = new_seg
            tokens = new_seg.tokens
            i = 0
            res += 1
        else:
            acc += cur
            text += txt
            i += 1
    result_all[-1].text = text
    return res
