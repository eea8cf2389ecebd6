"""Transcription loop: the ``whisper_full`` port.

Counterpart of ``whisper_tpu.api.context`` (the reference's ``runFullImpl``,
ContextImpl.cpp:452-794), a host-side sliding-window loop:

  while seek+100 < seek_end:
      progress / encoder-begin callbacks
      encode(mel window at seek)                      [device]
      prompt = [_PREV_] + tail(prompt_past) + SOT(+lang)(+task)
      WindowResult = decode_window(...)               [device]
      failed -> seek += 100 (1 s penalty skip)        [host]
      segment assembly on timestamp tokens + callbacks [host]
      seek += seek_delta

Times are centiseconds (1 mel frame = 10 ms), the reference's native unit.

Beam search (``runtime/beam.py``), token-level timestamps and segment
wrapping (``api/timestamps.py``), stereo input with diarization
(``api/diarize.py``), streamed input (``run_streamed`` over
``features/stream.py``) and live capture with VAD (``run_capture`` over
``audio/capture.py``) are ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from whisper_tpu_torch.api.diarize import detect_speaker
from whisper_tpu_torch.api.params import Flags, FullParams, SamplingStrategy, full_default_params
from whisper_tpu_torch.api.result import Segment, Speaker, Token, TokenFlags, TranscribeResult
from whisper_tpu_torch.api.timestamps import (
    TimestampState,
    compute_signal_energy,
    compute_token_level_timestamps,
    wrap_segment,
)
from whisper_tpu_torch.audio.load import speedup_2x
from whisper_tpu_torch.features.stream import MelStreamer
from whisper_tpu_torch.languages import find_language_id
from whisper_tpu_torch.obs.profiler import Profiler
from whisper_tpu_torch.runtime.beam import decode_window_beam


class _TokenData:
    """Host mirror of the reference sTokenData (ContextImpl.h:31-43)."""

    __slots__ = ("id", "p", "pt", "ptsum", "tid", "t0", "t1", "vlen")

    def __init__(self, id, p, pt, ptsum, tid):
        self.id = int(id)
        self.p = float(p)
        self.pt = float(pt)
        self.ptsum = float(ptsum)
        self.tid = int(tid)
        self.t0 = -1
        self.t1 = -1
        self.vlen = 0.0


class Context:
    """Per-transcription state over a shared Model (iContext analogue)."""

    def __init__(self, model):
        self.model = model
        self.runtime = model.runtime
        self.vocab = model.vocab
        self.prompt_past: list[int] = []
        self.result_all: list[Segment] = []
        self.profiler = Profiler()
        self._ts_state = TimestampState()
        self._energy: Optional[np.ndarray] = None   # signal energy for token ts
        self._stereo: Optional[np.ndarray] = None   # stereo pcm for diarization
        self._mel_len = 0
        self._time_scale = 1                        # 2 under SpeedupAudio

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def run_full(self, params: Optional[FullParams], audio: np.ndarray) -> TranscribeResult:
        """Transcribe a full PCM clip (float32 mono 16 kHz; [N] or [2, N]
        stereo — stereo is downmixed for the model and kept for diarization,
        reference Spectrogram.cpp:104-120)."""
        params = params or full_default_params()
        with self.profiler.cpu("run_complete"):
            audio = np.asarray(audio, np.float32)
            if audio.ndim == 2:
                self._stereo = audio
                mono = audio.mean(axis=0)
            else:
                self._stereo = None
                mono = audio

            if params.flag(Flags.SPEEDUP_AUDIO):
                # 2x time-compress; the decode runs in compressed time and
                # _emit_segment scales times back (whisper.cpp:3044-3045).
                mono = speedup_2x(mono)

            with self.profiler.cpu("spectrogram"):
                mel = self.model.mel(mono).cpu().numpy()    # [n_mels, n_len]

            if params.flag(Flags.TOKEN_TIMESTAMPS):
                self._energy = compute_signal_energy(mono)

            return self._run_full_impl(params, mel)

    def run_streamed(self, params: Optional[FullParams], reader,
                     total_frames: Optional[int] = None) -> TranscribeResult:
        """Transcribe from a chunked audio reader (runStreamed analogue,
        ContextImpl.misc.cpp:391-419). ``reader`` yields float32 mono chunks;
        mel is computed incrementally and each 30 s window decodes as soon as
        its frames are buffered (MelStreamer semantics, MelStreamer.cpp:
        125-180). ``total_frames``: known stream length in mel frames
        (duration estimate); inferred at EOF otherwise."""
        params = params or full_default_params()
        streamer = MelStreamer(self.model.mel)
        if params.flag(Flags.SPEEDUP_AUDIO):
            reader = (speedup_2x(chunk) for chunk in reader)
        it = iter(reader)

        class _StreamSource:
            """iSpectrogram-style lazy window provider (iSpectrogram.h:12-45)."""

            def __init__(self):
                self.eof = False
                self.n_len = total_frames

            def _pull_until(self, frames_needed: int) -> None:
                while not self.eof and streamer.n_frames < frames_needed:
                    try:
                        streamer.append(np.asarray(next(it), np.float32))
                    except StopIteration:
                        self.eof = True
                        streamer.flush()
                        self.n_len = streamer.n_frames

            def length_bound(self) -> int:
                # known duration, or "at least this many" while streaming
                if self.n_len is not None:
                    return self.n_len
                return max(streamer.n_frames, 1)

            def window(self, seek: int, length: int) -> np.ndarray:
                self._pull_until(seek + length)
                return streamer.window(seek, length)

        src = _StreamSource()
        # need at least 1 s to start (ContextImpl.cpp:470-473)
        src._pull_until(101)
        return self._run_full_impl(params, src)

    def run_capture(self, params: Optional[FullParams], source, capture_params=None,
                    on_status=None, should_cancel=None) -> TranscribeResult:
        """Real-time capture transcription (runCapture analogue,
        ContextImpl.capture.cpp:398-429). ``source`` is an iterable of
        float32 mono chunks @ 16 kHz (e.g. audio.capture.sounddevice_source).
        Each VAD-segmented buffer is one ``run_full`` on the runner's worker
        thread; the segments accumulate across buffers."""
        from whisper_tpu_torch.audio.capture import CaptureParams, CaptureRunner

        params = params or full_default_params()
        all_segments: list[Segment] = []

        def on_transcribe(pcm: np.ndarray):
            res = self.run_full(params, pcm)
            all_segments.extend(res.segments)

        runner = CaptureRunner(
            on_transcribe,
            capture_params or CaptureParams(),
            on_status=on_status,
            should_cancel=should_cancel,
        )
        runner.run(source)
        self.result_all = all_segments
        return TranscribeResult(segments=list(all_segments))

    # ------------------------------------------------------------------
    # the main loop
    # ------------------------------------------------------------------

    def _run_full_impl(self, params: FullParams, mel) -> TranscribeResult:
        """``mel``: a dense [n_mels, n_len] array, or a streamed source with
        ``window(seek, length)``, ``length_bound()`` and ``eof``."""
        dims = self.runtime.dims
        self.result_all = []
        self._time_scale = 2 if params.flag(Flags.SPEEDUP_AUDIO) else 1

        if isinstance(mel, np.ndarray):
            mel_arr = mel

            class _DenseSource:
                eof = True

                def length_bound(self) -> int:
                    return mel_arr.shape[1]

                def window(self, seek: int, length: int) -> np.ndarray:
                    out = np.zeros((mel_arr.shape[0], length), mel_arr.dtype)
                    avail = mel_arr[:, seek : seek + length]
                    out[:, : avail.shape[1]] = avail
                    return out

            src = _DenseSource()
        else:
            src = mel

        def current_seek_end(seek_start: int) -> int:
            if params.duration_ms:
                return seek_start + params.duration_ms // 10
            if src.eof:
                return src.length_bound()
            return seek_start + 10**9  # unknown-length stream: no end of audio yet

        seek_start = params.offset_ms // 10
        self._mel_len = src.length_bound()

        # skip clips shorter than 1 s (ContextImpl.cpp:470-473)
        if current_seek_end(seek_start) < 100 + seek_start:
            return TranscribeResult(segments=[])

        if params.flag(Flags.NO_CONTEXT):
            self.prompt_past = []
        if params.prompt_tokens:
            self.prompt_past = list(params.prompt_tokens) + self.prompt_past

        audio_ctx = params.audio_ctx or dims.n_audio_ctx
        if not (0 < audio_ctx <= dims.n_audio_ctx):
            raise ValueError(f"audio_ctx {audio_ctx} out of range")

        prompt_init = self.build_prompt_init(params)
        window = 2 * audio_ctx
        seek = seek_start
        cap = self.runtime.prompt_capacity

        while True:
            with self.profiler.cpu("spectrogram"):
                # lazy pull: streamed sources buffer mel here
                mel_win = src.window(seek, window)
            seek_end = current_seek_end(seek_start)
            self._mel_len = src.length_bound()

            if params.progress_callback:
                with self.profiler.cpu("callbacks"):
                    params.progress_callback(
                        min(1.0, (seek - seek_start) / max(1, seek_end - seek_start))
                    )
            if seek + 100 >= seek_end:
                break
            if params.encoder_begin_callback:
                with self.profiler.cpu("callbacks"):
                    if not params.encoder_begin_callback(self):
                        break

            with self.profiler.cpu("encode"):
                _, cross_kv = self.runtime.encode_window(mel_win[None])

            prompt = self._build_prompt(params, prompt_init)
            padded = np.zeros((1, cap), np.int32)
            padded[0, : len(prompt)] = prompt

            with self.profiler.cpu("decode"):
                if params.strategy == SamplingStrategy.BEAM_SEARCH:
                    res = self._run_window_beam(params, padded, len(prompt), cross_kv, seek, seek_end)
                else:
                    res = self.runtime.run_window(
                        padded,
                        np.full((1,), len(prompt), np.int32),
                        cross_kv,
                        np.full((1,), seek, np.int32),
                        np.full((1,), seek_end, np.int32),
                        max_tokens=params.max_tokens,
                        single_segment=params.flag(Flags.SINGLE_SEGMENT),
                    )
                # one host transfer per window
                res = {k: v.cpu().numpy() for k, v in res._asdict().items()}

            seek = self.apply_window_result(params, res, seek, lane=0)

        if params.progress_callback:
            params.progress_callback(1.0)
        return TranscribeResult(segments=list(self.result_all))

    # ------------------------------------------------------------------
    # per-window steps
    # ------------------------------------------------------------------

    def build_prompt_init(self, params: FullParams) -> list[int]:
        """SOT (+language)(+task) head (ContextImpl.cpp:491-512)."""
        vocab = self.vocab
        prompt_init = [vocab.token_sot]
        if vocab.multilingual:
            lang_id = find_language_id(params.language)
            if lang_id < 0:
                raise ValueError(f"unknown language {params.language!r}")
            if lang_id >= vocab.num_languages:
                raise ValueError(
                    f"language {params.language!r} requires a model with "
                    f">{vocab.num_languages} language tokens (large-v3 family)"
                )
            prompt_init.append(vocab.token_sot + 1 + lang_id)
            prompt_init.append(
                vocab.token_translate if params.flag(Flags.TRANSLATE) else vocab.token_transcribe
            )
        return prompt_init

    def _build_prompt(self, params: FullParams, prompt_init: list[int]) -> list[int]:
        """[_PREV_] + tail of accumulated context + head (ContextImpl.cpp:562-576)."""
        vocab = self.vocab
        dims = self.runtime.dims
        prompt: list[int] = []
        if self.prompt_past:
            n_take = min(params.n_max_text_ctx, dims.n_text_ctx // 2, len(self.prompt_past))
            prompt = [vocab.token_prev] + self.prompt_past[-n_take:]
            self.prompt_past = self.prompt_past[-n_take:]
        return prompt + prompt_init

    def apply_window_result(self, params: FullParams, res: dict, seek: int, lane: int) -> int:
        """Consume one lane of a host-side WindowResult dict (shared with the
        batched scheduler, runtime/batch.py): failure skip,
        prompt_past growth, segment assembly. Returns the advanced seek."""
        if bool(res["failed"][lane]):
            # "failed to generate timestamp token - skipping one second"
            return seek + 100

        result_len = int(res["result_len"][lane])
        seek_delta = int(res["seek_delta"][lane])
        tokens_cur = [
            _TokenData(
                res["tokens"][lane, i], res["p"][lane, i], res["pt"][lane, i],
                res["ptsum"][lane, i], res["tid"][lane, i],
            )
            for i in range(result_len)
        ]
        for t in tokens_cur:
            self.prompt_past.append(t.id)
        self._assemble_segments(params, tokens_cur, seek, seek_delta)
        return seek + seek_delta

    # ------------------------------------------------------------------
    # segment assembly (ContextImpl.cpp:689-784)
    # ------------------------------------------------------------------

    def _emit_segment(self, params: FullParams, t0: int, t1: int, text: bytes,
                      tokens: list[_TokenData]):
        vocab = self.vocab
        seg = Segment(
            text=text.decode("utf-8", errors="replace"),
            t0=t0,
            t1=t1,
            tokens=[
                Token(
                    id=t.id,
                    text=vocab.string(t.id) or "",
                    t0=t.t0,
                    t1=t.t1,
                    probability=t.p,
                    pt=t.pt,
                    ptsum=t.ptsum,
                    tid=t.tid,
                    vlen=t.vlen,
                    flags=TokenFlags.SPECIAL if t.id >= vocab.token_eot else TokenFlags.NONE,
                )
                for t in tokens
            ],
        )
        scale = self._time_scale
        if self._stereo is not None:
            # stereo PCM is uncompressed: index it with real-time bounds
            seg.speaker = detect_speaker(self._stereo, t0 * scale, t1 * scale)
        self.result_all.append(seg)

        n_new = 1
        if params.flag(Flags.TOKEN_TIMESTAMPS):
            compute_token_level_timestamps(
                self.result_all, len(self.result_all) - 1, vocab,
                params.thold_pt, params.thold_ptsum,
                energy=self._energy, state=self._ts_state,
            )
            if params.max_len > 0:
                n_new = wrap_segment(self.result_all, params.max_len, vocab)
        if scale != 1:
            # SpeedupAudio: decode ran in compressed time; real times are 2x
            # (reference whisper.cpp:3044-3045, ContextImpl.cpp:708-712)
            for s in self.result_all[-n_new:]:
                s.t0 *= scale
                s.t1 *= scale
                for t in s.tokens:
                    t.t0 *= scale
                    t.t1 *= scale
        if params.new_segment_callback:
            with self.profiler.cpu("callbacks"):
                params.new_segment_callback(self, n_new)

    def _assemble_segments(self, params: FullParams, tokens_cur: list[_TokenData],
                           seek: int, seek_delta: int):
        vocab = self.vocab
        if not tokens_cur:
            return
        single = params.flag(Flags.SINGLE_SEGMENT)
        i0 = 0
        t0 = seek + 2 * (tokens_cur[0].tid - vocab.token_beg)
        text = b""
        i = 0
        n = len(tokens_cur)
        while i < n:
            tk = tokens_cur[i]
            if params.flag(Flags.PRINT_SPECIAL) or tk.id < vocab.token_eot:
                text += vocab.bytes(tk.id) or b""
            if tk.id > vocab.token_beg and not single:
                t1 = seek + 2 * (tk.tid - vocab.token_beg)
                if text:
                    self._emit_segment(params, t0, t1, text, tokens_cur[i0 : i + 1])
                text = b""
                # skip consecutive timestamp tokens
                while i < n and tokens_cur[i].id > vocab.token_beg:
                    i += 1
                i -= 1
                t0 = t1
                i0 = i + 1
            i += 1
        if text:
            t1 = seek + seek_delta
            self._emit_segment(params, t0, t1, text, tokens_cur[i0:])

    # ------------------------------------------------------------------

    def _run_window_beam(self, params, padded, prompt_len, cross_kv, seek, seek_end):
        return decode_window_beam(self.runtime, params, padded, prompt_len, cross_kv, seek, seek_end)

    @property
    def results(self) -> TranscribeResult:
        return TranscribeResult(segments=list(self.result_all))

    def detect_speaker(self, t0: int, t1: int) -> Speaker:
        """Stereo-energy diarization over a time interval in centiseconds
        (ContextImpl.diarize.cpp:17-108)."""
        if self._stereo is None:
            return Speaker.NO_STEREO_DATA
        return detect_speaker(self._stereo, t0, t1)

    def timings_print(self) -> str:
        """timingsPrint analogue: host phases, RTF, the runtime's spans on
        the card's clock (encode, cross_kv, ingest, steps with ms per step;
        recorded while ``TRACER`` is on) and graph captures, and device
        memory."""
        from whisper_tpu_torch.obs.profiler import TRACER, device_memory_stats

        lines = [self.profiler.report(), TRACER.report()]
        total = self.profiler.get("run_complete")
        if total > 0 and self._mel_len:
            audio_s = self._mel_len / 100.0
            lines.append(f"audio: {audio_s:.1f}s in {total:.2f}s -> RTF {audio_s/total:.2f}")
        for dev, stats in device_memory_stats().items():
            lines.append(
                f"device {dev}: {stats['bytes_in_use']/1e9:.2f} GB in use, "
                f"peak {stats['peak_bytes_in_use']/1e9:.2f} GB"
            )
        report = "\n".join(lines)
        print(report)
        return report

    def timings_reset(self) -> None:
        self.profiler.reset()
