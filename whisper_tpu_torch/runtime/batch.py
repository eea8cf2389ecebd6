"""Batched multi-utterance transcription scheduler.

Counterpart of ``whisper_tpu.runtime.batch``. The reference serves
concurrent transcriptions by cloning the model per thread on one GPU
(ModelImpl.cpp:40-60); here N utterances' 30 s windows ride the batch
dimension of one encode and one window decode, so weight reads amortize
across lanes.

Scheduling: each utterance owns a Context (prompt carry-over, segments);
every round, up to ``batch`` unfinished utterances contribute their next
window; finished lanes are refilled from the queue; short rounds pad with
dead lanes (seek_end = 0 ends them at their first step, and their output is
discarded). The width stays ``batch`` in every round: the port recompiles
nothing, but a fixed width keeps each lane's results, and the kernels'
launch shapes, equal to the JAX scheduler's.

Feature parity with Context.run_full: SPEEDUP_AUDIO compresses each lane's
PCM before mel; TOKEN_TIMESTAMPS computes per-lane signal energy; stereo
clips are downmixed and kept per lane for diarization; progress callbacks
fire per round with each utterance's own progress. Beam search composes
with batching: the utterances' beams ride [batch*beam] lanes of one decode
(runtime/beam.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from whisper_tpu_torch.api.params import Flags, FullParams, SamplingStrategy, full_default_params
from whisper_tpu_torch.api.result import TranscribeResult
from whisper_tpu_torch.api.timestamps import compute_signal_energy
from whisper_tpu_torch.audio.load import speedup_2x
from whisper_tpu_torch.runtime.beam import decode_window_beam


@dataclasses.dataclass
class _Lane:
    ctx: "object"
    mel: np.ndarray           # zero-padded [n_mels, n_len + window]
    n_len: int
    seek: int
    seek_start: int
    seek_end: int
    prompt_init: list
    done: bool = False


class BatchTranscriber:
    def __init__(self, model, batch: int = 8):
        self.model = model
        self.batch = batch

    def transcribe(
        self,
        clips: Sequence[np.ndarray],
        params: Optional[FullParams] = None,
    ) -> list[TranscribeResult]:
        params = params or full_default_params()
        single_segment = params.flag(Flags.SINGLE_SEGMENT)
        beam_search = params.strategy == SamplingStrategy.BEAM_SEARCH
        rt = self.model.runtime
        dims = rt.dims
        window = 2 * (params.audio_ctx or dims.n_audio_ctx)
        cap = rt.prompt_capacity

        # build lanes: Context.run_full's per-clip preprocessing
        pending: list[_Lane] = []
        results: list[Optional[TranscribeResult]] = [None] * len(clips)
        lanes_by_idx: dict[int, _Lane] = {}
        for idx, clip in enumerate(clips):
            ctx = self.model.create_context()
            mono = np.asarray(clip, np.float32)
            if mono.ndim == 2:
                ctx._stereo = mono
                mono = mono.mean(axis=0)
            if params.flag(Flags.SPEEDUP_AUDIO):
                mono = speedup_2x(mono)
                ctx._time_scale = 2
            if params.flag(Flags.TOKEN_TIMESTAMPS):
                ctx._energy = compute_signal_energy(mono)
            mel = self.model.mel(mono).cpu().numpy()
            n_len = mel.shape[1]
            ctx._mel_len = n_len
            mel_pad = np.zeros((mel.shape[0], n_len + window), mel.dtype)
            mel_pad[:, :n_len] = mel
            seek_start = params.offset_ms // 10
            seek_end = seek_start + (params.duration_ms // 10 if params.duration_ms else n_len)
            if params.flag(Flags.NO_CONTEXT):
                ctx.prompt_past = []
            if params.prompt_tokens:
                ctx.prompt_past = list(params.prompt_tokens) + ctx.prompt_past
            lane = _Lane(
                ctx=ctx, mel=mel_pad, n_len=n_len, seek=seek_start,
                seek_start=seek_start, seek_end=seek_end,
                prompt_init=ctx.build_prompt_init(params),
            )
            if seek_end < 100 + seek_start:
                lane.done = True
                results[idx] = TranscribeResult(segments=[])
            lanes_by_idx[idx] = lane
            if not lane.done:
                pending.append(lane)

        active: list[_Lane] = []
        while pending or active:
            # refill the active set
            while pending and len(active) < self.batch:
                active.append(pending.pop(0))

            if params.progress_callback:
                # per-utterance progress, like run_full
                for lane in active:
                    params.progress_callback(
                        min(1.0, (lane.seek - lane.seek_start)
                            / max(1, lane.seek_end - lane.seek_start))
                    )

            # fixed batch width: dead pad lanes (seek_end=0) finish at their
            # first step and are discarded
            b = self.batch
            mel_batch = np.zeros((b, dims.n_mels, window), np.float32)
            prompts = np.zeros((b, cap), np.int32)
            prompts[:, 0] = rt.ids.sot
            plens = np.ones((b,), np.int32)
            seeks = np.zeros((b,), np.int32)
            ends = np.zeros((b,), np.int32)
            for i, lane in enumerate(active):
                mel_batch[i] = lane.mel[:, lane.seek : lane.seek + window]
                p = lane.ctx._build_prompt(params, lane.prompt_init)
                prompts[i, : len(p)] = p
                plens[i] = len(p)
                seeks[i] = lane.seek
                ends[i] = lane.seek_end

            _, cross = rt.encode_window(mel_batch)
            if beam_search:
                res = decode_window_beam(rt, params, prompts, plens, cross, seeks, ends)
            else:
                res = rt.run_window(
                    prompts, plens, cross, seeks, ends,
                    max_tokens=params.max_tokens, single_segment=single_segment,
                )
            res = {k: v.cpu().numpy() for k, v in res._asdict().items()}

            for i, lane in enumerate(active):
                lane.seek = lane.ctx.apply_window_result(params, res, lane.seek, lane=i)
                if lane.seek + 100 >= lane.seek_end:
                    lane.done = True
                    if params.progress_callback:
                        params.progress_callback(1.0)
            active = [lane for lane in active if not lane.done]

        # results in submission order
        out: list[TranscribeResult] = []
        for idx in range(len(clips)):
            if results[idx] is not None:
                out.append(results[idx])
            else:
                out.append(TranscribeResult(segments=list(lanes_by_idx[idx].ctx.result_all)))
        return out
