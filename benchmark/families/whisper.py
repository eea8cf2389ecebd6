"""The Whisper family: OpenAI's encoder-decoder as ``whisper_tpu_torch`` serves it.

A configuration whose ``model_type`` is ``whisper`` (OpenAI's ``config.json``
names, and the program's ``dtype_policy`` and ``kv_int8``) runs here. The
family's parts stay in the modules that hold them, which only this driver
reaches: ``benchmark.inputs`` (``Dims``; ``draw_raw``, the raw weights in
the checkpoint's layout; ``draw_pcm``, the audio), ``benchmark.program``
(the port built from them), ``benchmark.counts.Work`` (the windows'
operations and K1's and K2's bounds), ``benchmark.check`` and
``benchmark.reference.whisper_ref`` (the comparison that decides
``correct``).

A round: a new item's mel (its first window), the lanes' 30 s windows
encoded together, one window decode of ``steps`` forced token steps, the
result on the host, the prompts carried. A window's prompt is [sot, en,
transcribe], after [prev] and the last n_text_ctx/2 tokens of its lane's
text where the mix carries text.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import check, devtrace
from benchmark.counts import Work
from benchmark.harness import Run, log
from benchmark.inputs import Dims, draw_pcm, draw_raw
from benchmark.reference import whisper_ref as ref
from benchmark.traffic import Traffic


class Driver:
    """One seed's Whisper model, its program, traffic and audio."""

    # K1 and K2 in the device trace, by fragments of their kernels' names
    KERNELS = {"k1": "flash_attention_kernel", "k2": "decode_attention",
               "k2_split": "decode_attention_kernel", "k2_combine": "decode_attention_combine"}

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, run: Run, spans: devtrace.Spans):
        import benchmark.program  # noqa: F401  the program, after the card check and before any draw
        self.cfg, self.mix, self.seed, self.dev, self.run, self.spans = cfg, mix, seed, dev, run, spans
        self.dims = dims = Dims(cfg)
        self.sp = ref.specials(dims.n_vocab)
        self.work = Work(dims, cfg["kv_int8"])
        self.filters = ref.mel_filters(dims.n_mels)
        # the traced rounds' work: K1's and K2's bounds and the kernels they launch
        run.traced.update(k1_bound_s=0.0, k1_kernels=0, k2_bound_s=0.0, k2_calls=0)
        self.item_mel: dict[int, torch.Tensor] = {}

    def draw(self) -> dict:
        return draw_raw(self.dims, self.seed, self.dev)

    def build(self, raw: dict) -> None:
        from benchmark.program import Program
        self.prog = Program(raw, self.dims, self.sp, self.cfg, self.filters, self.dev)

    def serve(self) -> None:
        sp, dims = self.sp, self.dims
        head = [sp.sot, sp.lang(0), sp.transcribe]        # language 0 is English
        self.traffic = Traffic(self.mix, self.seed, dims.window_frames,
                               lambda past: [sp.prev, *past, *head] if past else list(head),
                               dims.n_text_ctx // 2)
        self.pool = {k: draw_pcm(self.seed, k, secs, self.dev) for k, secs in self.traffic.recordings()}

    def round(self, count: bool) -> list:
        """One round of every lane's next window; ``count``: a round of the
        measured window, whose windows and work are recorded."""
        run, traffic, prog, spans = self.run, self.traffic, self.prog, self.spans
        frames = self.dims.window_frames
        t_in = time.perf_counter()
        wins = traffic.round()
        for w in wins:
            if w.item not in self.item_mel:
                for old in [k for k in self.item_mel if k not in {x.item for x in wins}]:
                    del self.item_mel[old]
                rec, secs = traffic.recording(w.item)
                with spans("mel"):
                    m = prog.mel(self.pool[rec])
                if count:
                    run.mel_audio_s += secs
                self.item_mel[w.item] = torch.nn.functional.pad(m, (0, frames))
        mel = torch.stack([self.item_mel[w.item][:, w.seek: w.seek + frames] for w in wins])
        with spans("encode"):
            cross = prog.encode(mel)
        prompt = np.zeros((len(wins), prog.prompt_capacity), np.int32)
        for i, w in enumerate(wins):
            prompt[i, : len(w.prompt)] = w.prompt
        plen = np.array([len(w.prompt) for w in wins], np.int32)
        with spans("decode"):
            res = prog.decode(prompt, plen, cross, np.array([w.seek for w in wins], np.int32),
                              np.array([w.seek_end for w in wins], np.int32), traffic.steps)
        lat = (time.perf_counter() - t_in) * 1e3
        del cross
        with torch.profiler.record_function(devtrace.SPAN + "host"):
            for i, w in enumerate(wins):
                rl = int(res["result_len"][i])
                traffic.done(w, res["tokens"][i], rl)
                if count:
                    run.records.append(dict(lane=w.lane, item=w.item, seek=w.seek, audio_s=w.audio_s,
                                            prompt=w.prompt, tokens=res["tokens"][i].copy(), p=res["p"][i].copy(),
                                            result_len=rl, seek_delta=int(res["seek_delta"][i]),
                                            failed=bool(res["failed"][i])))
                    run.latency_ms.append(lat)
                    run.audio_s += w.audio_s
                    run.flops += self.work.window_flops(len(w.prompt), traffic.steps)
        if count:
            run.flops += self.work.encode_flops(len(wins))
        return wins

    def traced(self, wins: list) -> None:
        """A traced round's K1 and K2 work, into ``run.traced``."""
        tr, dims, steps = self.run.traced, self.dims, self.traffic.steps
        tr["k1_bound_s"] += self.work.k1_bound_s(len(wins))
        tr["k1_kernels"] += dims.enc_layers
        tr["k2_bound_s"] += self.work.k2_bound_s([len(w.prompt) for w in wins], steps)
        tr["k2_calls"] += steps * dims.dec_layers * 2     # self and cross

    def free(self) -> None:
        del self.prog
        self.item_mel.clear()

    def failed(self) -> int:
        """Windows whose result is out of range (the window rule's own
        ``failed`` flag is a transcription outcome, not a failure)."""
        n_max = self.dims.n_text_ctx // 2 - 4
        return sum(1 for r in self.run.records if not (0 <= r["result_len"] <= n_max and r["seek_delta"] >= 0))

    def judge(self, controls: tuple = ()) -> dict:
        """The check of a sample of the window's windows (after ``free``):
        ``benchmark.check.judge`` at the configuration's tier, and at each
        control's lower precision (``fp8``, ``int4``)."""
        run, cfg = self.run, self.cfg
        picked = check.sample(run.records, run.lanes, self.seed)
        prec = ref.Precision(weights_int8=cfg["dtype_policy"] == "serving", kv_int8=cfg["kv_int8"])
        t3 = time.perf_counter()
        raw = self.draw()
        verdict = check.judge(run.records, picked, raw, self.dims, self.sp, prec,
                              lambda item: self.pool[self.traffic.recording(item)[0]],
                              torch.from_numpy(self.filters), self.traffic.steps, self.dev,
                              controls=tuple(dataclasses.replace(prec, lower=c) for c in controls))
        log(f"check: {verdict['windows']} windows, {verdict['tokens']} served tokens against the "
            f"reference in {time.perf_counter() - t3:.1f} s; widest gap {verdict['gap']!r}, widest "
            f"log-probability error {verdict['logp_err']!r}, mean {verdict['logp_mean_err']!r}; rules mismatches {verdict['rules_mismatch']}, "
            f"banned tokens {verdict['banned']}, windows compared only in part {verdict['truncated']}")
        return verdict
