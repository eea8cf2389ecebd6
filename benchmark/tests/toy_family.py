"""A toy family for the harness's tests: a two-layer decoder-only model over a pooled mel, in plain torch.

``tiny.checkout`` writes this file into a checkout as
``benchmark/families/toydec.py``, beside a configuration whose
``model_type`` is ``toydec``. A window's log-mel is averaged into
``audio_tokens`` positions and projected to ``d_model``; the prompt's
tokens follow, then ``steps`` greedy tokens. The program computes in
float32, the whole sequence again for each token; the reference in
float64 from the raw weights drawn again, once over each sampled window's
prompt and served tokens. ``judge`` reads ``logit_err``: at the worst
served token, the larger of its logit's gap below the reference's best
and |log p - log p_ref|.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import check, devtrace
from benchmark.harness import Run
from benchmark.inputs import draw_pcm, sub_seed
from benchmark.reference import whisper_ref as ref
from benchmark.traffic import Traffic

HEAD = [1, 2]       # an item's first prompt
PREV = 3            # before a lane's carried text


def logits_of(w: dict, feats: torch.Tensor, ids: list, heads: int) -> torch.Tensor:
    """Logits [len(ids), V] after each token of ``ids``, behind the audio
    positions ``feats`` [A, n_mels], in ``w``'s dtype."""
    x = torch.cat([feats.to(w["audio"].dtype) @ w["audio"], w["tok"][torch.as_tensor(ids)]])[None]
    _, s, d = x.shape
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    for wqkv, wo, up, down in zip(w["qkv"], w["o"], w["up"], w["down"]):
        q, k, v = (F.layer_norm(x, (d,)) @ wqkv).view(1, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        att = (q @ k.transpose(-1, -2) / (d // heads) ** 0.5).masked_fill(~causal, float("-inf"))
        x = x + (att.softmax(-1) @ v).transpose(1, 2).reshape(1, s, d) @ wo
        x = x + torch.relu(F.layer_norm(x, (d,)) @ up) @ down
    return (F.layer_norm(x, (d,)) @ w["tok"].T)[0, len(feats):]


class Program:
    """The toy's system under test: greedy tokens in float32."""

    def __init__(self, raw: dict, heads: int):
        self.w = {k: v.float() for k, v in raw.items()}
        self.heads = heads

    def generate(self, feats: torch.Tensor, prompt: list, steps: int) -> tuple[np.ndarray, np.ndarray]:
        ids, tokens, p = list(prompt), [], []
        for _ in range(steps):
            logits = logits_of(self.w, feats, ids, self.heads)[-1]
            tok = int(logits.argmax())
            p.append(float(logits.softmax(-1)[tok]))
            ids.append(tok)
            tokens.append(tok)
        return np.array(tokens), np.array(p)


class Driver:
    KERNELS: dict = {}

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, run: Run, spans: devtrace.Spans):
        self.cfg, self.mix, self.seed, self.dev, self.run, self.spans = cfg, mix, seed, dev, run, spans
        self.filters = torch.from_numpy(ref.mel_filters(cfg["num_mel_bins"]))
        run.traced["toy_tokens"] = 0

    def draw(self) -> dict:
        c = self.cfg
        d, n, v, m = c["d_model"], c["layers"], c["vocab_size"], c["num_mel_bins"]
        gen = torch.Generator(device=self.dev).manual_seed(sub_seed(self.seed, 1))

        def randn(*shape, scale):
            return torch.randn(shape, generator=gen, device=self.dev) * scale

        return {"audio": randn(m, d, scale=m ** -0.5), "tok": randn(v, d, scale=1.0),
                "qkv": randn(n, d, 3 * d, scale=d ** -0.5), "o": randn(n, d, d, scale=d ** -0.5),
                "up": randn(n, d, 4 * d, scale=d ** -0.5), "down": randn(n, 4 * d, d, scale=(4 * d) ** -0.5)}

    def build(self, raw: dict) -> None:
        self.prog = Program(raw, self.cfg["heads"])
        self.n_weights = sum(t.numel() for t in raw.values())

    def serve(self) -> None:
        self.traffic = Traffic(self.mix, self.seed, self.cfg["window_frames"],
                               lambda past: [PREV, *past, *HEAD] if past else list(HEAD), self.cfg["carry_tokens"])
        self.pool = {k: draw_pcm(self.seed, k, secs, self.dev) for k, secs in self.traffic.recordings()}

    def features(self, item: int, seek: int) -> torch.Tensor:
        """The window's log-mel, averaged into ``audio_tokens`` positions [A, n_mels]."""
        frames, a = self.cfg["window_frames"], self.cfg["audio_tokens"]
        mel = ref.log_mel(self.pool[self.traffic.recording(item)[0]], self.filters)
        mel = F.pad(mel, (0, frames))[:, seek: seek + frames]
        return mel.T.reshape(a, frames // a, -1).mean(1)

    def round(self, count: bool) -> list:
        run, steps = self.run, self.traffic.steps
        t_in = time.perf_counter()
        wins = self.traffic.round()
        with self.spans("decode"):
            out = [self.prog.generate(self.features(w.item, w.seek), w.prompt, steps) for w in wins]
        lat = (time.perf_counter() - t_in) * 1e3
        for w, (tokens, p) in zip(wins, out):
            self.traffic.done(w, tokens, len(tokens))
            if count:
                run.records.append(dict(lane=w.lane, item=w.item, seek=w.seek, audio_s=w.audio_s,
                                        prompt=w.prompt, tokens=tokens, p=p, result_len=len(tokens)))
                run.latency_ms.append(lat)
                run.audio_s += w.audio_s
                run.flops += 2 * self.n_weights * (self.cfg["audio_tokens"] + len(w.prompt) + steps)
        return wins

    def traced(self, wins: list) -> None:
        self.run.traced["toy_tokens"] += len(wins) * self.traffic.steps

    def free(self) -> None:
        del self.prog

    def failed(self) -> int:
        return sum(1 for r in self.run.records if r["result_len"] != self.traffic.steps)

    def judge(self, controls: tuple = ()) -> dict:
        if controls:
            raise ValueError(f"the toy family has no control {controls}")
        run = self.run
        w = {k: v.double() for k, v in self.draw().items()}
        out = {"logit_err": 0.0, "windows": 0, "tokens": 0}
        for i in check.sample(run.records, run.lanes, self.seed):
            r = run.records[i]
            served = torch.as_tensor(r["tokens"], dtype=torch.long)
            ids = list(r["prompt"]) + served.tolist()[:-1]
            logits = logits_of(w, self.features(r["item"], r["seek"]).double(), ids,
                               self.cfg["heads"])[len(r["prompt"]) - 1:]
            rows = torch.arange(len(served))
            gap = logits.max(-1).values - logits[rows, served]
            lp = (torch.log(torch.as_tensor(r["p"], dtype=torch.float64))
                  - logits.log_softmax(-1)[rows, served]).abs()
            out["logit_err"] = max(out["logit_err"], float(torch.maximum(gap, lp).max()))
            out["windows"] += 1
            out["tokens"] += len(served)
        return out
