"""The omni family: Uni-MoE-2.0-Omni's audio-to-text path as ``whisper_tpu_torch`` serves it.

A configuration whose ``model_type`` is ``grin_qwen2_vl`` (the published
``config.json``'s keys, the assumed encoder sizes and ``audio_token_id``)
runs here, through the program's own loader (``model/omni_params.py:
params_from_tensors``) and entry points (``runtime/omni.py:OmniContext``:
``encode_window``, ``run_window``). Its plain reference is
``benchmark/reference/omni_ref.py``, its bounds' arithmetic
``benchmark/counts_omni.py``.

Weights are drawn on the device by checkpoint name, in groups each from a
stream of its own (the connector, embeddings and head; the audio tower;
each language-model layer), so that the check draws one layer again at a
time after the program is freed. Matmul weights are bf16, N(0, 1/fan_in)
(the untied head too), embeddings N(0, 0.02^2); norms, biases and the
router f32: gains 1 + N(0, 0.05^2), biases N(0, 0.02^2), router N(0, 1/d).

A round: a new item's mel (its first window), the lanes' 30 s windows
encoded together (encoder and connector: 300 audio tokens each), one
window of ``steps`` forced greedy steps after an eager prefill, the result
on the host, the lanes' text carried. A window's prompt: a 24-token head
(system turn and the user turn's opening) and a 12-token tail
(instruction and the assistant's opening), both drawn once per seed, and
between them the lane's last 112 served tokens where the mix carries text
and the window's 300 audio placeholders; right-padded to 448.

``correct``: a sample of the windows (one a lane) goes through the
reference, f32, from the raw weights drawn again, the PCM and the
prompts. At every served token: the gap of its logit below the
reference's best and |log p - log p_ref| (``logit_err``: the larger, at
the worst token; ``logp_mean_err``: the second's mean). At every layer and
position the reference routes by its own probabilities; where the
program's record keeps another set it records that choice's margin and
continues with the program's choice (``route_margin_max``: the largest; 0
where every choice agrees).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check, devtrace
from benchmark.counts_omni import OmniWork
from benchmark.harness import Run, log
from benchmark.inputs import draw_pcm, sub_seed
from benchmark.reference import omni_ref
from benchmark.reference import whisper_ref as wref
from benchmark.traffic import Traffic

PROMPT_COLS = 448        # the prompt's capacity: 24 + 112 + 300 + 12
HEAD, TAIL, CARRY = 24, 12, 112
TEXT_IDS = 151_643       # Qwen2's ordinary (non-special) ids: [0, 151643)


class Driver:
    """One seed's Uni-MoE-2.0-Omni, its program, traffic and audio."""

    # K1 (the encoder) and K2 (the steps' self-attention) in the device trace
    KERNELS = {"k1": "flash_attention_kernel", "k2": "decode_attention"}

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, run: Run, spans: devtrace.Spans):
        try:
            from whisper_tpu_torch.model.omni_params import OmniDims, tensor_names
        except ImportError as e:       # a program without this family: stop before any draw
            raise SystemExit(f"the program has no omni path ({e}). No result.") from e

        self.cfg, self.mix, self.seed, self.dev, self.run, self.spans = cfg, mix, seed, dev, run, spans
        self.dims = dims = OmniDims.from_config(cfg)
        names = list(tensor_names(dims).items())
        top = ("model.embed_tokens", "model.norm", "lm_head", "model.audio_projector")
        self.groups = [[x for x in names if x[0].startswith(top)],
                       [x for x in names if x[0].startswith("model.audio_tower.")]]
        self.groups += [[x for x in names if x[0].startswith(f"model.layers.{i}.")] for i in range(dims.n_layer)]
        assert sum(map(len, self.groups)) == len(names)
        self.work = OmniWork(cfg)
        self.filters = wref.mel_filters(dims.audio.n_mels)
        run.traced.update(omni_step_bound_s=0.0, omni_steps=0)
        self.item_mel: dict[int, torch.Tensor] = {}
        self.last: tuple = ()
        self.count = False

    # ---- weights ------------------------------------------------------------

    def draw_group(self, k: int) -> dict:
        """Group ``k``'s tensors by checkpoint name, from its own stream."""
        gen = torch.Generator(device=self.dev).manual_seed(sub_seed(self.seed, 1, k))
        out = {}
        for name, shape in self.groups[k]:
            x = torch.randn(shape, generator=gen, device=self.dev)
            if name.endswith("bias"):
                out[name] = x * 0.02
            elif name.endswith("norm.weight") or "layer_norm" in name:
                out[name] = 1 + 0.05 * x
            elif name.endswith("mlp.gate.weight"):
                out[name] = x * shape[1] ** -0.5
            elif name.endswith(("embed_tokens.weight", "embed_positions.weight")):
                out[name] = (x * 0.02).to(torch.bfloat16)
            else:
                out[name] = (x * int(np.prod(shape[1:])) ** -0.5).to(torch.bfloat16)
            del x
        return out

    def draw(self) -> dict:
        raw = {}
        for k in range(len(self.groups)):
            raw.update(self.draw_group(k))
        return raw

    def build(self, raw: dict) -> None:
        from whisper_tpu_torch.features.mel import LogMelSpectrogram
        from whisper_tpu_torch.kernels._build import build_all
        from whisper_tpu_torch.model.omni_params import params_from_tensors
        from whisper_tpu_torch.runtime.omni import OmniContext

        if self.dev.type == "cuda":
            build_all()
        params = params_from_tensors(self.dims, raw)       # empties ``raw`` as it goes
        self.ctx = OmniContext(params, self.dims, device=self.dev, prompt_capacity=PROMPT_COLS,
                               max_new_tokens=self.mix["steps"])
        self.mel = LogMelSpectrogram(self.filters, device=self.dev)

    # ---- traffic ------------------------------------------------------------

    def serve(self) -> None:
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        text = min(TEXT_IDS, self.dims.n_vocab, self.dims.audio_token_id)   # ordinary ids below it
        head = rng.integers(0, text, HEAD).tolist()
        tail = rng.integers(0, text, TAIL).tolist()
        audio = [self.dims.audio_token_id] * self.dims.audio_tokens
        # the carried text is the transcript's ordinary tokens: specials (the audio placeholder
        # among them) never come back as text
        self.traffic = Traffic(self.mix, self.seed, 2 * self.dims.audio.n_audio_ctx,
                               lambda past: head + [t for t in past if t < text] + audio + tail, CARRY)
        self.pool = {k: draw_pcm(self.seed, k, secs, self.dev) for k, secs in self.traffic.recordings()}

    def _window_mel(self, wins) -> torch.Tensor:
        frames = self.traffic.window_frames
        for w in wins:
            if w.item not in self.item_mel:
                for old in [k for k in self.item_mel if k not in {x.item for x in wins}]:
                    del self.item_mel[old]
                rec, secs = self.traffic.recording(w.item)
                with self.spans("mel"):
                    m = self.mel(self.pool[rec])
                if self.count:
                    self.run.mel_audio_s += secs
                self.item_mel[w.item] = torch.nn.functional.pad(m, (0, frames))
        return torch.stack([self.item_mel[w.item][:, w.seek: w.seek + frames] for w in wins])

    def round(self, count: bool) -> list:
        run, traffic, steps, spans = self.run, self.traffic, self.traffic.steps, self.spans
        self.count = count
        t_in = time.perf_counter()
        wins = traffic.round()
        mel = self._window_mel(wins)
        with spans("encode"):
            audio = self.ctx.encode_window(mel)
        prompt = np.zeros((len(wins), PROMPT_COLS), np.int32)
        for i, w in enumerate(wins):
            prompt[i, : len(w.prompt)] = w.prompt
        plen = np.array([len(w.prompt) for w in wins], np.int32)
        with spans("decode"):
            res = self.ctx.run_window(prompt, plen, audio, steps)
        lat = (time.perf_counter() - t_in) * 1e3
        del audio
        self.last = (res, plen)
        with torch.profiler.record_function(devtrace.SPAN + "host"):
            for i, w in enumerate(wins):
                traffic.done(w, res.tokens[i], steps)
                if not count:
                    continue
                s, p = int(res.attn_start[i]), res.prompt_cols
                routes = np.concatenate([res.routes[:, i, s: p], res.routes[:, i, p: p + steps]], axis=1)
                run.records.append(dict(lane=w.lane, item=w.item, seek=w.seek, audio_s=w.audio_s,
                                        prompt=w.prompt, tokens=res.tokens[i].copy(), p=res.p[i].copy(),
                                        routes=routes, result_len=steps))
                run.latency_ms.append(lat)
                run.audio_s += w.audio_s
                run.flops += self.window_flops(routes, len(w.prompt), steps)
        if count:
            run.flops += self.work.encode_flops(len(wins))
        return wins

    def window_flops(self, routes: np.ndarray, plen: int, steps: int) -> float:
        """A lane's prefill of its real prompt tokens and its ``steps`` token
        steps, each with a row of logits, the routed experts as chosen
        (``routes`` [L, plen + steps, top_k]: the lane's positions)."""
        wk = self.work
        routed = ((routes >= 0) & (routes < wk.n_routed)).sum(axis=(0, 2))
        keys = np.arange(1, plen + steps + 1)
        return wk.token_flops(keys, routed) + (steps + 1) * wk.logits_flops()

    def traced(self, wins: list) -> None:
        """A traced round's token steps: their least time, into ``run.traced``."""
        res, plen = self.last
        tr, steps = self.run.traced, self.traffic.steps
        for t in range(steps):
            tr["omni_step_bound_s"] += self.work.step_bound_s(res.touched[t], plen + t + 1)
        tr["omni_steps"] += steps

    def free(self) -> None:
        del self.ctx
        self.last = ()
        self.item_mel.clear()

    def failed(self) -> int:
        """Windows whose result is out of range: not ``steps`` tokens, an id
        outside the vocabulary, or a probability that is not one."""
        steps, v = self.traffic.steps, self.dims.n_vocab
        return sum(1 for r in self.run.records
                   if len(r["tokens"]) != steps or not ((r["tokens"] >= 0) & (r["tokens"] < v)).all()
                   or not (np.isfinite(r["p"]) & (r["p"] > 0) & (r["p"] <= 1)).all())

    # ---- the check ------------------------------------------------------------

    def judge(self, controls: tuple = ()) -> dict:
        """The check of a sample of the window's windows (after ``free``),
        and each control's (``fp8``) on the same prompts and served tokens."""
        run, cfg, dev = self.run, self.cfg, self.dev
        t0 = time.perf_counter()
        rows = [run.records[i] for i in check.sample(run.records, run.lanes, self.seed)]
        frames = self.traffic.window_frames
        filters = torch.from_numpy(self.filters).to(dev)

        def window_mel(r):
            pcm = self.pool[self.traffic.recording(r["item"])[0]].to(dev)
            return torch.nn.functional.pad(wref.log_mel(pcm, filters), (0, frames))[:, r["seek"]: r["seek"] + frames]

        mel = torch.stack([window_mel(r) for r in rows])
        tower = self.draw_group(1)
        top = self.draw_group(0)

        def layer(i):
            p = f"model.layers.{i}."
            return {k[len(p):]: t for k, t in self.draw_group(2 + i).items()}

        def run_ref(prec, follow):
            feats = omni_ref.encode(tower.__getitem__, cfg, mel, prec)
            audio = omni_ref.audio_tokens(top.__getitem__, cfg, feats, prec)
            del feats
            seqs, want = [], []
            for k, r in enumerate(rows):
                ids = list(r["prompt"]) + [int(t) for t in r["tokens"][:-1]]
                seqs.append((torch.tensor(ids, dtype=torch.long, device=dev), audio[k], len(r["prompt"])))
                want.append(list(range(len(r["prompt"]) - 1, len(ids))))
            return omni_ref.forward(layer, top, cfg, seqs, prec, follow, want)

        program = [torch.from_numpy(r["routes"][:, :-1].astype(np.int64)) for r in rows]
        base = run_ref(omni_ref.Precision(), program)
        out = {"windows": len(rows), "tokens": 0, "route_disagreements": 0}
        out.update(self._errors(base, [(r["tokens"], np.log(r["p"].astype(np.float64))) for r in rows]))
        out["route_disagreements"] = int(sum(int((o["margins"] > 0).sum()) for o in base))
        out["tokens"] = sum(len(r["tokens"]) for r in rows)
        for c in controls:
            low = run_ref(omni_ref.Precision(lower=c), None)
            ref = run_ref(omni_ref.Precision(), [o["routes"] for o in low])
            served = []
            for r, lo in zip(rows, low):
                logp = torch.log_softmax(lo["logits"].double(), -1)
                served.append((r["tokens"], logp[torch.arange(len(r["tokens"])), torch.as_tensor(
                    r["tokens"], dtype=torch.long, device=logp.device)].cpu().numpy(),
                    lo["logits"].argmax(-1).cpu().numpy()))
            out.setdefault("control", {})[c] = self._errors(ref, served)
            del low, ref
        log(f"check: {out['windows']} windows, {out['tokens']} served tokens against the reference in "
            f"{time.perf_counter() - t0:.1f} s; logit_err {out['logit_err']!r}, mean log-probability error "
            f"{out['logp_mean_err']!r}, routing disagreements {out['route_disagreements']}, widest margin "
            f"{out['route_margin_max']!r}; controls {out.get('control')}")
        return out

    @staticmethod
    def _errors(ref: list, served: list) -> dict:
        """Under the reference's logits, at each served token: the gap of the
        token picked (the served one, or a control's own best) below the
        best, and |log p - log p_ref| of the served token; with the
        reference's route margins."""
        worst, total, n, margin = 0.0, 0.0, 0, 0.0
        for o, s in zip(ref, served):
            tokens, logp = s[0], s[1]
            picked = s[2] if len(s) > 2 else tokens
            logits = o["logits"].double()
            rows = torch.arange(len(tokens), device=logits.device)
            ref_logp = torch.log_softmax(logits, -1)[rows, torch.as_tensor(tokens, dtype=torch.long,
                                                                            device=logits.device)].cpu().numpy()
            best = logits.max(-1).values
            gap = (best - logits[rows, torch.as_tensor(picked, dtype=torch.long, device=logits.device)]).cpu().numpy()
            lp = np.abs(logp - ref_logp)
            worst = max(worst, float(np.maximum(gap, lp).max()))
            total += float(lp.sum())
            n += len(tokens)
            margin = max(margin, float(o["margins"].max()))
        return {"logit_err": worst, "logp_mean_err": total / max(n, 1), "route_margin_max": margin}
