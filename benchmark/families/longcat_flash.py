"""The longcat family: LongCat-Flash-Omni's audio-to-text path, one card's expert share, as ``whisper_tpu_torch`` serves it.

A configuration whose ``model_type`` is ``longcat_flash`` (the published
``config.json``'s keys, ``expert_share``, the stand-in ``audio_config`` and
``audio_token_id``) runs here, through the program's own loader
(``model/longcat_params.py:params_from_tensors``) and entry points
(``runtime/longcat.py:LongcatContext``: ``encode_window``, ``run_window``).
Its plain reference is ``benchmark/reference/longcat_ref.py``, its bounds'
arithmetic ``benchmark/counts_longcat.py``.

Weights are drawn on the device by checkpoint name, in groups each from a
stream of its own (the connector, embeddings and head; the audio tower;
each double layer), so that the check draws one layer again at a time
after the program is freed. Matmul weights are bf16, N(0, 1/fan_in) (the
untied head too), but latent attention's up-projections ``q_b_proj`` and
``kv_b_proj`` N(0, 1/d): the MLA scales (d / q_rank)^0.5 and (d /
kv_rank)^0.5 restore the variance that weights of one scale give, so
under fan-in draws they would make q 2x, the latent 3.5x and the
attention logits ~7x a trained model's, every head a near argmax whose
choice bf16 rounding flips. Embeddings N(0, 0.02^2); norms, biases and the
router f32: gains 1 + N(0, 0.05^2), biases N(0, 0.02^2), router N(0, 1/d),
its ``e_score_correction_bias`` N(0, (0.1 / n_experts)^2), then balanced in
the set-up over rounds of the cell's own traffic (``Driver.balance``), as a
deployment's load balancing leaves it: random weights give the router's
rows a large common part, so the bias as drawn sends most tokens of a
layer to a few of its experts.

A round is the omni family's (``families/grin_qwen2_vl.py``): a new item's
mel, the lanes' 30 s windows encoded together (300 audio tokens each), one
window of ``steps`` forced greedy steps after an eager prefill, the result
on the host, the lanes' text carried; its prompt layout too (a 24-token
head, the lane's last <= 112 served tokens of text, the 300 audio
placeholders and a 12-token tail, right-padded to 448).

``correct``: one window from each of 8 lanes drawn from the seed goes
through the reference, f32, from the raw weights drawn again, the PCM and
the prompts; at every served token, ``logit_err`` and ``logp_mean_err`` as
the omni family reads them (its ``Driver._errors``). At every layer and
position the reference routes by its own selection scores; where the
program's record chose another set it records that choice's margin, in
units of the mean score, and continues with the program's choice
(``route_margin_max``: the largest; 0 where every choice agrees).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import devtrace
from benchmark.counts_longcat import LongcatWork
from benchmark.families.grin_qwen2_vl import CARRY, HEAD, PROMPT_COLS, TAIL
from benchmark.families.grin_qwen2_vl import Driver as OmniDriver
from benchmark.harness import Run, log
from benchmark.inputs import draw_pcm, sub_seed
from benchmark.reference import longcat_ref, omni_ref
from benchmark.reference import whisper_ref as wref
from benchmark.traffic import Traffic

SAMPLE_LANES = 8         # windows the check takes, one from each of as many lanes
BALANCE_ROUNDS = 3       # set-up rounds over which the router's correction bias is balanced
BALANCE_STEP = 4.0       # the most a round moves an expert's bias, in mean scores 1/n_experts


class Driver(OmniDriver):
    """One seed's LongCat-Flash-Omni share, its program, traffic and audio."""

    # K1 (the encoder), the step's latent attention (its kernel, and with its combine) and expert pair
    KERNELS = {"k1": "flash_attention_kernel", "mla": "mla_", "mla_main": "mla_decode_kernel", "moe": "moe_"}

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, run: Run, spans: devtrace.Spans):
        try:
            from whisper_tpu_torch.model.longcat_params import LongcatDims, tensor_names
        except ImportError as e:       # a program without this family: stop before any draw
            raise SystemExit(f"the program has no longcat path ({e}). No result.") from e

        self.cfg, self.mix, self.seed, self.dev, self.run, self.spans = cfg, mix, seed, dev, run, spans
        self.dims = dims = LongcatDims.from_config(cfg)
        names = list(tensor_names(dims).items())
        top = ("model.embed_tokens", "model.norm", "lm_head", "model.audio_projector")
        self.groups = [[x for x in names if x[0].startswith(top)],
                       [x for x in names if x[0].startswith("model.audio_tower.")]]
        self.groups += [[x for x in names if x[0].startswith(f"model.layers.{i}.")] for i in range(dims.n_layer)]
        assert sum(map(len, self.groups)) == len(names)
        self.work = LongcatWork(cfg)
        self.filters = wref.mel_filters(dims.audio.n_mels)
        run.traced.update(mla_bound_s=0.0, mla_calls=0)
        self.item_mel: dict[int, torch.Tensor] = {}
        self.last: tuple = ()
        self.count = False
        self.bias: list = []       # each layer's balanced correction bias (``balance``)

    # ---- weights ------------------------------------------------------------

    def draw_group(self, k: int) -> dict:
        """Group ``k``'s tensors by checkpoint name, from its own stream."""
        gen = torch.Generator(device=self.dev).manual_seed(sub_seed(self.seed, 1, k))
        n_experts = self.dims.n_experts
        out = {}
        for name, shape in self.groups[k]:
            x = torch.randn(shape, generator=gen, device=self.dev)
            if name.endswith("e_score_correction_bias"):
                out[name] = self.bias[k - 2].clone() if self.bias else x * (0.1 / n_experts)
            elif name.endswith("bias"):
                out[name] = x * 0.02
            elif "norm" in name:
                out[name] = 1 + 0.05 * x
            elif name.endswith(("router.classifier.weight", "q_b_proj.weight", "kv_b_proj.weight")):
                out[name] = (x * self.dims.d ** -0.5).to(torch.bfloat16 if "_b_proj" in name else torch.float32)
            elif name.endswith(("embed_tokens.weight", "embed_positions.weight")):
                out[name] = (x * 0.02).to(torch.bfloat16)
            else:
                out[name] = (x * int(np.prod(shape[1:])) ** -0.5).to(torch.bfloat16)
            del x
        return out

    def build(self, raw: dict) -> None:
        from whisper_tpu_torch.features.mel import LogMelSpectrogram
        from whisper_tpu_torch.kernels._build import build_all
        from whisper_tpu_torch.model.longcat_params import params_from_tensors
        from whisper_tpu_torch.runtime.longcat import LongcatContext

        if self.dev.type == "cuda":
            build_all()
        params = params_from_tensors(self.dims, raw)       # empties ``raw`` as it goes
        self.ctx = LongcatContext(params, self.dims, device=self.dev, prompt_capacity=PROMPT_COLS,
                                  max_new_tokens=self.mix["steps"])
        self.mel = LogMelSpectrogram(self.filters, device=self.dev)

    # ---- traffic ------------------------------------------------------------

    def serve(self) -> None:
        rng = np.random.default_rng(sub_seed(self.seed, 5))
        text = min(self.cfg["text_ids"], self.dims.audio_token_id)   # ordinary ids below it
        head = rng.integers(0, text, HEAD).tolist()
        tail = rng.integers(0, text, TAIL).tolist()
        audio = [self.dims.audio_token_id] * self.dims.audio_tokens
        self.traffic = Traffic(self.mix, self.seed, 2 * self.dims.audio.n_audio_ctx,
                               lambda past: head + [t for t in past if t < text] + audio + tail, CARRY)
        self.pool = {k: draw_pcm(self.seed, k, secs, self.dev) for k, secs in self.traffic.recordings()}
        self.balance()

    def balance(self) -> None:
        """The router's correction bias as a deployment's load balancing
        leaves it (the configuration's ``assumed.router_bias``): over
        ``BALANCE_ROUNDS`` rounds of the cell's own traffic, after each
        round every layer's bias moves each expert toward an even share of
        the choices made at the lanes' real positions (prompt and steps):
        by its relative shortfall, in mean scores 1/n_experts, at most
        ``BALANCE_STEP``. The check draws these biases (``draw_group``).
        The program's routing counters as these rounds leave them go to
        ``run.counters_base``: the readers of those counters count from
        there, under the balanced bias."""
        from whisper_tpu_torch.obs.profiler import TRACER

        blocks, n = self.ctx.params.blocks, self.dims.n_experts
        for _ in range(BALANCE_ROUNDS):
            self.round(count=False)
            res, _ = self.last
            end = res.prompt_cols + self.traffic.steps
            for li, blk in enumerate(blocks):
                chosen = np.concatenate([res.routes[li, b, int(s):end].ravel() for b, s in enumerate(res.attn_start)])
                load = np.bincount(chosen[chosen >= 0].astype(np.int64), minlength=n).astype(np.float64)
                target = load.sum() / n
                move = np.clip((target - load) / target, -BALANCE_STEP, BALANCE_STEP) / n
                blk.router_bias.add_(torch.from_numpy(move).to(blk.router_bias))
        self.bias = [blk.router_bias.clone() for blk in blocks]
        self.run.counters_base = {k: v for k, v in TRACER.counters.items() if k.startswith("moe.")}

    def window_flops(self, routes: np.ndarray, plen: int, steps: int) -> float:
        """A lane's prefill of its real prompt tokens and its ``steps`` token
        steps, each with a row of logits, the held and zero experts as
        chosen (``routes`` [L, plen + steps, top_k]: the lane's positions)."""
        wk = self.work
        lo, hi = wk.held
        held = ((routes >= lo) & (routes < hi)).sum(axis=(0, 2))
        zero = (routes >= wk.published).sum(axis=(0, 2))
        keys = np.arange(1, plen + steps + 1)
        return wk.token_flops(keys, held, zero) + (steps + 1) * wk.logits_flops()

    def traced(self, wins: list) -> None:
        """A traced round's latent attention calls, 2L a step: their least time."""
        res, plen = self.last
        tr, steps = self.run.traced, self.traffic.steps
        for t in range(steps):
            tr["mla_bound_s"] += 2 * self.dims.n_layer * self.work.mla_bound_s(plen + t + 1)
        tr["mla_calls"] += 2 * self.dims.n_layer * steps

    # ---- the check ------------------------------------------------------------

    def sample(self) -> list:
        """One window from each of ``SAMPLE_LANES`` lanes drawn from the seed."""
        rng = np.random.default_rng(sub_seed(self.seed, 4))
        by_lane: dict[int, list[int]] = {}
        for i, r in enumerate(self.run.records):
            by_lane.setdefault(r["lane"], []).append(i)
        lanes = rng.choice(sorted(by_lane), size=min(SAMPLE_LANES, len(by_lane)), replace=False)
        return sorted(int(rng.choice(by_lane[lane])) for lane in lanes)

    def judge(self, controls: tuple = ()) -> dict:
        """The check of a sample of the window's windows (after ``free``),
        and each control's (``fp8``) on the same prompts and served tokens."""
        run, cfg, dev = self.run, self.cfg, self.dev
        t0 = time.perf_counter()
        rows = [run.records[i] for i in self.sample()]
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
            feats = omni_ref.encode(tower.__getitem__, cfg["audio_config"], mel, prec)
            audio = omni_ref.audio_tokens(top.__getitem__, cfg["audio_config"], feats, prec)
            del feats
            seqs, want = [], []
            for k, r in enumerate(rows):
                ids = list(r["prompt"]) + [int(t) for t in r["tokens"][:-1]]
                seqs.append((torch.tensor(ids, dtype=torch.long, device=dev), audio[k], len(r["prompt"])))
                want.append(list(range(len(r["prompt"]) - 1, len(ids))))
            return longcat_ref.forward(layer, top, cfg, seqs, prec, follow, want)

        program = [torch.from_numpy(r["routes"][:, :-1].astype(np.int64)) for r in rows]
        base = run_ref(longcat_ref.Precision(), program)
        out = {"windows": len(rows), "tokens": 0, "route_disagreements": 0}
        out.update(self._errors(base, [(r["tokens"], np.log(r["p"].astype(np.float64))) for r in rows]))
        out["route_disagreements"] = int(sum(int((o["margins"] > 0).sum()) for o in base))
        out["tokens"] = sum(len(r["tokens"]) for r in rows)
        for c in controls:
            low = run_ref(longcat_ref.Precision(lower=c), None)
            ref = run_ref(longcat_ref.Precision(), [o["routes"] for o in low])
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
