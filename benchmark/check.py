"""Whether the timed path served the right tokens: the comparison that decides ``correct``.

After the window has closed and the program's state is freed, a sample of
the windows it finished, drawn from the seed (one a lane, or eight from
the one lane), goes through the plain float32 reference
(``benchmark/reference``) from the raw weights, the PCM and the prompts
the program was given. At every served token the reference's logits
before it give two errors, in nats:

  - the gap: how far the served token's logit lies below the best logit
    among the tokens the greedy sampler may pick there (its rules read
    from the reference's own probabilities). Greedy decoding picks the
    best, so a sound program's gaps are zero, or small where two tokens
    nearly tie;
  - the log-probability error: how far the probability the program gave
    the token (``WindowResult.p``) lies from the reference's, |log p -
    log p_ref|. It measures the numerics at every token, ties or none.

``logit_err`` is the larger of the two at the worst served token of the
sample; ``logp_mean_err`` is the log-probability error's mean over every
served token of the sample, which reads the numerics' typical error where
the widest one is noise. Each cell's limits file says which it compares. A served token the sampler's rules ban there,
or a window whose returned rule outputs (seek_delta, result_len, failed)
are not what the window rules make of its tokens, counts as infinite. A
step whose token the rules dropped leaves the token it fed unknown; the
window is compared up to it (``truncated`` counts them).

The control (``Precision.lower``) is read on the same prompts and served
tokens: at each position the gap of its own best token under the
reference, and its log-probability of the served token against the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import sub_seed
from benchmark.reference import whisper_ref as ref


def sample(records: list, lanes: int, seed: int, n_min: int = 8) -> list:
    """Indices into ``records`` (the window's finished windows): one window
    per lane, or ``n_min`` in all from a lane, drawn from the seed, with a
    window of the longest audio among them."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    by_lane: dict[int, list[int]] = {}
    for i, r in enumerate(records):
        by_lane.setdefault(r["lane"], []).append(i)
    per_lane = max(1, -(-n_min // max(1, len(by_lane))))
    picked = []
    for lane in sorted(by_lane):
        idx = by_lane[lane]
        picked += rng.choice(idx, size=min(per_lane, len(idx)), replace=False).tolist()
    longest = max(r["audio_s"] for r in records)
    if all(records[i]["audio_s"] < longest for i in picked):
        cands = [i for i, r in enumerate(records) if r["audio_s"] == longest]
        picked[0] = int(rng.choice(cands))
    return sorted(picked)


def _errors(ref_logits: torch.Tensor, served: torch.Tensor, sp, logp: torch.Tensor | None = None,
            low: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per position of one window, (gap, log-probability error) under
    ``ref_logits`` [R, V]: of the ``served`` tokens [R] with the program's
    log-probabilities ``logp`` [R], or, with the control's logits ``low``,
    of the token the control puts first and of its log-probability of the
    served token. A token the rules ban gives an infinite gap."""
    initial = torch.zeros(len(served), dtype=torch.bool, device=ref_logits.device)
    initial[0] = True
    rows = torch.arange(len(served), device=ref_logits.device)
    allowed = ref.allowed_tokens(ref_logits, sp, initial)
    best = torch.where(allowed, ref_logits, float("-inf")).amax(dim=-1)
    ref_logp = torch.log_softmax(ref_logits, dim=-1)[rows, served]
    pick = served
    if low is not None:
        own = ref.allowed_tokens(low, sp, initial)
        pick = torch.where(own, low, float("-inf")).argmax(dim=-1)
        logp = torch.log_softmax(low, dim=-1)[rows, served]
    gap = torch.where(allowed[rows, pick], best - ref_logits[rows, pick], float("inf"))
    return gap, (logp - ref_logp).abs()


def judge(records: list, picked: list, raw: dict, dims, sp, prec: ref.Precision, pcm_of,
          filters: torch.Tensor, steps: int, device, controls: tuple = ()) -> dict:
    """The sample's ``logit_err`` and its parts and counts; ``controls``:
    further precisions read the same way (under ``control``)."""
    rows = [records[i] for i in picked]
    w = dims.window_frames
    mels, mel_of = [], {}
    for r in rows:
        if r["item"] not in mel_of:
            m = ref.log_mel(pcm_of(r["item"]).to(device), filters.to(device))
            mel_of[r["item"]] = torch.nn.functional.pad(m, (0, w))
        mels.append(mel_of[r["item"]][:, r["seek"]: r["seek"] + w])
    mel = torch.stack(mels)
    del mel_of

    replays = [ref.replay_rules(r["tokens"], steps, sp.beg, w) for r in rows]
    seqs, rowsel = [], []
    for r, rp in zip(rows, replays):
        seqs.append(list(r["prompt"]) + [int(t) for t in r["tokens"][:rp.known]])
        rowsel.append([len(r["prompt"]) - 1 + j for j in range(max(rp.known, 1))])
    s_max, r_max = max(map(len, seqs)), max(map(len, rowsel))
    tokens = torch.tensor([q + [0] * (s_max - len(q)) for q in seqs], device=device)
    sel = torch.tensor([q + [q[-1]] * (r_max - len(q)) for q in rowsel], device=device)

    def logits_of(p: ref.Precision) -> torch.Tensor:
        feats = ref.encode(raw, mel, dims.enc_heads, p)
        cross = ref.cross_kv(raw, feats, dims.dec_heads, p)
        del feats
        return ref.decode_logits(raw, tokens, sel, cross, dims.dec_heads, p)

    def widest(x: torch.Tensor) -> float:
        return float(x.max()) if len(x) else 0.0

    base = logits_of(prec)
    served = [torch.as_tensor(np.asarray(r["tokens"][:rp.known], np.int64), device=device)
              for r, rp in zip(rows, replays)]
    out = {"logit_err": 0.0, "logp_mean_err": 0.0, "gap": 0.0, "logp_err": 0.0, "windows": len(rows),
           "tokens": 0, "rules_mismatch": 0, "banned": 0, "truncated": 0}
    for k, (r, rp) in enumerate(zip(rows, replays)):
        logp = torch.log(torch.as_tensor(np.asarray(r["p"][:rp.known], np.float64), device=device))
        gap, lp = _errors(base[k, :rp.known], served[k], sp, logp=logp.float())
        ok = (rp.consistent and int(r["result_len"]) == rp.result_len
              and bool(r["failed"]) == rp.failed
              and (rp.known < steps or int(r["seek_delta"]) == rp.seek_delta))
        out["rules_mismatch"] += not ok
        out["truncated"] += rp.known < steps
        out["banned"] += int(torch.isinf(gap).sum())
        out["tokens"] += rp.known
        out["gap"] = max(out["gap"], widest(gap))
        out["logp_err"] = max(out["logp_err"], widest(lp))
        out["logp_mean_err"] += float(lp.sum())
        out["logit_err"] = max(out["logit_err"], widest(torch.maximum(gap, lp)),
                               0.0 if ok else float("inf"))
    out["logp_mean_err"] /= max(out["tokens"], 1)
    for p in controls:
        low = logits_of(p)
        parts = [_errors(base[k, :rp.known], served[k], sp, low=low[k, :rp.known])
                 for k, rp in enumerate(replays) if rp.known]
        out.setdefault("control", {})[p.lower] = {
            "logit_err": max(widest(torch.maximum(g, lp)) for g, lp in parts),
            "gap": max(widest(g) for g, _ in parts), "logp_err": max(widest(lp) for _, lp in parts),
            "logp_mean_err": float(sum(lp.sum() for _, lp in parts)) / max(out["tokens"], 1)}
        del low
    return out
