"""Benchmark of the port: audio seconds transcribed per wall second on one card.

Counterpart of ``bench.py`` (which stays the JAX package's). It runs the
whole pipeline (mel -> encode -> window decode) with synthetic weights of
a known model built on the device (``tools/synthetic.py``) and a fixed
decode workload of DECODE_TOKENS token steps per 30 s window
(``force_steps``: random weights would make the token count vary).

Knobs, from the environment as in the JAX bench:

  BENCH_MODEL          a ``hparams.KNOWN_MODELS`` name (default large-v2)
  BENCH_DECODE_TOKENS  token steps per window (default 128)
  BENCH_WINDOWS        30 s windows of the single-stream clip (default 4)
  BENCH_BATCH          lanes of the batched rounds (default 8)
  BENCH_KERNELS        the tier: ``serving`` (default; int8 decoder
                       weights and int8 K/V caches, the JAX bench's
                       default), ``bf16`` or ``f32`` (DtypePolicy.f32())

Prints ONE JSON line on stdout:

  {"metric": ..., "value": N, "unit": "audio_s/s", "vs_baseline": N,
   "single_stream_rtf": N, "device": ..., "tier": ...}

``value`` is the batched throughput (BATCH 30 s windows a round, mel
included), ``single_stream_rtf`` the best of two single-stream passes over
the clip. On stderr: the card's name and power limit (nvidia-smi), the
tier, encode ms per window and decode ms per token step apart for every
pass and every batched round. Times are host clocks around work that ends
in ``torch.cuda.synchronize()``.

    python -m whisper_tpu_torch.tools.bench                 # on the card
    BENCH_MODEL=tiny BENCH_DECODE_TOKENS=2 BENCH_WINDOWS=1 BENCH_BATCH=2 \
        python -m whisper_tpu_torch.tools.bench --device cpu   # host times only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections.abc import Sequence

import numpy as np
import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.features.filters import mel_filter_bank
from whisper_tpu_torch.features.mel import LogMelSpectrogram
from whisper_tpu_torch.hparams import KNOWN_MODELS, N_FRAMES, SAMPLE_RATE
from whisper_tpu_torch.model.params import DtypePolicy
from whisper_tpu_torch.runtime.context import WhisperRuntime
from whisper_tpu_torch.runtime.sampler import SpecialIds
from whisper_tpu_torch.tools.synthetic import make_synthetic_params

BASELINE_RTF = 7.22  # the reference's large model on a GTX 1080 Ti (BASELINE.md)
TIERS = {                # tier -> (dtype policy, int8 K/V caches)
    "serving": (DtypePolicy.serving(), True),
    "bf16": (DtypePolicy(), False),
    "f32": (DtypePolicy.f32(), False),
}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run(model: str = "large-v2", tier: str = "serving", decode_tokens: int = 128,
        windows: int = 4, batch: int = 8, device: str | torch.device = "cuda") -> dict:
    """One bench run; returns the JSON line's object, plus ``passes`` and
    ``rounds`` (the per-pass and per-round times) for callers that keep
    them."""
    device = resolve_device(device)
    policy, kv_int8 = TIERS[tier]
    dims = KNOWN_MODELS[model]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    log(f"bench model={model} tier={tier} device={device} card: {card(device)}")
    log(f"dtype_policy={policy} kv_int8={kv_int8} decode_tokens={decode_tokens} "
        f"windows={windows} batch={batch}")
    t0 = time.perf_counter()
    params = make_synthetic_params(dims, policy.param_dtype, policy.norm_dtype,
                                   weights_int8=policy.weights_int8, device=device)
    sync()
    log(f"params built on {device} in {time.perf_counter() - t0:.1f} s")

    shift = 1 if dims.n_vocab >= 51_865 else 0
    ids = SpecialIds(eot=50_256 + shift, sot=50_257 + shift, prev=50_360 + shift,
                     solm=50_361 + shift, not_=50_362 + shift, beg=50_363 + shift)
    rt = WhisperRuntime(params, dims, ids, compute_dtype=policy.compute_dtype, device=device,
                        kv_int8=kv_int8)

    audio_s = 30 * windows
    t = np.arange(SAMPLE_RATE * audio_s) / SAMPLE_RATE
    rng = np.random.default_rng(0)
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    mel_engine = LogMelSpectrogram(mel_filter_bank(dims.n_mels), device=device)
    prompt = [ids.sot] + ([ids.sot + 1, 50_359] if shift else [])
    padded = np.zeros((1, rt.prompt_capacity), np.int32)
    padded[0, : len(prompt)] = prompt
    plen = np.full((1,), len(prompt), np.int32)
    seek_end = np.full((1,), 10**7, np.int32)

    def single_stream() -> dict:
        t_start = time.perf_counter()
        mel = mel_engine(audio)
        n_len = mel.shape[1]
        mel_pad = torch.zeros((mel.shape[0], n_len + N_FRAMES), device=device)
        mel_pad[:, :n_len] = mel
        t_enc = t_dec = 0.0
        n_win = 0
        for seek in range(0, n_len - 1, N_FRAMES):
            sync()
            t1 = time.perf_counter()
            _, cross = rt.encode_window(mel_pad[None, :, seek : seek + N_FRAMES])
            sync()
            t2 = time.perf_counter()
            rt.run_window(padded, plen, cross, np.full((1,), seek, np.int32), seek_end,
                          force_steps=decode_tokens)
            sync()
            t_enc += t2 - t1
            t_dec += time.perf_counter() - t2
            n_win += 1
        total = time.perf_counter() - t_start
        return dict(total_s=total, windows=n_win, mel_s=total - t_enc - t_dec,
                    encode_ms_per_window=t_enc * 1e3 / n_win,
                    decode_ms_per_step=t_dec * 1e3 / (n_win * decode_tokens))

    def show(label: str, p: dict) -> None:
        log(f"{label}: windows={p['windows']} total {p['total_s']:.3f} s (mel {p['mel_s']:.3f} s), "
            f"encode {p['encode_ms_per_window']:.2f} ms/window, decode "
            f"{p['decode_ms_per_step']:.3f} ms/token step ({decode_tokens} steps a window)")

    t0 = time.perf_counter()
    show("warm-up single-stream pass", single_stream())
    log(f"warm-up done in {time.perf_counter() - t0:.1f} s")
    passes = []
    for i in range(2):
        passes.append(single_stream())
        show(f"single-stream pass {i + 1}", passes[-1])
    rtf_single = audio_s / min(p["total_s"] for p in passes)
    log(f"single-stream RTF: {rtf_single:.3f} audio_s/s (x{rtf_single / BASELINE_RTF:.3f} baseline)")

    bp, bl = np.tile(padded, (batch, 1)), np.tile(plen, batch)
    bseek, bend = np.zeros((batch,), np.int32), np.full((batch,), 10**7, np.int32)

    def batched_round() -> dict:
        sync()
        t1 = time.perf_counter()
        mel = mel_engine(audio[: SAMPLE_RATE * 30])
        _, cross = rt.encode_window(mel[None, :, :N_FRAMES].expand(batch, -1, -1).contiguous())
        sync()
        t2 = time.perf_counter()
        rt.run_window(bp, bl, cross, bseek, bend, force_steps=decode_tokens)
        sync()
        t3 = time.perf_counter()
        return dict(total_s=t3 - t1, mel_encode_ms=(t2 - t1) * 1e3,
                    decode_ms_per_step=(t3 - t2) * 1e3 / decode_tokens)

    batched_round()  # warm-up
    rounds = []
    for i in range(3):
        rounds.append(batched_round())
        r = rounds[-1]
        log(f"batched round {i + 1}: batch={batch} {r['total_s'] * 1e3:.1f} ms (mel + encode "
            f"{r['mel_encode_ms']:.2f} ms, decode {r['decode_ms_per_step']:.3f} ms/token step)")
    dt = sum(r["total_s"] for r in rounds) / len(rounds)
    rtf_batched = 30 * batch / dt
    log(f"batched throughput: batch={batch}, {rtf_batched:.3f} audio_s/s ({dt * 1e3:.1f} ms/round, "
        f"{dt * 1e3 / decode_tokens:.3f} ms/token step)")
    return {
        "metric": f"batched_b{batch}_{model.replace('-', '_')}_{tier}_{decode_tokens}tok",
        "value": round(rtf_batched, 3),
        "unit": "audio_s/s",
        "vs_baseline": round(rtf_batched / BASELINE_RTF, 3),
        "single_stream_rtf": round(rtf_single, 3),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "tier": tier,
        "passes": passes,
        "rounds": rounds,
    }


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain versions, host times only)")
    args = parser.parse_args(argv)
    env = os.environ
    tier = env.get("BENCH_KERNELS", "serving")
    if tier not in TIERS:
        parser.error(f"BENCH_KERNELS={tier!r}: one of {', '.join(TIERS)}")
    res = run(model=env.get("BENCH_MODEL", "large-v2"), tier=tier,
              decode_tokens=int(env.get("BENCH_DECODE_TOKENS", "128")),
              windows=int(env.get("BENCH_WINDOWS", "4")), batch=int(env.get("BENCH_BATCH", "8")),
              device=args.device)
    print(json.dumps({k: v for k, v in res.items() if k not in ("passes", "rounds")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
