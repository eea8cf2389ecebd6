#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``whisper_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit and no
result line:

  1. card       name and power limit (nvidia-smi), torch and CUDA versions
  2. build      nvcc builds every kernel from whisper_tpu_torch/csrc/, one
                process per source, all at once
  3. kernels    each CUDA kernel against its plain PyTorch version at the main
                path's large-v2 shapes (bf16 inputs; K2 also on int8 K/V with
                column scales, the serving tier's caches), with its time, the
                plain version's, one PyTorch library call's (a yardstick the
                port never calls; none takes int8 K/V with scales) on events
                and on profiler device time over all its kernels, and the
                bound (least time the card could take: bytes over 3.35 TB/s
                or operations over 989 TFLOP/s); each case's share of the
                bound and its ratio to the library call. K1 on strided views
                (as the encoder passes them) and on contiguous tensors; K1's
                f32 instance (DtypePolicy.f32()) at B=1 and B=8 on strided
                f32 views, held to 1e-5 x max(1, max |plain|), bound by the
                f32 FMA rate (67 TFLOP/s), with SDPA on the same views and
                the backend SDPA took, and its launch geometry (q rows and
                threads a block, shared memory, blocks per SM, rounds); K1
                (bf16 and f32) and K2 (bf16 and int8, cross and self) also
                at H=10, a rank's share of large-v2's 20 heads at n_model=2
  3b. kbench    the port's microbenchmark of the decode-attention stream
                (whisper_tpu_torch.tools.kbench, the JAX tool's large-v2
                defaults B=8 S=1500 HD=1280 H=20 L=32 CS=512): each of its
                kernels K3-K9 against its plain version on the tool's inputs
                and on seeded random ones (f32-p attention 1e-5, bf16-p
                1e-4, each times max(1, max |plain|), and bf16-p's mean
                error under a quarter of the bf16 rounding's mean effect;
                row sums 1e-5 of the row's sum of |k| + |v|); every
                variant's pass timed, with the kernel counters set to 0
                before the run and checked after it (per pass: 2L launches
                for K3's split tiling, partial sums and combine, L for the
                other per-layer kernels, 2 for K6 and K9; plus a warm-up
                pass); every variant's device time per pass; each kernel's
                device time per launch, plain pass, library pass
                (torch.sum for the row sums, SDPA for the bf16 attention)
                on events and on profiler device time, and bound; K4b's,
                K7's and K8's launch geometry and how many of their
                clusters the card holds; the attention kernels' bound over
                the keys < S (the tool's bytes over S_PAD beside it); K7's
                device time at S = 1, its fixed cost a launch; K2's int8
                branch on K8's inputs as K8's yardstick
  4. golden     a small scripted checkpoint (head dim 64, so it runs the
                kernels) through the user's entry points on the card must
                give its known transcript, on the bf16 tier and on the
                serving tier (DtypePolicy.serving() weights, WhisperRuntime(
                kv_int8=True)), and the same on the CPU: run_full greedy and
                with beam 5, token timestamps with max_len 2, a stereo clip
                (speaker LEFT), run_streamed over ChunkedReader, the
                BatchTranscriber (batch 4, 6 clips, greedy and beam 5) and
                the server of cli/serve.py (3 concurrent POSTs); the card's
                counters show K1 and K2, K2's grouped launches on every beam
                run; then run_full under DtypePolicy.f32() (K1's f32
                instance) and run_capture over a paced source (bf16 tier;
                run_full on the capture runner's worker thread), each the
                CPU's segments (and buffers) with exact K1/K2 counts; a small
                random model's encoder on the card must agree with the CPU
                path; the native host library (g++ at first use): its
                log-mel against the port's LogMelSpectrogram on the card
                (2e-3) and its host ms, whether the audio decoder built
                (FFmpeg headers) and an ffmpeg binary is there, and where
                it built, a 16 kHz WAV through it equal to scipy's read
  5. main path  a synthetic large-v2 GGML checkpoint (full width and depth,
                f16 weights from a seeded generator), once per tier: the bf16
                tier (load_model), then the serving tier (load_model with
                DtypePolicy.serving(), runtime with kv_int8=True). Each runs
                Context.run_full on a seeded 3 s clip, then the runtime's
                encode_window + run_window at B=1 and B=8, with
                force_steps=128 and to its natural end: the token step
                replayed as a CUDA graph (the path), then the same window on
                the eager step, which must give an identical WindowResult.
                Every kernel counter is set to 0 right before each of these
                and must show the launches the path implies (32 encoder
                layers per encode, 2 x 32 decoder layers per token step, all
                of them on int8 K/V in the serving tier; a replay adds what
                its capture recorded). Graph and eager ms per token step,
                the host's cost of the loop's read of ``stop`` per step
                (replays with and without it), each graph slot's bytes and
                capture + instantiate ms, the tier's peak device memory.
                After the timed runs, profiled runs split the card's time by
                kernel group and give the idle share, for the encode and for
                the eager and the graph step (whether the trace lists the
                graph's kernels is logged). Beam 5 (U=1, U=8; serving U=8)
                runs on the graphs, natural and forced, and its natural
                window again on the eager step (identical winners); at the
                largest U the cache reorder's cost by the columns it moves.
                The scheduler and f32 run_full run on the graphs and again
                on the eager step (the same segments). The serving tier also checks the
                bytes it stores (int8 cross K/V, decoder weights, token
                table) and profiles the two passes XLA fused and eager
                PyTorch does not: int8 -> bf16 weight conversion and the
                self cache's quantize-and-write. The bf16 tier also runs
                Context.run_capture over a seeded 6 s source in 100 ms
                chunks, paced (buffers, ms per buffer, exact counts); then
                the f32 tier (load_model with DtypePolicy.f32()) runs
                run_full on the 3 s clip (32 f32 K1 launches a window) and
                one profiled encode at B=1
  5b. parallel  two ranks on the card over gloo (parallel.launch.spawn),
                eager steps: at n_model = 2 the scripted checkpoint's
                run_full on the bf16, serving and f32 tiers (the golden
                transcript), large-v2 f32 (features within 1e-3 x max(1,
                max |x|) of one process, tokens, result_len and seek_delta
                identical) and bf16 (first-step logits within PAR_BF16_TOL
                of one process), with K1 and K2 at 10 of 20 heads; data
                parallel 2 x B=4 against one process's B=8 on the f32
                tier (identical tokens); Model(mesh=) with graphs on a
                gloo group refused. Then NCCL at world size 1 in this
                process: a 1x1 mesh with graphs equal to mesh=None bit for
                bit, with the graph step's launches. Ms per window and per
                token step, and the collectives' share of each
  5c. omni      Uni-MoE-2.0-Omni's audio-to-text window (runtime/omni.py's
                OmniContext) at the published widths and vocabulary, cut to
                2 of 28 language-model layers and 2 of 32 encoder layers
                (seeded random weights drawn on the card, ~6 GB): B=8,
                448 prompt columns, 112 steps, as the omni cell runs it. A
                first window captures the token step; the expert kernel's
                counter is set to 0 before a replayed window and before the
                same window on the eager step, and each must show 2
                launches a layer and step, moe.experts_read equal to
                moe.experts_touched, and the same tokens, probabilities and
                routing record
  6. report    one JSON line of every kernel's numbers (with the serving
                path's in ``serving_path``), then
                the result line
                {"ok": true, "device": {...}}

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 peak outside the tensor cores
L2_BYTES = 50 * 2**20
FORCE_STEPS = 128
PROFILE_STEPS = 16             # decode steps under the profiler (the trace stays small)
BEAM = 5                       # beam width of the beam-search runs
GAP_STEPS = 64                 # replays a pass when timing the loop's read of `stop`
# the counts of the kernel layer's ledger (kernels/_build.py:LAUNCHES) that
# the phases read: K1's launches, K2's, and of K2's those on int8 K/V and
# those with kv_group > 1 (beam search's cross-attention)
K1_K2 = ("flash_attention", "decode_attention_hd", "decode_attention_hd_int8",
         "decode_attention_hd_grouped")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------------------
# synthetic checkpoints (the port's own GGML writer)
# ---------------------------------------------------------------------------

def vocab_words(n_vocab: int) -> list[bytes]:
    """256 single bytes, then filler words up to token_eot (the loader
    synthesizes every special token)."""
    words = [bytes([b]) for b in range(256)] + [b" w%d" % i for i in range(256, 50_256)]
    return words[: min(n_vocab, 50_256)]


def _names(dims):
    """Tensor names and torch-layout shapes of a whisper GGML checkpoint."""
    d = dims.n_audio_state
    out = [("encoder.positional_embedding", (dims.n_audio_ctx, d)),
           ("encoder.conv1.weight", (d, dims.n_mels, 3)), ("encoder.conv1.bias", (d,)),
           ("encoder.conv2.weight", (d, d, 3)), ("encoder.conv2.bias", (d,)),
           ("encoder.ln_post.weight", (d,)), ("encoder.ln_post.bias", (d,))]
    attn = [("attn_ln.weight", (d,)), ("attn_ln.bias", (d,)),
            ("attn.query.weight", (d, d)), ("attn.query.bias", (d,)),
            ("attn.key.weight", (d, d)), ("attn.value.weight", (d, d)),
            ("attn.value.bias", (d,)), ("attn.out.weight", (d, d)), ("attn.out.bias", (d,))]
    cross = [(n.replace("attn", "cross_attn", 1), s) for n, s in attn]
    mlp = [("mlp_ln.weight", (d,)), ("mlp_ln.bias", (d,)), ("mlp.0.weight", (4 * d, d)),
           ("mlp.0.bias", (4 * d,)), ("mlp.2.weight", (d, 4 * d)), ("mlp.2.bias", (d,))]
    for i in range(dims.n_audio_layer):
        out += [(f"encoder.blocks.{i}.{n}", s) for n, s in attn + mlp]
    out += [("decoder.positional_embedding", (dims.n_text_ctx, d)),
            ("decoder.token_embedding.weight", (dims.n_vocab, d)),
            ("decoder.ln.weight", (d,)), ("decoder.ln.bias", (d,))]
    for i in range(dims.n_text_layer):
        out += [(f"decoder.blocks.{i}.{n}", s) for n, s in attn + cross + mlp]
    return out


def write_checkpoint(path: str, dims, tensors: dict) -> None:
    from whisper_tpu_torch.ggml import MelFilters, mel_filter_bank, write_checkpoint_file

    filters = mel_filter_bank(dims.n_mels)
    write_checkpoint_file(path, dims, MelFilters(*filters.shape, filters),
                          vocab_words(dims.n_vocab), tensors, use_f16=True)


def random_tensors(dims, seed: int) -> dict:
    """Random weights (f16 for matrices) at the scale of the test fixtures:
    N(0, 1/d) matrices, layernorm gains near 1."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / math.sqrt(dims.n_audio_state)
    out = {}
    for name, shape in _names(dims):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        if name.endswith("ln.weight") or name.endswith("ln_post.weight"):
            x = 1.0 + 0.1 * x
        elif len(shape) == 1:
            x = 0.1 * x
        out[name] = x.astype(np.float16) if len(shape) > 1 else x
    return out


def scripted_tensors(dims, script: list[int], seed: int) -> dict:
    """Weights that make the decoder a position -> token lookup: attention
    and MLP weights zero, positional row i a large multiple of the (tied)
    embedding of script[i], so greedy decode emits ``script`` whatever the
    audio."""
    rng = np.random.default_rng(seed)
    d = dims.n_audio_state
    out = {}
    for name, shape in _names(dims):
        out[name] = (np.ones(shape, np.float32) if name.endswith("ln.weight")
                     or name.endswith("ln_post.weight") else np.zeros(shape, np.float32))
    emb = rng.standard_normal((dims.n_vocab, d)).astype(np.float32)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    eot = 50_256 + (1 if dims.n_vocab >= 51_865 else 0)
    out["decoder.token_embedding.weight"] = 4.0 * unit
    out["decoder.positional_embedding"] = np.stack(
        [50.0 * unit[script[i] if i < len(script) else eot] for i in range(dims.n_text_ctx)])
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def event_ms(fn, n_sets: int, iters: int) -> float:
    """Mean ms per call over back-to-back calls on rotating input sets (so
    the working set exceeds L2 where one set alone would fit), CUDA events."""
    import torch

    for i in range(3):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n_sets: int, iters: int, pattern: str, per_call: int | None = None):
    """Mean device time per call of the CUDA kernels whose name contains
    ``pattern``, from torch.profiler's kernel records; None when the trace
    holds none. torch.profiler's traces here can lose a kernel: with
    ``per_call`` (the kernels one call launches) the time is the mean of
    the kernels traced times ``per_call``, and a trace short of kernels is
    taken again, up to three times in all, and logged if it stays short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad.add_(1)  # a kernel of another name first and last: traces here
            for i in range(iters):  # have lost the first or last kernel of a session
                fn(i % n_sets)
            pad.add_(1)
            torch.cuda.synchronize()
        durs = [ev.time_range.elapsed_us() for ev in prof.events()
                if ev.device_type == DeviceType.CUDA and pattern in ev.name]
        if per_call is None or len(durs) >= per_call * iters:
            break
    else:
        log(f"    (the trace holds {len(durs)} of the {per_call * iters} {pattern} kernels launched)")
    if not durs:
        return None
    return sum(durs) / (len(durs) / per_call if per_call else iters) / 1e3


def breakdown(fn) -> dict:
    """Where one call of ``fn`` spends the card's time, from a torch.profiler
    trace: kernel durations summed by group, the busy total, and the idle
    share of the wall time measured with the profiler on (which slows the
    host, so the share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def group(name: str) -> str:
        if "flash_attention_f32_kernel" in name:
            return "K1 flash_attention (f32)"
        if "flash_attention_kernel" in name:
            return "K1 flash_attention"
        if "decode_attention" in name:
            return "K2 decode_attention_hd"
        # cuBLAS on Hopper names its GEMMs nvjet_*, its M=1 products gemv*
        if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
            return "GEMM/GEMV (cuBLAS)"
        return "other (elementwise, reductions, copies)"

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    n = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            g = group(ev.name)
            groups[g] = groups.get(g, 0.0) + ms
            names[ev.name[:80]] = names.get(ev.name[:80], 0.0) + ms
            n += 1
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall_ms),
                launches=n, groups_ms=groups, top_kernels_ms=dict(top),
                profile_s=time.perf_counter() - t0)


def show_breakdown(label: str, bd: dict, per: int = 1) -> None:
    parts = ", ".join(f"{k} {v / per:.3f}" for k, v in sorted(bd["groups_ms"].items(),
                                                              key=lambda kv: -kv[1]))
    log(f"  {label}: busy {bd['busy_ms'] / per:.3f} ms of {bd['wall_ms'] / per:.3f} ms wall "
        f"(profiler on; idle share {bd['idle_share']:.3f}), {bd['launches'] / per:.0f} kernels; {parts} "
        f"[{bd['profile_s']:.1f} s with the trace's processing]")
    log("    top kernels: " + "; ".join(f"{k} {v / per:.3f}" for k, v in bd["top_kernels_ms"].items()))
    check(bd["launches"] > 0, f"{label}: the profiler saw no kernel on the card")


def sync_ms(fn):
    """(host ms, result) of ``fn()`` between two device syncs."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _n_sets(set_bytes: int) -> int:
    return max(2, min(32, math.ceil(2.5 * L2_BYTES / set_bytes)))


def library_device_ms(fn, n_sets: int, iters: int) -> float:
    """Mean device time per call of ``fn`` over every kernel it launches
    (profiler), for a library call whose kernels have no fixed name."""
    return breakdown(lambda: [fn(i % n_sets) for i in range(iters)])["busy_ms"] / iters


def flash_case(b: int, t: int, h: int = 20, dh: int = 64, contiguous: bool = False) -> dict:
    """K1 at the encoder's shapes: q, k, v as strided views of one
    [B, T, H, 3, Dh] bf16 tensor, as the encoder hands them over, or as
    three contiguous [B, T, H, Dh] tensors."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.kernels.attention import (
        flash_attention,
        flash_attention_ref,
        flash_attention_shape,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    set_bytes = 4 * b * t * h * dh * 2
    n = _n_sets(set_bytes)
    sets = []
    for _ in range(n):
        qkv = (torch.randn((b, t, h, 3, dh), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
        sets.append(tuple(x.contiguous() for x in qkv.unbind(3)) if contiguous else qkv.unbind(3))
    q, k, v = sets[0]
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.bfloat16, "flash_attention shape/dtype")
    check(bool(torch.isfinite(got).all()), "flash_attention output not finite")
    err = (got.float() - want.float()).abs().max().item()

    def lib(i):
        q, k, v = sets[i]
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), scale=1.0)

    flops = 4 * b * h * t * t * dh
    bound_flops = flops / BF16_FLOPS * 1e3
    bound_bytes = set_bytes / HBM_BYTES_PER_S * 1e3
    return dict(
        case=f"B={b} T={t} H={h} Dh={dh} bf16, {'contiguous' if contiguous else 'strided'} q/k/v",
        max_abs_err=err, tol=2e-2,
        tol_reason="bf16 output (1 ulp is 7.8e-3 at |x| in [1, 2)); P is rounded to bf16 "
                   "before normalisation in the kernel and after it in the plain version",
        ms=event_ms(lambda i: flash_attention(*sets[i]), n, 50),
        device_ms=device_ms(lambda i: flash_attention(*sets[i]), n, 20, "flash_attention_kernel"),
        plain_ms=event_ms(lambda i: flash_attention_ref(*sets[i]), n, 5),
        library_ms=event_ms(lib, n, 50),
        library_device_ms=library_device_ms(lib, n, 20),
        # both block shapes, forced, against which the kernel's own choice is made
        shape_device_ms={shape: device_ms(lambda i: flash_attention_shape(*sets[i], shape), n, 20,
                                          "flash_attention_kernel") for shape in ("wide", "deep")},
        bound_ms=max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )


def sdpa_backend(fn) -> str:
    """The backend SDPA took for ``fn()``, from the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA})
    low = " ".join(names).lower()
    kind = ("cuDNN" if "cudnn" in low else "flash" if "flash" in low
            else "memory-efficient" if "fmha" in low or "efficient" in low else "math")
    return f"{kind} ({'; '.join(n[:60] for n in names[:3])})"


def flash_f32_case(b: int, t: int, h: int = 20, dh: int = 64) -> dict:
    """K1's f32 instance (DtypePolicy.f32()) at the encoder's shapes: q, k, v
    as strided f32 views of one [B, T, H, 3, Dh] tensor; bound by the f32
    FMA rate (no tensor-core type keeps the f32 tier's 1e-5)."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.kernels.attention import (
        flash_attention,
        flash_attention_f32_geometry,
        flash_attention_ref,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    set_bytes = 4 * b * t * h * dh * 4
    n = _n_sets(set_bytes)
    sets = [(torch.randn((b, t, h, 3, dh), generator=g, device="cuda") * 0.5).unbind(3)
            for _ in range(n)]
    before = LAUNCHES["flash_attention_f32"]
    got = flash_attention(*sets[0])
    check(LAUNCHES["flash_attention_f32"] == before + 1, "flash_attention f32: the f32 kernel did not launch")
    want = flash_attention_ref(*sets[0])
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32, "flash_attention f32 shape/dtype")
    check(bool(torch.isfinite(got).all()), "flash_attention f32 output not finite")
    err = (got - want).abs().max().item()

    def lib(i):
        q, k, v = sets[i]
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), scale=1.0)

    bound_flops = 4 * b * h * t * t * dh / F32_FLOPS * 1e3
    bound_bytes = set_bytes / HBM_BYTES_PER_S * 1e3
    return dict(
        case=f"B={b} T={t} H={h} Dh={dh} f32, strided q/k/v",
        max_abs_err=err, tol=1e-5 * max(1.0, want.abs().max().item()),
        tol_reason="1e-5 x max(1, max |plain|): f32 throughout, only the summation order "
                   "and expf's rounding differ",
        ms=event_ms(lambda i: flash_attention(*sets[i]), n, 20),
        device_ms=device_ms(lambda i: flash_attention(*sets[i]), n, 10, "flash_attention_f32_kernel"),
        plain_ms=event_ms(lambda i: flash_attention_ref(*sets[i]), n, 3),
        library_ms=event_ms(lib, n, 20),
        library_device_ms=library_device_ms(lib, n, 10),
        library_backend=sdpa_backend(lambda: lib(0)),
        geometry=flash_attention_f32_geometry(b, h, t),
        bound_ms=max(bound_flops, bound_bytes),
        bound_by="operations" if bound_flops >= bound_bytes else "bytes",
    )


def decode_case(b: int, s: int, group: int = 1, masked: bool = False, int8: bool = False,
                empty: bool = False, h: int = 20, dh: int = 64, path: str = "") -> dict:
    """K2 at the decoder's shapes: cross (S=1500, whole cache) or self
    (S=448, per-lane [start, valid_len) as in a window after prompt ingest),
    with a bf16 query on bf16 K/V, or on int8 K/V with f32 column scales
    that the port's quantize_cols made from seeded bf16 tensors (the serving
    tier's caches). ``empty`` gives lanes 1 and 2 of 4 an empty interval."""
    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.kernels.decode_attention import (
        decode_attention_hd,
        decode_attention_hd_ref,
    )
    from whisper_tpu_torch.kernels.quant import quantize_cols

    g = torch.Generator(device="cuda").manual_seed(SEED)
    hd, u = h * dh, b // group
    isz = 1 if int8 else 2                       # bytes per K/V element
    n = _n_sets(2 * u * hd * s * isz)
    sets = []
    for _ in range(n):
        q = (torch.randn((b, hd, 1), generator=g, device="cuda") * 0.5).bfloat16()
        kt = (torch.randn((u, hd, s), generator=g, device="cuda") * 0.5).bfloat16()
        vt = torch.randn((u, hd, s), generator=g, device="cuda").bfloat16()
        if int8:
            (kt, ks), (vt, vs) = quantize_cols(kt, axis=-2), quantize_cols(vt, axis=-2)
            sets.append((q, kt, vt, dict(k_scale=ks, v_scale=vs)))
        else:
            sets.append((q, kt, vt, {}))
    if empty:
        start = torch.tensor([0, 300, 100, 0], dtype=torch.int32, device="cuda")
        valid = torch.tensor([s, 300, 50, s - 100], dtype=torch.int32, device="cuda")
    elif masked:
        # lanes at different prompt depths, 100 steps into a window
        start = torch.arange(b, dtype=torch.int32, device="cuda") * 7 % 40
        valid = torch.full((b,), 228 + 100, dtype=torch.int32, device="cuda")
    else:
        start = valid = None
    kw = dict(valid_len=valid, start=start, kv_group=group)

    def call(fn, i):
        q, kt, vt, scales = sets[i]
        return fn(q, kt, vt, h, **kw, **scales)

    got, want = call(decode_attention_hd, 0), call(decode_attention_hd_ref, 0)
    torch.cuda.synchronize()
    check(got.shape == (b, hd, 1) and got.dtype == torch.float32, "decode_attention_hd shape/dtype")
    check(bool(torch.isfinite(got).all()), "decode_attention_hd output not finite")
    err = (got - want).abs().max().item()

    mask = None
    if start is not None:
        col = torch.arange(s, device="cuda")
        mask = ((col >= start[:, None]) & (col < valid[:, None]))[:, None, None, :]

    def lib(i):
        # the G lanes that share a K/V lane fold into SDPA's query-row axis
        # (no mask on the grouped cross-attention), as model/decoder.py does
        q, kt, vt, _ = sets[i]
        k4 = kt.view(u, h, dh, s).transpose(-1, -2)
        v4 = vt.view(u, h, dh, s).transpose(-1, -2)
        q4 = q.view(u, group, h, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)

    # What this run's data needs: K and V of the attended keys; a lane that
    # attends none reads all of V (its mean) and no K. Cases with start or
    # valid_len have group 1, so query lanes and K/V lanes are the same.
    if start is None:
        k_keys = v_keys = s * u
        q_keys = [s] * b
    else:
        q_keys = (valid - start).clamp_min(0).tolist()
        k_keys = sum(q_keys)
        v_keys = sum(n_k or s for n_k in q_keys)
    kv_bytes = (k_keys + v_keys) * hd * isz + ((k_keys + v_keys) * 4 if int8 else 0)
    bytes_ = b * hd * 2 + kv_bytes + b * hd * 4     # bf16 q in, f32 out
    flops = 2 * hd * (sum(q_keys) + sum(n_k or s for n_k in q_keys))
    bound_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / BF16_FLOPS * 1e3
    kind = "self, empty lanes" if empty else "self" if masked else "cross"
    return dict(
        case=f"{kind} B={b} S={s} G={group} H={h} Dh={dh} " + ("int8 K/V, bf16 q" if int8 else "bf16"),
        path=path,
        max_abs_err=err, tol=2e-3,
        tol_reason=f"f32 output from identical {'int8 codes and scales' if int8 else 'bf16 inputs'}: "
                   "only the f32 summation order (split-S partials, shuffle trees) and __expf differ",
        ms=event_ms(lambda i: call(decode_attention_hd, i), n, 200),
        device_ms=device_ms(lambda i: call(decode_attention_hd, i), n, 50, "decode_attention"),
        plain_ms=event_ms(lambda i: call(decode_attention_hd_ref, i), n, 20),
        # no single PyTorch call takes int8 K/V with per-column scales
        library_ms=None if int8 else event_ms(lib, n, 50),
        library_device_ms=None if int8 else library_device_ms(lib, n, 20),
        bound_ms=max(bound_bytes, bound_flops),
        bound_by="bytes" if bound_bytes >= bound_flops else "operations",
    )


W8A16_SHAPES = {  # large-v2's decode products: (K, N, layout)
    "qkv": (1280, 3840, "nn"), "o": (1280, 1280, "nn"), "xq": (1280, 1280, "nn"),
    "xo": (1280, 1280, "nn"), "fc1": (1280, 5120, "nn"), "fc2": (5120, 1280, "nn"),
    "logits": (1280, 51_865, "nt"),
}


def w8a16_case(name: str, m: int, path: str = "") -> dict:
    """The W8A16 kernel at one of large-v2's decode products with ``m`` rows:
    seeded bf16 x, int8 codes ([in, out], or the table [V, d] read
    transposed), f32 column scales and bias; against its plain version, and
    beside the converted path it replaces (``w.to(bf16)``, ``torch.mm`` with
    an f32 result, then the scale and the bias: four launches)."""
    import torch

    from whisper_tpu_torch.kernels.w8a16 import w8a16_dense, w8a16_dense_ref, w8a16_geometry

    k, n, layout = W8A16_SHAPES[name]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    sets = []
    for _ in range(_n_sets(k * n)):
        codes = torch.randint(-127, 128, (k, n) if layout == "nn" else (n, k), generator=g,
                              device="cuda", dtype=torch.int8)
        sets.append(codes if layout == "nn" else codes.T)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    sc = torch.rand((1, n), generator=g, device="cuda") * 1e-2 + 1e-3
    b = None if name == "logits" else torch.randn((n,), generator=g, device="cuda") * 0.1

    def converted(i):
        y = torch.mm(x, sets[i].to(torch.bfloat16), out_dtype=torch.float32) * sc
        return y if b is None else y + b

    got = w8a16_dense(x, sets[0], sc, b)
    want = w8a16_dense_ref(x, sets[0], sc, b)
    torch.cuda.synchronize()
    check(got.shape == (m, n) and got.dtype == torch.float32, f"w8a16 {name}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"w8a16 {name}: output not finite")
    mag = (x.float().abs() @ sets[0].float().abs()) * sc
    rel = ((got - want).abs() / (mag + 1e-30)).max().item()
    bytes_ = k * n + 2 * m * k + 4 * m * n + 4 * n * (1 if b is None else 2)
    bound_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_flops = 2 * m * k * n / BF16_FLOPS * 1e3
    geo = w8a16_geometry(m, k, n)
    return dict(
        case=f"{name} M={m} K={k} N={n} {layout.upper()}" + ("" if b is None else " +bias"),
        path=path, max_abs_err=rel, tol=1e-5,
        tol_reason="relative to the product's magnitude sum (|x| @ |w|, scaled): both sum exact "
                   "bf16 x bf16 products in f32, in other orders",
        ms=event_ms(lambda i: w8a16_dense(x, sets[i], sc, b), len(sets), 200),
        device_ms=device_ms(lambda i: w8a16_dense(x, sets[i], sc, b), len(sets), 50,
                            "w8a16_dense", 1),
        plain_ms=event_ms(lambda i: w8a16_dense_ref(x, sets[i], sc, b), len(sets), 20),
        library_ms=event_ms(converted, len(sets), 100),
        library_device_ms=library_device_ms(converted, len(sets), 20),
        bound_ms=max(bound_bytes, bound_flops),
        bound_by="bytes" if bound_bytes >= bound_flops else "operations",
        geometry=dict(batch_tiles=geo.batch_tiles, tile_n=geo.tile_n, chunk_k=geo.chunk_k,
                      blocks=geo.blocks, cluster=geo.cluster,
                      chunks_per_warp=geo.chunks_per_warp),
    )


MOE_D, MOE_W, MOE_SHARED = 3584, 18944, 4736   # Uni-MoE-2.0-Omni: d, a routed expert, the shared SwiGLU


def moe_case(b: int, kept: int, path: str = "") -> dict:
    """The omni step's expert layer (kernels/moe.py's kernel pair) at the
    published widths, ``b`` lanes, the first ``kept`` of the 4 routed
    experts kept (expert e by lane e % b, expert 0 by every lane): against
    its plain version, and beside the cuBLAS chain it replaced (the shared
    SwiGLU and every routed expert over every lane, gate 0 where a lane did
    not keep it: two products, chunk, SiLU, multiply, cast, gate multiply,
    add an expert). Device times per launch of each kernel and per pair;
    the kernel's and the plain version's errors against the expression in
    f64 with unrounded activations, of the down products' magnitude sum."""
    import torch

    from whisper_tpu_torch.kernels.moe import DOWN_SPLITS, OUT_TILE, moe_experts, moe_experts_ref, swiglu

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)

    def pair(w):
        gate_up = (torch.randn((2 * w, MOE_D), generator=g, device="cuda") * MOE_D ** -0.5).bfloat16()
        down = (torch.randn((MOE_D, w), generator=g, device="cuda") * w ** -0.5).bfloat16()
        return gate_up.T, down.T

    shared, routed = pair(MOE_SHARED), [pair(MOE_W) for _ in range(4)]
    h = torch.randn((b, MOE_D), generator=g, device="cuda").bfloat16()
    gates = torch.zeros((b, 5), device="cuda")
    for e in range(kept):
        lanes = list(range(b)) if e == 0 else [e % b]
        gates[lanes, e] = torch.rand((len(lanes),), generator=g, device="cuda") * 0.9 + 0.05
    gates = gates[:, :4]

    def kernel(_):
        return moe_experts(h, gates, shared, routed)

    def plain(_):
        return moe_experts_ref(h, gates, shared, routed)

    def chain(_):
        out = swiglu(h, *shared)
        for e, (gate_up, down) in enumerate(routed):
            out = out + gates[:, e:e + 1] * swiglu(h, gate_up, down)
        return out

    got, want = kernel(0), plain(0)
    torch.cuda.synchronize()
    check(got.shape == (b, MOE_D) and bool(torch.isfinite(got).all()), f"moe_experts B={b}: shape or finite")
    mag = 0.0
    for e, (gate_up, down) in enumerate([shared, *routed]):
        gv, uv = (h.float() @ gate_up.float()).chunk(2, dim=-1)
        a = (torch.nn.functional.silu(gv) * uv).bfloat16().float().abs() @ down.float().abs()
        mag = mag + (a if e == 0 else gates[:, e - 1:e].abs() * a)
    rel = ((got - want).abs() / (mag + 1e-30)).max().item()
    # both against the expression in f64 with unrounded activations: the same error statistics
    # mean the pair differs from the cuBLAS path in f32 order and bf16 rounding neighbours alone
    exact = torch.zeros((b, MOE_D), dtype=torch.float64, device="cuda")
    for e, (gate_up, down) in enumerate([shared, *routed]):
        if e == 0 or bool(gates[:, e - 1].any()):
            gv, uv = (h.double() @ gate_up.double()).chunk(2, dim=-1)
            y = (torch.nn.functional.silu(gv) * uv) @ down.double()
            exact += y if e == 0 else gates[:, e - 1:e].double() * y
    err_f64 = {}
    for side, y in (("kernel", got), ("plain", want)):
        r = (y.double() - exact).abs() / (mag.double() + 1e-30)
        err_f64[side] = dict(mean=r.mean().item(), max=r.max().item())
    del exact
    streamed = 3 * MOE_D * (MOE_SHARED + kept * MOE_W) * 2
    bytes_ = streamed + 2 * b * MOE_D + 4 * b * MOE_D + 4 * b * 4
    bound_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_flops = 2 * b * streamed / 2 / BF16_FLOPS * 1e3
    del mag
    return dict(
        case=f"B={b} d={MOE_D} routed {kept} of 4 x w={MOE_W} + shared w={MOE_SHARED}", path=path,
        max_abs_err=rel, tol=1e-4, err_f64=err_f64,
        tol_reason="relative to the down products' magnitude sum: f32 sums in other orders, and a bf16 "
                   "activation rounded to its neighbour where the reordered sum crosses a rounding point",
        ms=event_ms(kernel, 1, 20),
        device_ms=device_ms(kernel, 1, 10, "moe_", 2),
        gate_up_device_ms=device_ms(kernel, 1, 10, "moe_gate_up_kernel", 1),
        down_device_ms=device_ms(kernel, 1, 10, "moe_down_kernel", 1),
        plain_ms=event_ms(plain, 1, 5),
        library_ms=event_ms(chain, 1, 10),
        library_device_ms=library_device_ms(chain, 1, 5),
        bound_ms=max(bound_bytes, bound_flops),
        bound_by="bytes" if bound_bytes >= bound_flops else "operations",
        geometry=dict(gate_up_blocks=(MOE_SHARED + 4 * MOE_W) // 16,
                      gate_up_blocks_run=(MOE_SHARED + kept * MOE_W) // 16,
                      down_blocks=MOE_D // OUT_TILE * DOWN_SPLITS, down_splits=DOWN_SPLITS),
    )


def show_case(name: str, c: dict) -> None:
    """Log a case with its share of the bound (bound over device time) and
    its ratio to the library call (events over events, device over device),
    keep both in the case, and hold its error to the tolerance."""
    def f(x):
        return "n/a" if x is None else f"{x:.4f}"

    def ratio(a, b):
        return None if a is None or b is None else a / b

    c["bound_share"] = ratio(c["bound_ms"], c["device_ms"])
    c["vs_library"] = ratio(c["ms"], c["library_ms"])
    c["vs_library_device"] = ratio(c["device_ms"], c["library_device_ms"])
    log(f"  {name} [{c['case']}{', ' + c['path'] if c.get('path') else ''}]: max_abs_err {c['max_abs_err']:.3e} (tol {c['tol']:.0e}: "
        f"{c['tol_reason']}); ms {f(c['ms'])} (device {f(c['device_ms'])}), plain_ms "
        f"{f(c['plain_ms'])}, library_ms {f(c['library_ms'])} (device "
        f"{f(c['library_device_ms'])}), bound_ms {f(c['bound_ms'])} ({c['bound_by']}); "
        f"share of bound {f(c['bound_share'])}, x library {f(c['vs_library'])} (device "
        f"{f(c['vs_library_device'])})")
    if "library_backend" in c:
        log(f"    SDPA took {c['library_backend']}")
    if "geometry" in c:
        log("    launch geometry: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                             for k, v in c["geometry"].items()))
    if "shape_device_ms" in c:
        log("    device ms by block shape: " + ", ".join(f"{k} {f(v)}" for k, v in
                                                   c["shape_device_ms"].items()))
    check(c["max_abs_err"] <= c["tol"], f"{name} {c['case']}: error {c['max_abs_err']} > {c['tol']}")


# ---------------------------------------------------------------------------
# phase 3b: the microbenchmark's kernels (K3-K9)
# ---------------------------------------------------------------------------

# kernel id, wrapper, variant, the TPU's pallas_call, its body, tolerance
# against the plain version (times max(1, max |plain|); "rows": 1e-5 of the
# row's sum of |k| + |v|). For bf16 p (K4b, K7) 1e-4, since an ulp of exp
# can flip one bf16 rounding of p; on the random inputs the mean error must
# also stay under ROUNDING_SHARE of the mean gap between the bf16-p and
# f32-p plain versions, which a kernel that skipped the rounding (or
# rounded at another max) would show in full.
ROUNDING_SHARE = 0.25
KBENCH = [
    ("K3", "kernel_read", "read", "tools/kbench.py:54", "kernel_read :65-80", "rows"),
    ("K4a", "kernel_vpu", "vpu", "tools/kbench.py:54", "kernel_vpu :82-111", 1e-5),
    ("K4b", "kernel_mxu", "mxu", "tools/kbench.py:54", "kernel_mxu :114-150", 1e-4),
    ("K5", "kernel_rows", "rows", "tools/kbench.py:174", "kernel_rows :170-172", "rows"),
    ("K6", "kernel_read_all_layers", "read1", "tools/kbench.py:215", "kernel_read3 :200-213",
     "rows"),
    ("K7", "kernel_mxub", "mxub", "tools/kbench.py:277", "kernel_mxub :243-275", 1e-4),
    ("K8", "kernel_vpu8", "vpu8", "tools/kbench.py:336", "kernel_vpu8 :302-334", 1e-5),
    ("K9", "kernel_flatread", "flatread", "tools/kbench.py:397", "kernel_read :65-80", "rows"),
]
KB_PATTERN = {"kernel_vpu": "kb_attn_f32_split", "kernel_vpu8": "kb_attn_int8_split",
              "kernel_mxu": "kb_attn_mma_dense", "kernel_mxub": "kb_attn_mma_head"}


def kbench_phase() -> tuple[list[dict], dict]:
    """The port's kbench at the JAX tool's large-v2 defaults (B=8 S=1500
    HD=1280 H=20 L=32 CS=512 RB=256): each kernel against its plain version
    on the tool's inputs (one layer, or all slabs for K6 and K9) and on
    seeded random ones of the same shape; then every variant's pass timed
    by ``run`` with its launches counted (the ledger read just before and
    just after); then per kernel the profiler's device time per launch, the plain
    pass, the library pass and the bound."""
    import gc

    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.kernels import kbench as kb
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.tools import kbench as tool

    d = tool.Dims()
    inp = tool.make_inputs(d, "cuda", tool.VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shape = inp["k"].shape
    rnd = dict(q=(torch.randn(inp["q"].shape, generator=g, device="cuda") * 0.3).bfloat16(),
               k=(torch.randn(shape, generator=g, device="cuda") * 0.3).bfloat16(),
               v=torch.randn(shape, generator=g, device="cuda").bfloat16(),
               k8=torch.randint(-127, 128, shape[1:], generator=g, device="cuda", dtype=torch.int8),
               v8=torch.randint(-127, 128, shape[1:], generator=g, device="cuda", dtype=torch.int8),
               sk=torch.rand((d.B, 1, d.s_pad), generator=g, device="cuda") * 9e-3 + 1e-3,
               sv=torch.rand((d.B, 1, d.s_pad), generator=g, device="cuda") * 9e-3 + 1e-3)
    per_layer = {name: name not in ("kernel_read_all_layers", "kernel_flatread")
                 for _, name, *_ in KBENCH}

    def args(name, li, x=inp):
        if name in ("kernel_read", "kernel_rows"):
            return x["k"][li], x["v"][li], d.RB if name == "kernel_rows" else d.CS
        if not per_layer[name]:
            return x["k"], x["v"], d.CS
        if name == "kernel_vpu8":
            if x is inp:
                return (x["q"], x["k8"][li], x["v8"][li], x["sc"][li], x["sc"][li], d.H, d.S, d.CS)
            return x["q"], x["k8"], x["v8"], x["sk"], x["sv"], d.H, d.S, d.CS
        return x["q"], x["k"][li], x["v"][li], d.H, d.S, d.CS

    # 1. kernel against plain on the card (launches here are not counted)
    errs, rounding = {}, {}
    for _, name, _, _, _, tol in KBENCH:
        wrapper, ref = kb.KERNELS[name]
        errs[name] = 0.0
        for x in (inp, rnd):
            a = args(name, 1, x)
            got, want = wrapper(*a), ref(*a)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{name} output")
            err = (got - want).abs()
            if tol == "rows":
                scale = (a[0].float().abs() + a[1].float().abs()).sum(-1, keepdim=True)
                rel = (err.reshape(scale.shape) / scale).max().item()
                check(rel <= 1e-5, f"{name}: error {rel} of the row's sum of |k| + |v| > 1e-5")
            else:
                # the tool's int8 K/V reach 100 with unit scales, so outputs do
                # too: the bound scales with the output's size past 1
                bound = tol * max(1.0, want.abs().max().item())
                check(err.max().item() <= bound, f"{name}: error {err.max().item()} > {bound}")
            if name in ("kernel_mxu", "kernel_mxub") and x is rnd:
                gap = (want - kb.attention_ref(*a)).abs().mean().item()
                rounding[name] = err.mean().item() / gap
                check(rounding[name] <= ROUNDING_SHARE,
                      f"{name}: mean error {err.mean().item()} is {rounding[name]:.3f} of the "
                      f"bf16 rounding's mean effect {gap} (limit {ROUNDING_SHARE})")
            errs[name] = max(errs[name], err.max().item())
            del got, want, err
    del rnd
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the kbench run: every variant, its launches counted
    before = LAUNCHES.copy()
    records = tool.run(d, tool.VARIANTS, "cuda", inputs=inp)
    counts = {name: LAUNCHES[name] - before[name] for name in kb.KERNELS}
    variants = tool.make_variants(d, inp, tool.VARIANTS)
    for _, name, var, *_ in KBENCH:
        want = (tool.REPS + 1) * variants[var].launches_per_pass
        check(counts[name] == want, f"kbench run: {name} launched {counts[name]} times, want "
                                    f"{want} ({tool.REPS} passes and a warm-up)")
    # every variant's device time per pass (all its kernels, two passes under
    # the profiler): the event times above include the host's launch gaps,
    # which vary from run to run on a shared host
    for name, var in variants.items():
        busy = breakdown(lambda: [var.fn() for _ in range(2)])["busy_ms"]
        records[name]["device_ms"] = busy / 2
    log("  device ms per pass: " + ", ".join(f"{n} {r['device_ms']:.4f}"
                                             for n, r in records.items()))
    # the W8A16 kernel in w8mm's pass over the same int8 weights [L, D, 14 D]
    # (x0, then per layer x @ w8[li] * wscale, the next x its first D columns
    # in bf16), beside w8mm (the converted product) and wbfmm (bf16 weights)
    from whisper_tpu_torch.kernels.w8a16 import w8a16_dense, w8a16_dense_ref

    def w8a16_pass():
        x = inp["x0"]
        for li in range(d.L):
            x = w8a16_dense(x, inp["w8"][li], inp["wscale"])[:, :tool.D].to(torch.bfloat16) * 1e-3
        return x

    saved = LAUNCHES.copy()
    got = w8a16_dense(inp["x0"], inp["w8"][0], inp["wscale"])
    want = w8a16_dense_ref(inp["x0"], inp["w8"][0], inp["wscale"])
    mag = inp["x0"].float().abs() @ inp["w8"][0].float().abs()
    err = ((got - want).abs() / (mag + 1e-30)).max().item()
    check(err <= 1e-5, f"w8a16 on w8mm's weights: error {err} of the magnitude sum")
    records["w8a16"] = dict(ms=event_ms(lambda _: w8a16_pass(), 1, tool.REPS),
                            device_ms=breakdown(lambda: [w8a16_pass() for _ in range(2)])["busy_ms"] / 2,
                            bytes=records["w8mm"]["bytes"], bound_ms=records["w8mm"]["bound_ms"],
                            max_rel_err=err)
    LAUNCHES.clear()
    LAUNCHES.update(saved)
    log("  w8a16 pass over w8mm's weights: ms {:.4f} (device {:.4f}), beside w8mm {:.4f} ({:.4f}) "
        "and wbfmm {:.4f} ({:.4f}); bound {:.4f} (the int8 weights); error {:.2e} of the "
        "magnitude sum".format(records["w8a16"]["ms"], records["w8a16"]["device_ms"],
                               records["w8mm"]["ms"], records["w8mm"]["device_ms"],
                               records["wbfmm"]["ms"], records["wbfmm"]["device_ms"],
                               records["w8mm"]["bound_ms"], err))

    # 3. per kernel: device time, plain pass, library pass, bound
    def sdpa_pass(_):
        q4 = inp["q"].view(d.B, d.H, 1, d.dh)
        for li in range(d.L):
            k4 = inp["k"][li].view(d.B, d.H, d.dh, d.s_pad).transpose(-1, -2)[:, :, : d.S]
            v4 = inp["v"][li].view(d.B, d.H, d.dh, d.s_pad).transpose(-1, -2)[:, :, : d.S]
            F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)

    def whole_sum_pass(_):
        return (inp["k"].sum(-1, keepdim=True, dtype=torch.float32)
                + inp["v"].sum(-1, keepdim=True, dtype=torch.float32))

    # each yardstick's pass on events and on device time over all its kernels
    library = {"xla": records["xla"]["ms"], "whole": event_ms(whole_sum_pass, 1, 5),
               "sdpa": event_ms(sdpa_pass, 1, 5)}
    library_dev = {"xla": records["xla"]["device_ms"],
                   "whole": library_device_ms(whole_sum_pass, 1, 2),
                   "sdpa": library_device_ms(sdpa_pass, 1, 2)}
    kv_elems = d.L * d.B * d.HD * d.s_pad
    geo = kb.mxu_geometry(d.B, d.HD, d.H, d.s_pad, d.CS)
    log(f"  K4b geometry: {geo.groups} groups of {geo.heads} heads x {d.B} lanes x clusters of "
        f"{geo.cluster} blocks = {geo.blocks} blocks, key ranges {list(geo.ranges)}, "
        f"{geo.smem} B of shared memory a block; the card holds "
        f"{kb.mxu_active_clusters(geo, d.HD, d.H, d.s_pad, d.CS)} such clusters at once")
    g7 = kb.mxub_geometry(d.B, d.H, d.s_pad, d.CS)
    log(f"  K7 geometry: {d.H} heads x {d.B} lanes x clusters of {g7.cluster} blocks = "
        f"{g7.blocks} blocks, key ranges {list(g7.ranges)}, a ring of {g7.stages} tiles, "
        f"{g7.smem} B of shared memory a block; the card holds "
        f"{kb.mxub_active_clusters(g7, d.s_pad, d.CS)} such clusters at once")
    g4a = kb.vpu_geometry(d.B, d.H, d.S, d.s_pad)
    log(f"  K4a geometry: {d.H} heads x {d.B} lanes x clusters of {g4a.cluster} blocks = "
        f"{g4a.blocks} blocks, key ranges {list(g4a.ranges)}, "
        f"{'TMA' if g4a.tma else '4-byte cp.async'} loads, {kb.VPU_SMEM} B of static shared "
        f"memory a block; the card holds "
        f"{kb.vpu_active_clusters(g4a, d.HD, d.S, d.s_pad)} such clusters at once")
    # the clusters the card holds at every size (kernels.kbench.CLUSTER_SLOTS)
    slots = {}
    for c in range(1, kb.MAX_CLUSTER + 1):
        geo_c = dataclasses.replace(g4a, cluster=c, ranges=tuple(kb.vpu_ranges(d.S, c)))
        slots[c] = kb.vpu_active_clusters(geo_c, d.HD, d.S, d.s_pad)
    log("  K4a clusters held at once by cluster size, " + f"{kb.VPU_BLOCKS_PER_SM} blocks an SM: "
        + ", ".join(f"{c}: {n}" for c, n in slots.items()))
    for c, n in slots.items():
        want_slots = kb.CLUSTER_SLOTS.get((c, kb.VPU_BLOCKS_PER_SM))
        check(want_slots is None or want_slots == n,
              f"K4a: the card holds {n} clusters of {c}, CLUSTER_SLOTS says {want_slots}")
    g8 = kb.vpu8_geometry(d.B, d.H, d.S, d.s_pad)
    log(f"  K8 geometry: {d.H} heads x {d.B} lanes x clusters of {g8.cluster} blocks = "
        f"{g8.blocks} blocks, key ranges {list(g8.ranges)}, {g8.vec}-byte loads; the card holds "
        f"{kb.vpu8_active_clusters(g8, d.HD, d.S, d.s_pad)} such clusters at once")
    # K8's yardstick: K2's int8 branch (split-S and a combine launch) on the
    # tool's int8 inputs of one layer, keys < S, per call on device time; its
    # counters are put back so that the main path's counts stay exact
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd as k2
    saved = LAUNCHES.copy()
    valid = torch.full((d.B,), d.S, dtype=torch.int32, device="cuda")
    k2_int8_dev = device_ms(lambda li: k2(inp["q"], inp["k8"][li], inp["v8"][li], d.H,
                                          valid_len=valid, k_scale=inp["sc"][li],
                                          v_scale=inp["sc"][li]), d.L, 2 * d.L, "decode_attention")
    LAUNCHES.clear()
    LAUNCHES.update(saved)
    out = []

    def f(x):
        return "n/a" if x is None else f"{x:.4f}"

    for kid, name, var, call, body, tol in KBENCH:
        v_ = variants[var]
        per_pass = v_.launches_per_pass
        pattern = KB_PATTERN.get(name, "kv_rowsum")
        dev = device_ms(lambda _: v_.fn(), 1, 2, pattern, per_pass)
        ref = kb.KERNELS[name][1]
        if per_layer[name]:
            plain = event_ms(lambda _: [ref(*args(name, li)) for li in range(d.L)], 1, 2)
        else:
            plain = event_ms(lambda _: ref(*args(name, 0)), 1, 2)
        if name in ("kernel_vpu", "kernel_mxu", "kernel_mxub", "kernel_vpu8"):
            # the operations the kernel does, at its type's peak: q.K and P.V
            # over S_PAD keys, 2 flops a product; K7 puts q and p in one
            # 8-column n-tile each (K and V are A); K4b issues a 16-row
            # m-tile for the scores and 8 columns per 8 heads of its group
            # for P.V
            rows = {"kernel_mxu": 16 + 8 * geo.n_tiles, "kernel_mxub": 16}.get(name, 2)
            ops_ms = 2 * kv_elems * rows / (BF16_FLOPS if rows > 2 else F32_FLOPS) * 1e3
        else:
            ops_ms = 2 * kv_elems / F32_FLOPS * 1e3     # k + v and the running sum
        need = records[var]["bytes"]
        if name in ("kernel_vpu", "kernel_mxu", "kernel_mxub", "kernel_vpu8"):
            # attention needs only the keys < S (p is 0 past them): the K/V
            # rows over S (int8 for K8, with both scales), q once and the
            # outputs; the tool's bytes count all S_PAD columns
            kv_row = (2 * d.HD + 2 * 4) * d.S if name == "kernel_vpu8" else 2 * d.HD * d.S * 2
            need = d.L * d.B * (kv_row + 4 * d.HD) + 2 * d.B * d.HD
            ops_ms = ops_ms * d.S / d.s_pad
        bytes_ms = need / tool.HBM_BYTES_PER_S * 1e3
        lib_key = ("xla" if name in ("kernel_read", "kernel_rows")
                   else "whole" if not per_layer[name]
                   else None if name == "kernel_vpu8" else "sdpa")
        lib_ms, lib_dev = (library[lib_key], library_dev[lib_key]) if lib_key else (None, None)
        e = dict(name=name, id=kid, route="cuda", source="whisper_tpu_torch/csrc/kbench.cu",
                 replaces=call, tpu_body=body, launches=counts[name],
                 launches_by_path={"kbench pass": per_pass},
                 max_abs_err=errs[name], tol=tol, rounding_share=rounding.get(name),
                 unit="per kbench pass (L=32 layers)",
                 ms=records[var]["ms"], device_ms=None if dev is None else dev / per_pass,
                 device_ms_per_pass=dev, plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=lib_ms,
                 library_device_ms=lib_dev,
                 vs_library_device=None if dev is None or lib_dev is None else dev / lib_dev,
                 bytes=need, tool_bytes=records[var]["bytes"], gbps=records[var]["gbps"],
                 shape=f"kbench B={d.B} S={d.S} (pad {d.s_pad}) HD={d.HD} H={d.H} CS={d.CS} "
                       f"L={d.L} RB={d.RB}")
        out.append(e)
        share = "" if name not in rounding else f", {rounding[name]:.4f} of the rounding's effect"
        log(f"  {kid} {name}: max_abs_err {e['max_abs_err']:.3e} (tol {tol}{share}); ms/pass "
            f"{f(e['ms'])} (device {f(dev)} = {per_pass} x {f(e['device_ms'])}), plain "
            f"{f(plain)}, library {f(lib_ms)} (device {f(lib_dev)}), bound {f(e['bound_ms'])} "
            f"({e['bound_by']}); share of bound {f(None if dev is None else e['bound_ms'] / dev)}, "
            f"x library device {f(e['vs_library_device'])}; launches {counts[name]} "
            f"({per_pass} per pass)")
        if name in ("kernel_vpu", "kernel_mxu", "kernel_mxub"):
            log(f"    bytes the kernel needs over the keys < S {need} a pass (the tool's, over "
                f"S_PAD: {e['tool_bytes']}, bound {f(records[var]['bound_ms'])})")
        if name in ("kernel_vpu", "kernel_mxub"):
            # the fixed cost a launch: the launch at S = 1 reads one K and
            # one V tile a (head, lane) (K7 keeps its clusters of 3, K4a takes
            # clusters of 1) and still pays the ramp, the cluster barriers
            # and the combine
            wrapper = kb.KERNELS[name][0]
            s1 = device_ms(lambda li: wrapper(inp["q"], inp["k"][li], inp["v"][li], d.H, 1, d.CS),
                           d.L, 2 * d.L, pattern, 1)
            e["device_ms_s1"] = s1
            if s1 is not None and dev is not None:
                rate = need / d.L / ((e["device_ms"] - s1) * 1e-3) / 1e12
                log(f"    fixed cost: device ms a launch at S = 1 {s1:.4f} of {e['device_ms']:.4f}; "
                    f"the rest moves the launch's {need // d.L} B at {rate:.3f} TB/s")
        if name == "kernel_vpu":
            # the geometry's choice against its neighbours: the same launches
            # with clusters of 2 and of 4 (two rounds on the card)
            by_cluster = {}
            chosen = kb.vpu_geometry
            try:
                for c in (2, 4):
                    forced = dataclasses.replace(g4a, cluster=c, ranges=tuple(kb.vpu_ranges(d.S, c)))
                    kb.vpu_geometry = lambda *_, g=forced: g
                    by_cluster[c] = device_ms(lambda li: kb.kernel_vpu(
                        inp["q"], inp["k"][li], inp["v"][li], d.H, d.S, d.CS), d.L, 2 * d.L, pattern,
                        1)
            finally:
                kb.vpu_geometry = chosen
            e["device_ms_by_cluster"] = {g4a.cluster: e["device_ms"], **by_cluster}
            log("    device ms a launch by cluster size: " + ", ".join(
                f"{c}: {f(t)}" for c, t in sorted(e["device_ms_by_cluster"].items())))
            # the instance that fills the ring by 4-byte cp.async (S_PAD % 8 != 0):
            # 8 layers of the tool's K/V cut to S_PAD = S + 2
            kn, vn = (x[:8, ..., :d.S + 2].contiguous() for x in (inp["k"], inp["v"]))
            narrow = device_ms(lambda li: kb.kernel_vpu(inp["q"], kn[li], vn[li], d.H, d.S, 2), 8, 16,
                               pattern, 1)
            want_n = kb.attention_ref(inp["q"], kn[1], vn[1], d.H, d.S, 2)
            err_n = (kb.kernel_vpu(inp["q"], kn[1], vn[1], d.H, d.S, 2) - want_n).abs().max().item()
            check(err_n <= 1e-5 * max(1.0, want_n.abs().max().item()),
                  f"K4a at S_PAD {d.S + 2}: error {err_n}")
            e["device_ms_narrow"] = narrow
            log(f"    S_PAD = {d.S + 2} (4-byte cp.async instead of TMA): device ms a launch "
                f"{f(narrow)}, max_abs_err {err_n:.3e}")
            del kn, vn, want_n
        if name in ("kernel_vpu", "kernel_vpu8"):
            # the CLI's single stream: lane 0 of the tool's inputs, B = 1
            if name == "kernel_vpu":
                b1 = device_ms(lambda li: kb.kernel_vpu(inp["q"][:1], inp["k"][li][:1],
                                                        inp["v"][li][:1], d.H, d.S, d.CS),
                               d.L, 2 * d.L, pattern, 1)
                need1 = 2 * d.HD * d.S * 2 + 4 * d.HD + 2 * d.HD
                g1 = kb.vpu_geometry(1, d.H, d.S, d.s_pad)
            else:
                b1 = device_ms(lambda li: kb.kernel_vpu8(
                    inp["q"][:1], inp["k8"][li][:1], inp["v8"][li][:1], inp["sc"][li][:1],
                    inp["sc"][li][:1], d.H, d.S, d.CS), d.L, 2 * d.L, pattern, 1)
                need1 = (2 * d.HD + 2 * 4) * d.S + 4 * d.HD + 2 * d.HD
                g1 = kb.vpu8_geometry(1, d.H, d.S, d.s_pad)
            e["device_ms_b1"], e["bound_ms_b1"] = b1, need1 / tool.HBM_BYTES_PER_S * 1e3
            log(f"    B = 1 (lane 0): device ms a launch {f(b1)}, bound {e['bound_ms_b1']:.5f} "
                f"(bytes), clusters of {g1.cluster}, {g1.blocks} blocks")
        if name == "kernel_vpu8":
            e["k2_int8_device_ms"] = k2_int8_dev
            log(f"    bytes the kernel needs over the keys < S {need} a pass (the tool's, over "
                f"S_PAD: {e['tool_bytes']}, bound {f(records[var]['bound_ms'])}); yardstick: "
                f"K2's int8 branch on the same layer, device ms a call {f(k2_int8_dev)} "
                f"against K8's {f(e['device_ms'])} (bound {e['bound_ms'] / per_pass:.5f} a "
                f"launch)")
    log("  library passes, ms (device): " + ", ".join(
        f"{label} {library[key]:.4f} ({f(library_dev[key])})" for key, label in
        (("xla", "torch.sum per layer"), ("whole", "over all slabs"), ("sdpa", "SDPA per layer"))))
    del inp, variants
    gc.collect()
    torch.cuda.empty_cache()
    return out, records


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------

class eager:
    """Within the block the runtime ``rt`` runs its token steps eagerly,
    launch by launch (``cuda_graphs=False``): the plain version that the
    replayed graphs are held against."""

    def __init__(self, rt):
        self.rt = rt

    def __enter__(self):
        self.rt.cuda_graphs = False
        return self.rt

    def __exit__(self, *exc):
        self.rt.cuda_graphs = True


def same_window(a, b) -> bool:
    """Every array of two WindowResults equal, bit for bit."""
    import torch

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def graph_slot(rt, kind: str, lanes: int):
    """The runtime's one slot of a ``kind`` loop over ``lanes`` lanes."""
    slots = [s for key, s in rt.graphs.slots.items() if key[:2] == (kind, lanes)]
    check(len(slots) == 1, f"{len(slots)} {kind} slots of {lanes} lanes")
    return slots[0]


def slot_record(slot) -> dict:
    """What one slot holds: its static tensors' bytes, the bytes of its
    graphs' memory pool, and each captured step's capture + instantiate ms
    and replays."""
    return dict(static_bytes=slot.nbytes, pool_bytes=slot.pool_bytes(),
                steps={str(k): dict(capture_ms=v.capture_ms, replays=v.replays,
                                    k2_per_replay=v.launches["decode_attention_hd"])
                       for k, v in slot.steps.items()})


def show_slot(label: str, rec: dict) -> None:
    caps = ", ".join(f"{k} {v['capture_ms']:.1f} ms" for k, v in rec["steps"].items())
    log(f"  {label} graph slot: {rec['static_bytes'] / 1e9:.3f} GB of static tensors + "
        f"{rec['pool_bytes'] / 1e9:.3f} GB of graph pool; capture + instantiate per step key: {caps}")


def read_gap_ms(slot, key: tuple, n: int) -> dict:
    """The host's cost of the loop's read of ``stop``: ``run_steps`` over
    ``n`` replays of the slot's captured step ``key`` with no read, with a
    read after every step, and with the read one step behind (what the
    loop does on graphs), in turns twice each, ms per step (the least of
    the two). Its flag is never set in ``n`` steps, so every pass runs
    ``n``. They run over the slot's state with its counter set to 0, so no
    replay writes past the cache (the next window resets the state); their
    kernel counts are taken back."""
    import torch

    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.runtime.decode import run_steps

    st, step = slot.state, slot.steps[key]
    check(key[2] == 0 or key[2] > n, f"the step of {key} would set its flag within {n} steps")
    saved = LAUNCHES.copy()
    modes = {"no read": dict(force_steps=n), "read each step": dict(force_steps=0),
             "read one behind": dict(force_steps=0, behind=True)}
    ms = {m: [] for m in modes}
    for mode in [*modes, *reversed(modes)]:
        with torch.inference_mode():          # the slot's tensors are inference tensors
            st.i.zero_()
            st.stop.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = run_steps(lambda _: step(), st.stop, n, **modes[mode])
            torch.cuda.synchronize()
        ms[mode].append((time.perf_counter() - t0) * 1e3 / n)
        check(steps == n, f"{mode}: {steps} of {n} steps")
    LAUNCHES.clear()
    LAUNCHES.update(saved)
    best = {m: min(v) for m, v in ms.items()}
    return dict(ms_per_step=best, gap_each_ms=best["read each step"] - best["no read"],
                gap_behind_ms=best["read one behind"] - best["no read"])


def show_graph_breakdown(label: str, bd: dict, per: int, want_kernels: int) -> None:
    """show_breakdown for replayed graphs: whether the profiler's trace
    lists the graph's kernels (``want_kernels`` a step); a trace without
    them gives no device time (logged, not failed)."""
    listed = bd["launches"] / per
    log(f"  {label}: the trace lists {listed:.0f} kernels a step of the {want_kernels} the "
        f"eager step launches" + ("" if listed else " (graph kernels not traced: no device time)"))
    if listed:
        show_breakdown(label, bd, per)


def launched(rt, fn):
    """(result of ``fn()``, the token steps the card ran for it): the
    runtime's replays when it replays its steps (a window that ends before
    its cap runs one more, frozen, step: its flag is read one step behind),
    else the window's ``steps``."""
    before = rt.graphs.replays()
    res = fn()
    return res, (rt.graphs.replays() - before) if rt.replays else int(res.steps)


class counting:
    """Records a runtime's encodes (their batch widths, ``widths``) and each
    window's token steps (``window_steps``) and the steps the card ran for
    it (``window_launched``, ``launched``) while in the ``with`` block, from
    whichever thread calls it (run_capture's worker too): the K1 and K2
    launches a run implies are L_enc per encode and 2 L_dec per step run."""

    def __init__(self, rt):
        self.rt, self.widths, self.window_steps, self.window_launched = rt, [], [], []

    @property
    def encodes(self) -> int:
        return len(self.widths)

    @property
    def steps(self) -> int:
        return sum(self.window_steps)

    @property
    def launched(self) -> int:
        return sum(self.window_launched)

    def __enter__(self):
        encode, run = self.rt.encode_window, self.rt.run_window

        def counted_encode(mel):
            self.widths.append(mel.shape[0])
            return encode(mel)

        def counted_run(*a, **kw):
            res, n = launched(self.rt, lambda: run(*a, **kw))
            self.window_steps.append(int(res.steps))
            self.window_launched.append(n)
            return res

        self.rt.encode_window, self.rt.run_window = counted_encode, counted_run
        return self

    def __exit__(self, *exc):
        del self.rt.encode_window, self.rt.run_window


def speechy(n: int, seed: int) -> np.ndarray:
    """A loud modulated 1.2 kHz tone with noise, which the VAD takes for speech."""
    t = np.arange(n) / 16_000
    noise = 0.05 * np.random.default_rng(seed).standard_normal(n)
    return ((0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) * np.sin(2 * np.pi * 1200 * t)
            + noise).astype(np.float32)


def noise_floor(n: int, seed: int = 1) -> np.ndarray:
    """A quiet 60 Hz hum, the silence the VAD's thresholds adapt to."""
    t = np.arange(n) / 16_000
    noise = 1e-5 * np.random.default_rng(seed).standard_normal(n)
    return (1e-3 * np.sin(2 * np.pi * 60 * t) + noise).astype(np.float32)


def chunks_of(audio: np.ndarray, n: int = 1600) -> list:
    return [audio[i : i + n] for i in range(0, len(audio), n)]


def paced(chunks):
    """Yield each chunk once no thread started since the first chunk is
    alive: the capture runner then never finds its worker busy (it would
    cut other buffers, STALLED), so the card and the CPU see the same
    buffers however fast each transcribes."""
    import threading

    base = set(threading.enumerate())
    for chunk in chunks:
        while any(t.is_alive() for t in threading.enumerate() if t not in base):
            time.sleep(0.001)
        yield chunk


def recorded_capture(ctx, params, chunks, capture_params) -> tuple[list, list, object]:
    """Context.run_capture over paced ``chunks``; the buffers handed to
    run_full, the ms each took (run_full returns segments read back to the
    host, so its device work has ended), and the result."""
    buffers, ms = [], []
    run_full = ctx.run_full

    def recording_run_full(p, pcm):
        t0 = time.perf_counter()
        res = run_full(p, pcm)
        buffers.append(len(pcm))
        ms.append((time.perf_counter() - t0) * 1e3)
        return res

    ctx.run_full = recording_run_full
    try:
        res = ctx.run_capture(params, paced(chunks), capture_params=capture_params)
    finally:
        del ctx.run_full
    return buffers, ms, res


def serving_model(path: str, device: str, mesh=None, cuda_graphs: bool = True):
    """The serving tier through the user's entry points: int8 decoder
    weights from load_model(policy=DtypePolicy.serving()), and the model's
    runtime swapped for one with int8 K/V caches (``Model`` keeps the JAX
    package's interface, whose runtime takes the cache tier separately)."""
    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.model.params import DtypePolicy
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    model = load_model(path, policy=DtypePolicy.serving(), device=device, mesh=mesh,
                       cuda_graphs=cuda_graphs)
    rt = model.runtime
    model.runtime = WhisperRuntime(rt.params, rt.dims, rt.ids, compute_dtype=rt.compute_dtype,
                                   device=rt.device, kv_int8=True, cuda_graphs=cuda_graphs)
    return model


def wav_bytes(pcm: np.ndarray) -> bytes:
    """A mono 16 kHz 16-bit WAV file of ``pcm``."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def serve_posts(model, bodies: list[bytes]) -> list[dict]:
    """The port's server (cli/serve.py) on a free port with batch 4, one
    concurrent POST per body; the parsed answers, in order."""
    import threading
    import urllib.request

    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.cli.serve import make_server

    srv = make_server(model, 4, FullParams(language="en"), 0, host="127.0.0.1")
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    answers: list = [None] * len(bodies)

    def ask(i):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/transcribe",
                                     data=bodies[i], method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        srv.shutdown()
        srv.server_close()
        server_thread.join(timeout=60)
    return answers


def golden_phase(tmp: str) -> dict:
    """A small scripted checkpoint (head dim 64, so the card runs the
    kernels) through the user's entry points, on the card and on the CPU,
    on both tiers: greedy run_full, beam 5, token timestamps with max_len 2,
    a stereo clip louder on the left, run_streamed over ChunkedReader, the
    BatchTranscriber (batch 4, 6 clips, greedy and beam 5) and the server
    (3 concurrent POSTs). Each must give the script's transcript and the
    card must equal the CPU; the card's counters must show K1 and K2 (K2's
    grouped launches on every beam run, int8 on the serving tier), the
    CPU's none."""
    import torch

    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import Flags, FullParams, SamplingStrategy
    from whisper_tpu_torch.audio.load import ChunkedReader
    from whisper_tpu_torch.hparams import ModelDims
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.model.params import DtypePolicy
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    dims = ModelDims(51_864, 96, 256, 4, 2, 48, 256, 4, 2, 80, 1)
    beg, eot = 50_363, 50_256
    script = [beg, 32, 104, 105, beg + 96, eot]    # <|0.00|> " hi" <|1.92|> <|eot|>
    want = [(" hi", 0, 192, script[:5])]
    path = os.path.join(tmp, "scripted.bin")
    write_checkpoint(path, dims, scripted_tensors(dims, script, SEED))
    silence = np.zeros(16_000 * 2, np.float32)
    t = np.arange(16_000 * 2) / 16_000
    tone = (0.3 * np.sin(2 * np.pi * 220 * t) * (t > 0.4) * (t < 1.5)).astype(np.float32)
    stereo = np.stack([tone, 0.1 * tone])
    rng = np.random.default_rng(SEED)
    clips = [(0.1 * rng.standard_normal(int(16_000 * sec))).astype(np.float32)
             for sec in (1.2, 2.5, 1.6, 2.0, 2.2, 1.4)]
    bodies = [wav_bytes(c) for c in clips[:3]]
    greedy = FullParams(language="en")
    beam = FullParams(language="en", strategy=SamplingStrategy.BEAM_SEARCH, beam_width=5)
    ts = FullParams(language="en", flags=Flags.TOKEN_TIMESTAMPS, max_len=2)

    def segs(result, times=False):
        return [(s.text, s.t0, s.t1, [(t.id, t.t0, t.t1) if times else t.id for t in s.tokens])
                for s in result.segments]

    def speakers(result):
        return [(*seg, s.speaker.name) for seg, s in zip(segs(result), result.segments)]

    # name -> (beam?, run(model) -> comparable output, check of the output)
    runs = {
        "run_full": (False, lambda m: segs(m.create_context().run_full(greedy, silence)),
                     lambda out: out == want),
        "beam 5": (True, lambda m: segs(m.create_context().run_full(beam, silence)),
                   lambda out: out == want),
        "token timestamps, max_len 2": (
            False, lambda m: segs(m.create_context().run_full(ts, tone), times=True),
            lambda out: ("".join(s[0] for s in out) == " hi" and len(out) == 2
                         and [i for s in out for i, _, _ in s[3]] == script[:5] and out[0][1] == 0
                         and all(t0 >= 0 and t1 >= t0 for s in out for _, t0, t1 in s[3]))),
        "stereo": (False, lambda m: speakers(m.create_context().run_full(greedy, stereo)),
                   lambda out: out == [(*want[0], "LEFT")]),
        "run_streamed": (False, lambda m: segs(m.create_context().run_streamed(greedy, ChunkedReader(tone))),
                         lambda out: out == want),
        "batch 4 greedy": (False, lambda m: [segs(r) for r in BatchTranscriber(m, 4).transcribe(clips, greedy)],
                           lambda out: out == [want] * len(clips)),
        "batch 4 beam 5": (True, lambda m: [segs(r) for r in BatchTranscriber(m, 4).transcribe(clips, beam)],
                           lambda out: out == [want] * len(clips)),
        "server, 3 POSTs": (False, lambda m: serve_posts(m, bodies),
                            lambda out: out == [{"text": " hi", "segments": [
                                {"t0": 0.0, "t1": 1.92, "text": " hi"}]}] * len(bodies)),
    }
    out: dict = {}
    for tier in ("bf16", "serving"):
        got = {}
        for device in ("cuda", "cpu"):
            model = Model(path, device=device) if tier == "bf16" else serving_model(path, device)
            for name, (is_beam, run, ok) in runs.items():
                LAUNCHES.clear()
                t0 = time.perf_counter()
                got[name, device] = res = run(model)
                sec = time.perf_counter() - t0
                k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
                log(f"  {tier} tier, {name}, on {device} ({sec:.2f} s): {res}; launches K1 {k1}, "
                    f"K2 {k2} ({k2_int8} on int8 K/V, {k2_grouped} grouped)")
                check(ok(res), f"scripted {name}, {tier} tier, on {device}: {res}")
                if device == "cuda":
                    check(k1 > 0 and k2 > 0 and k2_int8 == (k2 if tier == "serving" else 0)
                          and (2 * k2_grouped == k2 if is_beam else k2_grouped == 0),
                          f"{name}, {tier}, on the card: launched K1 {k1} / K2 {k2} ({k2_int8} "
                          f"on int8 K/V, {k2_grouped} grouped) times")
                    out[f"{tier} {name}"] = dict(k1=k1, k2=k2, k2_int8=k2_int8,
                                                  k2_grouped=k2_grouped, s=sec)
                else:
                    check(k1 == k2 == 0, f"{name}, {tier}, on the CPU: K1 {k1} / K2 {k2} launches")
            del model
        for name in runs:
            check(got[name, "cuda"] == got[name, "cpu"],
                  f"{name}, {tier} tier: card {got[name, 'cuda']} != CPU {got[name, 'cpu']}")

    # DtypePolicy.f32() (K1's f32 instance on the card), and run_capture on
    # the bf16 tier over a paced source (1 s of noise floor, 4 s of speech,
    # 1 s of floor, 2 s of speech; max_duration 2 s, no prompt carried from
    # buffer to buffer): each the CPU's result, with the exact counts (K1:
    # L_enc per encode, all f32 under the f32 policy; K2: 2 L_dec per token
    # step), counted on the capture runner's worker thread.
    from whisper_tpu_torch.api.params import Flags
    from whisper_tpu_torch.audio.capture import CaptureParams

    chunks = chunks_of(np.concatenate([noise_floor(16_000), speechy(16_000 * 4, 0), noise_floor(16_000),
                                       speechy(16_000 * 2, 2)]))
    cap_params = CaptureParams(min_duration=1.0, max_duration=2.0)
    no_context = FullParams(language="en", flags=Flags.NO_CONTEXT)
    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    more = {}
    for device in ("cuda", "cpu"):
        for name in ("f32 run_full", "bf16 run_capture"):
            f32 = name.startswith("f32")
            model = Model(path, policy=DtypePolicy.f32() if f32 else None, device=device)
            ctx = model.create_context()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            with counting(model.runtime) as rec:
                if f32:
                    res = (None, segs(ctx.run_full(greedy, silence)))
                else:
                    buffers, _, result = recorded_capture(ctx, no_context, chunks, cap_params)
                    res = (buffers, segs(result))
            sec = time.perf_counter() - t0
            k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
            k1_f32 = LAUNCHES["flash_attention_f32"]
            more[name, device] = res
            log(f"  {name}, on {device} ({sec:.2f} s): buffers {res[0]}, {res[1]}; {rec.encodes} "
                f"encode(s), {rec.steps} token steps ({rec.launched} run); launches K1 {k1} ({k1_f32} "
                f"f32), K2 {k2}")
            check(res[1] == (want if f32 else want * 2) and (f32 or res[0][:2] == [32_000, 32_000]),
                  f"scripted {name} on {device}: {res}")
            if device == "cuda":
                check(rec.encodes >= 1 and k1 == n_enc * rec.encodes and k1_f32 == (k1 if f32 else 0)
                      and k2 == 2 * n_dec * rec.launched and k2_int8 == k2_grouped == 0,
                      f"{name} on the card: K1 {k1} ({k1_f32} f32) / K2 {k2} for {rec.encodes} "
                      f"encodes and {rec.launched} token steps run")
                out[name] = dict(k1=k1, k1_f32=k1_f32, k2=k2, encodes=rec.encodes, steps=rec.steps, s=sec)
            else:
                check(k1 == k2 == 0, f"{name} on the CPU: K1 {k1} / K2 {k2} launches")
            del model, ctx
    for name in ("f32 run_full", "bf16 run_capture"):
        check(more[name, "cuda"] == more[name, "cpu"],
              f"{name}: card {more[name, 'cuda']} != CPU {more[name, 'cpu']}")

    # a small random model: the card's encoder (kernels) against the CPU path
    path = os.path.join(tmp, "random.bin")
    write_checkpoint(path, dims, random_tensors(dims, SEED + 1))
    mel = np.random.default_rng(SEED).standard_normal((1, 80, 2 * dims.n_audio_ctx)).astype(np.float32)
    feats = {}
    for device in ("cuda", "cpu"):
        m = Model(path, policy=DtypePolicy(), device=device)
        feats[device] = m.runtime.encode_window(mel)[0].float().cpu()
    err = (feats["cuda"] - feats["cpu"]).abs().max().item()
    log(f"  small random encoder, bf16 tier, card vs CPU: max_abs_err {err:.3e} (tol 5e-2: "
        "bf16 activations rounded in other places by cuBLAS and the CPU GEMMs)")
    check(bool(torch.isfinite(feats["cuda"]).all()) and err < 5e-2, "small encoder card vs CPU")
    out["native"] = native_checks(tmp)
    return out


def native_checks(tmp: str) -> dict:
    """The native host library (g++ at first use): its log-mel of a seeded
    30 s clip against the port's LogMelSpectrogram on the card, within 2e-3
    (tests/test_native.py's bound), and its host ms; whether the audio
    decoder built (it needs the FFmpeg headers) and whether an ffmpeg binary
    is on the PATH; where the decoder built, a 16 kHz WAV through it must
    equal scipy's read exactly."""
    import shutil

    from whisper_tpu_torch import native
    from whisper_tpu_torch.audio import ffdecode
    from whisper_tpu_torch.features.mel import LogMelSpectrogram
    from whisper_tpu_torch.ggml import mel_filter_bank

    check(native.available(), "libwhisper_native did not build")
    pcm = (0.3 * np.random.default_rng(SEED + 2).standard_normal(16_000 * 30)).astype(np.float32)
    filters = mel_filter_bank()
    native.log_mel_raw(pcm, filters)                                           # warm-up
    t0 = time.perf_counter()
    host = native.log_mel_raw(pcm, filters)
    host_ms = (time.perf_counter() - t0) * 1e3
    mel = LogMelSpectrogram(filters, device="cuda")
    mel(pcm, normalize=False)                                                  # warm-up
    card_ms, card = sync_ms(lambda: mel(pcm, normalize=False))
    err = float(np.abs(host - card.cpu().numpy()).max())
    rec = dict(log_mel_err=err, log_mel_host_ms=host_ms, log_mel_card_ms=card_ms,
               audio_decoder=ffdecode.available(), ffmpeg=shutil.which("ffmpeg"))
    log(f"  native log_mel_raw (30 s clip, {os.cpu_count()} host cores, 4 threads): {host_ms:.2f} host ms; "
        f"the port's LogMelSpectrogram on the card {card_ms:.2f} ms; max_abs_err {err:.3e} (tol 2e-3); "
        f"libwhisper_audio built: {rec['audio_decoder']}; ffmpeg binary: {rec['ffmpeg']}")
    check(host.shape == tuple(card.shape) and err < 2e-3, "native log_mel_raw against the card's mel")
    if rec["audio_decoder"]:
        from scipy.io import wavfile

        path = os.path.join(tmp, "native.wav")
        wavfile.write(path, 16_000, (pcm[:16_000] * 20_000).astype(np.int16))
        _, want = wavfile.read(path)
        got = ffdecode.decode_file(path, 16_000, 1)
        rec["decoded_wav_equal"] = bool(np.array_equal(got, want.astype(np.float32) / 32768.0))
        log(f"  a 16 kHz WAV through libwhisper_audio equals scipy's read: {rec['decoded_wav_equal']}")
        check(rec["decoded_wav_equal"], "libwhisper_audio's WAV differs from scipy's")
    return rec


def tier_runs(model, dims, tier: str, beam_units: tuple = (), scheduler: bool = False) -> dict:
    """One tier on the synthetic large-v2 model: Context.run_full on a
    seeded 3 s clip, then encode_window and run_window at B=1 and B=8, with
    force_steps=128 and to its natural end, each on the replayed graph and
    on the eager step (identical WindowResults and kernel counts; ms per
    token step of each), the host's cost of the read of ``stop`` per step,
    a profiled run of the encode and of each step, and what the graph slot
    holds; at the B in ``beam_units``, beam search (``beam_runs``) over the
    same cross K/V with U = B; with ``scheduler``, the BatchTranscriber
    (``scheduler_run``); the tier's peak device memory. Every tier gets the
    same seeded inputs."""
    import torch

    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES

    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    int8 = model.runtime.kv_int8
    out = {}
    torch.cuda.reset_peak_memory_stats()

    def check_k2(label, k2, k2_int8, want, k2_grouped=0):
        check(k2 == want and k2_int8 == (k2 if int8 else 0) and k2_grouped == 0,
              f"{tier} {label}: K2 launches {k2} ({k2_int8} on int8 K/V, {k2_grouped} grouped), "
              f"want {want}" + (", all on int8 K/V" if int8 else "") + ", none grouped")

    # --- the user's entry point: Context.run_full on a seeded 3 s clip ---
    rng = np.random.default_rng(SEED)
    clip = (0.1 * rng.standard_normal(16_000 * 3)).astype(np.float32)
    ctx = model.create_context()
    LAUNCHES.clear()
    with counting(model.runtime) as rec:
        ms, res = sync_ms(lambda: ctx.run_full(FullParams(language="en"), clip))
    k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
    steps = rec.window_steps
    log(f"  {tier} run_full (3 s clip): {ms:.1f} ms, {len(steps)} window(s), token steps {steps} "
        f"({rec.window_launched} run), {len(res.segments)} segment(s); launches K1 {k1}, K2 {k2} "
        f"({k2_int8} on int8 K/V)")
    check(len(steps) >= 1, "run_full decoded no window")
    check(k1 == n_enc * len(steps), f"K1 launches {k1} != {n_enc} x {len(steps)} encodes")
    check_k2("run_full", k2, k2_int8, 2 * n_dec * rec.launched, k2_grouped)
    for seg in res.segments:
        check(seg.t1 >= seg.t0 >= 0 and all(0 <= t.id < dims.n_vocab for t in seg.tokens),
              "run_full segment out of range")
    out["run_full"] = dict(ms=ms, windows=len(steps), steps=steps, k1=k1, k2=k2, k2_int8=k2_int8)

    # --- the runtime at B=1 and B=8: encode ms, decode ms per token step ---
    rt = model.runtime
    peaks = []
    for b in (1, 8):
        audio = rng.standard_normal((b, 16_000 * 30)).astype(np.float32) * 0.1
        mel = np.stack([model.mel(a).cpu().numpy()[:, : 2 * dims.n_audio_ctx]
                        for a in audio])                                      # [B, 80, 3000]
        prompt = np.zeros((b, rt.prompt_capacity), np.int32)
        prompt[:, :3] = [rt.ids.sot, rt.ids.sot + 1, rt.ids.transcribe]
        plen = np.full((b,), 3, np.int32)
        seek, seek_end = np.zeros(b, np.int32), np.full(b, 3000, np.int32)

        sync_ms(lambda: rt.encode_window(mel))                                # warm-up
        LAUNCHES.clear()
        enc_ms, (feats, cross) = sync_ms(lambda: rt.encode_window(mel))
        k1 = LAUNCHES["flash_attention"]
        check(k1 == n_enc, f"B={b}: K1 launches {k1} != {n_enc} per encode")
        check(bool(torch.isfinite(feats).all()) and feats.shape == (b, dims.n_audio_ctx, dims.n_audio_state),
              f"B={b}: encoder output")
        check(tuple(cross.k.shape) == (n_dec, b, dims.n_text_state, dims.n_audio_ctx), f"B={b}: cross K/V")
        check(cross.k.dtype == (torch.int8 if int8 else rt.compute_dtype), f"B={b}: cross K/V dtype")

        def window(force=FORCE_STEPS, ends=seek_end):
            return rt.run_window(prompt, plen, cross, seek, ends, force_steps=force)

        # the window on the replayed graph (its first window captures the
        # step), then the same window on the eager step: identical, with the
        # same K2 counts; forced, then to its natural end (seek_end past the
        # audio, so only EOT, the rules and the cap end a lane)
        natural_end = np.full(b, 10**6, np.int32)
        runs = {}
        for label, force, ends in (("forced", FORCE_STEPS, seek_end), ("natural", 0, natural_end)):
            sync_ms(lambda: window(force, ends))                            # warm-up: capture
            for mode in ("graph", "eager"):
                LAUNCHES.clear()
                if mode == "graph":
                    ms, (win, run) = sync_ms(lambda: launched(rt, lambda: window(force, ends)))
                else:
                    with eager(rt):
                        ms, (win, run) = sync_ms(lambda: launched(rt, lambda: window(force, ends)))
                k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
                steps = int(win.steps)
                check(steps == force if force else 1 <= steps <= rt.n_max_steps,
                      f"B={b} {label} {mode}: {steps} steps")
                # a read one step behind runs one frozen step past a natural end before the cap
                check(run == steps + (mode == "graph" and steps < (force or rt.n_max_steps)),
                      f"B={b} {label} {mode}: {run} steps run for {steps}")
                check(k1 == 0, f"B={b}: K1 launched {k1} times in decode")
                check_k2(f"B={b} {label} decode ({mode})", k2, k2_int8, 2 * n_dec * run, k2_grouped)
                # int8 weights: every product of a token step (6 a layer and the
                # logits) and the ingest's last-row logits take the W8A16 kernel
                w8 = LAUNCHES["w8a16_dense"]
                want_w8 = (6 * n_dec + 1) * run + 1 if tier == "serving" else 0
                check(w8 == want_w8, f"{tier} B={b} {label} {mode}: W8A16 launches {w8}, "
                                     f"want {want_w8}")
                tok = win.tokens.cpu()
                check(bool(((tok >= 0) & (tok < dims.n_vocab)).all()) and bool(torch.isfinite(win.p).all())
                      and bool(((win.p >= 0) & (win.p <= 1)).all()), f"B={b}: window tokens/probabilities")
                runs[label, mode] = dict(ms=ms, steps=steps, run=run, ms_per_step=ms / steps, k2=k2,
                                         k2_int8=k2_int8, w8a16=w8, win=win)
            g, e = runs[label, "graph"], runs[label, "eager"]
            check(same_window(g.pop("win"), e.pop("win")),
                  f"{tier} B={b} {label}: the graph's WindowResult differs from the eager step's")
            log(f"  {tier} B={b} decode, {label} ({g['steps']} steps): graph {g['ms_per_step']:.3f} "
                f"ms/token step, eager {e['ms_per_step']:.3f} ({g['ms']:.1f} / {e['ms']:.1f} ms incl. "
                f"prompt ingest); identical WindowResults; launches K2 {g['k2']} ({g['k2_int8']} on "
                f"int8 K/V), W8A16 {g['w8a16']} each")
        slot = graph_slot(rt, "greedy", b)
        gap = read_gap_ms(slot, (0, False, FORCE_STEPS), GAP_STEPS)
        step_ms = gap["ms_per_step"]["no read"]
        log(f"  {tier} B={b} the loop's read of `stop`, ms per replayed step: " + ", ".join(
            f"{m} {v:.4f}" for m, v in gap["ms_per_step"].items()) + f"; a read each step costs "
            f"{gap['gap_each_ms'] * 1e3:.1f} us ({gap['gap_each_ms'] / step_ms:.2%} of the step), one "
            f"behind {gap['gap_behind_ms'] * 1e3:.1f} us ({gap['gap_behind_ms'] / step_ms:.2%})")
        sync_ms(lambda: window(PROFILE_STEPS))                                 # warm-up: capture
        bd_enc = breakdown(lambda: rt.encode_window(mel))
        show_breakdown(f"{tier} B={b} encode, per window", bd_enc)
        bd_dec = breakdown(lambda: window(PROFILE_STEPS))
        with eager(rt):
            bd_eager = breakdown(lambda: window(PROFILE_STEPS))
        show_breakdown(f"{tier} B={b} eager decode, per token step ({PROFILE_STEPS} steps)", bd_eager,
                       PROFILE_STEPS)
        show_graph_breakdown(f"{tier} B={b} graph decode, per token step ({PROFILE_STEPS} steps)", bd_dec,
                             PROFILE_STEPS, round(bd_eager["launches"] / PROFILE_STEPS))
        slot_rec = slot_record(slot)
        show_slot(f"{tier} B={b} greedy", slot_rec)
        out[f"B{b}"] = dict(encode_ms=enc_ms, decode_ms_per_step=runs["forced", "graph"]["ms_per_step"],
                            eager_decode_ms_per_step=runs["forced", "eager"]["ms_per_step"],
                            k2=runs["forced", "graph"]["k2"], k2_int8=runs["forced", "graph"]["k2_int8"],
                            runs={f"{k[0]} {k[1]}": v for k, v in runs.items()}, read_gap=gap,
                            graph_slot=slot_rec, encode_breakdown=bd_enc, decode_breakdown=bd_dec,
                            eager_decode_breakdown=bd_eager, decode_breakdown_steps=PROFILE_STEPS)
        if b in beam_units:
            peaks.append(torch.cuda.max_memory_allocated())
            out[f"beam U={b}"] = beam_runs(rt, dims, tier, prompt, plen, cross, seek, seek_end,
                                           profile=b == max(beam_units))
            peaks += [v["peak_bytes"] for v in out[f"beam U={b}"].values()
                      if isinstance(v, dict) and "peak_bytes" in v]
    out["cross_kv_bytes_B8"] = cross.k.nbytes + cross.v.nbytes
    out["cross_scale_bytes_B8"] = (cross.k_s.nbytes + cross.v_s.nbytes) if int8 else 0
    del feats, cross
    if scheduler:
        out["scheduler"] = scheduler_run(model, dims, tier)
    out["max_memory_allocated"] = max(peaks + [torch.cuda.max_memory_allocated()])
    log(f"  [{tier} tier] torch.cuda.max_memory_allocated(): {out['max_memory_allocated'] / 1e9:.2f} GB "
        f"(the graphs' slots: " + ", ".join(
            f"{'/'.join(map(str, k[:2]))} {(s.nbytes + s.pool_bytes()) / 1e9:.3f}"
            for k, s in rt.graphs.slots.items()) + " GB)")
    return out


def beam_runs(rt, dims, tier, prompt, plen, cross, seek, seek_end, profile: bool) -> dict:
    """Beam search (width BEAM) at U = prompt's rows over the cross K/V of
    the greedy runs, [L, U, HD, T], handed to the loop as it is (never
    broadcast per beam), on the replayed graphs: a window to its natural
    end, then one of FORCE_STEPS steps, each with its kernel counts (K2: 2L
    a step, L of them grouped; all on int8 K/V on the serving tier; no K1)
    and the peak memory it adds, which must stay under the bytes of a
    per-beam broadcast of the cross K/V; then the natural window on the
    eager step, which must give the same winners, window rules and counts.
    With ``profile``: one profiled window of PROFILE_STEPS steps on each,
    and the cost of the cache reorder by the columns it moves."""
    import torch

    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    u, n_dec = prompt.shape[0], dims.n_text_layer
    int8 = rt.kv_int8
    params = FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=BEAM)
    check(tuple(cross.k.shape) == (n_dec, u, dims.n_text_state, dims.n_audio_ctx),
          f"beam U={u}: cross K/V {tuple(cross.k.shape)} handed to the loop")
    cross_bytes = sum(a.nbytes for a in cross if a is not None)
    broadcast = BEAM * cross_bytes

    def window(force_steps=0):
        return decode_window_beam(rt, params, prompt, plen, cross, seek, seek_end,
                                  force_steps=force_steps)

    sync_ms(lambda: window())                                  # warm-up: every range's capture
    out = dict(u=u, lanes=u * BEAM, cross_kv_bytes=cross_bytes, broadcast_bytes=broadcast)
    wins = {}
    for label, force, mode in (("natural", 0, "graph"), ("forced", FORCE_STEPS, "graph"),
                               ("natural", 0, "eager")):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        if mode == "graph":
            ms, (res, run) = sync_ms(lambda: launched(rt, lambda: window(force)))
        else:
            with eager(rt):
                ms, (res, run) = sync_ms(lambda: launched(rt, lambda: window(force)))
        k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
        extra = torch.cuda.max_memory_allocated() - base
        steps = int(res.steps)
        log(f"  {tier} beam {BEAM} U={u} ({u * BEAM} lanes), {label}, {mode}: {steps} steps ({run} "
            f"run), {ms:.1f} ms, {ms / steps:.3f} ms/beam step; launches K1 {k1}, K2 {k2} ({k2_grouped} "
            f"grouped, {k2_int8} on int8 K/V); peak extra memory {extra / 1e9:.3f} GB (a per-beam "
            f"broadcast of the cross K/V: {broadcast / 1e9:.3f} GB)")
        check(steps >= 1 and (steps == force if force else steps <= rt.n_max_steps),
              f"beam U={u} {label}: {steps} steps")
        check(run == steps + (mode == "graph" and steps < (force or rt.n_max_steps)),
              f"beam U={u} {label} {mode}: {run} steps run for {steps}")
        check(k1 == 0, f"beam U={u} {label}: K1 launched {k1} times")
        check(k2 == 2 * n_dec * run and k2_grouped == n_dec * run
              and k2_int8 == (k2 if int8 else 0),
              f"beam U={u} {label}: K2 {k2} ({k2_grouped} grouped, {k2_int8} int8), want "
              f"{2 * n_dec * run} ({n_dec * run} grouped" + (", all int8)" if int8 else ")"))
        check(extra < broadcast, f"beam U={u} {label}: peak extra memory {extra} B >= {broadcast} B")
        tok = res.tokens.cpu()
        check(tuple(tok.shape) == (u, rt.n_max_steps)
              and bool(((tok >= 0) & (tok < dims.n_vocab)).all())
              and bool(torch.isfinite(res.p).all()), f"beam U={u} {label}: window tokens")
        wins[label, mode] = res
        key = label if mode == "graph" else f"{label} eager"
        out[key] = dict(steps=steps, run=run, ms=ms, ms_per_step=ms / steps, k1=k1, k2=k2,
                        k2_grouped=k2_grouped, k2_int8=k2_int8, peak_extra_bytes=extra,
                        peak_bytes=torch.cuda.max_memory_allocated())
    check(same_window(wins["natural", "graph"], wins["natural", "eager"]),
          f"{tier} beam U={u}: the graph's winners and window rules differ from the eager step's")
    log(f"  {tier} beam {BEAM} U={u}: graph and eager give identical winners, window rules and counts")
    out["graph_slot"] = slot_record(graph_slot(rt, "beam", u * BEAM))
    show_slot(f"{tier} beam U={u}", out["graph_slot"])
    if profile:
        bd = breakdown(lambda: window(PROFILE_STEPS))
        with eager(rt):
            bd_eager = breakdown(lambda: window(PROFILE_STEPS))
        show_breakdown(f"{tier} beam {BEAM} U={u}, eager, per beam step ({PROFILE_STEPS} steps)",
                       bd_eager, PROFILE_STEPS)
        show_graph_breakdown(f"{tier} beam {BEAM} U={u}, graph, per beam step ({PROFILE_STEPS} steps)",
                             bd, PROFILE_STEPS, round(bd_eager["launches"] / PROFILE_STEPS))
        out["breakdown"], out["eager_breakdown"], out["breakdown_steps"] = bd, bd_eager, PROFILE_STEPS
        out["reorder"] = reorder_costs(rt, u * BEAM, prompt.shape[1], out["graph_slot"])
    return out


def reorder_costs(rt, lanes: int, p_max: int, slot_rec: dict) -> dict:
    """The beam reorder's choice, measured: device ms (CUDA events) of
    ``reorder_self_kv`` over n generated columns of a [L, lanes, HD, C]
    cache for each range width a captured step takes, summed over a
    window of n_max steps, against the whole region [p_max, p_max + n_max)
    every step (one graph; the JAX package's reorder) and against the
    written columns only (the eager loop before graphs); with the capture
    ms the extra ranges cost once per slot."""
    import torch

    from whisper_tpu_torch.model.decoder import reorder_self_kv
    from whisper_tpu_torch.runtime.beam import reorder_columns

    n_max = rt.n_max_steps
    kv = rt.self_kv(lanes)
    parent = torch.randperm(lanes, device="cuda")
    widths = sorted({reorder_columns(i, n_max) for i in range(n_max)})
    ms = {n: event_ms(lambda _: reorder_self_kv(kv, parent, p_max, n), 1, 10) for n in widths}
    ranged = sum(ms[reorder_columns(i, n_max)] for i in range(n_max))
    whole = n_max * ms[n_max]
    written = sum(event_ms(lambda _: reorder_self_kv(kv, parent, p_max, i), 1, 3)
                  for i in range(1, n_max, 16)) * 16
    captures = [v["capture_ms"] for k, v in slot_rec["steps"].items()]
    log(f"  beam reorder at {lanes} lanes, device ms by columns moved: "
        + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
        + f"; a window of {n_max} steps: by ranges {ranged:.1f} ms, the whole region {whole:.1f} ms, "
        f"the written columns (~{written:.1f} ms); the {len(captures)} ranges' captures "
        f"{sum(captures):.1f} ms once (one graph: {max(captures):.1f})")
    del kv
    return dict(ms_by_columns=ms, window_ms_ranges=ranged, window_ms_whole=whole,
                window_ms_written=written, capture_ms=captures)


def scheduler_run(model, dims, tier) -> dict:
    """BatchTranscriber(batch=8) over 12 seeded clips of 2-8 s, greedy: wall
    ms, rounds (one encode each), audio seconds per wall second, and the
    counts the rounds imply (K1: L_enc a round; K2: 2 L_dec a token step)."""
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    rng = np.random.default_rng(SEED + 2)
    clips = [(0.1 * rng.standard_normal(int(16_000 * sec))).astype(np.float32)
             for sec in rng.uniform(2.0, 8.0, 12)]
    audio_s = sum(len(c) for c in clips) / 16_000
    rt = model.runtime
    bt = BatchTranscriber(model, batch=8)
    LAUNCHES.clear()
    with counting(rt) as rec:
        ms, results = sync_ms(lambda: bt.transcribe(clips, FullParams(language="en")))
    k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
    rounds, steps = rec.widths, rec.window_steps
    n_seg = sum(len(r.segments) for r in results)
    log(f"  {tier} BatchTranscriber(batch=8), 12 clips, {audio_s:.2f} s of audio: {ms:.1f} ms wall, "
        f"{len(rounds)} rounds of width {set(rounds)}, token steps {steps}, "
        f"{audio_s / (ms / 1e3):.2f} audio s per wall s, {n_seg} segment(s); launches K1 {k1}, "
        f"K2 {k2} ({k2_int8} on int8 K/V, {k2_grouped} grouped)")
    check(len(results) == len(clips) and set(rounds) == {8}, "scheduler: results or round width")
    check(k1 == dims.n_audio_layer * len(rounds),
          f"scheduler: K1 {k1} != {dims.n_audio_layer} x {len(rounds)} rounds")
    check(k2 == 2 * dims.n_text_layer * rec.launched and k2_grouped == 0
          and k2_int8 == (k2 if rt.kv_int8 else 0),
          f"scheduler: K2 {k2} != {2 * dims.n_text_layer} x {rec.launched} token steps run")
    for r in results:
        for seg in r.segments:
            check(seg.t1 >= seg.t0 >= 0 and all(0 <= t.id < dims.n_vocab for t in seg.tokens),
                  "scheduler segment out of range")
    with eager(rt):
        eager_ms, eager_results = sync_ms(lambda: bt.transcribe(clips, FullParams(language="en")))
    check([segments(r) for r in results] == [segments(r) for r in eager_results],
          "scheduler: the graph's segments differ from the eager step's")
    log(f"  {tier} BatchTranscriber on the eager step: {eager_ms:.1f} ms wall, the same segments")
    return dict(clips=len(clips), audio_s=audio_s, wall_ms=ms, eager_wall_ms=eager_ms,
                rounds=len(rounds), steps=steps, audio_s_per_s=audio_s / (ms / 1e3), segments=n_seg,
                k1=k1, k2=k2)


def segments(result) -> list:
    """A TranscribeResult's segments as comparable tuples."""
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in result.segments]


def f32_runs(model, dims) -> dict:
    """DtypePolicy.f32() on the synthetic large-v2 model: Context.run_full
    on the seeded 3 s clip of ``tier_runs`` (every encoder layer on K1's f32
    instance: 32 f32 launches a window; K2 2 L_dec a token step), then one
    encode_window at B=1 timed and profiled."""
    import torch

    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES

    rt = model.runtime
    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    clip = (0.1 * np.random.default_rng(SEED).standard_normal(16_000 * 3)).astype(np.float32)
    ctx = model.create_context()
    LAUNCHES.clear()
    with counting(rt) as rec:
        ms, res = sync_ms(lambda: ctx.run_full(FullParams(language="en"), clip))
    k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
    k1_f32 = LAUNCHES["flash_attention_f32"]
    log(f"  f32 run_full (3 s clip): {ms:.1f} ms, {rec.encodes} window(s), {rec.steps} token steps, "
        f"{len(res.segments)} segment(s); launches K1 {k1} ({k1_f32} f32), K2 {k2}")
    check(rec.encodes >= 1 and k1 == k1_f32 == n_enc * rec.encodes,
          f"f32 run_full: K1 {k1} ({k1_f32} f32) != {n_enc} x {rec.encodes} encodes, all f32")
    check(k2 == 2 * n_dec * rec.launched and k2_int8 == k2_grouped == 0,
          f"f32 run_full: K2 {k2} != {2 * n_dec} x {rec.launched} token steps run")
    for seg in res.segments:
        check(seg.t1 >= seg.t0 >= 0 and all(0 <= t.id < dims.n_vocab for t in seg.tokens),
              "f32 run_full segment out of range")
    with eager(rt):
        eager_ms, eager_res = sync_ms(lambda: model.create_context().run_full(FullParams(language="en"),
                                                                              clip))
    check(segments(res) == segments(eager_res), "f32 run_full: the graph's segments differ from the eager step's")
    log(f"  f32 run_full on the eager step: {eager_ms:.1f} ms, the same segments")
    mel = np.zeros((1, dims.n_mels, 2 * dims.n_audio_ctx), np.float32)
    m = model.mel(clip).cpu().numpy()
    mel[0, :, : m.shape[1]] = m
    sync_ms(lambda: rt.encode_window(mel))                                    # warm-up
    enc_ms, (feats, _) = sync_ms(lambda: rt.encode_window(mel))
    check(bool(torch.isfinite(feats).all()), "f32 encoder output not finite")
    log(f"  f32 B=1: encode {enc_ms:.2f} ms/window")
    bd = breakdown(lambda: rt.encode_window(mel))
    show_breakdown("f32 B=1 encode, per window", bd)
    return dict(run_full=dict(ms=ms, eager_ms=eager_ms, windows=rec.encodes, steps=rec.steps, k1=k1,
                              k1_f32=k1_f32, k2=k2, k2_int8=k2_int8, k2_grouped=k2_grouped),
                encode_ms=enc_ms, encode_breakdown=bd)


def capture_run(model, dims) -> dict:
    """Context.run_capture on the bf16 tier over a seeded 6 s source (1 s of
    noise floor, 2 s of speech, 1 s of floor, 2 s of speech) in 100 ms
    chunks, paced, with the default CaptureParams (buffers of 2-3 s): the
    buffers, ms per buffer (run_full on the runner's worker thread) and
    the counts the encodes and token steps imply."""
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES

    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    audio = np.concatenate([noise_floor(16_000, SEED + 3), speechy(16_000 * 2, SEED + 4),
                            noise_floor(16_000, SEED + 5), speechy(16_000 * 2, SEED + 6)])
    ctx = model.create_context()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    with counting(model.runtime) as rec:
        buffers, ms, res = recorded_capture(ctx, FullParams(language="en"), chunks_of(audio), None)
    wall = (time.perf_counter() - t0) * 1e3
    k1, k2, k2_int8, k2_grouped = (LAUNCHES[k] for k in K1_K2)
    log(f"  bf16 run_capture (6 s source, 100 ms chunks, paced): {wall:.1f} ms wall, buffers "
        f"{buffers} samples, run_full ms per buffer {[round(x, 1) for x in ms]}, {rec.encodes} "
        f"encode(s), {rec.steps} token steps, {len(res.segments)} segment(s); launches K1 {k1}, K2 {k2}")
    check(len(buffers) >= 1 and rec.encodes >= 1, f"run_capture: buffers {buffers}, {rec.encodes} encodes")
    check(k1 == n_enc * rec.encodes and LAUNCHES["flash_attention_f32"] == 0,
          f"run_capture: K1 {k1} != {n_enc} x {rec.encodes} encodes")
    check(k2 == 2 * n_dec * rec.launched and k2_int8 == k2_grouped == 0,
          f"run_capture: K2 {k2} != {2 * n_dec} x {rec.launched} token steps run")
    return dict(wall_ms=wall, buffers=buffers, ms_per_buffer=ms, encodes=rec.encodes, steps=rec.steps,
                segments=len(res.segments), k1=k1, k2=k2)


def stored_bytes(params) -> dict:
    """Bytes of the decoder's _QUANT_KEYS weights (and their scales) and of
    the token table (and its scales)."""
    from whisper_tpu_torch.model.params import _QUANT_KEYS

    blocks, dec = params.dec.blocks, params.dec

    def nbytes(key, where):
        return sum(getattr(m, key).nbytes for m in where if hasattr(m, key))

    return dict(weights=sum(nbytes(k, blocks) for k in _QUANT_KEYS),
                weight_scales=sum(nbytes(k + "_s", blocks) for k in _QUANT_KEYS),
                tok=dec.tok.nbytes, tok_scales=nbytes("tok_s", [dec]))


def int8_pass_costs(params, dims, compute_dtype) -> dict:
    """Profile, on the card, one decode step's worth of the two passes that
    XLA fused into its neighbours and eager PyTorch runs apart: converting
    every int8 decoder weight and the token table to bf16 (kernels/w8a16.py
    dense, model/decoder.py logits), and quantizing and writing each
    layer's new K and V cache column at B=8 (model/decoder.py)."""
    import torch

    from whisper_tpu_torch.kernels.quant import quantize_cols
    from whisper_tpu_torch.model.decoder import _cache_write, init_self_kv
    from whisper_tpu_torch.model.params import _QUANT_KEYS

    weights = [getattr(b, k) for b in params.dec.blocks for k in sorted(_QUANT_KEYS)]
    tok = params.dec.tok

    def convert():
        for w in weights:
            w.to(compute_dtype)
        tok.T.to(compute_dtype)

    b = 8
    kv = init_self_kv(dims, b, device="cuda", quant=True)
    new = torch.randn((b, 1, dims.n_text_state), device="cuda")

    def quantize_and_write():
        for li in range(dims.n_text_layer):
            for cache, scales in ((kv.k, kv.k_s), (kv.v, kv.v_s)):
                codes, sc = quantize_cols(new, axis=-1)
                _cache_write(cache, li, codes, 100)
                _cache_write(scales, li, sc, 100)

    out = {}
    for name, fn, n_bytes in (
        ("int8->bf16 weight conversion", convert, 3 * (sum(w.numel() for w in weights) + tok.numel())),
        ("cache quantize-and-write, B=8", quantize_and_write, None),
    ):
        fn()                                                                   # warm-up
        bd = breakdown(fn)
        show_breakdown(f"serving, {name}, per decode step", bd)
        out[name] = dict(busy_ms=bd["busy_ms"], wall_ms=bd["wall_ms"], launches=bd["launches"],
                         bytes=n_bytes)
        if n_bytes:
            log(f"    {n_bytes / 1e9:.3f} GB moved (1 B read + 2 B written per weight): "
                f"{n_bytes / bd['busy_ms'] / 1e6:.0f} GB/s of device time")
    return out


LARGE_V2_FILE = "ggml-large-v2-synthetic.bin"   # kept in the run's directory for [parallel]


def main_path_phase(tmp: str) -> dict:
    import gc

    import torch

    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.hparams import KNOWN_MODELS
    from whisper_tpu_torch.model.params import DtypePolicy

    dims = KNOWN_MODELS["large-v2"]
    n_dec, d, t = dims.n_text_layer, dims.n_text_state, dims.n_audio_ctx
    out = {}

    t0 = time.perf_counter()
    path = os.path.join(tmp, LARGE_V2_FILE)
    write_checkpoint(path, dims, random_tensors(dims, SEED))
    log(f"  wrote synthetic large-v2 checkpoint ({os.path.getsize(path) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")

    stored = {}
    for tier in ("bf16", "serving"):
        t0 = time.perf_counter()
        model = load_model(path) if tier == "bf16" else serving_model(path, "cuda")
        torch.cuda.synchronize()
        log(f"  [{tier} tier] load_model on {model.device}: {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
        # beam search at U=1 and U=8 on the bf16 tier, U=8 on the serving
        # tier; the scheduler on the bf16 tier
        out[tier] = tier_runs(model, dims, tier, beam_units=(1, 8) if tier == "bf16" else (8,),
                              scheduler=tier == "bf16")
        log(f"  [{tier} tier] runs: {time.perf_counter() - t0:.1f} s")
        stored[tier] = dict(stored_bytes(model.runtime.params),
                            cross_kv_B8=out[tier]["cross_kv_bytes_B8"],
                            cross_scales_B8=out[tier]["cross_scale_bytes_B8"])
        if tier == "bf16":
            out["bf16"]["capture"] = capture_run(model, dims)
        if tier == "serving":
            out["serving_passes"] = int8_pass_costs(model.runtime.params, dims,
                                                    model.runtime.compute_dtype)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = load_model(path, policy=DtypePolicy.f32())
    torch.cuda.synchronize()
    log(f"  [f32 tier] load_model on {model.device}: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    out["f32"] = f32_runs(model, dims)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # stored bytes, from the shapes: cross K/V [L, 8, HD, T] x2, the decoder's
    # _QUANT_KEYS weights (14 d^2 per layer, 11 d output columns, each with
    # one f32 scale) and the token table [V, d] (one f32 scale per row)
    n_cross, n_w, n_tok = 2 * n_dec * 8 * d * t, 14 * d * d * n_dec, dims.n_vocab * d
    want = dict(
        bf16=dict(cross_kv_B8=2 * n_cross, cross_scales_B8=0, weights=2 * n_w, weight_scales=0,
                  tok=2 * n_tok, tok_scales=0),
        serving=dict(cross_kv_B8=n_cross, cross_scales_B8=2 * n_dec * 8 * t * 4, weights=n_w,
                     weight_scales=4 * 11 * d * n_dec, tok=n_tok,
                     tok_scales=4 * dims.n_vocab),
    )
    for tier in stored:
        log(f"  [{tier} tier] stored bytes: " + ", ".join(f"{k} {v:,}" for k, v in stored[tier].items()))
        check(stored[tier] == want[tier], f"{tier} stored bytes {stored[tier]} != {want[tier]}")
    out["stored_bytes"] = stored
    return out


# ---------------------------------------------------------------------------
# phase 5b: parallelism (two ranks on the one card over gloo; NCCL at world size 1)
# ---------------------------------------------------------------------------

PAR_TIMEOUT = 420.0            # seconds the two ranks of [parallel] may take, start-up included
# bf16 first-step logits at n_model = 2, x max(1, max |one process|): a rank
# adds its f32 partial sums to the other's in another order than one GEMM
# does, so activations round to bf16 apart after every row-parallel product
# (the small encoder's card-vs-CPU bound, 5e-2, for the same cause)
PAR_BF16_TOL = 5e-2


def tier_model(path: str, tier: str, mesh=None, cuda_graphs: bool = True):
    """The scripted checkpoint's model on ``tier`` (bf16, serving, f32)."""
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.model.params import DtypePolicy

    if tier == "serving":
        return serving_model(path, "cuda", mesh=mesh, cuda_graphs=cuda_graphs)
    return Model(path, policy=DtypePolicy.f32() if tier == "f32" else None, mesh=mesh,
                 cuda_graphs=cuda_graphs)


def collective_ms(fn):
    """(result of ``fn()``, host ms of the run, host ms inside c10d
    collectives) from one profiled run. gloo's collectives are synchronous:
    each call waits for the card's work before it, copies to the host,
    reduces over TCP and copies back, so its time includes that wait."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ms, out = sync_ms(fn)
    coll = sum(e.cpu_time_total for e in prof.key_averages() if e.key.startswith("c10d::")) / 1e3
    return out, ms, coll


def par_inputs(model_mel, dims, ids, b: int, seed: int):
    """``b`` seeded 3 s clips as a window: mel [b, 80, 3000], the prompt
    (SOT, language, transcribe) and the window's bounds (the clip's 300
    frames)."""
    rng = np.random.default_rng(seed)
    mel = np.zeros((b, dims.n_mels, 2 * dims.n_audio_ctx), np.float32)
    for i in range(b):
        m = model_mel((0.1 * rng.standard_normal(16_000 * 3)).astype(np.float32)).cpu().numpy()
        m = m[:, : mel.shape[2]]
        mel[i, :, : m.shape[1]] = m
    prompt = np.zeros((b, dims.n_text_ctx // 2 + 4), np.int32)
    prompt[:, :3] = [ids.sot, ids.sot + 1, ids.transcribe]
    return mel, prompt, np.full((b,), 3, np.int32), np.zeros(b, np.int32), np.full(b, 300, np.int32)


def par_logits(rt, mel, prompt, plen):
    """The first token step's logits [1, V] (f32): encode, ingest the
    prompt, then one step on the prompt's greedy token."""
    import torch

    from whisper_tpu_torch.model.decoder import decode_step

    with torch.inference_mode():
        _, cross = rt.encode_window(mel)
        toks = torch.from_numpy(prompt[:, : int(plen[0])]).cuda()
        kv = rt.self_kv(1)
        zero = torch.zeros(1, dtype=torch.int32, device="cuda")
        logits, _ = decode_step(rt.params, rt.dims, toks, zero, kv, cross,
                                compute_dtype=rt.compute_dtype)
        tok = logits.argmax(-1, keepdim=True).int()
        logits, _ = decode_step(rt.params, rt.dims, tok, zero + toks.shape[1], kv, cross,
                                write_pos=toks.shape[1], compute_dtype=rt.compute_dtype)
    return logits.float().cpu()


def parallel_ranks(scripted: str, large: str) -> dict:
    """One of the two ranks of [parallel], on the one card over gloo with
    eager steps (``cuda_graphs=False``: gloo's collectives cannot be
    captured), on a 1x2 mesh (tensor parallelism, 2 of 4 heads a rank on
    the scripted checkpoint, 10 of 20 on large-v2) and a 2x1 mesh (data
    parallelism). Rank 0 also runs each large-v2 case unsharded, in its
    own process, for the one-process reference. Returns what it measured,
    and its log lines."""
    import gc

    import torch
    import torch.distributed as dist

    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.features.mel import LogMelSpectrogram
    from whisper_tpu_torch.ggml import load_checkpoint
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.model.params import DtypePolicy, host_tree_from_checkpoint, params_from_numpy
    from whisper_tpu_torch.parallel.mesh import make_mesh
    from whisper_tpu_torch.parallel.sharding import gather_batch, shard_batch, shard_params
    from whisper_tpu_torch.runtime.context import WhisperRuntime
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.vocab import Vocabulary

    rank = dist.get_rank()
    lines, out = [], {"device": torch.cuda.get_device_name(0)}

    def note(msg):
        lines.append(f"  [rank {rank}] {msg}")

    tp_mesh, dp_mesh = make_mesh(n_model=2), make_mesh(n_model=1)

    # graphs on a gloo model group of two ranks on the card: refused
    try:
        tier_model(scripted, "bf16", mesh=tp_mesh)
        out["graphs_refused"] = None
    except ValueError as e:
        out["graphs_refused"] = str(e)

    # the scripted checkpoint's golden run_full on the three tiers
    silence = np.zeros(16_000 * 2, np.float32)
    for tier in ("bf16", "serving", "f32"):
        model = tier_model(scripted, tier, mesh=tp_mesh, cuda_graphs=False)
        ctx = model.create_context()
        LAUNCHES.clear()
        with counting(model.runtime) as rec:
            ms, res = sync_ms(lambda: ctx.run_full(FullParams(language="en"), silence))
        k1, k2, k2_int8, _ = (LAUNCHES[k] for k in K1_K2)
        out[f"golden {tier}"] = dict(segments=segments(res), ms=ms, windows=rec.encodes,
                                     steps=rec.launched, k1=k1, k1_f32=LAUNCHES["flash_attention_f32"],
                                     k2=k2, k2_int8=k2_int8, heads=model.runtime.params.tp.part(4))
        note(f"golden {tier} at n_model=2: {segments(res)}; {ms:.1f} ms for {rec.encodes} window(s) "
             f"of {rec.launched} token steps; K1 {k1}, K2 {k2}")
        del model, ctx

    # large-v2 at full width and depth
    t0 = time.perf_counter()
    cp = load_checkpoint(large)
    dims = cp.dims
    ids = SpecialIds.from_vocab(Vocabulary(cp.vocab_words, dims.n_vocab))
    tree = host_tree_from_checkpoint(cp)
    mel_fn = LogMelSpectrogram(cp.filters.data, device="cuda")
    del cp
    note(f"large-v2 host tree: {time.perf_counter() - t0:.1f} s")
    mel, prompt, plen, seek, seek_end = par_inputs(mel_fn, dims, ids, 1, SEED)

    def window(rt, m, p, pl, sk, se):
        """features, WindowResult, encode ms, window ms and the launches:
        K1 (f32 instance) of the encode, K2 of the token steps."""
        LAUNCHES.clear()
        enc_ms, (feats, cross) = sync_ms(lambda: rt.encode_window(m))
        k1_f32 = LAUNCHES["flash_attention_f32"]
        LAUNCHES.clear()
        win_ms, res = sync_ms(lambda: rt.run_window(p, pl, cross, sk, se))
        return feats, res, enc_ms, win_ms, dict(k1_f32=k1_f32, k2=LAUNCHES["decode_attention_hd"], cross=cross)

    def step_ms(rt, cross):
        """ms a token step: forced windows of 2 and 6 steps (the prompt
        ingest cancels out), the collectives' share of a profiled 6-step
        window, and the 6-step window's result (6 tokens past the EOT)."""
        def forced(n):
            return sync_ms(lambda: rt.run_window(prompt, plen, cross, seek, seek_end, force_steps=n))

        forced(2)                                                              # warm-up
        ms6, res6 = forced(6)
        ms = (ms6 - forced(2)[0]) / 4
        _, prof_ms, coll = collective_ms(lambda: forced(6))
        return ms, coll / prof_ms, res6

    # f32 tier, tensor parallel: 10 heads a rank
    params = params_from_numpy(tree, "cuda", DtypePolicy.f32())
    sharded = shard_params(params, tp_mesh)
    rt = WhisperRuntime(sharded, dims, ids, compute_dtype=torch.float32, cuda_graphs=False)
    window(rt, mel, prompt, plen, seek, seek_end)                              # warm-up
    feats, res, enc_ms, win_ms, counts = window(rt, mel, prompt, plen, seek, seek_end)
    k1_f32, k2 = counts["k1_f32"], counts["k2"]
    steps = int(res.steps)
    _, enc_prof_ms, enc_coll = collective_ms(lambda: rt.encode_window(mel))
    ms, share, forced6 = step_ms(rt, counts["cross"])
    rec = dict(enc_ms=enc_ms, window_ms=win_ms, steps=steps, ms_per_step=ms, k1_f32=k1_f32, k2=k2,
               heads=sharded.tp.part(dims.n_audio_head), encode_collective_share=enc_coll / enc_prof_ms,
               step_collective_share=share)
    note(f"large-v2 f32 at n_model=2: encode {enc_ms:.1f} ms (collectives {enc_coll:.1f} of "
         f"{enc_prof_ms:.1f} profiled ms), window {win_ms:.1f} ms ({steps} token steps and the "
         f"prompt ingest), {ms:.2f} ms a token step (collectives {share:.3f} of a profiled "
         f"6-step window); K1 f32 {k1_f32}, K2 {k2}")
    if rank == 0:
        one = WhisperRuntime(params, dims, ids, compute_dtype=torch.float32, cuda_graphs=False)
        window(one, mel, prompt, plen, seek, seek_end)                         # warm-up
        feats1, res1, enc1, win1, counts1 = window(one, mel, prompt, plen, seek, seek_end)
        one_ms, _, forced6_1 = step_ms(one, counts1["cross"])

        def same(a, b):
            n = int(b.result_len[0])
            return (torch.equal(a.result_len, b.result_len) and torch.equal(a.seek_delta, b.seek_delta)
                    and torch.equal(a.tokens[0, :n], b.tokens[0, :n]))

        n = int(res1.result_len[0])
        rec.update(one_enc_ms=enc1, one_window_ms=win1, one_ms_per_step=one_ms,
                   feats_err=(feats - feats1).abs().max().item(),
                   feats_tol=1e-3 * max(1.0, feats1.abs().max().item()),
                   same_window=same(res, res1), tokens=res1.tokens[0, :n].tolist(),
                   same_forced6=same(forced6, forced6_1),
                   forced6_tokens=forced6_1.tokens[0, :int(forced6_1.result_len[0])].tolist())
        note(f"large-v2 f32, one process: encode {enc1:.1f} ms, window {win1:.1f} ms, "
             f"{rec['one_ms_per_step']:.2f} ms a token step; features "
             f"max_abs_err {rec['feats_err']:.3e} (tol {rec['feats_tol']:.3e}); tokens, result_len "
             f"and seek_delta identical: {rec['same_window']} ({rec['tokens']}); in the forced "
             f"6-step window: {rec['same_forced6']} ({rec['forced6_tokens']})")
        del one
    out["large-v2 f32 tp"] = rec
    del rt, sharded

    # f32 tier, data parallel: 2 ranks x B=4 against B=8, graphs on (no
    # model collective: the model group has one rank)
    mel8, prompt8, plen8, seek8, end8 = par_inputs(mel_fn, dims, ids, 8, SEED + 1)
    local = [shard_batch(a, dp_mesh) for a in (mel8, prompt8, plen8, seek8, end8)]
    rt = WhisperRuntime(params, dims, ids, compute_dtype=torch.float32)
    window(rt, *local)                                                         # warm-up: capture
    _, res, enc_ms, win_ms, _ = window(rt, *local)
    got = {k: gather_batch(getattr(res, k), dp_mesh).cpu() for k in ("tokens", "result_len", "seek_delta")}
    rec = dict(enc_ms=enc_ms, window_ms=win_ms, steps=int(res.steps), lanes=local[0].shape[0])
    note(f"large-v2 f32, 2 ranks x B=4: encode {enc_ms:.1f} ms, window {win_ms:.1f} ms for "
         f"{int(res.steps)} token steps")
    if rank == 0:
        _, res8, enc8, win8, _ = window(rt, mel8, prompt8, plen8, seek8, end8)
        _, res8, enc8, win8, _ = window(rt, mel8, prompt8, plen8, seek8, end8)
        rec.update(one_enc_ms=enc8, one_window_ms=win8, same_tokens=all(
            torch.equal(got[k], getattr(res8, k).cpu()) for k in got))
        note(f"large-v2 f32, one process B=8: encode {enc8:.1f} ms, window {win8:.1f} ms; tokens, "
             f"result_len and seek_delta identical to the 2 x B=4 ranks: {rec['same_tokens']}")
    out["large-v2 f32 dp"] = rec
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 tier, tensor parallel: the first token step's logits
    params = params_from_numpy(tree, "cuda", DtypePolicy())
    sharded = shard_params(params, tp_mesh)
    rt = WhisperRuntime(sharded, dims, ids, cuda_graphs=False)
    par_logits(rt, mel, prompt, plen)                                          # warm-up
    LAUNCHES.clear()
    ms, logits = sync_ms(lambda: par_logits(rt, mel, prompt, plen))
    k1, k2 = LAUNCHES["flash_attention"], LAUNCHES["decode_attention_hd"]
    rec = dict(ms=ms, k1=k1, k2=k2)
    if rank == 0:
        one = WhisperRuntime(params, dims, ids, cuda_graphs=False)
        want = par_logits(one, mel, prompt, plen)
        rec.update(err=(logits - want).abs().max().item(),
                   tol=PAR_BF16_TOL * max(1.0, want.abs().max().item()),
                   same_argmax=bool(logits.argmax() == want.argmax()), shape=tuple(logits.shape))
        note(f"large-v2 bf16 first-step logits at n_model=2 against one process: max_abs_err "
             f"{rec['err']:.3e} (tol {rec['tol']:.3e}), same argmax {rec['same_argmax']}; {ms:.1f} ms "
             f"for encode, ingest and a step; K1 {k1}, K2 {k2}")
    out["large-v2 bf16 tp"] = rec
    out["lines"] = lines
    return out


def nccl_world1(scripted: str, tmp: str) -> dict:
    """NCCL at world size 1: Model(mesh=make_mesh()) on a 1x1 mesh, with the
    token steps replayed as graphs, against Model(mesh=None): run_full's
    segments and launch counts, and encode_window + run_window bit for bit,
    with each graph step's launches."""
    import torch.distributed as dist

    from whisper_tpu_torch.api.devices import init_distributed
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.parallel.mesh import make_mesh

    init_distributed(f"file://{tmp}/nccl_store", 1, 0, device="cuda", backend="nccl")
    try:
        mesh = make_mesh()
        runs = {}
        for name, m in (("mesh=None", None), ("1x1 mesh", mesh)):
            model = Model(scripted, mesh=m)
            rt = model.runtime
            silence = np.zeros(16_000 * 2, np.float32)
            model.create_context().run_full(FullParams(language="en"), silence)   # capture
            LAUNCHES.clear()
            with counting(rt) as rec:
                ms, res = sync_ms(lambda: model.create_context().run_full(FullParams(language="en"),
                                                                          silence))
            counts = tuple(LAUNCHES[k] for k in K1_K2)
            mel, prompt, plen, seek, seek_end = par_inputs(model.mel, model.dims, rt.ids, 1, SEED)
            _, cross = rt.encode_window(mel)
            win_ms, win = sync_ms(lambda: rt.run_window(prompt, plen, cross, seek, seek_end))
            slot = graph_slot(rt, "greedy", 1)
            runs[name] = dict(segments=segments(res), counts=counts, ms=ms,
                              steps=rec.steps, launched=rec.launched, encodes=rec.encodes,
                              replays=rt.graphs.replays(),
                              win=win, win_ms=win_ms,
                              step_launches={str(k): v.launches for k, v in slot.steps.items()})
            log(f"  NCCL world 1, {name}: run_full {runs[name]['segments']} in {ms:.1f} ms, "
                f"{rec.launched} token steps on the graph; launches K1/K2 {runs[name]['counts'][:2]}; "
                f"graph step launches {runs[name]['step_launches']}; window {win_ms:.1f} ms")
        a, b = runs["mesh=None"], runs["1x1 mesh"]
        check(b["replays"] > 0, "NCCL 1x1 mesh: no graph replayed")
        check(a["segments"] == b["segments"] and a["counts"] == b["counts"]
              and a["step_launches"] == b["step_launches"] and same_window(a["win"], b["win"]),
              "NCCL 1x1 mesh with graphs differs from mesh=None")
        check(a["counts"][:2] == (2 * a["encodes"], 4 * a["launched"]),
              f"NCCL world 1: launches {a['counts']} for {a['encodes']} encodes, {a['launched']} steps")
        for r in runs.values():
            del r["win"]
        return runs
    finally:
        dist.destroy_process_group()


def parallel_phase(tmp: str, scripted: str, large: str) -> dict:
    """[parallel]: two ranks on the card over gloo (``parallel_ranks``),
    then NCCL at world size 1 in this process (``nccl_world1``). Each
    case's check fails the script."""
    from whisper_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:parallel_ranks", 2, args=(scripted, large), device="cuda",
                  backend="gloo", timeout=PAR_TIMEOUT, threads=4)
    log(f"  two gloo ranks on {ranks[0]['device']}: {time.perf_counter() - t0:.1f} s, start-up included")
    for r in ranks:
        for line in r.pop("lines"):
            log(line)
    want = [(" hi", 0, 192, [50_363, 32, 104, 105, 50_363 + 96])]
    r0 = ranks[0]
    for r in ranks:
        check(r["graphs_refused"] is not None and "cuda_graphs=False" in r["graphs_refused"],
              "cuda_graphs=True on a gloo model group of 2 was not refused")
        for tier in ("bf16", "serving", "f32"):
            g = r[f"golden {tier}"]
            check(g["segments"] == want, f"golden {tier} at n_model=2: {g['segments']}")
            check(g["heads"] == 2 and g["k1"] == 2 * g["windows"] and g["k2"] == 4 * g["steps"]
                  and g["k1_f32"] == (g["k1"] if tier == "f32" else 0)
                  and g["k2_int8"] == (g["k2"] if tier == "serving" else 0),
                  f"golden {tier} at n_model=2: launches {g}")
        tp = r["large-v2 f32 tp"]
        check(tp["heads"] == 10 and tp["k1_f32"] == 32 and tp["k2"] == 64 * tp["steps"],
              f"large-v2 f32 at n_model=2: K1 f32 {tp['k1_f32']}, K2 {tp['k2']} for {tp['steps']} steps")
        bf = r["large-v2 bf16 tp"]
        check(bf["k1"] == 32 and bf["k2"] == 64, f"large-v2 bf16 at n_model=2: K1 {bf['k1']}, K2 {bf['k2']}")
    tp, dp, bf = r0["large-v2 f32 tp"], r0["large-v2 f32 dp"], r0["large-v2 bf16 tp"]
    check(tp["feats_err"] <= tp["feats_tol"] and tp["same_window"] and tp["same_forced6"]
          and len(tp["forced6_tokens"]) == 6, f"large-v2 f32 at n_model=2 against one process: {tp}")
    check(dp["same_tokens"], f"large-v2 f32, 2 ranks x B=4 against B=8: {dp}")
    check(bf["err"] <= bf["tol"], f"large-v2 bf16 first-step logits at n_model=2: {bf}")
    log("[parallel] NCCL at world size 1")
    nccl = nccl_world1(scripted, tmp)
    return dict(ranks=ranks, nccl_world1=nccl, s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 5c: the omni window (runtime/omni.py) at the published widths
# ---------------------------------------------------------------------------

OMNI_CONFIG = "benchmark/configs/uni-moe-2.0-omni.bf16.json"   # the published config.json's keys
OMNI_LAYERS = 2                  # language-model layers (of 28) and encoder layers (of 32) kept
OMNI_LANES, OMNI_COLS, OMNI_STEPS = 8, 448, 112   # lanes, prompt columns and steps of the omni cell


def omni_phase() -> dict:
    """[omni]: Uni-MoE-2.0-Omni's window through ``OmniContext`` at the
    published widths, cut in depth only (``OMNI_LAYERS``), on seeded random
    weights drawn on the card as the benchmark draws them. A first window
    captures the token step; then the launch ledger is cleared right
    before a replayed window and before the same window on the eager
    step, and each must count 2 launches a layer and step, read exactly
    the routed experts some lane kept, and give the same result."""
    import torch

    from whisper_tpu_torch.kernels._build import LAUNCHES
    from whisper_tpu_torch.model.omni_params import OmniDims, params_from_tensors, tensor_names
    from whisper_tpu_torch.obs.profiler import TRACER
    from whisper_tpu_torch.runtime.omni import OmniContext

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), OMNI_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(num_hidden_layers=OMNI_LAYERS, whisper_encoder_layers=OMNI_LAYERS)
    dims = OmniDims.from_config(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    raw = {}
    for name, shape in tensor_names(dims).items():
        x = torch.randn(shape, generator=g, device="cuda")
        if name.endswith("bias"):
            raw[name] = x * 0.02
        elif name.endswith("norm.weight") or "layer_norm" in name:
            raw[name] = 1 + 0.05 * x
        elif name.endswith("mlp.gate.weight"):
            raw[name] = x * shape[1] ** -0.5
        elif name.endswith(("embed_tokens.weight", "embed_positions.weight")):
            raw[name] = (x * 0.02).bfloat16()
        else:
            raw[name] = (x * int(np.prod(shape[1:])) ** -0.5).bfloat16()
        del x
    params = params_from_tensors(dims, raw)
    log(f"  {OMNI_LAYERS} of 28 layers at d {dims.d}, experts {dims.n_routed} x {dims.routed_width} + shared "
        f"{dims.n_shared} x {dims.shared_width}, vocab {dims.n_vocab}: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    rng = np.random.default_rng(SEED + 22)
    text = min(151_643, dims.audio_token_id)
    prompt = np.zeros((OMNI_LANES, OMNI_COLS), np.int32)
    plen = np.zeros(OMNI_LANES, np.int32)
    for b in range(OMNI_LANES):      # 24 head ids, 14 b carried, the audio positions, 12 tail ids
        seq = (rng.integers(0, text, 24 + 14 * b).tolist() + [dims.audio_token_id] * dims.audio_tokens
               + rng.integers(0, text, 12).tolist())
        prompt[b, :len(seq)], plen[b] = seq, len(seq)
    mel = torch.from_numpy(rng.normal(size=(OMNI_LANES, dims.audio.n_mels, 3000)).astype(np.float32))
    kw = dict(prompt_capacity=OMNI_COLS, max_new_tokens=OMNI_STEPS)
    ctx = OmniContext(params, dims, **kw)
    audio = ctx.encode_window(mel)
    ctx.run_window(prompt, plen, audio, OMNI_STEPS)          # captures the step
    runs, results = {}, {}
    for label, c in (("replayed", ctx), ("eager", OmniContext(params, dims, cuda_graphs=False, **kw))):
        before = dict(TRACER.counters)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        results[label] = c.run_window(prompt, plen, audio, OMNI_STEPS)
        ms = (time.perf_counter() - t0) * 1e3
        runs[label] = dict(launches=LAUNCHES["moe_experts"], window_ms=ms, **{
            k.split(".")[1]: TRACER.counters[k] - before.get(k, 0)
            for k in ("moe.experts_read", "moe.experts_touched", "moe.step_layers")})
        r = runs[label]
        log(f"  {label} window, B={OMNI_LANES}, {OMNI_STEPS} steps: moe_experts launches {r['launches']} "
            f"(2 x {OMNI_LAYERS} layers x {OMNI_STEPS} steps = {2 * OMNI_LAYERS * OMNI_STEPS}), routed experts "
            f"read {r['experts_read']} / kept {r['experts_touched']} over {r['step_layers']} step-layers "
            f"({r['experts_read'] / r['step_layers']:.3f} a layer), {ms:.1f} ms")
        check(r["launches"] == 2 * OMNI_LAYERS * OMNI_STEPS and r["step_layers"] == OMNI_LAYERS * OMNI_STEPS
              and r["experts_read"] == r["experts_touched"] > 0, f"omni {label} window: {r}")
    for k in ("tokens", "p", "routes", "attn_start", "touched"):
        check(np.array_equal(getattr(results["replayed"], k), getattr(results["eager"], k)),
              f"omni window: the replayed step's {k} differ from the eager step's")
    del ctx, params, audio
    torch.cuda.empty_cache()
    return dict(layers=OMNI_LAYERS, lanes=OMNI_LANES, steps=OMNI_STEPS, runs=runs)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    # phase 1: card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from whisper_tpu_torch.kernels._build import build_all, ptxas_report

    # phase 2: build, with each kernel's registers, spills and static shared
    # memory as ptxas reports them
    t0 = time.perf_counter()
    info = build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, i in info.items():
        log(f"  {name}.cu: {i['seconds']:.1f} s")
        for line in ptxas_report(i["log"]):
            log(f"    {line}")

    # phase 3: kernels vs plain versions
    phase_s = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    log("[kernels]")
    # H=10: a rank's share of large-v2's 20 heads at n_model = 2 ([parallel])
    k1_cases = [flash_case(1, 1500), flash_case(8, 1500), flash_case(8, 1500, contiguous=True),
                flash_case(1, 1500, h=10)]
    k1_f32_cases = [flash_f32_case(1, 1500), flash_f32_case(8, 1500), flash_f32_case(1, 1500, h=10)]
    k2_cases = [decode_case(1, 1500, int8=int8, path="greedy B=1") for int8 in (False, True)]
    k2_cases += [decode_case(8, 1500, int8=int8, path="greedy B=8") for int8 in (False, True)]
    # beam search: the cross K/V of U utterances read by U x 5 query lanes
    k2_cases += [decode_case(5, 1500, group=5, int8=int8, path="beam U=1") for int8 in (False, True)]
    k2_cases += [decode_case(40, 1500, group=5, int8=int8, path="beam U=8") for int8 in (False, True)]
    k2_cases += [decode_case(8, 448, masked=True, int8=int8, path="greedy B=8") for int8 in (False, True)]
    k2_cases += [decode_case(40, 448, masked=True, int8=int8, path="beam U=8") for int8 in (False, True)]
    k2_cases += [decode_case(4, 448, int8=True, empty=True)]
    k2_cases += [decode_case(1, 1500, h=10, int8=int8, path="TP rank, greedy B=1") for int8 in (False, True)]
    k2_cases += [decode_case(8, 448, masked=True, h=10, int8=int8, path="TP rank, greedy B=8")
                 for int8 in (False, True)]
    for c in k1_cases:
        show_case("flash_attention", c)
    for c in k1_f32_cases:
        show_case("flash_attention f32", c)
    for c in k2_cases:
        show_case("decode_attention_hd", c)
    w8_cases = [w8a16_case(name, 8, "greedy B=8") for name in W8A16_SHAPES]
    w8_cases += [w8a16_case(name, m, path) for name in ("qkv", "logits")
                 for m, path in ((1, "run_full B=1"), (40, "beam U=8"))]
    for c in w8_cases:
        show_case("w8a16_dense", c)
    # a token step at B=8: 32 layers of the six products, then the logits
    step = {p: None if any(c[p] is None for c in w8_cases[:7])
            else 32 * sum(c[p] for c in w8_cases[:6]) + w8_cases[6][p]
            for p in ("device_ms", "library_device_ms", "bound_ms")}
    log("  w8a16_dense, a large-v2 token step's 193 products at B=8 (32 x the six of a layer + "
        "the logits): device ms {device_ms}, the converted path {library_device_ms}, bound "
        "{bound_ms}".format(**{k: "n/a" if v is None else f"{v:.4f}" for k, v in step.items()}))

    # the omni step's expert layer: 8 lanes touch ~3.5 of the 4 routed experts a layer, one lane ~1.6
    from whisper_tpu_torch.kernels._build import LAUNCHES

    moe_before = LAUNCHES["moe_experts"]
    moe_cases = [moe_case(8, 4, "omni step B=8, all kept"), moe_case(8, 3, "omni step B=8"),
                 moe_case(1, 2, "omni single stream B=1")]
    moe_launches = LAUNCHES["moe_experts"] - moe_before
    for c in moe_cases:
        show_case("moe_experts", c)
        log("    device ms by launch: gate/up {}, down {}".format(
            *("n/a" if c[k] is None else f"{c[k]:.4f}" for k in ("gate_up_device_ms", "down_device_ms"))))
        log("    error against f64 with unrounded activations, of the magnitude sum: " + ", ".join(
            f"{side} mean {e['mean']:.3e} max {e['max']:.3e}" for side, e in c["err_f64"].items()))

    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[kbench] python -m whisper_tpu_torch.tools.kbench at large-v2, every variant")
    kb_entries, kb_records = kbench_phase()
    phase_s["kbench"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        log("[golden]")
        golden = golden_phase(tmp)
        phase_s["golden"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log("[main path] synthetic large-v2")
        main = main_path_phase(tmp)
        phase_s["main path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log("[parallel] two ranks on the card over gloo: n_model = 2 (the scripted checkpoint on "
            "three tiers, large-v2 f32 and bf16), data parallel 2 x B=4; then NCCL at world size 1")
        par = parallel_phase(tmp, os.path.join(tmp, "scripted.bin"), os.path.join(tmp, LARGE_V2_FILE))
        phase_s["parallel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(f"[omni] Uni-MoE-2.0-Omni's window at the published widths, {OMNI_LAYERS} of 28 layers: "
        "replayed and eager steps")
    omni = omni_phase()
    phase_s["omni"] = time.perf_counter() - t0
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # the serving path: beam windows (natural end) per tier and U, and the
    # scheduler, each counted from 0
    beam_paths = {f"{tier} beam U={k.split('=')[1]}": v["natural"]
                  for tier in ("bf16", "serving") for k, v in main[tier].items()
                  if k.startswith("beam U=")}
    serving_path = dict(beams=beam_paths, scheduler=main["bf16"]["scheduler"], golden=golden)

    def entry(name, source, replaces, cases, by_path):
        """``launches``: the kernel's count over the main path's runs, each
        counted from 0: run_full per tier, the beam windows, the scheduler,
        run_capture."""
        head = cases[0]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
                    plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    library_ms=head["library_ms"], device_ms=head["device_ms"],
                    library_device_ms=head["library_device_ms"], shape=head["case"], cases=cases)

    def paths(key):
        by_path = {f"{tier} run_full": main[tier]["run_full"][key] for tier in ("bf16", "serving")}
        by_path.update({label: run[key] for label, run in beam_paths.items()})
        by_path["bf16 scheduler"] = main["bf16"]["scheduler"][key]
        by_path["bf16 run_capture"] = main["bf16"]["capture"][key]
        return by_path

    # [parallel]: rank 0's launches (each rank launches the same), at a
    # rank's share of the heads
    r0 = par["ranks"][0]
    k2_paths = paths("k2")
    k2_paths["f32 run_full"] = main["f32"]["run_full"]["k2"]
    k2_paths.update({f"parallel rank 0, golden {t}": r0[f"golden {t}"]["k2"] for t in ("bf16", "serving", "f32")})
    k2_paths["parallel rank 0, large-v2 f32"] = r0["large-v2 f32 tp"]["k2"]
    k2_paths["parallel rank 0, large-v2 bf16"] = r0["large-v2 bf16 tp"]["k2"]
    k1_paths = paths("k1")
    k1_paths.update({f"parallel rank 0, golden {t}": r0[f"golden {t}"]["k1"] for t in ("bf16", "serving")})
    k1_paths["parallel rank 0, large-v2 bf16"] = r0["large-v2 bf16 tp"]["k1"]
    k2 = entry("decode_attention_hd", "whisper_tpu_torch/csrc/decode_attention.cu",
               "whisper_tpu/kernels/decode_attention.py:187", k2_cases, k2_paths)
    k2["launches_int8"] = (main["serving"]["run_full"]["k2_int8"]
                           + sum(run["k2_int8"] for run in beam_paths.values()))
    k2["launches_grouped"] = sum(run["k2_grouped"] for run in beam_paths.values())
    # every token step of the path is a replayed graph: its K2 launches a step, as captured
    k2["launches_per_graph_step"] = {
        tier: dict(greedy=main[tier]["B1"]["graph_slot"]["steps"][str((0, False, FORCE_STEPS))]
                   ["k2_per_replay"],
                   beam=[v["k2_per_replay"] for v in main[tier][f"beam U={u}"]["graph_slot"]["steps"]
                         .values()][0])
        for tier, u in (("bf16", 1), ("serving", 8))}
    check(k2["launches_grouped"] > 0, "no grouped K2 launch on the beam path")
    kernels = [
        entry("flash_attention", "whisper_tpu_torch/csrc/flash_attention.cu",
              "whisper_tpu/kernels/attention.py:90", k1_cases, k1_paths),
        entry("flash_attention_f32", "whisper_tpu_torch/csrc/flash_attention_f32.cu",
              "whisper_tpu/kernels/attention.py:90", k1_f32_cases,
              {"f32 run_full": main["f32"]["run_full"]["k1_f32"],
               "parallel rank 0, golden f32": r0["golden f32"]["k1_f32"],
               "parallel rank 0, large-v2 f32": r0["large-v2 f32 tp"]["k1_f32"]}),
        k2,
        dict(name="w8a16_dense", route="cuda", source="whisper_tpu_torch/csrc/w8a16_dense.cu",
             replaces="none: XLA fused dense's int8 -> bf16 conversion into the product",
             launches_by_path={f"serving B={b} {run}": main["serving"][f"B{b}"]["runs"][run]["w8a16"]
                               for b in (1, 8) for run in ("forced graph", "natural graph")},
             max_abs_err=max(c["max_abs_err"] for c in w8_cases), shape=w8_cases[0]["case"],
             **{p: w8_cases[0][p] for p in ("ms", "device_ms", "plain_ms", "library_ms",
                                            "library_device_ms", "bound_ms", "bound_by")},
             step_at_b8=step, cases=w8_cases),
        dict(name="moe_experts", route="cuda", source="whisper_tpu_torch/csrc/moe_lanes.cu",
             replaces="none: the JAX package has no omni path (the cuBLAS chain of model/omni.py's step)",
             launches_by_path={f"omni run_window B={omni['lanes']}, {omni['steps']} steps, {label} "
                               f"({omni['layers']} of 28 layers)": r["launches"]
                               for label, r in omni["runs"].items()},
             launches_cases=moe_launches,
             max_abs_err=max(c["max_abs_err"] for c in moe_cases), shape=moe_cases[0]["case"],
             **{p: moe_cases[0][p] for p in ("ms", "device_ms", "plain_ms", "library_ms",
                                              "library_device_ms", "bound_ms", "bound_by")},
             cases=moe_cases),
        *kb_entries,
    ]
    for k in kernels[3:5]:
        k["launches"] = sum(k["launches_by_path"].values())
    kernels[1]["library_backend"] = k1_f32_cases[0]["library_backend"]
    for k in kernels[:5]:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels, "serving_path": serving_path, "main_path": main,
                      "parallel": par, "omni": omni, "kbench": kb_records, "card": smi,
                      "phase_s": phase_s}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
