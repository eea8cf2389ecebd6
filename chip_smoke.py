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
                (as the encoder passes them) and on contiguous tensors
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
                run; a small random model's encoder on the card must agree
                with the CPU path
  5. main path  a synthetic large-v2 GGML checkpoint (full width and depth,
                f16 weights from a seeded generator), once per tier: the bf16
                tier (load_model), then the serving tier (load_model with
                DtypePolicy.serving(), runtime with kv_int8=True). Each runs
                Context.run_full on a seeded 3 s clip, then the runtime's
                encode_window + run_window(force_steps=128) at B=1 and B=8.
                Every kernel counter is set to 0 right before each of these
                and must show the launches the path implies (32 encoder
                layers per encode, 2 x 32 decoder layers per token step, all
                of them on int8 K/V in the serving tier). After each timed
                run, one profiled run splits the card's time by kernel group
                and gives the idle share. The serving tier also checks the
                bytes it stores (int8 cross K/V, decoder weights, token
                table) and profiles the two passes XLA fused and eager
                PyTorch does not: int8 -> bf16 weight conversion and the
                self cache's quantize-and-write
  6. report     one JSON line of every kernel's numbers (with the serving
                path's in ``serving_path``), then the result line
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
L2_BYTES = 50 * 2**20
FORCE_STEPS = 128
PROFILE_STEPS = 16             # decode steps under the profiler (the trace stays small)
BEAM = 5                       # beam width of the beam-search runs


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
                launches=n, groups_ms=groups, top_kernels_ms=dict(top))


def show_breakdown(label: str, bd: dict, per: int = 1) -> None:
    parts = ", ".join(f"{k} {v / per:.3f}" for k, v in sorted(bd["groups_ms"].items(),
                                                              key=lambda kv: -kv[1]))
    log(f"  {label}: busy {bd['busy_ms'] / per:.3f} ms of {bd['wall_ms'] / per:.3f} ms wall "
        f"(profiler on; idle share {bd['idle_share']:.3f}), {bd['launches'] / per:.0f} kernels; {parts}")
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
    if "shape_device_ms" in c:
        log("    device ms by block shape: " + ", ".join(f"{k} {f(v)}" for k, v in
                                                   c["shape_device_ms"].items()))
    check(c["max_abs_err"] <= c["tol"], f"{name} {c['case']}: error {c['max_abs_err']} > {c['tol']}")


# ---------------------------------------------------------------------------
# phase 3b: the microbenchmark's kernels (K3-K9)
# ---------------------------------------------------------------------------

F32_FLOPS = 67e12              # H100 SXM f32 peak outside the tensor cores
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
    by ``run`` with the kernel counters set to 0 just before and read just
    after; then per kernel the profiler's device time per launch, the plain
    pass, the library pass and the bound."""
    import gc

    import torch
    import torch.nn.functional as F

    from whisper_tpu_torch.kernels import kbench as kb
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

    # 2. the kbench run: every variant, counters from 0
    for fn, _ in kb.KERNELS.values():
        fn.launches = 0
    records = tool.run(d, tool.VARIANTS, "cuda", inputs=inp)
    counts = {name: fn.launches for name, (fn, _) in kb.KERNELS.items()}
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
    saved = (k2.launches, k2.launches_int8, k2.launches_grouped)
    valid = torch.full((d.B,), d.S, dtype=torch.int32, device="cuda")
    k2_int8_dev = device_ms(lambda li: k2(inp["q"], inp["k8"][li], inp["v8"][li], d.H,
                                          valid_len=valid, k_scale=inp["sc"][li],
                                          v_scale=inp["sc"][li]), d.L, 2 * d.L, "decode_attention")
    k2.launches, k2.launches_int8, k2.launches_grouped = saved
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

def counters():
    from whisper_tpu_torch.kernels.attention import flash_attention
    from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd

    return flash_attention, decode_attention_hd


def reset_counts() -> None:
    k1, k2 = counters()
    k1.launches = k2.launches = k2.launches_int8 = k2.launches_grouped = 0


def read_counts() -> tuple[int, int, int, int]:
    """K1 launches, K2 launches, and of those the K2 launches on int8 K/V
    and those with kv_group > 1 (beam search's cross-attention)."""
    k1, k2 = counters()
    return k1.launches, k2.launches, k2.launches_int8, k2.launches_grouped


def serving_model(path: str, device: str):
    """The serving tier through the user's entry points: int8 decoder
    weights from load_model(policy=DtypePolicy.serving()), and the model's
    runtime swapped for one with int8 K/V caches (``Model`` keeps the JAX
    package's interface, whose runtime takes the cache tier separately)."""
    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.model.params import DtypePolicy
    from whisper_tpu_torch.runtime.context import WhisperRuntime

    model = load_model(path, policy=DtypePolicy.serving(), device=device)
    rt = model.runtime
    model.runtime = WhisperRuntime(rt.params, rt.dims, rt.ids, compute_dtype=rt.compute_dtype,
                                   device=rt.device, kv_int8=True)
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
                reset_counts()
                t0 = time.perf_counter()
                got[name, device] = res = run(model)
                sec = time.perf_counter() - t0
                k1, k2, k2_int8, k2_grouped = read_counts()
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
    return out


def tier_runs(model, dims, tier: str, beam_units: tuple = (), scheduler: bool = False) -> dict:
    """One tier on the synthetic large-v2 model: Context.run_full on a
    seeded 3 s clip, then encode_window + run_window(force_steps=128) at B=1
    and B=8, each with its kernel counts, then a profiled run of each; at
    the B in ``beam_units``, beam search (``beam_runs``) over the same cross
    K/V with U = B; with ``scheduler``, the BatchTranscriber
    (``scheduler_run``). Every tier gets the same seeded inputs."""
    import torch

    from whisper_tpu_torch.api.params import FullParams

    n_enc, n_dec = dims.n_audio_layer, dims.n_text_layer
    int8 = model.runtime.kv_int8
    out = {}

    def check_k2(label, k2, k2_int8, want, k2_grouped=0):
        check(k2 == want and k2_int8 == (k2 if int8 else 0) and k2_grouped == 0,
              f"{tier} {label}: K2 launches {k2} ({k2_int8} on int8 K/V, {k2_grouped} grouped), "
              f"want {want}" + (", all on int8 K/V" if int8 else "") + ", none grouped")

    # --- the user's entry point: Context.run_full on a seeded 3 s clip ---
    rng = np.random.default_rng(SEED)
    clip = (0.1 * rng.standard_normal(16_000 * 3)).astype(np.float32)
    steps = []
    run_window = model.runtime.run_window

    def counted_run_window(*a, **kw):
        res = run_window(*a, **kw)
        steps.append(int(res.steps))
        return res

    model.runtime.run_window = counted_run_window
    ctx = model.create_context()
    reset_counts()
    ms, res = sync_ms(lambda: ctx.run_full(FullParams(language="en"), clip))
    k1, k2, k2_int8, k2_grouped = read_counts()
    model.runtime.run_window = run_window
    log(f"  {tier} run_full (3 s clip): {ms:.1f} ms, {len(steps)} window(s), token steps {steps}, "
        f"{len(res.segments)} segment(s); launches K1 {k1}, K2 {k2} ({k2_int8} on int8 K/V)")
    check(len(steps) >= 1, "run_full decoded no window")
    check(k1 == n_enc * len(steps), f"K1 launches {k1} != {n_enc} x {len(steps)} encodes")
    check_k2("run_full", k2, k2_int8, 2 * n_dec * sum(steps), k2_grouped)
    for seg in res.segments:
        check(seg.t1 >= seg.t0 >= 0 and all(0 <= t.id < dims.n_vocab for t in seg.tokens),
              "run_full segment out of range")
    out["run_full"] = dict(ms=ms, windows=len(steps), steps=steps, k1=k1, k2=k2, k2_int8=k2_int8)

    # --- the runtime at B=1 and B=8: encode ms, decode ms per token step ---
    rt = model.runtime
    for b in (1, 8):
        audio = rng.standard_normal((b, 16_000 * 30)).astype(np.float32) * 0.1
        mel = np.stack([model.mel(a).cpu().numpy()[:, : 2 * dims.n_audio_ctx]
                        for a in audio])                                      # [B, 80, 3000]
        prompt = np.zeros((b, rt.prompt_capacity), np.int32)
        prompt[:, :3] = [rt.ids.sot, rt.ids.sot + 1, rt.ids.transcribe]
        plen = np.full((b,), 3, np.int32)
        seek, seek_end = np.zeros(b, np.int32), np.full(b, 3000, np.int32)

        sync_ms(lambda: rt.encode_window(mel))                                # warm-up
        reset_counts()
        enc_ms, (feats, cross) = sync_ms(lambda: rt.encode_window(mel))
        k1, _, _, _ = read_counts()
        check(k1 == n_enc, f"B={b}: K1 launches {k1} != {n_enc} per encode")
        check(bool(torch.isfinite(feats).all()) and feats.shape == (b, dims.n_audio_ctx, dims.n_audio_state),
              f"B={b}: encoder output")
        check(tuple(cross.k.shape) == (n_dec, b, dims.n_text_state, dims.n_audio_ctx), f"B={b}: cross K/V")
        check(cross.k.dtype == (torch.int8 if int8 else rt.compute_dtype), f"B={b}: cross K/V dtype")

        sync_ms(lambda: rt.run_window(prompt, plen, cross, seek, seek_end, force_steps=8))  # warm-up
        reset_counts()
        dec_ms, win = sync_ms(lambda: rt.run_window(prompt, plen, cross, seek, seek_end,
                                                    force_steps=FORCE_STEPS))
        k1, k2, k2_int8, k2_grouped = read_counts()
        check(int(win.steps) == FORCE_STEPS, f"B={b}: {int(win.steps)} steps")
        check(k1 == 0, f"B={b}: K1 launched {k1} times in decode")
        check_k2(f"B={b} decode", k2, k2_int8, 2 * n_dec * FORCE_STEPS, k2_grouped)
        tok = win.tokens.cpu()
        check(bool(((tok >= 0) & (tok < dims.n_vocab)).all()) and bool(torch.isfinite(win.p).all())
              and bool(((win.p >= 0) & (win.p <= 1)).all()), f"B={b}: window tokens/probabilities")
        log(f"  {tier} B={b}: encode {enc_ms:.2f} ms/window; decode {dec_ms / FORCE_STEPS:.3f} ms/token "
            f"step ({FORCE_STEPS} steps, {dec_ms:.1f} ms incl. prompt ingest); launches K2 {k2} "
            f"({k2_int8} on int8 K/V)")
        bd_enc = breakdown(lambda: rt.encode_window(mel))
        show_breakdown(f"{tier} B={b} encode, per window", bd_enc)
        bd_dec = breakdown(lambda: rt.run_window(prompt, plen, cross, seek, seek_end,
                                                 force_steps=PROFILE_STEPS))
        show_breakdown(f"{tier} B={b} decode, per token step ({PROFILE_STEPS} steps)", bd_dec,
                       PROFILE_STEPS)
        out[f"B{b}"] = dict(encode_ms=enc_ms, decode_ms_per_step=dec_ms / FORCE_STEPS, k2=k2,
                            k2_int8=k2_int8, encode_breakdown=bd_enc, decode_breakdown=bd_dec,
                            decode_breakdown_steps=PROFILE_STEPS)
        if b in beam_units:
            out[f"beam U={b}"] = beam_runs(rt, dims, tier, prompt, plen, cross, seek, seek_end,
                                           profile=b == max(beam_units))
    out["cross_kv_bytes_B8"] = cross.k.nbytes + cross.v.nbytes
    out["cross_scale_bytes_B8"] = (cross.k_s.nbytes + cross.v_s.nbytes) if int8 else 0
    del feats, cross
    if scheduler:
        out["scheduler"] = scheduler_run(model, dims, tier)
    return out


def beam_runs(rt, dims, tier, prompt, plen, cross, seek, seek_end, profile: bool) -> dict:
    """Beam search (width BEAM) at U = prompt's rows over the cross K/V of
    the greedy runs, [L, U, HD, T], handed to the loop as it is (never
    broadcast per beam): a window to its natural end, then one of
    FORCE_STEPS steps, each with its kernel counts (K2: 2L a step, L of
    them grouped; all on int8 K/V on the serving tier; no K1) and the peak
    memory it adds, which must stay under the bytes of a per-beam
    broadcast of the cross K/V; with ``profile``, one profiled window of
    PROFILE_STEPS steps."""
    import torch

    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
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

    sync_ms(lambda: window(8))                                                   # warm-up
    out = dict(u=u, lanes=u * BEAM, cross_kv_bytes=cross_bytes, broadcast_bytes=broadcast)
    for label, force in (("natural", 0), ("forced", FORCE_STEPS)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, res = sync_ms(lambda: window(force))
        k1, k2, k2_int8, k2_grouped = read_counts()
        extra = torch.cuda.max_memory_allocated() - base
        steps = int(res.steps)
        log(f"  {tier} beam {BEAM} U={u} ({u * BEAM} lanes), {label}: {steps} steps, {ms:.1f} ms, "
            f"{ms / steps:.3f} ms/beam step; launches K1 {k1}, K2 {k2} ({k2_grouped} grouped, "
            f"{k2_int8} on int8 K/V); peak extra memory {extra / 1e9:.3f} GB (a per-beam "
            f"broadcast of the cross K/V: {broadcast / 1e9:.3f} GB)")
        check(steps >= 1 and (steps == force if force else steps <= rt.n_max_steps),
              f"beam U={u} {label}: {steps} steps")
        check(k1 == 0, f"beam U={u} {label}: K1 launched {k1} times")
        check(k2 == 2 * n_dec * steps and k2_grouped == n_dec * steps
              and k2_int8 == (k2 if int8 else 0),
              f"beam U={u} {label}: K2 {k2} ({k2_grouped} grouped, {k2_int8} int8), want "
              f"{2 * n_dec * steps} ({n_dec * steps} grouped" + (", all int8)" if int8 else ")"))
        check(extra < broadcast, f"beam U={u} {label}: peak extra memory {extra} B >= {broadcast} B")
        tok = res.tokens.cpu()
        check(tuple(tok.shape) == (u, rt.n_max_steps)
              and bool(((tok >= 0) & (tok < dims.n_vocab)).all())
              and bool(torch.isfinite(res.p).all()), f"beam U={u} {label}: window tokens")
        out[label] = dict(steps=steps, ms=ms, ms_per_step=ms / steps, k1=k1, k2=k2,
                          k2_grouped=k2_grouped, k2_int8=k2_int8, peak_extra_bytes=extra)
    if profile:
        bd = breakdown(lambda: window(PROFILE_STEPS))
        show_breakdown(f"{tier} beam {BEAM} U={u}, per beam step ({PROFILE_STEPS} steps)", bd,
                       PROFILE_STEPS)
        out["breakdown"], out["breakdown_steps"] = bd, PROFILE_STEPS
    return out


def scheduler_run(model, dims, tier) -> dict:
    """BatchTranscriber(batch=8) over 12 seeded clips of 2-8 s, greedy: wall
    ms, rounds (one encode each), audio seconds per wall second, and the
    counts the rounds imply (K1: L_enc a round; K2: 2 L_dec a token step)."""
    from whisper_tpu_torch.api.params import FullParams
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    rng = np.random.default_rng(SEED + 2)
    clips = [(0.1 * rng.standard_normal(int(16_000 * sec))).astype(np.float32)
             for sec in rng.uniform(2.0, 8.0, 12)]
    audio_s = sum(len(c) for c in clips) / 16_000
    rt = model.runtime
    encode_window, run_window = rt.encode_window, rt.run_window
    rounds, steps = [], []

    def counted_encode(mel):
        rounds.append(mel.shape[0])
        return encode_window(mel)

    def counted_run(*a, **kw):
        res = run_window(*a, **kw)
        steps.append(int(res.steps))
        return res

    rt.encode_window, rt.run_window = counted_encode, counted_run
    try:
        bt = BatchTranscriber(model, batch=8)
        reset_counts()
        ms, results = sync_ms(lambda: bt.transcribe(clips, FullParams(language="en")))
        k1, k2, k2_int8, k2_grouped = read_counts()
    finally:
        rt.encode_window, rt.run_window = encode_window, run_window
    n_seg = sum(len(r.segments) for r in results)
    log(f"  {tier} BatchTranscriber(batch=8), 12 clips, {audio_s:.2f} s of audio: {ms:.1f} ms wall, "
        f"{len(rounds)} rounds of width {set(rounds)}, token steps {steps}, "
        f"{audio_s / (ms / 1e3):.2f} audio s per wall s, {n_seg} segment(s); launches K1 {k1}, "
        f"K2 {k2} ({k2_int8} on int8 K/V, {k2_grouped} grouped)")
    check(len(results) == len(clips) and set(rounds) == {8}, "scheduler: results or round width")
    check(k1 == dims.n_audio_layer * len(rounds),
          f"scheduler: K1 {k1} != {dims.n_audio_layer} x {len(rounds)} rounds")
    check(k2 == 2 * dims.n_text_layer * sum(steps) and k2_grouped == 0
          and k2_int8 == (k2 if rt.kv_int8 else 0),
          f"scheduler: K2 {k2} != {2 * dims.n_text_layer} x {sum(steps)} token steps")
    for r in results:
        for seg in r.segments:
            check(seg.t1 >= seg.t0 >= 0 and all(0 <= t.id < dims.n_vocab for t in seg.tokens),
                  "scheduler segment out of range")
    return dict(clips=len(clips), audio_s=audio_s, wall_ms=ms, rounds=len(rounds), steps=steps,
                audio_s_per_s=audio_s / (ms / 1e3), segments=n_seg, k1=k1, k2=k2)


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
    every int8 decoder weight and the token table to bf16 (model/layers.py
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


def main_path_phase(tmp: str) -> dict:
    import gc

    import torch

    from whisper_tpu_torch.api.model import load_model
    from whisper_tpu_torch.hparams import KNOWN_MODELS

    dims = KNOWN_MODELS["large-v2"]
    n_dec, d, t = dims.n_text_layer, dims.n_text_state, dims.n_audio_ctx
    out = {}

    t0 = time.perf_counter()
    path = os.path.join(tmp, "ggml-large-v2-synthetic.bin")
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
        stored[tier] = dict(stored_bytes(model.runtime.params),
                            cross_kv_B8=out[tier]["cross_kv_bytes_B8"],
                            cross_scales_B8=out[tier]["cross_scale_bytes_B8"])
        if tier == "serving":
            out["serving_passes"] = int8_pass_costs(model.runtime.params, dims,
                                                    model.runtime.compute_dtype)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    os.remove(path)

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
    k1_cases = [flash_case(1, 1500), flash_case(8, 1500), flash_case(8, 1500, contiguous=True)]
    k2_cases = [decode_case(1, 1500, int8=int8, path="greedy B=1") for int8 in (False, True)]
    k2_cases += [decode_case(8, 1500, int8=int8, path="greedy B=8") for int8 in (False, True)]
    # beam search: the cross K/V of U utterances read by U x 5 query lanes
    k2_cases += [decode_case(5, 1500, group=5, int8=int8, path="beam U=1") for int8 in (False, True)]
    k2_cases += [decode_case(40, 1500, group=5, int8=int8, path="beam U=8") for int8 in (False, True)]
    k2_cases += [decode_case(8, 448, masked=True, int8=int8, path="greedy B=8") for int8 in (False, True)]
    k2_cases += [decode_case(40, 448, masked=True, int8=int8, path="beam U=8") for int8 in (False, True)]
    k2_cases += [decode_case(4, 448, int8=True, empty=True)]
    for c in k1_cases:
        show_case("flash_attention", c)
    for c in k2_cases:
        show_case("decode_attention_hd", c)

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
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    # the serving path: beam windows (natural end) per tier and U, and the
    # scheduler, each counted from 0
    beam_paths = {f"{tier} beam U={k.split('=')[1]}": v["natural"]
                  for tier in ("bf16", "serving") for k, v in main[tier].items()
                  if k.startswith("beam U=")}
    serving_path = dict(beams=beam_paths, scheduler=main["bf16"]["scheduler"], golden=golden)

    def entry(name, source, replaces, cases, key):
        """``launches``: the kernel's count over the main path's runs, each
        counted from 0: run_full per tier, the beam windows, the scheduler."""
        head = cases[0]
        by_path = {f"{tier} run_full": main[tier]["run_full"][key] for tier in ("bf16", "serving")}
        by_path.update({label: run[key] for label, run in beam_paths.items()})
        by_path["bf16 scheduler"] = main["bf16"]["scheduler"][key]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
                    plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    library_ms=head["library_ms"], device_ms=head["device_ms"],
                    library_device_ms=head["library_device_ms"], shape=head["case"], cases=cases)

    k2 = entry("decode_attention_hd", "whisper_tpu_torch/csrc/decode_attention.cu",
               "whisper_tpu/kernels/decode_attention.py:187", k2_cases, "k2")
    k2["launches_int8"] = (main["serving"]["run_full"]["k2_int8"]
                           + sum(run["k2_int8"] for run in beam_paths.values()))
    k2["launches_grouped"] = sum(run["k2_grouped"] for run in beam_paths.values())
    check(k2["launches_grouped"] > 0, "no grouped K2 launch on the beam path")
    kernels = [
        entry("flash_attention", "whisper_tpu_torch/csrc/flash_attention.cu",
              "whisper_tpu/kernels/attention.py:90", k1_cases, "k1"),
        k2,
        *kb_entries,
    ]
    print(json.dumps({"kernels": kernels, "serving_path": serving_path, "main_path": main,
                      "kbench": kb_records, "card": smi, "phase_s": phase_s}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
