"""Microbenchmark of the decode-attention stream on the card: the port's
counterpart of ``tools/kbench.py``.

Variants over large-v2's cross K/V, bf16 [L, B, HD, S_PAD] in the decoder's
transposed layout (and int8 with column scales for ``vpu8``), or over
decoder-sized weights [L, D, 14 D] (``w8mm``, ``wbfmm``). A pass is all L
layers. The seven Pallas kernels of the JAX tool are hand-written CUDA
kernels here (``whisper_tpu_torch/kernels/kbench.py``):

  read      K3  row sums of k + v, split tiling (the stream's speed of light)
  rows      K5  the same, whole rows in one launch (a warp a row; RB sets no block)
  read1     K6  the same over all layers in one call, summed to a scalar
  flatread  K9  the same launches, flat [L * B, HD, 1] output
  vpu       K4a single-query attention on the CUDA cores, its keys split over a
                thread-block cluster fed by a TMA ring
  mxu       K4b the same on the tensor cores, head-masked dense product, its
                keys split over a thread-block cluster
  mxub      K7  the same on the tensor cores, per-head products
  vpu8      K8  vpu on int8 K/V with column scales, its keys split over a
                thread-block cluster

and the variants that XLA computed outside any kernel stay PyTorch calls:
``xla`` (per-layer ``torch.sum``s, the read family's library call),
``flat`` (one sum over everything), ``gemv`` / ``gemv2d`` (K and V times a
[S_PAD, N] ones matrix, batched with a bf16 result / as one 2-D product
with an f32 result), ``copy`` (K * 2), ``w8mm`` (int8 weights converted to
bf16, then the product, times the column scales: what the port's ``dense``
does) and ``wbfmm`` (bf16 weights). The TPU-only knobs ``SEMS`` and ``VMEM``
are gone.

Each variant is timed per pass with CUDA events after one warm-up pass and
reported against its OWN bytes (inputs read once, outputs written once):
bf16 K + V for the bf16 family, int8 K + V and scales for ``vpu8``, the
weights for ``w8mm`` / ``wbfmm``, K read and written for ``copy``.

Dimensions come from the environment, as in the JAX tool (defaults:
B=8 S=1500 HD=1280 H=20 L=32 CS=512 RB=256 N=128), and VARIANTS picks the
variants (default read,vpu,mxu). On a machine with a card:

    VARIANTS=read,rows,vpu,vpu8,mxu,mxub python -m whisper_tpu_torch.tools.kbench

Without one it raises, unless asked for the CPU, where the kernels' plain
versions run and the times are host times, not device times:

    B=2 S=200 HD=128 H=2 L=2 CS=128 RB=64 python -m whisper_tpu_torch.tools.kbench --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections.abc import Callable, Sequence

import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.kernels import kbench as kb

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
D = 1280                    # width of the decoder-sized weights, as in the JAX tool
REPS = 10                   # timed passes per variant, as in the JAX tool
VARIANTS = ("read", "rows", "xla", "vpu", "mxu", "mxub", "flat", "gemv", "copy", "flatread",
            "gemv2d", "vpu8", "w8mm", "wbfmm", "read1")
DEFAULT_VARIANTS = "read,vpu,mxu"
_GEMV = ("gemv", "gemv2d")
_WEIGHTS = ("w8mm", "wbfmm")


@dataclasses.dataclass(frozen=True)
class Dims:
    """The JAX tool's dimensions."""

    B: int = 8
    S: int = 1500
    HD: int = 1280
    H: int = 20
    L: int = 32
    CS: int = 512
    RB: int = 256
    N: int = 128

    @property
    def dh(self) -> int:
        return self.HD // self.H

    @property
    def s_pad(self) -> int:
        return -(-self.S // self.CS) * self.CS

    @property
    def n_chunks(self) -> int:
        return self.s_pad // self.CS

    @classmethod
    def from_env(cls, env=os.environ) -> Dims:
        names = ("B", "S", "HD", "H", "L", "CS", "RB", "N")
        return cls(**{n: int(env[n]) for n in names if n in env})


def fill(shape: Sequence[int], device) -> torch.Tensor:
    """The JAX tool's ``fill``: sin(i * 0.37 + j) * 0.1 in bf16, i along the
    last axis and j along axis 0, made one index of axis 0 at a time (every
    other axis repeats the row)."""
    out = torch.empty(tuple(shape), dtype=torch.bfloat16, device=device)
    i = torch.arange(shape[-1], dtype=torch.float32, device=device)
    for j in range(shape[0]):
        out[j] = (torch.sin(i * 0.37 + j) * 0.1).to(torch.bfloat16)
    return out


def to_int8(x: torch.Tensor) -> torch.Tensor:
    """clip(x * 1000, -127, 127) as int8, one index of axis 0 at a time."""
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    for j in range(x.shape[0]):
        out[j] = (x[j].float() * 1000).clamp(-127, 127).to(torch.int8)
    return out


def make_inputs(dims: Dims, device, names: Sequence[str]) -> dict:
    """The tensors the variants ``names`` read, on ``device``."""
    d = dims
    k = fill((d.L, d.B, d.HD, d.s_pad), device)
    v = fill((d.L, d.B, d.HD, d.s_pad), device)
    inputs = dict(q=fill((d.B, d.HD, 1), device), k=k, v=v)
    if any(n in _GEMV for n in names):
        inputs["ones"] = torch.ones((d.s_pad, d.N), dtype=torch.bfloat16, device=device)
    if "vpu8" in names:
        inputs.update(k8=to_int8(k), v8=to_int8(v),
                      sc=torch.ones((d.L, d.B, 1, d.s_pad), dtype=torch.float32, device=device))
    if any(n in _WEIGHTS for n in names):
        wb = fill((d.L, D, 14 * D), device)
        inputs.update(wb=wb, w8=to_int8(wb) if "w8mm" in names else None,
                      wscale=torch.ones((14 * D,), dtype=torch.float32, device=device),
                      x0=torch.ones((8, D), dtype=torch.bfloat16, device=device))
    return inputs


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result (bf16 operands on the card, as kernels/w8a16.py:dense)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


@dataclasses.dataclass
class Variant:
    fn: Callable[[], object]            # one pass
    bytes: int                          # the pass's own bytes: inputs once, outputs once
    launches_per_pass: int = 0          # kernels its kbench wrapper launches, if it has one


def make_variants(dims: Dims, inputs: dict, names: Sequence[str]) -> dict[str, Variant]:
    """Every variant of ``names``, built once over ``inputs``."""
    d = dims
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    kv = 2 * k.numel() * k.element_size()
    q_b, outs = q.numel() * 2, d.L * d.B * d.HD * 4
    layers = range(d.L)
    split = 2 if d.n_chunks > 1 else 1      # the split row sum's partial and combine launches

    def per_layer(f):
        return lambda: [f(li) for li in layers]

    def attn(kernel):
        return Variant(per_layer(lambda li: kernel(q, k[li], v[li], d.H, d.S, d.CS)),
                       kv + q_b + outs, d.L)

    def weights(convert: bool):
        w = inputs["w8" if convert else "wb"]
        x0, wscale = inputs["x0"], inputs["wscale"]

        def fn():
            x = x0
            for li in layers:
                y = _mm_f32(x, w[li].to(x.dtype))      # the int8 -> bf16 copy, or none
                if convert:
                    y = y * wscale
                x = y[:, :D].to(torch.bfloat16) * 1e-3
            return x

        nbytes = w.numel() * w.element_size() + (wscale.numel() * 4 if convert else 0)
        return Variant(fn, nbytes + 2 * x0.numel() * 2)

    build = {
        "read": lambda: Variant(per_layer(lambda li: kb.kernel_read(k[li], v[li], d.CS)),
                                kv + outs, split * d.L),
        "rows": lambda: Variant(per_layer(lambda li: kb.kernel_rows(k[li], v[li], d.RB)),
                                kv + outs, d.L),
        "xla": lambda: Variant(per_layer(lambda li: k[li].sum(-1, keepdim=True, dtype=torch.float32)
                                         + v[li].sum(-1, keepdim=True, dtype=torch.float32)),
                               kv + outs),
        "vpu": lambda: attn(kb.kernel_vpu),
        "mxu": lambda: attn(kb.kernel_mxu),
        "mxub": lambda: attn(kb.kernel_mxub),
        "read1": lambda: Variant(lambda: kb.kernel_read_all_layers(k, v, d.CS).sum(), kv + 4,
                                 split),
        "flatread": lambda: Variant(lambda: kb.kernel_flatread(k, v, d.CS), kv + outs, split),
        "flat": lambda: Variant(lambda: k.sum(dtype=torch.float32) + v.sum(dtype=torch.float32),
                                kv + 4),
        "gemv": lambda: Variant(
            per_layer(lambda li: (torch.matmul(k[li], inputs["ones"]),
                                  torch.matmul(v[li], inputs["ones"]))),
            kv + inputs["ones"].numel() * 2 + 2 * d.L * d.B * d.HD * d.N * 2),
        "gemv2d": lambda: Variant(
            per_layer(lambda li: (_mm_f32(k[li].reshape(d.B * d.HD, d.s_pad), inputs["ones"]),
                                  _mm_f32(v[li].reshape(d.B * d.HD, d.s_pad), inputs["ones"]))),
            kv + inputs["ones"].numel() * 2 + 2 * d.L * d.B * d.HD * d.N * 4),
        "copy": lambda: Variant(lambda: k * 2, kv),
        "vpu8": lambda: Variant(
            per_layer(lambda li: kb.kernel_vpu8(q, inputs["k8"][li], inputs["v8"][li],
                                                inputs["sc"][li], inputs["sc"][li], d.H, d.S,
                                                d.CS)),
            kv // 2 + 2 * inputs["sc"].numel() * 4 + q_b + outs, d.L),
        "w8mm": lambda: weights(True),
        "wbfmm": lambda: weights(False),
    }
    unknown = [n for n in names if n not in build]
    if unknown:
        raise ValueError(f"unknown kbench variants {unknown}; known: {', '.join(VARIANTS)}")
    return {n: build[n]() for n in names}


def time_pass(fn: Callable[[], object], device: torch.device, reps: int) -> float:
    """Mean ms per call of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(dims: Dims, variants: Sequence[str], device="cuda", reps: int = REPS,
        inputs: dict | None = None) -> dict[str, dict]:
    """Time one pass of each variant (``reps`` passes after one warm-up) and
    print a line each. Returns, per variant, ms per pass, its bytes, GB/s,
    the bytes bound (bytes / 3.35 TB/s) and its share of it, and the device
    the times come from (host times on the CPU)."""
    device = resolve_device(device)
    if inputs is None:
        inputs = make_inputs(dims, device, variants)
    built = make_variants(dims, inputs, variants)
    on_card = device.type == "cuda"
    clock = torch.cuda.get_device_name(device) if on_card else "cpu"
    out = {}
    for name, var in built.items():
        ms = time_pass(var.fn, device, reps)
        bound_ms = var.bytes / HBM_BYTES_PER_S * 1e3
        # a host time on the CPU is no device rate: no GB/s or share there
        out[name] = dict(ms=ms, bytes=var.bytes, gbps=var.bytes / ms / 1e6 if on_card else None,
                         bound_ms=bound_ms, share_of_bound=bound_ms / ms if on_card else None,
                         device=clock, launches_per_pass=var.launches_per_pass)
        rate = (f"{var.bytes / ms / 1e6:.0f} GB/s, {bound_ms / ms:.1%} of the 3.35 TB/s bound"
                if on_card else "host clock, plain versions")
        print(f"{name:<8} {ms:8.3f} ms/pass  ({var.bytes / 1e9:.3f} GB -> {rate}; {clock})",
              flush=True)
    return out


def main(argv: Sequence[str] | None = None) -> dict[str, dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu (plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    dims = Dims.from_env()
    names = os.environ.get("VARIANTS", DEFAULT_VARIANTS).split(",")
    print(f"kbench B={dims.B} S={dims.S}(pad {dims.s_pad}) HD={dims.HD} H={dims.H} CS={dims.CS} "
          f"chunks={dims.n_chunks} L={dims.L} on {device}", flush=True)
    return run(dims, names, device)


if __name__ == "__main__":
    main()
