"""The token steps' expert layer: a grouped kernel pair over the experts some lane kept.
The CUDA kernel's wrapper and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no omni path. The omni step
(``model/omni.py:moe_lanes``) ran every routed expert over every lane
through cuBLAS, gate 0 where a lane did not keep it, around a chain of
elementwise launches. ``moe_experts`` computes

    out = S(h) + sum_e gates[:, e] * E_e(h),   E(h) = W_down(silu(W_gate h) * W_up h)

over B = 1..``MAX_LANES`` lanes of h [B, d], with ``shared`` = (gate_up,
down) the shared SwiGLU (ungated), or None where there is none
(LongCat-Flash's expert share, ``model/longcat.py:moe_lanes``), and
``routed`` a (gate_up, down) pair a routed expert, gated by column e of
``gates`` [B, >= n_routed] (f32, the router's output: the kept experts'
weights, 0 elsewhere). At most ``MAX_ENTRIES`` entries, the shared one
included. Weights are the views ``model/omni_params.py`` and
``model/longcat_params.py`` hold: ``gate_up`` [d, 2w] the transpose of a
contiguous [2w, d] (gate rows, then up rows), ``down`` [w, d] the
transpose of a contiguous [d, w]. Returns out [B, d] f32.

An expert that no lane kept adds ``out + 0 * E_e(h) = out``, so it is not
computed: the plain version skips it, and the kernel's blocks see it from
the gates on the device and read none of its weights. ``read``, an int32
tensor of one element, gets the count of routed experts computed added.

The kernel is ``csrc/moe_lanes.cu``; its header says what bounds it
(bytes: 407 MB an expert, ~42.8 GB a Uni-MoE-2.0-Omni step) and what its
design does about that: two launches, the first gate/up with SiLU·up into
a bf16 scratch [B, w] an expert, the second the down products with the
gates and the expert sum, ``DOWN_SPLITS`` blocks an output tile. Up to 8
lanes take the instance the omni step was measured on; 9 to 64 lanes an
instance that loops over 8-lane tiles, loading and multiplying only the
tiles in which some lane kept an expert. Each
call allocates its own scratch (activations, the down blocks' partial
sums and per-tile tickets), so calls on different streams share none.

On a CPU tensor ``moe_experts`` runs ``moe_experts_ref``; on a CUDA tensor
it launches the kernel pair or raises. Both refuse a wrong dtype, a
weight in another layout, more than ``MAX_LANES`` lanes and more than
``MAX_ENTRIES`` entries.
``LAUNCHES["moe_experts"]`` counts kernel launches (2 a call; a captured
CUDA graph's replays add what its capture recorded: ``runtime/graph.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from whisper_tpu_torch.kernels._build import LAUNCHES, load_library
from whisper_tpu_torch.kernels.w8a16 import dense

MAX_LANES = 64       # the MMA's B operand: up to 8 tiles of 8 lanes
OUT_TILE = 32        # output columns a down block
WIDTH_STEP = 64      # d and every expert width: multiples of it on the card
MAX_ENTRIES = 8      # experts the kernel takes, the shared one (if any) included
DOWN_SPLITS = 7      # down blocks an output tile, up to 8 lanes: Ring<1>::kSplits in csrc/moe_lanes.cu
WIDE_DOWN_SPLITS = 4  # the same, 9 to 64 lanes: Ring<8>::kSplits


def swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """W_down(silu(W_gate h) * W_up h), f32, with ``gate_up`` [d, 2w] (gate
    columns first) and ``down`` [w, d]: products in f32, silu(g) * u rounded
    to h's dtype."""
    g, u = dense(h, gate_up).chunk(2, dim=-1)
    return dense((F.silu(g) * u).to(h.dtype), down)


def moe_experts_ref(h: torch.Tensor, gates: torch.Tensor, shared: tuple, routed: list,
                    read: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the shared SwiGLU (or zeros), then each routed expert
    some lane kept, in order, times its gates (reads the host: CPU only)."""
    out = swiglu(h, *shared) if shared is not None else torch.zeros(h.shape, dtype=torch.float32,
                                                                      device=h.device)
    kept = (gates[:, : len(routed)] != 0).any(0)
    for e, (gate_up, down) in enumerate(routed):
        if kept[e]:
            out = out + gates[:, e:e + 1] * swiglu(h, gate_up, down)
    if read is not None:
        read += kept.sum(dtype=read.dtype)
    return out


def _transposed(w: torch.Tensor, name: str) -> None:
    """Raises unless ``w`` is 2-D and the transpose of a contiguous tensor."""
    if w.dim() != 2 or w.stride(0) != 1 or w.stride(1) != w.shape[0]:
        raise ValueError(f"moe_experts: {name} {list(w.shape)} with strides {tuple(w.stride())} is not "
                         f"the transpose of a contiguous [{w.shape[-1]}, {w.shape[0]}]")


def _check_inputs(h: torch.Tensor, gates: torch.Tensor, shared: tuple | None, routed: list,
                 read: torch.Tensor | None) -> list[int]:
    """Raises on what neither version takes; returns the entries' widths
    (the shared SwiGLU's first, if any)."""
    if h.dim() != 2 or not 1 <= h.shape[0] <= MAX_LANES:
        raise ValueError(f"moe_experts takes h [B, d] of 1 to {MAX_LANES} lanes, got {list(h.shape)}")
    if not h.is_floating_point():
        raise ValueError(f"moe_experts: h must be floating, got {h.dtype}")
    b, d = h.shape
    if gates.dtype != torch.float32 or gates.dim() != 2 or gates.shape[0] != b or gates.shape[1] < len(routed):
        raise ValueError(f"moe_experts: gates must be f32 [{b}, >= {len(routed)}], got {gates.dtype} "
                         f"{list(gates.shape)}")
    pairs = routed if shared is None else [shared, *routed]
    if not 1 <= len(pairs) <= MAX_ENTRIES:
        raise ValueError(f"moe_experts takes 1 to {MAX_ENTRIES} experts, the shared one included, got {len(pairs)}")
    if read is not None and (read.dtype != torch.int32 or read.numel() != 1):
        raise ValueError(f"moe_experts: read must be one int32, got {read.dtype} {list(read.shape)}")
    widths = []
    first = 0 if shared is None else 1
    for i, (gate_up, down) in enumerate(pairs):
        name = "shared" if i < first else f"expert {i - first}"
        for w, part in ((gate_up, "gate_up"), (down, "down")):
            if w.dtype != h.dtype:
                raise ValueError(f"moe_experts: {name} {part} is {w.dtype}, h {h.dtype}")
            if w.device != h.device:
                raise ValueError(f"moe_experts: {name} {part} on {w.device}, h on {h.device}")
            _transposed(w, f"{name} {part}")
        width = down.shape[0]
        if gate_up.shape != (d, 2 * width) or down.shape != (width, d):
            raise ValueError(f"moe_experts: {name} gate_up {list(gate_up.shape)}, down {list(down.shape)} "
                             f"for d {d}")
        widths.append(width)
    for t, name in ((gates, "gates"), (read, "read")):
        if t is not None and t.device != h.device:
            raise ValueError(f"moe_experts: {name} on {t.device}, h on {h.device}")
    return widths


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("moe_lanes")
    fn = lib.wtt_moe_lanes
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def moe_experts(h: torch.Tensor, gates: torch.Tensor, shared: tuple | None, routed: list,
                read: torch.Tensor | None = None) -> torch.Tensor:
    """``S(h) + sum_e gates[:, e] * E_e(h)`` over the experts some lane
    kept -> [B, d] f32 (see the module's docstring)."""
    widths = _check_inputs(h, gates, shared, routed, read)
    if h.device.type == "cpu":
        return moe_experts_ref(h, gates, shared, routed, read)
    if not h.is_cuda:
        raise ValueError(f"moe_experts: h on {h.device}, neither the CPU nor a CUDA device")
    if h.dtype != torch.bfloat16:
        raise NotImplementedError(f"moe_experts on CUDA takes bf16 h and weights, got {h.dtype}")
    b, d = h.shape
    if d % WIDTH_STEP or any(w % WIDTH_STEP for w in widths):
        raise ValueError(f"moe_experts on CUDA takes d and expert widths in multiples of {WIDTH_STEP}, "
                         f"got d {d}, widths {widths}")
    if gates.stride(1) != 1:
        raise ValueError(f"moe_experts: gates' rows must be contiguous, strides {tuple(gates.stride())}")
    h = h.contiguous()
    out = torch.empty((b, d), dtype=torch.float32, device=h.device)
    act = torch.empty((b * sum(widths),), dtype=torch.bfloat16, device=h.device)
    tiles = d // OUT_TILE
    lane_tiles, splits = (1, DOWN_SPLITS) if b <= 8 else (8, WIDE_DOWN_SPLITS)   # the kernel instance's
    partial = torch.empty((tiles * splits * 256 * lane_tiles,), dtype=torch.float32, device=h.device)
    tickets = torch.empty((tiles,), dtype=torch.int32, device=h.device)     # the first launch zeroes it
    offsets = [0]
    for w in widths[:-1]:
        offsets.append(offsets[-1] + b * w)
    n = len(widths)
    ptrs = ctypes.c_void_p * n
    pairs = routed if shared is None else [shared, *routed]
    rc = _lib().wtt_moe_lanes(
        h.data_ptr(), gates.data_ptr(), gates.stride(0),
        ptrs(*[gu.data_ptr() for gu, _ in pairs]), ptrs(*[dn.data_ptr() for _, dn in pairs]),
        ptrs(*[act.data_ptr() + 2 * o for o in offsets]), (ctypes.c_int * n)(*widths), n,
        int(shared is not None), out.data_ptr(),
        None if read is None else read.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
        b, d, torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_experts kernel launch failed: CUDA error {rc}")
    LAUNCHES["moe_experts"] += 2
    return out
