"""The decode-attention microbenchmark's kernels: the CUDA wrappers and their
plain PyTorch versions.

Replaces the seven Pallas kernels of ``tools/kbench.py`` (K3-K9). All read
K/V in the decoder's transposed layout [slabs, HD, S_PAD]: S_PAD is the key
count S rounded up to the chunk CS, and the padded columns hold data.

- ``kernel_read`` (K3, ``make_pallas(kernel_read)``), ``kernel_rows`` (K5,
  ``rows_call``), ``kernel_read_all_layers`` (K6, ``read1_call``) and
  ``kernel_flatread`` (K9, ``flatread``): per row, the f32 sum of k + v over
  every stored column, padding included. K3 and K5 take one layer
  [B, HD, S_PAD]; K6 and K9 take all layers [L, B, HD, S_PAD] in one call
  and differ only in the shape of their output ([L, B, HD, 1] and
  [L * B, HD, 1], the same memory): on the card both are one launch
  configuration over L * B slabs. The TPU's ``SEMS`` (dimension semantics) and ``VMEM`` (VMEM
  limit) knobs of K9 have no meaning there and are gone.
- ``kernel_vpu`` (K4a) and ``kernel_vpu8`` (K8, int8 K/V with f32 column
  scales [B, 1, S_PAD]): per lane and head, softmax over the keys s < S of
  the unscaled q . K[:, s] (masked keys at -inf), all in f32, out [B, HD, 1];
  K8 multiplies the raw dot by ``k_scale[s]`` before the mask, sums l over p,
  then weighs V by ``p * v_scale[s]``. Neither rounds p, so the result does
  not depend on how the keys are split, up to f32 rounding.
- ``kernel_mxu`` (K4b, head-masked dense product) and ``kernel_mxub`` (K7,
  per-head products): the same attention on the tensor cores, p rounded to
  bf16 before P.V, l summed from the f32 p. K7's TPU output is [B, H, Dh],
  the same memory as [B, HD, 1].

Each softmax of the TPU bodies walks the CS-wide chunks in order with a
running max, and the bf16 rounding of p happens at the chunk's running max,
so the plain versions walk the chunks too. The kernels are
``csrc/kbench.cu``; its header says what bounds them on an H100 (bytes:
2,013,265,920 B of bf16 K + V per large-v2 pass) and how each is laid out.
K4a and K8 walk no chunks: a thread-block cluster per (head, lane)
splits the keys [0, S) into ranges, and the blocks combine their (m, l,
P.V) through distributed shared memory. K4a's ranges are whole 64-key
tiles (``vpu_geometry``), which a producer warp streams by TMA into a ring
for the block's consumer warps; K8's are whole 16-key groups
(``vpu8_geometry``), each block loading all its K/V bytes before it
reduces. K4b splits the chunks over a
thread-block cluster per (head group, lane): the launch
geometry (``mxu_geometry``: heads per group, blocks per cluster, each
block's key range) fills the card's 132 SMs, each block reads only its
heads' rows of its keys, and the blocks exchange per-chunk maxima so that p
is still rounded at the walk's running max. K7 splits the chunks the same
way, a cluster per (head, lane) (``mxub_geometry``: blocks per cluster,
each block's key range, the depth of its TMA ring), each block reading only
its head's 64 rows of its keys. K5 sums one row a warp with
every load of the row in flight; its RB no longer sets a block.

On a CPU tensor each wrapper runs its plain version (``KERNELS[name]``
holds both, the plain one taking the wrapper's arguments). On a CUDA tensor
it launches its kernel or raises; it never falls back. Each wrapper counts
the kernels it launches in ``LAUNCHES`` under its own name: two a call for
the split tiling of K3, K6 and K9 (the partial sums, then the combine; one
where a single chunk spans S_PAD), one for the others.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from whisper_tpu_torch.kernels._build import LAUNCHES, load_library

SMS = 132                    # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448         # shared memory one H100 block may use, bytes
SMEM_PER_SM = 233_472        # an SM's shared memory; each block also reserves 1 KB
# K4b (csrc/kbench.cu kb_attn_mma_dense): TMA tiles of 128 rows by 64 keys
# (16 KB) in a 5-deep ring, at most 16 heads a block (one m-tile), at most 8
# blocks a cluster (the portable size), two blocks of 9 warps an SM (its
# launch bounds: 112 registers a thread) where shared memory allows
DENSE_TILE, DENSE_TILE_ROWS, DENSE_STAGES = 64, 128, 5
DENSE_MAX_HEADS, MAX_CLUSTER, DENSE_BLOCKS_PER_SM = 16, 8, 2
# Clusters an H100 SXM holds at once, by (blocks a cluster, blocks an SM),
# from cudaOccupancyMaxActiveClusters (mxu_active_clusters for K4b,
# mxub_active_clusters for K7, vpu_active_clusters for K4a at every cluster
# size; chip_smoke.py logs them at large-v2) on an NVIDIA H100 80GB HBM3:
# clusters must sit inside one GPC, so sizes that do not divide a GPC's SMs
# leave some idle (3 at one block an SM: 39, not 44; 4 at five: 154, not 165).
CLUSTER_SLOTS = {(1, 1): 132, (2, 1): 66, (3, 1): 39, (6, 1): 17,
                 (1, 2): 264, (2, 2): 132, (3, 2): 79, (6, 2): 39,
                 (1, 5): 660, (2, 5): 330, (3, 5): 203, (4, 5): 154, (5, 5): 124, (6, 5): 101,
                 (7, 5): 84, (8, 5): 77}
# K7 (csrc/kbench.cu kb_attn_mma_head): TMA tiles of a head's 64 rows by 64
# keys (8 KB) in a ring of 4 stages, fewer only where shared memory forces
# it, blocks of 4 consumer warps and a producer warp, at most 7 blocks an SM
# by its registers (its launch bounds: 56 registers a thread)
MXUB_TILE_BYTES, MXUB_MIN_STAGES, MXUB_STAGES, MXUB_BLOCKS_PER_SM = 64 * 64 * 2, 2, 4, 7
# K8 (csrc/kbench.cu kb_attn_int8_split): a lane owns 16 keys of a row (one
# 16-byte load), so a block of 8 warps takes 512 keys a pass
VPU8_GROUP, VPU8_PASS = 16, 512
# K4a (csrc/kbench.cu kb_attn_f32_split): key ranges of whole 64-key tiles,
# walked in passes of 512 keys; blocks of 4 consumer warps and a producer
# warp with 44,272 B of static shared memory (a 32 KB ring of tiles, the
# warps' partial dots and p of a pass, q, the combine's arrays), so 5
# blocks an SM
VPU_TILE, VPU_PASS, VPU_SMEM, VPU_BLOCKS_PER_SM = 64, 512, 44_272, 5


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rowsum_ref(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis of k + v, element by element as the TPU
    body adds them -> [..., 1]."""
    return (k.float() + v.float()).sum(-1, keepdim=True)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, s_valid: int,
                  cs: int, p_bf16: bool = False, k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The TPU bodies' chunk walk: per CS-wide chunk, f32 scores of the
    unscaled q (times k_scale), columns >= s_valid at -inf, running max m,
    l = l * alpha + sum(p) over the f32 p, then p (times v_scale; rounded to
    bf16 if ``p_bf16``) into acc = acc * alpha + P.V; out acc / l, f32
    [B, HD, 1]."""
    b, hd, s_pad = k.shape
    dh = hd // n_head
    q4 = q.float().reshape(b, n_head, dh)
    m = torch.full((b, n_head), float("-inf"), device=q.device)
    l = torch.zeros((b, n_head), device=q.device)
    acc = torch.zeros((b, n_head, dh), device=q.device)
    for c0 in range(0, s_pad, cs):
        kc = k[..., c0:c0 + cs].float().reshape(b, n_head, dh, -1)
        vc = v[..., c0:c0 + cs].float().reshape(b, n_head, dh, -1)
        sc = torch.einsum("bhd,bhds->bhs", q4, kc)
        if k_scale is not None:
            sc = sc * k_scale[..., c0:c0 + cs].float()
        col = torch.arange(c0, c0 + sc.shape[-1], device=q.device)
        sc = sc.masked_fill(col >= s_valid, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        m = m_new
        if v_scale is not None:
            p = p * v_scale[..., c0:c0 + cs].float()
        if p_bf16:
            p = p.bfloat16().float()
        acc = acc * alpha[..., None] + torch.einsum("bhs,bhds->bhd", p, vc)
    return (acc / l[..., None]).reshape(b, hd, 1)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("kbench")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wtt_kb_rowsum.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.wtt_kb_rowsum_rows.argtypes = [p] * 3 + [ctypes.c_longlong, i, p]
    lib.wtt_kb_attn_f32_split.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.wtt_kb_attn_f32_clusters.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.wtt_kb_attn_int8_split.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.wtt_kb_attn_int8_clusters.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.wtt_kb_attn_mma_head.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.wtt_kb_attn_mma_head_clusters.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.wtt_kb_attn_mma_dense.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.wtt_kb_attn_mma_dense_clusters.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    for fn in (lib.wtt_kb_rowsum, lib.wtt_kb_rowsum_rows, lib.wtt_kb_attn_f32_split,
               lib.wtt_kb_attn_f32_clusters,
               lib.wtt_kb_attn_int8_split, lib.wtt_kb_attn_int8_clusters,
               lib.wtt_kb_attn_mma_head, lib.wtt_kb_attn_mma_head_clusters,
               lib.wtt_kb_attn_mma_dense,
               lib.wtt_kb_attn_mma_dense_clusters):
        fn.restype = ctypes.c_int
    return lib


def _check_kv(name: str, dtype: torch.dtype, *ts: torch.Tensor, align: int = 16) -> None:
    dev = ts[0].device
    for t in ts:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: tensors must be contiguous with {align}-byte aligned bases")
    for t in ts[:2]:
        if t.dtype != dtype:
            raise NotImplementedError(f"{name} on CUDA takes {dtype} K/V, got {t.dtype}")
    if ts[0].shape != ts[1].shape:
        raise ValueError(f"{name}: K {tuple(ts[0].shape)} and V {tuple(ts[1].shape)} differ")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rowsum_shape(name: str, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int]:
    _check_kv(name, torch.bfloat16, k, v)
    hd, s_pad = k.shape[-2:]
    if s_pad % 8:
        raise ValueError(f"{name}: S_PAD {s_pad} must be a multiple of 8")
    return k.numel() // (hd * s_pad), hd, s_pad


def _rowsum(wrapper, k: torch.Tensor, v: torch.Tensor, cols: int) -> torch.Tensor:
    """Launch the split row sum over [slabs, HD, S_PAD] -> f32 [slabs, HD],
    and count its launches under ``wrapper``'s name: a combine follows when
    cols < S_PAD."""
    name = wrapper.__name__
    slabs, hd, s_pad = _rowsum_shape(name, k, v)
    if cols % 8 or s_pad % cols:
        raise ValueError(f"{name}: the tile width {cols} must be a multiple of 8 that divides "
                         f"S_PAD {s_pad}")
    if not 1 <= slabs <= 65_535:
        raise ValueError(f"{name}: {slabs} slabs; the kernel's grid takes 1 to 65535")
    out = torch.empty((slabs, hd), dtype=torch.float32, device=k.device)
    part = (torch.empty((slabs, s_pad // cols, hd), dtype=torch.float32, device=k.device)
            if cols < s_pad else out)
    _raise_on(_lib().wtt_kb_rowsum(k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
                                   slabs, hd, s_pad, cols, _stream(k)), name)
    LAUNCHES[name] += 1 if cols == s_pad else 2
    return out


def kernel_read(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K3: one layer's row sums [B, HD, S_PAD] -> [B, HD, 1], split tiling
    (CS-wide chunks, then a combine)."""
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    return _rowsum(kernel_read, k, v, cs).reshape(*k.shape[:-1], 1)


def kernel_rows(k: torch.Tensor, v: torch.Tensor, rb: int) -> torch.Tensor:
    """K5: one layer's row sums, whole rows in one launch: one warp a row
    with every load of the row in flight. HD % RB must be 0, the JAX
    function's domain (its grid would drop rows); RB was the TPU's VMEM tile
    and no longer sets the block."""
    if k.shape[-2] % rb:
        raise ValueError(f"kernel_rows: HD {k.shape[-2]} is not a multiple of RB {rb}")
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    slabs, hd, s_pad = _rowsum_shape("kernel_rows", k, v)
    out = torch.empty((*k.shape[:-1], 1), dtype=torch.float32, device=k.device)
    _raise_on(_lib().wtt_kb_rowsum_rows(k.data_ptr(), v.data_ptr(), out.data_ptr(), slabs * hd,
                                        s_pad, _stream(k)), "kernel_rows")
    LAUNCHES["kernel_rows"] += 1
    return out


def kernel_read_all_layers(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K6: every layer's row sums in one call, [L, B, HD, S_PAD] ->
    [L, B, HD, 1], split tiling over L * B slabs."""
    if k.device.type == "cpu":
        return rowsum_ref(k, v)
    return _rowsum(kernel_read_all_layers, k, v, cs).reshape(*k.shape[:-1], 1)


def _flat(out: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return out.reshape(-1, k.shape[-2], 1)


def kernel_flatread(k: torch.Tensor, v: torch.Tensor, cs: int) -> torch.Tensor:
    """K9: K6's launches, their output flat: [L, B, HD, S_PAD] (or [L * B,
    HD, S_PAD]) -> [L * B, HD, 1]."""
    if k.device.type == "cpu":
        return _flat(rowsum_ref(k, v), k)
    return _flat(_rowsum(kernel_flatread, k, v, cs), k)


def _check_attn(name: str, q, k, v, n_head: int, s_valid: int, cs: int) -> tuple[int, int, int]:
    b, hd, s_pad = k.shape
    if q.dtype != torch.bfloat16 or tuple(q.shape) != (b, hd, 1) or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 [{b}, {hd}, 1], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if q.device != k.device:
        raise ValueError(f"{name}: q must lie on K's device")
    if hd % n_head or s_pad % cs or not 1 <= s_valid <= s_pad:
        raise ValueError(f"{name}: HD {hd}, H {n_head}, S {s_valid}, S_PAD {s_pad}, CS {cs}: "
                         "H must divide HD, CS must divide S_PAD and 1 <= S <= S_PAD")
    return b, hd, s_pad


def _cuda_core_shape(name: str, q, k, v, n_head, s_valid, cs) -> tuple[int, int, int]:
    b, hd, s_pad = _check_attn(name, q, k, v, n_head, s_valid, cs)
    if cs % 2 or hd // n_head > 128:
        raise NotImplementedError(f"{name} kernel takes an even CS and Dh <= 128")
    return b, hd, s_pad


def vpu_ranges(s_valid: int, cluster: int) -> list[tuple[int, int]]:
    """K4a's key range [lo, hi) of each block of a cluster: the ceil(S / 64)
    tiles of 64 keys split as evenly as they go, the last range ending at S
    (csrc/kbench.cu's kb_attn_f32_split computes the same)."""
    tiles = -(-s_valid // VPU_TILE)
    return [(VPU_TILE * (r * tiles // cluster),
             min(s_valid, VPU_TILE * ((r + 1) * tiles // cluster))) for r in range(cluster)]


@dataclasses.dataclass(frozen=True)
class VpuGeometry:
    """K4a's launch: a cluster of ``cluster`` blocks per (head, lane) pair,
    block r over keys ``ranges[r]``; grid (heads * cluster, lanes); ``tma``:
    the ring is filled by TMA (S_PAD % 8 == 0, a row stride of whole 16
    bytes), else by the producer warp's 4-byte cp.async copies."""

    heads: int
    lanes: int
    cluster: int
    ranges: tuple[tuple[int, int], ...]
    tma: bool

    @property
    def blocks(self) -> int:
        return self.heads * self.cluster * self.lanes


@functools.cache
def vpu_geometry(lanes: int, n_head: int, s: int, s_pad: int) -> VpuGeometry:
    """The K4a launch for this shape: of every cluster of at most 8 blocks
    and at most one a 64-key tile, the one with the least work on the
    busiest SM (rounds of the blocks the card holds at once, times the
    blocks an SM holds in a round, times one block's keys in whole tiles),
    then the fewest blocks. The head dim does not move it: a block's shared
    memory is the same whatever Dh <= 128."""
    tiles = -(-s // VPU_TILE)
    best, best_key = None, None
    for cluster in range(1, min(MAX_CLUSTER, tiles) + 1):
        ranges = vpu_ranges(s, cluster)
        keys = max(-(-(hi - lo) // VPU_TILE) for lo, hi in ranges) * VPU_TILE
        blocks = n_head * cluster * lanes
        at_once = blocks_at_once(cluster, VPU_SMEM, VPU_BLOCKS_PER_SM)
        busiest = -(-min(blocks, at_once) // SMS)
        key = (-(-blocks // at_once) * busiest * keys, blocks)
        if best_key is None or key < best_key:
            best_key = key
            best = VpuGeometry(n_head, lanes, cluster, tuple(ranges), s_pad % 8 == 0)
    return best


def vpu_active_clusters(geo: VpuGeometry, hd: int, s: int, s_pad: int) -> int:
    """How many of K4a's clusters the current card holds at once for this
    geometry (cudaOccupancyMaxActiveClusters): the launch's blocks run in
    one round when that times the cluster size reaches ``geo.blocks``."""
    n = ctypes.c_int(0)
    _raise_on(_lib().wtt_kb_attn_f32_clusters(geo.lanes, hd, s_pad, s, geo.heads, geo.cluster,
                                              ctypes.byref(n)), "vpu_active_clusters")
    return n.value


def kernel_vpu(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K4a: f32 single-query attention -> [B, HD, 1] f32. On the card the
    keys [0, S) of each (head, lane) are split over a cluster
    (``vpu_geometry``) whose blocks are fed by a TMA ring, and the blocks'
    softmax partials are combined in the same launch."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs)
    _check_kv("kernel_vpu", torch.bfloat16, k, v)
    b, hd, s_pad = _cuda_core_shape("kernel_vpu", q, k, v, n_head, s_valid, cs)
    geo = vpu_geometry(b, n_head, s_valid, s_pad)
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k.device)
    _raise_on(_lib().wtt_kb_attn_f32_split(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), b, hd, s_pad, s_valid, n_head,
                                           geo.cluster, _stream(k)), "kernel_vpu")
    LAUNCHES["kernel_vpu"] += 1
    return out


def vpu8_ranges(s_valid: int, cluster: int) -> list[tuple[int, int]]:
    """K8's key range [lo, hi) of each block of a cluster: the ceil(S / 16)
    groups of 16 keys split as evenly as they go, the last range ending at
    S (csrc/kbench.cu's kb_attn_int8_split computes the same)."""
    groups = -(-s_valid // VPU8_GROUP)
    return [(VPU8_GROUP * (r * groups // cluster),
             min(s_valid, VPU8_GROUP * ((r + 1) * groups // cluster))) for r in range(cluster)]


@dataclasses.dataclass(frozen=True)
class Vpu8Geometry:
    """K8's launch: a cluster of ``cluster`` blocks per (head, lane) pair,
    block r over keys ``ranges[r]``; grid (heads * cluster, lanes); ``vec``
    bytes a K/V load (16, or 2 where S_PAD % 16 != 0)."""

    heads: int
    lanes: int
    cluster: int
    ranges: tuple[tuple[int, int], ...]
    vec: int

    @property
    def blocks(self) -> int:
        return self.heads * self.cluster * self.lanes


@functools.cache
def vpu8_geometry(b: int, n_head: int, s: int, s_pad: int) -> Vpu8Geometry:
    """The K8 launch for this shape: clusters of C blocks, C the least that
    keeps a block's range within one pass of 512 keys (32 lanes x 16), at
    most 8 and at most one a 16-key group. The head dim does not move it: a
    head's rows are a block's whatever Dh <= 128."""
    groups = -(-s // VPU8_GROUP)
    cluster = max(1, min(MAX_CLUSTER, groups, -(-s // VPU8_PASS)))
    return Vpu8Geometry(n_head, b, cluster, tuple(vpu8_ranges(s, cluster)),
                        16 if s_pad % 16 == 0 else 2)


def vpu8_active_clusters(geo: Vpu8Geometry, hd: int, s: int, s_pad: int) -> int:
    """How many of K8's clusters the current card holds at once for this
    geometry (cudaOccupancyMaxActiveClusters)."""
    n = ctypes.c_int(0)
    _raise_on(_lib().wtt_kb_attn_int8_clusters(geo.lanes, hd, s_pad, s, geo.heads, geo.cluster,
                                               geo.vec, ctypes.byref(n)), "vpu8_active_clusters")
    return n.value


def kernel_vpu8(q, k8, v8, k_scale, v_scale, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K8: K4a's function on int8 K/V with f32 column scales [B, 1, S_PAD];
    on the card the keys [0, S) are split over a cluster (``vpu8_geometry``)
    and the blocks' softmax partials combined in the same launch."""
    if k8.device.type == "cpu":
        return attention_ref(q, k8, v8, n_head, s_valid, cs, k_scale=k_scale, v_scale=v_scale)
    if k_scale is None or v_scale is None:
        raise ValueError("kernel_vpu8: int8 K/V need k_scale and v_scale")
    # the narrow load (2 bytes) takes any even base; CS even keeps S_PAD even
    _check_kv("kernel_vpu8", torch.int8, k8, v8, align=2)
    b, hd, s_pad = _cuda_core_shape("kernel_vpu8", q, k8, v8, n_head, s_valid, cs)
    for sname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, 1, s_pad)
                or not t.is_contiguous() or t.device != k8.device):
            raise ValueError(f"kernel_vpu8: {sname} must be contiguous f32 [{b}, 1, {s_pad}] "
                             f"on {k8.device}")
    geo = vpu8_geometry(b, n_head, s_valid, s_pad)
    vec = geo.vec if k8.data_ptr() % 16 == 0 and v8.data_ptr() % 16 == 0 else 2
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k8.device)
    _raise_on(_lib().wtt_kb_attn_int8_split(q.data_ptr(), k8.data_ptr(), v8.data_ptr(),
                                            k_scale.data_ptr(), v_scale.data_ptr(),
                                            out.data_ptr(), b, hd, s_pad, s_valid, n_head,
                                            geo.cluster, vec, _stream(k8)), "kernel_vpu8")
    LAUNCHES["kernel_vpu8"] += 1
    return out


def key_ranges(s_pad: int, cs: int, cluster: int) -> list[tuple[int, int]] | None:
    """K4b's key range [lo, hi) of each block of a cluster over the S_PAD /
    CS chunks: whole chunks, as evenly as they go, when the cluster has no
    more blocks than chunks; else each chunk cut into equal parts of whole
    64-key tiles. None where the cluster cannot cut the chunks so
    (csrc/kbench.cu's key_range is the same function)."""
    n = s_pad // cs
    if cluster <= n:
        return [(r * n // cluster * cs, (r + 1) * n // cluster * cs) for r in range(cluster)]
    if cluster % n or (n * cs // cluster) % DENSE_TILE:
        return None
    per = n * cs // cluster
    return [(r * per, (r + 1) * per) for r in range(cluster)]


def range_extent(ranges, cs: int) -> tuple[int, int]:
    """The keys and the CS-wide chunks that a block of ``ranges`` takes at
    most (csrc/kbench.cu's range_extent)."""
    return (max(hi - lo for lo, hi in ranges),
            max((hi - 1) // cs - lo // cs + 1 for lo, hi in ranges))


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def dense_smem(rows: int, heads: int, keys: int, chunks: int, cluster: int) -> int:
    """Dynamic shared memory of a K4b block of ``heads`` heads (``rows``
    rows), at most ``keys`` keys and ``chunks`` chunks, in clusters of
    ``cluster``: csrc/kbench.cu's dense_smem, array by array, with its 1024
    bytes that align the ring."""
    parts = (DENSE_STAGES * DENSE_TILE_ROWS * DENSE_TILE * 2,  # the K/V ring
             2 * DENSE_STAGES * 8,                      # its full and empty mbarriers
             heads * keys * 4,                          # f32 scores
             heads * (keys + 8) * 2,                    # bf16 p, padded rows
             2 * [heads * (keys // DENSE_TILE) * 4],    # per tile: max, sum of p
             cluster * heads * chunks * 4,              # every block's prefix maxima
             heads * chunks * 4,                        # exp(m_c - M)
             cluster * rows * 4,                        # every block's acc
             cluster * DENSE_MAX_HEADS * 4,             # every block's l
             rows // 16 * 32 * 16)                      # the masked q's A fragments
    flat = [x for part in parts for x in (part if isinstance(part, list) else [part])]
    return sum(_align16(x) for x in flat) + 1024


@dataclasses.dataclass(frozen=True)
class MxuGeometry:
    """K4b's launch: ``groups`` head groups of ``heads`` heads (the last may
    hold fewer), a cluster of ``cluster`` blocks per (group, lane), block r
    of a cluster over keys ``ranges[r]``; grid (groups * cluster, lanes)."""

    heads: int
    groups: int
    cluster: int
    lanes: int
    ranges: tuple[tuple[int, int], ...]
    smem: int

    @property
    def blocks(self) -> int:
        return self.groups * self.cluster * self.lanes

    @property
    def n_tiles(self) -> int:
        """n-tiles of 8 heads that P.V issues (the scores issue one 16-row
        m-tile)."""
        return -(-self.heads // 8)


def blocks_at_once(cluster: int, smem: int, per_sm_max: int = DENSE_BLOCKS_PER_SM) -> int:
    """Blocks an H100 SXM runs at once in clusters of ``cluster`` with
    ``smem`` bytes of shared memory a block and at most ``per_sm_max`` blocks
    an SM (K4b's by default) (CLUSTER_SLOTS; where it has no entry, as many
    whole clusters as the SMs' blocks hold)."""
    per_sm = min(per_sm_max, SMEM_PER_SM // (smem + 1024))
    return CLUSTER_SLOTS.get((cluster, per_sm), SMS * per_sm // cluster) * cluster


@functools.cache
def mxu_geometry(lanes: int, hd: int, n_head: int, s_pad: int, cs: int) -> MxuGeometry:
    """The K4b launch for this shape: of every (heads per group, cluster)
    whose block fits in shared memory, the one with the least work on the
    busiest SM (rounds of the blocks the card holds at once, times the
    blocks an SM holds in a round, times one block's rows times keys), then
    the fewest blocks. Raises NotImplementedError where none fits."""
    dh = hd // n_head
    best, best_key = None, None
    for cluster in range(1, MAX_CLUSTER + 1):
        ranges = key_ranges(s_pad, cs, cluster)
        if ranges is None:
            continue
        keys, chunks = range_extent(ranges, cs)
        for heads in range(1, min(DENSE_MAX_HEADS, n_head) + 1):
            rows = heads * dh
            smem = dense_smem(rows, heads, keys, chunks, cluster)
            if smem > SMEM_LIMIT:
                break
            groups = -(-n_head // heads)
            blocks = groups * cluster * lanes
            at_once = blocks_at_once(cluster, smem)
            busiest = -(-min(blocks, at_once) // SMS)
            rows_read = -(-rows // DENSE_TILE_ROWS) * DENSE_TILE_ROWS   # whole TMA tiles
            key = (-(-blocks // at_once) * busiest * rows_read * keys, blocks)
            if best_key is None or key < best_key:
                best_key = key
                best = MxuGeometry(heads, groups, cluster, lanes, tuple(ranges), smem)
    if best is None:
        raise NotImplementedError(
            f"kernel_mxu: no K4b block fits Dh {dh}, S_PAD {s_pad} and CS {cs}: one head's "
            f"scores and p over a block's keys, with the ring of {DENSE_STAGES} tiles, must fit "
            f"in {SMEM_LIMIT} B of shared memory")
    return best


def mxu_active_clusters(geo: MxuGeometry, hd: int, n_head: int, s_pad: int, cs: int) -> int:
    """How many of K4b's clusters the current card holds at once for this
    geometry (cudaOccupancyMaxActiveClusters): the launch's blocks run in
    one round when that times the cluster size reaches ``geo.blocks``."""
    n = ctypes.c_int(0)
    _raise_on(_lib().wtt_kb_attn_mma_dense_clusters(geo.lanes, hd, s_pad, n_head, cs, geo.heads,
                                                    geo.cluster, ctypes.byref(n)),
              "mxu_active_clusters")
    return n.value


def _mma_shape(name: str, q, k, v, n_head, s_valid, cs, dh_ok: bool, domain: str):
    _check_kv(name, torch.bfloat16, k, v)
    b, hd, s_pad = _check_attn(name, q, k, v, n_head, s_valid, cs)
    if cs % 64 or not dh_ok:
        raise NotImplementedError(f"{name} kernel takes CS % 64 == 0 and {domain}; got CS {cs}, "
                                  f"Dh {hd // n_head}")
    return b, hd, s_pad


def kernel_mxu(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K4b: the head-masked dense formulation on the tensor cores (scores
    = qm^T K over a head group's rows, vp = V p^T then the head mask), bf16
    p -> [B, HD, 1] f32; keys split over a cluster (``mxu_geometry``)."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs, p_bf16=True)
    hd = k.shape[-2]
    b, hd, s_pad = _mma_shape("kernel_mxu", q, k, v, n_head, s_valid, cs,
                              hd % n_head == 0 and hd // n_head % 16 == 0, "Dh % 16 == 0")
    geo = mxu_geometry(b, hd, n_head, s_pad, cs)
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k.device)
    _raise_on(_lib().wtt_kb_attn_mma_dense(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           out.data_ptr(), b, hd, s_pad, s_valid, n_head, cs,
                                           geo.heads, geo.cluster, _stream(k)), "kernel_mxu")
    LAUNCHES["kernel_mxu"] += 1
    return out


def mxub_smem(keys: int, chunks: int, cluster: int, stages: int) -> int:
    """Dynamic shared memory of a K7 block of at most ``keys`` keys and
    ``chunks`` chunks, in clusters of ``cluster``, with a ring of ``stages``
    tiles: csrc/kbench.cu's head_smem, array by array, with its 1024 bytes
    that align the ring."""
    parts = (stages * MXUB_TILE_BYTES,         # the K/V ring
             2 * stages * 8,                   # its full and empty mbarriers
             keys * 4,                         # f32 scores
             keys * 2,                         # bf16 p
             keys // DENSE_TILE * 4 * 4,       # each consumer warp's max of each tile
             cluster * chunks * 4,             # every block's prefix maxima
             chunks * 4, chunks * 4,           # m_c and exp(m_c - M)
             cluster * 64 * 4,                 # every block's acc
             cluster * 4,                      # every block's l
             4 * 4)                            # the warps' shares of l
    return sum(_align16(x) for x in parts) + 1024


@dataclasses.dataclass(frozen=True)
class MxubGeometry:
    """K7's launch: a cluster of ``cluster`` blocks per (head, lane) pair,
    block r over keys ``ranges[r]`` (K4b's ``key_ranges``), a TMA ring of
    ``stages`` tiles; grid (heads * cluster, lanes)."""

    heads: int
    lanes: int
    cluster: int
    ranges: tuple[tuple[int, int], ...]
    stages: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.heads * self.cluster * self.lanes


@functools.cache
def mxub_geometry(lanes: int, n_head: int, s_pad: int, cs: int) -> MxubGeometry:
    """The K7 launch for this shape: of every cluster whose block fits in
    shared memory with a ring of MXUB_STAGES tiles (or the deepest ring of
    at least MXUB_MIN_STAGES that fits), the one with the least work on the
    busiest SM (rounds of the blocks the card holds at once, times the
    blocks an SM holds in a round, times one block's keys), then the fewest
    blocks. Raises NotImplementedError where no block fits."""
    best, best_key = None, None
    for cluster in range(1, MAX_CLUSTER + 1):
        ranges = key_ranges(s_pad, cs, cluster)
        if ranges is None:
            continue
        keys, chunks = range_extent(ranges, cs)
        stages = next((st for st in range(MXUB_STAGES, MXUB_MIN_STAGES - 1, -1)
                       if mxub_smem(keys, chunks, cluster, st) <= SMEM_LIMIT), None)
        if stages is None:
            continue
        smem = mxub_smem(keys, chunks, cluster, stages)
        blocks = n_head * cluster * lanes
        at_once = blocks_at_once(cluster, smem, MXUB_BLOCKS_PER_SM)
        busiest = -(-min(blocks, at_once) // SMS)
        key = (-(-blocks // at_once) * busiest * keys, blocks)
        if best_key is None or key < best_key:
            best_key = key
            best = MxubGeometry(n_head, lanes, cluster, tuple(ranges), stages, smem)
    if best is None:
        raise NotImplementedError(
            f"kernel_mxub: no K7 block fits S_PAD {s_pad} and CS {cs}: the scores and p over a "
            f"block's keys, with a ring of {MXUB_MIN_STAGES} tiles, must fit in {SMEM_LIMIT} B of "
            "shared memory")
    return best


def mxub_active_clusters(geo: MxubGeometry, s_pad: int, cs: int) -> int:
    """How many of K7's clusters the current card holds at once for this
    geometry (cudaOccupancyMaxActiveClusters): the launch's blocks run in
    one round when that times the cluster size reaches ``geo.blocks``."""
    n = ctypes.c_int(0)
    _raise_on(_lib().wtt_kb_attn_mma_head_clusters(geo.lanes, 64 * geo.heads, s_pad, geo.heads,
                                                   cs, geo.cluster, geo.stages, ctypes.byref(n)),
              "mxub_active_clusters")
    return n.value


def kernel_mxub(q, k, v, n_head: int, s_valid: int, cs: int) -> torch.Tensor:
    """K7: per-head tensor-core products q_h^T K_h and p_h V_h^T, bf16 p ->
    [B, HD, 1] f32 (the TPU's [B, H, Dh], same memory). On the card each
    (head, lane)'s keys are split over a cluster (``mxub_geometry``) that
    exchanges per-chunk maxima, so p is rounded at the walk's running max,
    and combines its partial P.V and l in the same launch."""
    if k.device.type == "cpu":
        return attention_ref(q, k, v, n_head, s_valid, cs, p_bf16=True)
    hd = k.shape[-2]
    b, hd, s_pad = _mma_shape("kernel_mxub", q, k, v, n_head, s_valid, cs,
                              hd == 64 * n_head, "Dh == 64")
    geo = mxub_geometry(b, n_head, s_pad, cs)
    out = torch.empty((b, hd, 1), dtype=torch.float32, device=k.device)
    _raise_on(_lib().wtt_kb_attn_mma_head(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), b, hd, s_pad, s_valid, n_head, cs,
                                          geo.cluster, geo.stages, _stream(k)), "kernel_mxub")
    LAUNCHES["kernel_mxub"] += 1
    return out


def _rowsums(k, v, _tile):
    return rowsum_ref(k, v)     # the tile width (CS or RB) does not change the sums


# name -> (wrapper, plain version taking the wrapper's arguments)
KERNELS = {
    "kernel_read": (kernel_read, _rowsums),
    "kernel_rows": (kernel_rows, _rowsums),
    "kernel_read_all_layers": (kernel_read_all_layers, _rowsums),
    "kernel_flatread": (kernel_flatread, lambda k, v, cs: _flat(rowsum_ref(k, v), k)),
    "kernel_vpu": (kernel_vpu, attention_ref),
    "kernel_mxu": (kernel_mxu, functools.partial(attention_ref, p_bf16=True)),
    "kernel_mxub": (kernel_mxub, functools.partial(attention_ref, p_bf16=True)),
    "kernel_vpu8": (kernel_vpu8, lambda q, k8, v8, k_scale, v_scale, *rest: attention_ref(
        q, k8, v8, *rest, k_scale=k_scale, v_scale=v_scale)),
}
