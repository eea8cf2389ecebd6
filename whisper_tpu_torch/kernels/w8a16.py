"""W8A16 dense: a few rows of bf16 activations times int8 weight codes, with
the per-column scale and the bias, in one launch. The CUDA kernel's wrapper
and its plain PyTorch version.

Replaces no TPU kernel: XLA fused the int8 -> bf16 conversion of the
serving tier's weights into the product, and the port's ``dense``
(``model/layers.py``) did it as a separate pass that wrote a bf16 copy of
every weight on every call. ``dense`` sends its int8 calls of at most
``MAX_ROWS`` rows here (the decoder's token steps, greedy and beam, and
their logits); larger ones (the prompt ingest) keep the converted cuBLAS
product, which is bound by operations there.

``y = (x @ w) * s + b`` in f32: x bf16 [..., K]; w int8 [K, N], either
contiguous (the blocks' [in, out]) or the transpose of a contiguous [N, K]
(the token table ``tok.T``); s f32 with N elements (``[1, N]`` or ``[N]``);
b f32 [N] or None. Without ``s`` the product is raw (and ``b`` must be None):
tensor parallelism's row-parallel calls sum it over the ranks first.

The kernel is ``csrc/w8a16_dense.cu``; its header says what bounds it
(bytes: 800 MB of int8 weights a large-v2 token step, 0.24 ms at 3.35 TB/s)
and how its design answers that: the weight tile as the MMA's 16-row
operand, codes converted in registers, the K chunks split over a
thread-block cluster and summed through distributed shared memory.
``w8a16_geometry`` gives its launch geometry.

On a CPU tensor ``w8a16_dense`` runs ``w8a16_dense_ref``; on a CUDA tensor
it launches the kernel or raises. ``w8a16_dense.launches`` counts the
launches (a captured CUDA graph's replays add what its capture recorded:
``runtime/graph.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from whisper_tpu_torch.kernels._build import load_library

MAX_ROWS = 64        # rows the kernel takes: 8 batch tiles of 8
MAX_CLUSTER = 8      # blocks a cluster (the portable limit)
WARPS = 4            # warps a block


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch of ``csrc/w8a16_dense.cu``: ``batch_tiles`` MMA tiles of 8
    rows; each warp's column tile ``tile_n`` wide, its K in chunks of
    ``chunk_k``; ``cluster`` blocks of 4 warps split a column tile's
    ``n_chunks`` chunks."""

    batch_tiles: int
    tile_n: int
    chunk_k: int
    n_tiles: int
    n_chunks: int
    cluster: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.cluster

    @property
    def chunks_per_warp(self) -> int:
        """The most chunks a warp of the launch takes."""
        return -(-self.n_chunks // (WARPS * self.cluster))


def w8a16_geometry(m: int, k: int, n: int) -> Geometry:
    """The kernel's geometry for ``m`` rows (1..MAX_ROWS), depth ``k`` and
    ``n`` columns, as ``csrc/w8a16_dense.cu`` computes it: 4 MMA tiles of 16
    columns a warp (2 from 33 rows on) over chunks of 256 / tiles k rows,
    and the smallest cluster (at most 8) that gives every warp of a column
    tile at most one chunk."""
    if not 1 <= m <= MAX_ROWS or k < 1 or n < 1:
        raise ValueError(f"w8a16_geometry: m {m} (1..{MAX_ROWS}), k {k}, n {n}")
    mt = 1
    while 8 * mt < m:
        mt *= 2
    tiles = 4 if mt <= 4 else 2
    tile_n, chunk_k = 16 * tiles, 256 // tiles
    n_chunks = -(-k // chunk_k)
    cluster = min(MAX_CLUSTER, -(-n_chunks // WARPS))
    return Geometry(mt, tile_n, chunk_k, -(-n // tile_n), n_chunks, cluster)


def weight_layout(w: torch.Tensor) -> str:
    """"nn" for a contiguous [K, N], "nt" for the transpose of a contiguous
    [N, K]; raises for any other 2-D layout."""
    if w.dim() != 2:
        raise ValueError(f"w8a16_dense: w must be 2-D, got {list(w.shape)}")
    k, n = w.shape
    if (k == 1 or w.stride(0) == n) and (n == 1 or w.stride(1) == 1):
        return "nn"
    if (n == 1 or w.stride(1) == k) and (k == 1 or w.stride(0) == 1):
        return "nt"
    raise ValueError(f"w8a16_dense: w {list(w.shape)} with strides {w.stride()} is neither "
                     f"[K, N] nor the transpose of [N, K], contiguous")


def w8a16_dense_ref(
    x: torch.Tensor,                 # [..., K] bf16
    w: torch.Tensor,                 # [K, N] int8 codes
    s: torch.Tensor | None = None,   # N f32 column scales
    b: torch.Tensor | None = None,   # [N] f32
) -> torch.Tensor:
    """Plain version, the kernel's arithmetic: the codes as bf16 (exact),
    the product in f32, times the scale, then plus the bias -> [..., N] f32."""
    y = torch.matmul(x.float(), w.to(torch.bfloat16).float())
    if s is not None:
        y = y * s
    if b is not None:
        y = y + b
    return y


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("w8a16_dense")
    fn = lib.wtt_w8a16_dense
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def w8a16_dense(
    x: torch.Tensor,
    w: torch.Tensor,
    s: torch.Tensor | None = None,
    b: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(x @ w) * s + b`` (or the raw ``x @ w`` without ``s``) -> [..., N] f32."""
    if w.dtype != torch.int8:
        raise ValueError(f"w8a16_dense: w must be int8, got {w.dtype}")
    if b is not None and s is None:
        raise ValueError("w8a16_dense: a bias needs the scale (the raw product takes neither)")
    if x.device.type == "cpu":
        return w8a16_dense_ref(x, w, s, b)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("w8a16_dense: x and w must lie on one CUDA device")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"w8a16_dense on CUDA takes bf16 x, got {x.dtype}")
    layout = weight_layout(w)
    k, n = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"w8a16_dense: x {list(x.shape)} against w {list(w.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"w8a16_dense takes 1 to {MAX_ROWS} rows, got {m}")
    x2 = x2.contiguous()
    vecs = []
    for name, t in (("s", s), ("b", b)):
        if t is None:
            vecs.append(None)
            continue
        if t.device != x.device or t.numel() != n:
            raise ValueError(f"w8a16_dense: {name} must hold {n} values on {x.device}, "
                             f"got {list(t.shape)} on {t.device}")
        if name == "s" and t.dtype != torch.float32:
            raise ValueError(f"w8a16_dense: s must be f32, got {t.dtype}")
        vecs.append(t.reshape(n).float().contiguous())   # a bias adds in f32, as y + b
    s1, b1 = vecs
    geo = w8a16_geometry(m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().wtt_w8a16_dense(
        x2.data_ptr(), w.data_ptr(), None if s1 is None else s1.data_ptr(),
        None if b1 is None else b1.data_ptr(), y.data_ptr(), m, n, k, int(layout == "nt"),
        geo.cluster, stream)
    if rc != 0:
        raise RuntimeError(f"w8a16_dense kernel launch failed: CUDA error {rc}")
    w8a16_dense.launches += 1
    return y.reshape(*lead, n)


w8a16_dense.launches = 0
