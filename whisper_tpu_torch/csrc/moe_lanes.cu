// The omni token step's expert layer for Hopper (sm_90a), in two launches:
//
//   act_e = bf16(silu(h @ G_e) * (h @ U_e))           launch 1, every entry e kept
//   out   = y_0 + g_1 * y_1 + g_2 * y_2 + ...,  y_e = act_e @ D_e    launch 2
//
// for B = 1..64 lanes of bf16 h [B, d]. With a shared entry, entry 0 is the
// shared SwiGLU (the shared experts side by side, always taken, gate 1); the
// other entries are routed experts, the k-th routed one gated by column k of
// gates [B, n_routed] (f32, the kept experts' weights and 0 elsewhere, as the
// router gives them). An entry that no lane kept contributes
// out + 0 * y_e = out, so it is not read at all. out is f32 [B, d].
//
// Two instances: up to 8 lanes (one 8-lane tile: Uni-MoE-2.0-Omni's step,
// whose arithmetic and speed this instance keeps), and up to 64 lanes (eight
// tiles: LongCat-Flash-Omni's step at 64 lanes, 8 routed experts, no shared
// entry). In both, a lane tile in which no lane kept an entry is neither
// loaded nor multiplied for that entry.
//
// Replaces no TPU kernel: the JAX package has no omni path. Before it the
// step ran every routed expert over every lane through cuBLAS with gate 0
// where a lane did not keep it, around a chain of elementwise launches
// (chunk, SiLU, multiply, cast, gate multiply, add): ~30 launches a layer.
//
// Layouts (model/omni_params.py): G_e and U_e are the rows [0, w) and [w, 2w)
// of a contiguous [2w, d] (gate_up_e is its transposed view), so each of their
// output columns' d inputs are contiguous; D_e is a contiguous [d, w] (down_e
// is its transposed view), each output column's w inputs contiguous.
//
// Arithmetic: bf16 x bf16 products summed in f32 on the tensor cores
// (mma.sync m16n8k16); silu(g) * u in f32, rounded to bf16 once (the plain
// version's rounding point); each routed y_e times its gate, then added, in
// ascending e after the shared y_0: the plain version's steps
// (kernels/moe.py), with the f32 sums inside each product taken in another
// order. Every sum has a fixed order (no float atomics), so two calls on the
// same inputs give the same bits, and a replayed graph equals the eager step.
//
// What bounds it on an H100: bytes. At B = 8 it does 8 flops a weight byte,
// far below the ~295 at which the tensor cores would bound it. Uni-MoE-2.0-
// Omni's layer holds 4 routed experts of 407.4 MB (d 3584, w 18944) and a
// shared SwiGLU of 101.8 MB (w 4736); a step touches ~3.5 of the 4 a layer,
// ~42.8 GB over 28 layers: 12.8 ms at 3.35 TB/s.
//
// Design.
//  - Skip on the device: a block of a routed entry reads its gate column
//    first and, where no lane kept the expert, exits before it reads a weight
//    byte. No host read, so a CUDA graph holds the step.
//  - Swapped operands (as csrc/w8a16_dense.cu): 16 weight rows (output
//    columns) are the MMA's A operand and the lanes its 8-wide B operand.
//  - A stream of 32 weight rows: a block's stage holds 32 rows x 256 k of
//    weights and the B operand's rows (h, or act_e) at the same k, each row
//    brought by one bulk copy (cp.async.bulk, 512 contiguous bytes) into a
//    ring of 3 stages, completed on an mbarrier; one producer warp issues
//    them, 4 consumer warps take 64 k each of a stage. Rows are 576 bytes
//    apart in shared memory, so the 16-byte fragment loads of a quarter warp
//    (rows g and g + 1) fall in distinct banks. The weights are loaded with
//    an L2 evict-first policy; the few rows of h and act stay in L2.
//  - The MMA's k is a summed index, so A and B may permute it alike: a
//    thread's 8 consecutive k of a 32-k block give its slots of two steps,
//    one 16-byte load a row.
//  - Launch 1: a block a tile of 16 activation columns of one entry, over
//    the whole d: the tile's 16 gate rows and 16 up rows are its 32 rows, so
//    its epilogue holds both g and u of each output. The 4 warps' sums are
//    added in shared memory in a fixed order.
//  - Launch 2: kSplits = 7 blocks a tile of 32 output columns; split r takes
//    its share of each kept entry's 256-k chunks, entries in order, one ring
//    across them. Each warp keeps an entry's partial, scales it by the lanes'
//    gates at the entry's end and adds it to its total; the warps are added
//    in shared memory into the block's partial in global memory, and the
//    tile's last block to finish (an integer ticket) adds the 7 partials in
//    split order. The tickets are the call's own scratch, zeroed by launch
//    1's first block, so calls on other streams share no counter. d alone gives only 112 tiles for 132 SMs; 784
//    blocks fill the card's 396 slots twice. Tried first: clusters of 8
//    blocks a tile summed through distributed shared memory, 896 blocks that
//    the clusters packed into fewer slots, ~2.3 rounds: 72 % of the down
//    bytes' bound against 87 % now (chip_smoke.py's moe rows, PERF.md).
//  - Launch 2's first block adds the routed experts it streamed to a device
//    counter (one writer, an integer): the runtime's moe.experts_read.
//  - Up to 64 lanes: the B operand's 8-lane tiles are looped over inside a
//    stage, each weight fragment loaded once for all of them; a stage holds
//    32 weight rows and up to 64 lane rows (55 KB), two stages a block and
//    two blocks an SM, and launch 2 takes 4 blocks a tile. Only the lane
//    tiles in which some lane kept the entry are copied in, multiplied and
//    reduced: at LongCat-Flash's 64 lanes a held expert is kept by ~1 lane a
//    step, so ~1 tile of 8. A block's threads read the B x n gates together
//    (one thread reading all 512 made the down launch ~4x slower). Measured
//    (PERF.md, H100 SXM, 700 W): 6 of 8 experts of 6144 x 2048 kept by 7 of
//    64 lanes, ~49 % of the bytes' bound for the pair.
//  - Three blocks an SM (69 KB of ring each): up to 9 stages of 20 KB in
//    flight an SM, several times what 3.35 TB/s needs over a memory round trip.
//    Measured at the published widths, B = 8, 3 experts kept (H100 SXM, 700 W;
//    PERF.md): ~90 % of the bytes' bound for the pair, gate/up ~92 %, down
//    ~86 %. Tried and no faster: 2 or 4 stages, 384 or 512 k a stage (within
//    2 %); 128 k a stage, twice the copies, was 40 % slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 4;                  // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);  // and a producer warp
constexpr int kMaxLanes = 64;
constexpr int kMaxEntries = 8;
constexpr int kRows = 32;                      // weight rows a stage: two 16-row MMA tiles
constexpr int kChunk = 256;                    // k a stage
constexpr int kPitch = 2 * kChunk + 64;        // bytes between rows in shared memory
constexpr int kOutTile = 32;                   // output columns a launch-2 tile
constexpr int kActTile = 16;                   // activation columns a launch-1 block

// An instance's ring: NT 8-lane tiles of the B operand beside the weight rows.
template <int NT>
struct Ring {
  static constexpr int kStages = NT == 1 ? 3 : 2;
  static constexpr int kBlocksPerSm = NT == 1 ? 3 : 2;
  // launch-2 blocks a 32-column tile (kernels/moe.py: DOWN_SPLITS, WIDE_DOWN_SPLITS)
  static constexpr int kSplits = NT == 1 ? 7 : 4;
  static constexpr int kStageBytes = (kRows + 8 * NT) * kPitch;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr size_t kSmemBytes = kRingBytes + 2 * kStages * sizeof(uint64_t);
};

struct Entry {
  const __nv_bfloat16* gate_up;  // contiguous [2w, d]: w gate rows, then w up rows
  const __nv_bfloat16* down;     // contiguous [d, w]
  __nv_bfloat16* act;            // [B, w], launch 1's output
  int w;
};

struct Args {
  const __nv_bfloat16* h;  // [B, d]
  const float* gates;      // [B, *] with row stride gate_stride: routed entry e's column e - shared
  float* out;              // [B, d]
  int* read;               // one int: += routed entries streamed (launch 2), or null
  float* partial;          // launch 2: [d / 32][Ring<NT>::kSplits][256 NT], each block's sums
  int* tickets;            // launch 2: [d / 32], zeroed by launch 1
  Entry e[kMaxEntries];
  int tile0[kMaxEntries + 1];  // launch 1: each entry's first tile; tile0[n] = the grid
  int n, B, d, gate_stride;
  int shared;              // 1: entry 0 is the shared SwiGLU; 0: every entry is routed
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity; a wait
// that outlasts ~2^24 suspended tries (seconds) traps, so a broken pipeline
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// `bytes` (a multiple of 16) from global `src` into this block's shared `dst`,
// counted on `bar`; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the barrier of a block's consumer warps (named barrier 1; the producer
// warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumers) : "memory");
}

// Into tiles[e] (shared, zeroed by the caller) for each entry e < n_e from
// e0: the 8-lane tiles of the B lanes in which some lane kept entry e, a bit
// a tile (every tile of the shared entry); the block's threads read one gate
// each. The caller synchronises after.
__device__ __forceinline__ void live_tiles(const Args& a, int e0, int n_e, int* tiles) {
  for (int k = threadIdx.x; k < n_e * a.B; k += blockDim.x) {
    const int e = e0 + k / a.B, m = k % a.B;
    if ((a.shared && e == 0) || __ldg(a.gates + m * a.gate_stride + e - a.shared) != 0.f)
      atomicOr(tiles + e - e0, 1 << (m >> 3));
  }
}

__device__ __forceinline__ float gate_of(const Args& a, int e, int m) {
  return m < a.B ? __ldg(a.gates + m * a.gate_stride + e - a.shared) : 0.f;
}

// k [k0, k0 + len) of one stage: rows 0..31 from `row(r)`, the B operand's
// rows 32 + m from `lane_row(m)` for the lanes m < B of the `tiles` live;
// issued by the producer warp's lanes, row r by lane r, lane row m by lane
// m % 32. The 8-lane instance's one tile is live whenever it is called.
template <int NT, class RowFn, class LaneFn>
__device__ __forceinline__ void load_stage(uint8_t* stage, uint64_t* full, int lane, int B, int tiles, int len,
                                           uint64_t policy, RowFn row, LaneFn lane_row) {
  const uint32_t bytes = 2u * static_cast<uint32_t>(len);
  if constexpr (NT == 1) {
    if (lane == 0) mbar_expect_tx(full, bytes * static_cast<uint32_t>(kRows + B));
    __syncwarp();
    bulk_copy_hint(stage + lane * kPitch, row(lane), bytes, full, policy);
    if (lane < B) bulk_copy(stage + (kRows + lane) * kPitch, lane_row(lane), bytes, full);
  } else {
    int lanes = 0;
    for (int m = 0; m < B; ++m) lanes += tiles >> (m >> 3) & 1;
    if (lane == 0) mbar_expect_tx(full, bytes * static_cast<uint32_t>(kRows + lanes));
    __syncwarp();
    bulk_copy_hint(stage + lane * kPitch, row(lane), bytes, full, policy);
    for (int m = lane; m < B; m += 32)
      if (tiles >> (m >> 3) & 1) bulk_copy(stage + (kRows + m) * kPitch, lane_row(m), bytes, full);
  }
}

// Whether lane tile nt is live: the 8-lane instance's one tile always is
// where a block runs, so its code tests nothing.
template <int NT>
__device__ __forceinline__ bool live_tile(int tiles, int nt) {
  return NT == 1 || (tiles >> nt & 1);
}

// A consumer warp's MMAs of one stage: the 64-k pieces cw, cw + 4, ... of
// the stage's len, into acc[tile][lane tile] (tile 0: rows 0..15, tile 1:
// rows 16..31), for the live lane tiles. Thread (g, t) holds k 8t..8t + 7 of
// each 32-k block: slots of two MMA steps.
template <int NT>
__device__ __forceinline__ void mma_stage(const uint8_t* stage, float (&acc)[2][NT][4], int cw, int len,
                                          int g, int t, int B, int tiles) {
  for (int k = 64 * cw; k < len; k += 64 * kConsumers) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = 2 * (k + 32 * i) + 16 * t;
      uint4 b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt] = make_uint4(0u, 0u, 0u, 0u);
        if (live_tile<NT>(tiles, nt) && 8 * nt + g < B) b[nt] = lds128(stage + (kRows + 8 * nt + g) * kPitch + off);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4 lo = lds128(stage + (16 * r + g) * kPitch + off);
        const uint4 hi = lds128(stage + (16 * r + 8 + g) * kPitch + off);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (!live_tile<NT>(tiles, nt)) continue;
          mma_bf16(acc[r][nt], lo.x, hi.x, lo.y, hi.y, b[nt].x, b[nt].y);
          mma_bf16(acc[r][nt], lo.z, hi.z, lo.w, hi.w, b[nt].z, b[nt].w);
        }
      }
    }
  }
}

// Accumulator value i (0..3) of lane ln: row 8 (i / 2) + ln / 4 of its 16-row
// tile, lane (column) 2 (ln % 4) + i % 2.
__device__ __forceinline__ int frag_row(int ln, int i) { return (ln >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_lane(int ln, int i) { return 2 * (ln & 3) + (i & 1); }

template <int NT>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int s = 0; s < Ring<NT>::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Launch 1. Grid: tile0[n] blocks, entry e's tiles from tile0[e]; a block
// writes act_e[:, 16 j .. 16 j + 15] of its tile j, for the lanes of the
// entry's live lane tiles. Block 0 also zeroes launch 2's tickets, before
// it looks at its entry.
template <int NT>
__global__ void __launch_bounds__(kThreads, Ring<NT>::kBlocksPerSm) moe_gate_up_kernel(const __grid_constant__ Args a) {
  using R = Ring<NT>;
  const int tile = static_cast<int>(blockIdx.x);
  if (tile == 0)
    for (int q = threadIdx.x; q < a.d / kOutTile; q += kThreads) a.tickets[q] = 0;
  int e = 0;
  while (e + 1 < a.n && tile >= a.tile0[e + 1]) ++e;
  __shared__ int tiles_s;
  if (threadIdx.x == 0) tiles_s = 0;
  __syncthreads();
  live_tiles(a, e, 1, &tiles_s);
  __syncthreads();
  const int tiles = tiles_s;
  if (!tiles) return;  // no lane kept the expert: not a byte read
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kRingBytes);
  uint64_t* empty = full + R::kStages;
  const Entry& en = a.e[e];
  const int j0 = (tile - a.tile0[e]) * kActTile;
  const int n_chunks = (a.d + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_ring<NT>(full, empty);
  __syncthreads();

  if (warp == kConsumers) {
    // producer: the tile's 16 gate rows, its 16 up rows and the live lanes' h rows
    const uint64_t policy = evict_first_policy();
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % R::kStages, k0 = c * kChunk;
      if (c >= R::kStages) mbar_wait(&empty[s], ((c / R::kStages) - 1) & 1);
      load_stage<NT>(
          smem + s * R::kStageBytes, &full[s], lane, a.B, tiles, min(kChunk, a.d - k0), policy,
          [&](int r) {
            const int row = r < 16 ? j0 + r : en.w + j0 + r - 16;
            return en.gate_up + static_cast<long long>(row) * a.d + k0;
          },
          [&](int m) { return a.h + static_cast<long long>(m) * a.d + k0; });
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[2][NT][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % R::kStages;
    mbar_wait(&full[s], (c / R::kStages) & 1);
    mma_stage<NT>(smem + s * R::kStageBytes, acc, warp, min(kChunk, a.d - c * kChunk), g, t, a.B, tiles);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the warps' sums in a fixed order; g and u of an output share a thread
  consumers_sync();  // every stage read: the ring is free
  float* red = reinterpret_cast<float*>(smem);  // [warp][tile][lane tile][128]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[((warp * 2 + r) * NT + nt) * 128 + lane * 4 + i] = acc[r][nt][i];
  consumers_sync();
  const int idx = threadIdx.x, ln = idx >> 2, i = idx & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = 8 * nt + frag_lane(ln, i);
    if (m >= a.B || !(tiles >> nt & 1)) continue;
    float gv = red[nt * 128 + idx], uv = red[(NT + nt) * 128 + idx];
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) {
      gv += red[((w * 2) * NT + nt) * 128 + idx];
      uv += red[((w * 2 + 1) * NT + nt) * 128 + idx];
    }
    const float y = gv / (1.f + expf(-gv)) * uv;
    en.act[static_cast<long long>(m) * en.w + j0 + frag_row(ln, i)] = __float2bfloat16_rn(y);
  }
}

// Launch 2. Grid: (d / 32) x kSplits blocks; block (q, r) takes split r of
// tile q's chunks and writes partial[q][r]; the tile's last block to finish
// (an integer ticket) adds the splits in order r = 0, 1, ... into
// out[:, 32 q .. 32 q + 31]. Only the lane tiles some entry keeps are
// reduced and added; the others' outputs are written 0.
template <int NT>
__global__ void __launch_bounds__(kThreads, Ring<NT>::kBlocksPerSm) moe_down_kernel(const __grid_constant__ Args a) {
  using R = Ring<NT>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kRingBytes);
  uint64_t* empty = full + R::kStages;
  __shared__ int tiles_s[kMaxEntries];
  __shared__ int last_s, any_s;
  constexpr int S = R::kSplits;
  constexpr int kPart = 256 * NT;               // a block's sums: 32 columns x 8 NT lanes
  const int q = static_cast<int>(blockIdx.x) / S, rank = static_cast<int>(blockIdx.x) % S;
  const int n0 = q * kOutTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_ring<NT>(full, empty);
  if (threadIdx.x < kMaxEntries) tiles_s[threadIdx.x] = 0;
  __syncthreads();
  live_tiles(a, 0, a.n, tiles_s);
  __syncthreads();
  if (threadIdx.x == 0) {
    int routed = 0, any = 0;
    for (int e = 0; e < a.n; ++e) {
      routed += e >= a.shared && tiles_s[e];
      any |= tiles_s[e];
    }
    any_s = any;
    if (a.read && blockIdx.x == 0) *a.read += routed;
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: each kept entry's share of this split, its 32 down rows and the live lanes' act rows
    const uint64_t policy = evict_first_policy();
    int u = 0;
    for (int e = 0; e < a.n; ++e) {
      const int tiles = tiles_s[e];
      if (!tiles) continue;
      const Entry& en = a.e[e];
      const int nc = (en.w + kChunk - 1) / kChunk;
      for (int c = rank * nc / S; c < (rank + 1) * nc / S; ++c, ++u) {
        const int s = u % R::kStages, k0 = c * kChunk;
        if (u >= R::kStages) mbar_wait(&empty[s], ((u / R::kStages) - 1) & 1);
        load_stage<NT>(
            smem + s * R::kStageBytes, &full[s], lane, a.B, tiles, min(kChunk, en.w - k0), policy,
            [&](int r) { return en.down + static_cast<long long>(n0 + r) * en.w + k0; },
            [&](int m) { return en.act + static_cast<long long>(m) * en.w + k0; });
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  float total[2][NT][4] = {};
  int u = 0;
  for (int e = 0; e < a.n; ++e) {
    const int tiles = tiles_s[e];
    if (!tiles) continue;
    const int w = a.e[e].w, nc = (w + kChunk - 1) / kChunk;
    float acc[2][NT][4] = {};
    for (int c = rank * nc / S; c < (rank + 1) * nc / S; ++c, ++u) {
      const int s = u % R::kStages;
      mbar_wait(&full[s], (u / R::kStages) & 1);
      mma_stage<NT>(smem + s * R::kStageBytes, acc, warp, min(kChunk, w - c * kChunk), g, t, a.B, tiles);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (a.shared && e == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) total[r][nt][i] = acc[r][nt][i];
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (!(tiles >> nt & 1)) continue;
        const float g0 = gate_of(a, e, 8 * nt + 2 * t), g1 = gate_of(a, e, 8 * nt + 2 * t + 1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            total[r][nt][i] = __fadd_rn(total[r][nt][i], __fmul_rn(i & 1 ? g1 : g0, acc[r][nt][i]));
      }
    }
  }

  // the warps' totals in shared memory, added in a fixed order into this
  // block's partial; then the tile's last block adds the splits in order
  consumers_sync();  // every stage read: the ring is free
  const int any = any_s;
  float* red = reinterpret_cast<float*>(smem);  // [warp][kPart]: [lane tile][tile][128]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!live_tile<NT>(any, nt)) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp * kPart + (nt * 2 + r) * 128 + lane * 4 + i] = total[r][nt][i];
  }
  consumers_sync();
  const int tid = threadIdx.x;
  float* mine = a.partial + (static_cast<long long>(q) * S + rank) * kPart;
  for (int v = tid; v < kPart; v += 32 * kConsumers) {
    if (!live_tile<NT>(any, v >> 8)) continue;
    float sum = red[v];
#pragma unroll
    for (int w = 1; w < kConsumers; ++w) sum += red[w * kPart + v];
    mine[v] = sum;
  }
  __threadfence();  // this block's partial before its ticket
  consumers_sync();
  if (tid == 0) last_s = atomicAdd(a.tickets + q, 1) == S - 1;
  consumers_sync();
  if (!last_s) return;
  __threadfence();  // every split's partial after the last ticket
  const float* tile = a.partial + static_cast<long long>(q) * S * kPart;
  for (int v = tid; v < kPart; v += 32 * kConsumers) {
    const int nt = v >> 8, r = (v >> 7) & 1, idx = v & 127, ln = idx >> 2, i = idx & 3;
    const int m = 8 * nt + frag_lane(ln, i);
    if (m >= a.B) continue;
    float sum = 0.f;
    if (live_tile<NT>(any, nt))
      for (int src = 0; src < S; ++src) sum += __ldcg(tile + src * kPart + v);
    a.out[static_cast<long long>(m) * a.d + n0 + 16 * r + frag_row(ln, i)] = sum;
  }
}

template <int NT>
int launch(const Args& a, cudaStream_t st) {
  using R = Ring<NT>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(moe_gate_up_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(R::kSmemBytes));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(moe_down_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(R::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attrs_set = true;
  }
  moe_gate_up_kernel<NT><<<a.tile0[a.n], kThreads, R::kSmemBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<NT><<<a.d / kOutTile * R::kSplits, kThreads, R::kSmemBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One step's expert layer of B lanes (1..64): h bf16 [B, d] contiguous;
// gates f32 [B, *] with row stride gate_stride (the k-th routed entry's
// column k); for each of the n entries (entry 0 the shared SwiGLU where
// `shared` is 1): gate_up[e] a contiguous bf16 [2 w_e, d], down[e] a
// contiguous bf16 [d, w_e], act[e] a bf16 scratch [B, w_e]; out f32 [B, d];
// read an int counter or null; partial an f32 scratch [d / 32][kSplits][256
// NT] (NT = 1 for B <= 8, else 8); tickets an int scratch [d / 32] (launch 1
// zeroes it). d and every w_e multiples of 64, every base 16-byte aligned.
// Two launches on `stream`. Returns cudaGetLastError() after them, or
// cudaErrorInvalidValue for what it does not take.
extern "C" int wtt_moe_lanes(const void* h, const float* gates, int gate_stride, const void* const* gate_up,
                             const void* const* down, void* const* act, const int* widths, int n, int shared,
                             float* out, int* read, float* partial, int* tickets, int B, int d, void* stream) {
  if (B < 1 || B > kMaxLanes || n < 1 || n > kMaxEntries || (shared != 0 && shared != 1) || d < kOutTile ||
      d % 64 || gate_stride < n - shared || !aligned16(h) || !aligned16(out) || !partial || !tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.gates = gates;
  a.out = out;
  a.read = read;
  a.partial = partial;
  a.tickets = tickets;
  a.n = n;
  a.B = B;
  a.d = d;
  a.gate_stride = gate_stride;
  a.shared = shared;
  a.tile0[0] = 0;
  for (int e = 0; e < n; ++e) {
    const int w = widths[e];
    if (w < 64 || w % 64 || !aligned16(gate_up[e]) || !aligned16(down[e]) || !aligned16(act[e]))
      return static_cast<int>(cudaErrorInvalidValue);
    a.e[e] = Entry{static_cast<const __nv_bfloat16*>(gate_up[e]), static_cast<const __nv_bfloat16*>(down[e]),
                   static_cast<__nv_bfloat16*>(act[e]), w};
    a.tile0[e + 1] = a.tile0[e] + w / kActTile;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return B <= 8 ? launch<1>(a, st) : launch<8>(a, st);
}
