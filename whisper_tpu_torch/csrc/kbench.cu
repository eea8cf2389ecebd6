// The decode-attention microbenchmark's kernels for Hopper (sm_90a): the port
// of the seven Pallas kernels of tools/kbench.py.
//
// Replaces (tools/kbench.py): K3 make_pallas(kernel_read) :54 (body :65-80),
// K4a make_pallas(kernel_vpu) :54 (body :82-111), K4b make_pallas(kernel_mxu)
// :54 (body :114-150), K5 rows_call :174, K6 read1_call :215 (body :200-213),
// K7 mxub_inner :277 (body :243-275), K8 vpu8_call :336 (body :302-334) and
// K9 flatread's call :397. All read K/V in the decoder's transposed layout
// [slabs, HD, S_PAD] (row h * Dh + d holds feature d of every key; S_PAD is
// S rounded up to the chunk CS, and the padded columns hold data). The seven
// kernels compute three functions:
//   kv_rowsum          per row, the f32 sum of k + v over every stored
//                      column, padding included (K3, K5, K6, K9)
//   kb_attn_f32_split  per lane and head, softmax over the keys s < S of the
//   kb_attn_int8_split unscaled q . K[:, s], then P.V, all in f32 (K4a; K8 on
//                      int8 K/V with column scales folded where kernel_vpu8
//                      folds them: the raw dot times k_scale[s] before the
//                      mask, the sum l over p, then p * v_scale[s] into P.V)
//   kb_attn_mma_*      the same softmax attention on the tensor cores
//                      (mma.sync m16n8k16, bf16 operands, f32 accumulation),
//                      p rounded to bf16 before P.V and l summed from the f32
//                      p: per head (K7) or as the head-masked dense product
//                      (K4b)
//
// What bounds them on an H100: bytes. A large-v2 pass (32 layers, B = 8,
// HD = 1280, S_PAD = 1536) streams 2,013,265,920 B of bf16 K + V, 0.601 ms at
// 3.35 TB/s. K8 reads the int8 K/V and scales of the keys s < S only:
// 986,112,000 B a pass at S = 1500, 0.294 ms (1,009,778,688 B over all S_PAD
// columns, as the tool counts them).
// The attention kernels do 4 flops per K/V element, far below the ~295
// flop/byte where the tensor cores would matter; K4b's dense formulation
// issues a 16-row m-tile for the scores and an 8-column n-tile per 8 heads
// of its group for P.V (24 GFLOP a pass at large-v2, 0.024 ms at 989
// TFLOP/s), K7 an 8-column n-tile for each (16 flops per K/V element), still
// far under the bytes bound.
//
// Design. The TPU walked the chunk axis of its grid in order on one core,
// carrying sums in VMEM scratch; Hopper blocks run in parallel and carry
// nothing. kv_rowsum has two tilings: split (K3, K6, K9), where blocks over
// (16 rows, one CS-wide chunk, slab) write partial row sums and a combine
// kernel adds them, the structure of the decode kernel's split-S; and
// whole-row (K5, kv_rowsum_rows), one warp a row over all of S_PAD, every
// K and V load of a row (6 + 6 uint4 a lane at S_PAD = 1536) issued before
// the sum, thousands of warps in flight; the TPU's RB was a VMEM tile and
// sets no block here. Warps run along a row so every load is 16 coalesced
// bytes a thread. K6 (grid (L, B, chunks) on the TPU) and K9 (grid (L * B,
// chunks)) differ only in the TPU's grid nesting and so are one launch
// configuration over L * B slabs here (the split pass, then the combine).
//
// K4a (kb_attn_f32_split) walks no chunks: its p is f32 and never
// rounded, so the result does not depend on how the keys are split, up to
// f32 rounding. A thread-block cluster per (head, lane) splits [0, S) into
// key ranges of whole 64-key tiles (tiles at or past S are not read); in
// each block a producer warp streams the head's Dh-row x 64-key tiles of K,
// then of V, by TMA into a 32 KB ring, each consumer warp takes its set of
// the head's rows of every tile, its lanes two keys each, and the blocks
// combine their (m, l, P.V) through distributed shared memory in the same
// launch, as K8's do (see kb_attn_f32_split).
//
// K8 (kb_attn_int8_split) walks no chunks: its p is never rounded, so the
// result does not depend on how the keys are split, up to f32 rounding. A
// thread-block cluster per (head, lane) splits [0, S) into key ranges of
// whole 16-key groups (keys >= S give p = 0 and are not read); each block
// issues all its 16-byte K and V loads and its keys' scales before any
// reduction, decodes int8 by byte permute, and the blocks combine their
// (m, l, P.V) through distributed shared memory in the same launch.
//
// K4b and K7 split the walk instead: a thread-block cluster per (head group,
// lane) for K4b, per (head, lane) for K7, divides the keys into ranges that
// lie inside one chunk or cover whole chunks, and the blocks exchange
// per-chunk maxima through distributed shared memory so that each rounds p
// at the running max the TPU's walk would have reached at that chunk, then
// combine their partial P.V and l in the same launch. A producer warp
// streams each block's K and V tiles by TMA into a ring, so V's first tiles
// load while the cluster exchanges maxima (see kb_attn_mma_dense and
// kb_attn_mma_head). K7's tiles are its head's 64 rows, so each K/V byte is
// read once and no row of another head is read.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kMaxDh = 128;  // the attention kernels' largest head dim

// the two bf16 of a 32-bit word, low address first, as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// kv_rowsum: K3, K5, K6, K9
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSplitRows = 16;  // rows per block of the split tiling
constexpr int kRowVec = 6;      // uint4 of K (and of V) a lane loads before summing

// sum over 8 columns of k + v, element by element as the TPU body adds them
__device__ __forceinline__ float sum_kv8(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += bf16_lo(wa[i]) + bf16_lo(wb[i]);
    s += bf16_hi(wa[i]) + bf16_hi(wb[i]);
  }
  return s;
}

// Block (row tile, column chunk, slab): rows [x * 16, +16) x columns
// [y * cols, +cols). One warp per row at a time, lanes along the row.
// dst is [slabs, gridDim.y, HD]: the output itself when gridDim.y == 1.
__global__ void __launch_bounds__(kSumThreads)
kv_rowsum_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                 float* __restrict__ dst, int HD, int S, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kSplitRows;
  const int r_end = min(r0 + kSplitRows, HD);
  const long long slab = blockIdx.z;
  const int n_vec = cols / 8;
  for (int r = r0 + warp; r < r_end; r += kSumWarps) {
    const long long off = (slab * HD + r) * S + (long long)blockIdx.y * cols;
    const uint4* kr = reinterpret_cast<const uint4*>(k + off);
    const uint4* vr = reinterpret_cast<const uint4*>(v + off);
    float acc = 0.f;
#pragma unroll 4
    for (int i = lane; i < n_vec; i += 32) acc += sum_kv8(__ldg(kr + i), __ldg(vr + i));
    acc = warp_sum(acc);
    if (lane == 0) dst[(slab * gridDim.y + blockIdx.y) * HD + r] = acc;
  }
}

// K5: warp w of block x sums row x * 8 + w of the n_rows = slabs * HD rows
// over all S columns. Each pass of the outer loop issues kRowVec uint4 of K
// and of V a lane (a 1536-column row in one pass) before it adds any; the
// tail past S / 8 loads nothing and adds zeros, which leave the sum exact.
__global__ void __launch_bounds__(kSumThreads)
kv_rowsum_rows(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
               float* __restrict__ out, long long n_rows, int S) {
  const long long row = (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31, n_vec = S / 8;
  const uint4* kr = reinterpret_cast<const uint4*>(k + row * S);
  const uint4* vr = reinterpret_cast<const uint4*>(v + row * S);
  float acc = 0.f;
  for (int base = lane; base < n_vec; base += 32 * kRowVec) {
    uint4 a[kRowVec], b[kRowVec];
#pragma unroll
    for (int u = 0; u < kRowVec; ++u) {
      const int i = base + 32 * u;
      a[u] = i < n_vec ? __ldg(kr + i) : make_uint4(0u, 0u, 0u, 0u);
      b[u] = i < n_vec ? __ldg(vr + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kRowVec; ++u) acc += sum_kv8(a[u], b[u]);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

// out[slab, r] = sum over the chunks of part[slab, chunk, r]
__global__ void kv_rowsum_combine(const float* __restrict__ part, float* __restrict__ out, int HD,
                                  int n_parts, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // slab * HD + r
  if (i >= n) return;
  const float* p = part + (i / HD) * n_parts * HD + i % HD;
  float acc = 0.f;
  for (int c = 0; c < n_parts; ++c) acc += p[(long long)c * HD];
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// K8: int8 K/V + column scales, the keys split over a cluster
// ---------------------------------------------------------------------------

constexpr int kI8Threads = 256;
constexpr int kI8Warps = kI8Threads / 32;   // warp w holds rows w, w + 8, ... of the head
constexpr int kI8Group = 16;                // keys a lane owns: one 16-byte load of a row
constexpr int kI8Pass = 32 * kI8Group;      // keys a block takes at once: 512
constexpr int kI8MaxCluster = 8;

// Non-coherent loads as volatile asm, not __ldg: the asm keeps the loads in
// the order written, all of a pass before its first decode, and the address
// arithmetic apart from them. With __ldg for the same loads nvcc emits the
// same LDG instructions but schedules the address arithmetic and parameter
// loads around them differently, and K8 ran slower on an H100.
__device__ __forceinline__ uint4 ldg_v4(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t ldg_u16(const void* p) {
  unsigned short r;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ float ldg_f32(const float* p) {
  float r;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

// The 16 int8 codes at p as one uint4, or zeros where no key is left: n is
// the count of the 16 keys that lie in the block's range (<= 0: none).
// kVec = 16 takes one load (the 16 bytes lie inside the row when S_pad % 16
// == 0); kVec = 2 takes 2-byte loads of the pieces that hold a key in range
// (S_pad is even, so none reaches past the row).
template <int kVec>
__device__ __forceinline__ uint4 load_codes(const int8_t* p, int n) {
  if constexpr (kVec == 16) {
    return n > 0 ? ldg_v4(p) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 4 * i < n ? ldg_u16(p + 4 * i) : 0u;
      const uint32_t hi = 4 * i + 2 < n ? ldg_u16(p + 4 * i + 2) : 0u;
      w[i] = lo | hi << 16;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 16 int8 codes, low byte first, as f32 (exact): the biased byte c + 128 as
// the low mantissa bits of 2^23 by one byte permute, then one subtract,
// where a conversion instruction runs at a quarter of the FMA rate.
__device__ __forceinline__ void decode16(uint4 r, float (&f)[16]) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[4 * i + e] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | e)) - 8388736.f;
}

// Each of N values (N = 8, 16 or 32) summed over the warp in N + N/2 + ... + 1
// + 1 shuffles rather than 5 N: each step halves the values a lane carries.
// Lane L ends with the sum of value (L >> (5 - log2 N)) % N.
template <int N>
__device__ __forceinline__ float warp_sum_many(float (&v)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int o = 16 >> step, n = N >> (step + 1);  // n: values a lane keeps
    if (n > 0) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float send = up ? v[i] : v[i + n], keep = up ? v[i + n] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

// Where key j of a pass sits in part_s's rows and in p_s: lane j / 16's 16
// floats, their four 16-byte pieces rotated by (lane / 2) % 4, so that the
// lanes' float4 stores and loads of those rows meet no bank conflict.
__device__ __forceinline__ int i8_slot(int j) {
  const int ln = j >> 4;
  return (ln << 4) + ((((j >> 2) & 3) ^ ((ln >> 1) & 3)) << 2) + (j & 3);
}

// K8: a cluster of C blocks per (head, lane); grid (H * C, B). Block rank r
// takes keys [lo, hi): the ceil(S / 16) groups of 16 keys split as evenly as
// they go (kernels/kbench.py's vpu8_ranges), the last range ending at S, so
// no range is empty when C <= ceil(S / 16). In a pass of up to 512 keys
// from p0, lane j of warp w owns keys [p0 + 16 j, +16) of the head's rows
// w, w + 8, ... (kRows of them): every K and V load of the pass (16 bytes
// a row) and its keys' scales go out first, 64 KB a block at Dh = 64, so
// V's bytes arrive while the scores are reduced. The bytes land in
// registers (128 a thread, two blocks an SM), which no copy into shared
// memory has to wait out.
//   scores: each thread's 16 partial dots over its rows (f32, the codes
//     decoded by byte permute) meet in shared memory; a thread a key sums
//     them, times k_scale, keys >= hi at -inf; the block's max m and
//     p = exp(s - m), l the sum of p, p * v_scale into p_s.
//   P.V: a lane takes the p of its 16 keys and multiplies them into each of
//     its V rows; the rows' sums over the warp leave lane L with one row.
// Over passes (ranges past 512 keys) m, l and acc run as the online softmax.
//   combine: each block stores its acc of row d into block d % C's shared
//     memory and its (m, l) into every block's; cluster.sync(); block r
//     writes rows d = r (mod C): sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M)
//     l_j, M the max of the m_j. Every block stores before the one sync and
//     reads only its own shared memory after it, so none waits out a
//     peer's reads; each m_j is finite (every range holds a key < S).
template <int kVec, int kRows>
__global__ void __launch_bounds__(kI8Threads, kVec == 16 && kRows == 8 ? 2 : 1)
kb_attn_int8_split(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                   const int8_t* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, float* __restrict__ out, int HD, int S_pad,
                   int S, int H) {
  __shared__ __align__(16) float part_s[kI8Warps][kI8Pass];  // each warp's partial scores
  __shared__ __align__(16) float p_s[kI8Pass];               // p * v_scale
  __shared__ float red_m[kI8Warps], red_l[kI8Warps];
  __shared__ float acc_x[kI8MaxCluster][kMaxDh];  // every block's acc of this block's rows
  __shared__ float2 ml_x[kI8MaxCluster];          // every block's (m, l)
  cg::cluster_group cluster = cg::this_cluster();
  // a block stores into its peers' shared memory only once all are running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = static_cast<int>(blockIdx.x) / C, b = blockIdx.y, dh = HD / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = (S + kI8Group - 1) / kI8Group;
  const int lo = kI8Group * (rank * groups / C);
  const int hi = min(S, kI8Group * ((rank + 1) * groups / C));
  const long long row0 = ((long long)b * HD + (long long)h * dh) * S_pad;
  const float* ksb = k_scale + (long long)b * S_pad;
  const float* vsb = v_scale + (long long)b * S_pad;
  const int sw = (lane >> 1) & 3;  // i8_slot's rotation of this lane's pieces

  float qv[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int d = warp + kI8Warps * i;
    qv[i] = d < dh ? __bfloat162float(q[(long long)b * HD + h * dh + d]) : 0.f;
  }

  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int p0 = lo; p0 < hi; p0 += kI8Pass) {
    const int key0 = p0 + kI8Group * lane, n = hi - key0;
    uint4 kr[kRows], vr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int d = warp + kI8Warps * i;
      kr[i] = load_codes<kVec>(k + row0 + (long long)d * S_pad + key0, d < dh ? n : 0);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int d = warp + kI8Warps * i;
      vr[i] = load_codes<kVec>(v + row0 + (long long)d * S_pad + key0, d < dh ? n : 0);
    }
    float ks[2], vs[2];  // the scales of keys p0 + tid and p0 + tid + 256
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = p0 + tid + kI8Threads * u;
      ks[u] = key < hi ? ldg_f32(ksb + key) : 0.f;
      vs[u] = key < hi ? ldg_f32(vsb + key) : 0.f;
    }

    // scores: this thread's rows' partial dots of its 16 keys
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float f[16];
      decode16(kr[i], f);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = fmaf(qv[i], f[e], s[e]);
    }
    float* pw = part_s[warp] + kI8Group * lane;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pw + ((c ^ sw) << 2)) =
          make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
    __syncthreads();

    // a thread a key: the whole dot, scaled and masked; the block's max
    float sc[2], t_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = tid + kI8Threads * u, slot = i8_slot(j);
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kI8Warps; ++w) a += part_s[w][slot];
      sc[u] = p0 + j < hi ? a * ks[u] : -INFINITY;
      t_max = fmaxf(t_max, sc[u]);
    }
    t_max = warp_max(t_max);
    if (lane == 0) red_m[warp] = t_max;
    __syncthreads();
    float m_pass = red_m[0];
#pragma unroll
    for (int w = 1; w < kI8Warps; ++w) m_pass = fmaxf(m_pass, red_m[w]);
    const float m_new = fmaxf(m, m_pass);  // finite: key p0 < hi
    const float alpha = expf(m - m_new);   // 0 on the first pass
    float t_sum = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float p = expf(sc[u] - m_new);  // 0 for a masked key
      t_sum += p;
      p_s[i8_slot(tid + kI8Threads * u)] = p * vs[u];
    }
    t_sum = warp_sum(t_sum);
    if (lane == 0) red_l[warp] = t_sum;
    __syncthreads();  // p_s and red_l are whole
    float l_pass = 0.f;
#pragma unroll
    for (int w = 0; w < kI8Warps; ++w) l_pass += red_l[w];
    l = l * alpha + l_pass;
    m = m_new;

    // P.V: this lane's 16 p against each of its V rows, then the warp's sums
    float pv[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(p_s + kI8Group * lane + ((c ^ sw) << 2));
      pv[4 * c] = x.x;
      pv[4 * c + 1] = x.y;
      pv[4 * c + 2] = x.z;
      pv[4 * c + 3] = x.w;
    }
    float a[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float f[16];
      decode16(vr[i], f);
      a[i] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) a[i] = fmaf(pv[e], f[e], a[i]);
    }
    acc = acc * alpha + warp_sum_many<kRows>(a);
    // the next pass writes part_s, p_s and red_* only after its first
    // __syncthreads(), which every thread reaches after reading them here
  }

  // --- combine over the cluster ---
  constexpr int kCopies = 32 / kRows;                  // lanes that hold one row's sum
  const int d_own = warp + kI8Warps * (lane / kCopies);  // warp_sum_many's row of this lane
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (lane % kCopies == 0 && d_own < dh)
    *cluster.map_shared_rank(&acc_x[rank][d_own], d_own % C) = acc;
  if (tid < C) *cluster.map_shared_rank(&ml_x[rank], tid) = make_float2(m, l);
  cluster.sync();  // every block's acc and (m, l) are in
  for (int d = rank + C * tid; d < dh; d += C * kI8Threads) {
    float M = -INFINITY;
    for (int j = 0; j < C; ++j) M = fmaxf(M, ml_x[j].x);
    float num = 0.f, den = 0.f;
    for (int j = 0; j < C; ++j) {
      const float f = expf(ml_x[j].x - M);
      num += f * acc_x[j][d];
      den += f * ml_x[j].y;
    }
    out[(long long)b * HD + h * dh + d] = num / den;
  }
}

// ---------------------------------------------------------------------------
// tensor-core attention: K7 (per head), K4b (head-masked dense)
// ---------------------------------------------------------------------------

constexpr int kT = 64;          // keys per shared-memory tile
constexpr int kMmaDh = 64;      // K7's head dim
constexpr int kHeadConsumers = 128;                  // K7: 4 consumer warps, 16 features each
constexpr int kHeadWarps = kHeadConsumers / 32;
constexpr int kHeadThreads = kHeadConsumers + 32;    // and one producer warp
constexpr int kHeadMaxStages = 4;                    // K7's TMA ring: 2 to 4 stages
constexpr uint32_t kHeadTileBytes = kMmaDh * kT * 2;  // a tile: the head's 64 rows by 64 keys
constexpr int kDenseConsumers = 256;               // K4b: 8 consumer warps
constexpr int kDenseWarps = kDenseConsumers / 32;
constexpr int kDenseThreads = kDenseConsumers + 32;  // and one producer warp
constexpr int kDenseStages = 5;                    // K4b's TMA ring
constexpr int kDenseTileRows = 128;                // rows of a tile: one m-tile a warp
constexpr uint32_t kDenseTileBytes = kDenseTileRows * 64 * 2;
constexpr int kDenseMaxHeads = 16;                 // heads of a group: one m-tile of qm^T

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32_at(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

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

// Wait for the completion of the barrier's phase of the given parity; a
// wait that outlasts ~2^24 suspended tries (seconds) traps, so a broken
// pipeline fails the launch instead of hanging the card.
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

// One box of a 2-D map at (column x, row y) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                            int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// ---------------------------------------------------------------------------
// K4b: the head-masked dense product, its keys split over a cluster
// ---------------------------------------------------------------------------

// Key range [lo, hi) of cluster rank r of C over n CS-wide chunks: whole
// chunks, as evenly as they go, when C <= n; else each chunk cut into C / n
// equal parts (the launch requires C % n == 0 and parts of whole 64-key
// tiles). kernels/kbench.py's key_ranges is the same function.
__host__ __device__ inline void key_range(int r, int C, int n, int CS, int& lo, int& hi) {
  if (C <= n) {
    lo = r * n / C * CS;
    hi = (r + 1) * n / C * CS;
  } else {
    const int per = n * CS / C;
    lo = r * per;
    hi = lo + per;
  }
}

// Dynamic shared memory of a K4b block: G heads of Dh rows (rows = G * Dh),
// at most R keys and n_loc chunks a block, clusters of C blocks; 1024 bytes
// of slack align the ring for TMA's 128-byte swizzle. kernels/kbench.py's
// dense_smem mirrors it to choose the launch geometry.
struct DenseSmem {
  size_t ring, bars, p, pb, tmax, tsum, pm, fc, acc, l, qa, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline DenseSmem dense_smem(int rows, int G, int R, int n_loc, int C) {
  DenseSmem s;
  size_t o = 0;
  s.ring = o;  // the K/V tiles: kDenseStages x [128 rows][64 keys], swizzled
  o = align16(o + static_cast<size_t>(kDenseStages) * kDenseTileBytes);
  s.bars = o;  // full[kDenseStages], empty[kDenseStages]
  o = align16(o + 2 * kDenseStages * sizeof(uint64_t));
  s.p = o;     // f32 scores [G][R]
  o = align16(o + static_cast<size_t>(G) * R * 4);
  s.pb = o;    // bf16 p [G][R + 8]: padded rows, conflict-free B fragments
  o = align16(o + static_cast<size_t>(G) * (R + 8) * 2);
  s.tmax = o;  // per head and 64-key tile: max score, then its share of l
  o = align16(o + static_cast<size_t>(G) * (R / kT) * 4);
  s.tsum = o;
  o = align16(o + static_cast<size_t>(G) * (R / kT) * 4);
  s.pm = o;    // every block's prefix max per head and local chunk [C][G][n_loc]
  o = align16(o + static_cast<size_t>(C) * G * n_loc * 4);
  s.fc = o;    // exp(m_c - M)
  o = align16(o + static_cast<size_t>(G) * n_loc * 4);
  s.acc = o;   // every block's P.V of the rows this block writes [C][rows]
  o = align16(o + static_cast<size_t>(C) * rows * 4);
  s.l = o;     // every block's l per head [C][16]
  o = align16(o + static_cast<size_t>(C) * kDenseMaxHeads * 4);
  s.qa = o;    // the masked q's A fragment of each k-step of 16 rows, a lane's 16 B
  o = align16(o + static_cast<size_t>(rows / 16) * 32 * 16);
  s.total = o + 1024;
  return s;
}

// the barrier of a block's kThreads consumer threads (named barrier 1; the
// producer warp is not in it)
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// max into shared memory by integer atomics: non-negative floats order as
// ints, negative ones in reverse as unsigned (the cell starts at -inf)
__device__ __forceinline__ void atomic_max_f32(float* p, float x) {
  if (x >= 0.f) atomicMax(reinterpret_cast<int*>(p), __float_as_int(x));
  else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(x));
}

// K4b: a cluster of C blocks per (group of G heads, lane); grid (groups * C,
// B); 8 consumer warps and a producer warp a block, two blocks an SM where
// shared memory allows. Block rank r takes keys [lo, hi) of its lane
// (key_range) and only its heads' rows [h0 Dh, (h0 + G) Dh) of K and V,
// since every other row's product with the masked q is an exact 0: each K/V
// byte is read once (rows past a group's last 128-row tile are read and not
// used). The producer's one thread streams tiles of 128 rows by 64 keys by
// TMA into a kDenseStages-deep ring with a full and an empty mbarrier a
// stage: K by key tile, its row blocks innermost, then V by row block, its
// key tiles innermost. It runs ahead of the consumers, so V's first tiles
// load while the last K tiles are multiplied and while the cluster
// exchanges maxima.
//   scores [16 heads, keys] = qm^T K, qm^T[h][r] = q[r] where row r belongs
//     to head h, else 0 (its A fragments made once into shared memory):
//     warp w owns keys [8w, 8w + 8) of a key tile and sums them over its row
//     blocks, B fragments by ldmatrix.trans. Keys >= S score -inf. Each key
//     tile's max per head goes to shared memory by atomics as its scores are
//     stored.
//   exchange: per head, the prefix max over the block's chunks goes into
//     every block's shared memory; cluster.sync(); then a warp a (head, key
//     tile) takes m_c, the max over every block's keys in the tile's chunk c
//     and the chunks before it (the running max the TPU's walk reaches at
//     chunk c), and M, the last chunk's m_c, and makes p = exp(s - m_c) in
//     f32 into l (l = sum of p exp(m_c - M)) and rounded to bf16 for P.V. A
//     block wholly past S has -inf maxima of its own but a finite m_c: chunk
//     0 holds key 0 < S.
//   P.V: vp[rows, heads] = V p^T, n-tiles of 8 heads, warp w owning the
//     16-row m-tile w of each row block. After a chunk's last key tile the
//     head mask keeps vp[r][head(r)], times exp(m_c - M), in the row's sum:
//     the sequential walk's acc, up to f32 rounding.
//   combine: each block stores its acc of rows r, r + C, ... into block
//     r's shared memory and its l into every block's; cluster.sync(); rank r
//     adds them and writes acc / l.
// Blocks exchange by storing into each other's shared memory (distributed
// shared memory) before a cluster.sync() and read only their own after it:
// no block waits out a remote read, and none has to outlive another's
// reads. The producer warp joins both cluster.sync()s: the exchange's
// before the first tile whose stage only the V phase frees, the combine's
// at the end.
__global__ void __launch_bounds__(kDenseThreads, 2)
kb_attn_mma_dense(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const __nv_bfloat16* __restrict__ q,
                  float* __restrict__ out, int HD, int S_pad, int S, int H, int CS, int G, int R,
                  int n_loc) {
  extern __shared__ uint8_t dyn_raw[];
  uint8_t* dyn = dyn_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(dyn_raw)) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int dh = HD / H, b = blockIdx.y;
  const int h0 = static_cast<int>(blockIdx.x) / C * G, gh = min(G, H - h0), rows = gh * dh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int n_chunks = S_pad / CS, tpr = R / kT;  // tiles a head's row of p_s holds
  int k_lo, k_hi;
  key_range(rank, C, n_chunks, CS, k_lo, k_hi);
  const int n_t = (k_hi - k_lo) / kT, c_first = k_lo / CS;
  const int n_lc = (k_hi - 1) / CS - c_first + 1;
  const int n_rb = (rows + kDenseTileRows - 1) / kDenseTileRows, n_kv = n_t * n_rb;
  const int dsteps = dh / 16;  // k-steps of 16 rows a head

  const DenseSmem lay = dense_smem(G * dh, G, R, n_loc, C);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dyn + lay.ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + lay.bars);
  uint64_t* empty = full + kDenseStages;
  float* p_s = reinterpret_cast<float*>(dyn + lay.p);
  __nv_bfloat16* pb_s = reinterpret_cast<__nv_bfloat16*>(dyn + lay.pb);
  float* tmax_s = reinterpret_cast<float*>(dyn + lay.tmax);
  float* tsum_s = reinterpret_cast<float*>(dyn + lay.tsum);
  float* pm_s = reinterpret_cast<float*>(dyn + lay.pm);
  float* fc_s = reinterpret_cast<float*>(dyn + lay.fc);
  float* acc_s = reinterpret_cast<float*>(dyn + lay.acc);
  float* l_s = reinterpret_cast<float*>(dyn + lay.l);
  uint4* qa_s = reinterpret_cast<uint4*>(dyn + lay.qa);
  const int row0 = b * HD + h0 * dh;  // the group's first row of the [B * HD, S_pad] maps

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < kDenseStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDenseWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < G * tpr; i += kDenseThreads) tmax_s[i] = -INFINITY;
  __syncthreads();

  if (warp == kDenseWarps) {
    // --- producer: tile u is K (key tile u / n_rb, row block u % n_rb) for
    // u < n_kv, else V (row block w / n_t, key tile w % n_t), w = u - n_kv ---
    const int join = n_kv + kDenseStages;  // its stage is freed after the exchange
    for (int u = 0; u < 2 * n_kv; ++u) {
      if (u == join) cluster.sync();  // the exchange's
      if (lane == 0) {
        const bool is_k = u < n_kv;
        const int w = is_k ? u : u - n_kv;
        const int kt = is_k ? w / n_rb : w % n_t, rb = is_k ? w % n_rb : w / n_t;
        const int s = u % kDenseStages;
        if (u >= kDenseStages) mbar_wait(&empty[s], ((u / kDenseStages) - 1) & 1);
        mbar_expect_tx(&full[s], kDenseTileBytes);
        tma_load_2d(ring + s * (kDenseTileBytes / 2), is_k ? &k_map : &v_map, &full[s],
                    k_lo + kt * kT, row0 + rb * kDenseTileRows);
      }
      __syncwarp();
    }
    if (2 * n_kv <= join) cluster.sync();  // the exchange's
    cluster.sync();                         // the combine's
    return;
  }

  // the masked q's A fragments: k-step j's 16 rows are head j / dsteps's, so
  // row g of A (head g) carries q there, as does row g + 8 (head g + 8)
  for (int i = tid; i < rows / 16 * 32; i += kDenseConsumers) {
    const int j = i >> 5, gi = (i & 31) >> 2, ti = i & 3, hj = j / dsteps;
    const __nv_bfloat16* qj = q + (long long)row0 + 16 * j + 2 * ti;
    const uint32_t q0 = *reinterpret_cast<const uint32_t*>(qj);
    const uint32_t q8 = *reinterpret_cast<const uint32_t*>(qj + 8);
    qa_s[i] = make_uint4(hj == gi ? q0 : 0u, hj == gi + 8 ? q0 : 0u, hj == gi ? q8 : 0u,
                         hj == gi + 8 ? q8 : 0u);
  }
  consumers_sync<kDenseConsumers>();  // (the producer is already loading)
  const int n_nt = (gh + 7) / 8;  // n-tiles of 8 heads in P.V
  // Per-thread byte offsets into a [128][64] tile in the 128-byte swizzle
  // (chunk c of row r at c ^ (r % 8)): the ldmatrix rows of chunk `warp`,
  // and row 16 warp + g of the P.V A fragments, whose chunk c sits at c ^ g.
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t ldsm_off = (mi * 8 + rr) * 128 + ((warp ^ rr) << 4);
  const uint32_t ldsm2_off = ((mi & 1) * 8 + rr) * 128 + ((warp ^ rr) << 4);
  const uint32_t va_off = (16 * warp + g) * 128 + tig * 4;

  // --- K: key tile kt, its row blocks rb innermost; warp w sums keys
  // [8w, 8w + 8) of the key tile over every row ---
  float s2[2][4];  // two accumulators: even and odd k-steps
  for (int u = 0, kt = 0, rb = 0; u < n_kv; ++u) {
    const int s = u % kDenseStages;
    mbar_wait(&full[s], (u / kDenseStages) & 1);
    const uint32_t tile = ring_u32 + s * kDenseTileBytes;
    const int r0 = rb * kDenseTileRows, tr = min(kDenseTileRows, rows - r0);
    if (rb == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s2[0][e] = s2[1][e] = 0.f;
    }
    const uint4* qa = qa_s + (r0 / 16) * 32 + lane;  // k-step j's fragment at qa[32 j]
    if (tr == kDenseTileRows) {
#pragma unroll
      for (int j2 = 0; j2 < kDenseTileRows / 32; ++j2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, tile + ldsm_off + j2 * 32 * 128);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 f = qa[32 * (2 * j2 + half)];
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
          mma_bf16_16816(s2[half], a, bf[2 * half], bf[2 * half + 1]);
        }
      }
    } else {  // a last, partial row block: k-steps of 16 rows up to tr
      for (int r = 0; r < tr; r += 16) {
        uint32_t bf[2];
        ldsm_x2_trans(bf, tile + ldsm2_off + r * 128);
        const uint4 f = qa[2 * r];
        const uint32_t a[4] = {f.x, f.y, f.z, f.w};
        mma_bf16_16816(s2[(r >> 4) & 1], a, bf[0], bf[1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (rb == n_rb - 1) {  // the key tile's scores are whole: store, and its max per head
      const int j = kt * kT + 8 * warp + 2 * tig;  // local key of s[0] and s[2]
      const bool in0 = k_lo + j < S, in1 = k_lo + j + 1 < S;
      const float v0 = in0 ? s2[0][0] + s2[1][0] : -INFINITY, v1 = in1 ? s2[0][1] + s2[1][1] : -INFINITY;
      const float v2 = in0 ? s2[0][2] + s2[1][2] : -INFINITY, v3 = in1 ? s2[0][3] + s2[1][3] : -INFINITY;
      float m_lo = fmaxf(v0, v1), m_hi = fmaxf(v2, v3);  // rows g and g + 8, over the quad
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 1));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 1));
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, 2));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, 2));
      if (g < gh) {
        p_s[g * R + j] = v0;
        p_s[g * R + j + 1] = v1;
        if (tig == 0) atomic_max_f32(&tmax_s[g * tpr + kt], m_lo);
      }
      if (g + 8 < gh) {
        p_s[(g + 8) * R + j] = v2;
        p_s[(g + 8) * R + j + 1] = v3;
        if (tig == 0) atomic_max_f32(&tmax_s[(g + 8) * tpr + kt], m_hi);
      }
    }
    if (++rb == n_rb) rb = 0, ++kt;
  }

  // --- the exchange: every score and tile max of the range is in ---
  consumers_sync<kDenseConsumers>();
  for (int h = tid; h < gh; h += kDenseConsumers) {  // into every block's pm_s[rank]
    float run = -INFINITY;
    for (int t = 0; t < n_t; ++t) {
      run = fmaxf(run, tmax_s[h * tpr + t]);
      float* dst = pm_s + (rank * G + h) * n_loc + (k_lo + t * kT) / CS - c_first;
      for (int rk = 0; rk < C; ++rk) *cluster.map_shared_rank(dst, rk) = run;
    }
  }
  cluster.sync();  // every block's prefix maxima are in every block
  // A warp a (head, key tile): m_c of the tile's chunk and M (the last
  // chunk's m_c) from every block's prefix maxima, a lane each; then
  // p = exp(s - m_c), f32 into the tile's share of l (its sum times
  // exp(m_c - M)), bf16 into P.V's B. Warps on tiles of one chunk write
  // the same exp(m_c - M).
  for (int i = warp; i < gh * n_t; i += kDenseWarps) {
    const int h = i / n_t, t = i - h * n_t, cg_ = (k_lo + t * kT) / CS;
    // lane rk < 8 reads block rk's term of m_c, lane 8 + rk its term of M
    const int rk = lane & 7, cc = lane < 8 ? cg_ : n_chunks - 1;
    int lo, hi;
    key_range(rk, C, n_chunks, CS, lo, hi);
    float m = rk < C && lo / CS <= cc && lane < 16
                  ? pm_s[(rk * G + h) * n_loc + min(cc, (hi - 1) / CS) - lo / CS]
                  : -INFINITY;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float mM = __shfl_sync(0xffffffffu, m, 8);  // M
    m = __shfl_sync(0xffffffffu, m, 0);               // m_c
    const float f = expf(m - mM);
    const float* row = p_s + h * R + t * kT;
    __nv_bfloat16* pr = pb_s + h * (R + 8) + t * kT;
    const float p0 = expf(row[lane] - m), p1 = expf(row[lane + 32] - m);
    pr[lane] = __float2bfloat16_rn(p0);
    pr[lane + 32] = __float2bfloat16_rn(p1);
    const float sum = warp_sum(p0 + p1);
    if (lane == 0) {
      tsum_s[h * tpr + t] = sum * f;
      fc_s[h * n_loc + cg_ - c_first] = f;
    }
  }
  consumers_sync<kDenseConsumers>();  // pb_s, fc_s and l's shares are whole for every warp
  for (int h = tid; h < gh; h += kDenseConsumers) {  // l = sum of the f32 p exp(m_c - M)
    float l = 0.f;
    for (int t = 0; t < n_t; ++t) l += tsum_s[h * tpr + t];
    for (int rk = 0; rk < C; ++rk) *cluster.map_shared_rank(l_s + rank * kDenseMaxHeads + h, rk) = l;
  }

  // --- V: row block rb, its key tiles kt innermost; warp w owns the m-tile
  // of rows 16w + [0, 16) of the row block ---
  float ua[2][2][4] = {};  // the chunk's vp fragments: k-step parity, n-tile
  float acc2[2] = {0.f, 0.f};  // vp[r][head(r)] of rows m0 + g, m0 + g + 8
  for (int u = n_kv, kt = 0, rb = 0; u < 2 * n_kv; ++u) {
    const int s = u % kDenseStages;
    mbar_wait(&full[s], (u / kDenseStages) & 1);
    const int m0 = rb * kDenseTileRows + 16 * warp;
    const int c = (k_lo + kt * kT) / CS - c_first;  // the key tile's chunk
    if (m0 < rows) {
      // every fragment of the tile's 4 k-steps first, then the products
      const uint32_t ta = ring_u32 + s * kDenseTileBytes + va_off;
      const __nv_bfloat16* pr = pb_s + g * (R + 8) + kt * kT + 2 * tig;  // n-tile 0's B
      uint32_t a[4][4], bp[4][2][2];
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        const uint32_t c0 = ((2 * ks) ^ g) << 4, c1 = ((2 * ks + 1) ^ g) << 4;
        a[ks][0] = lds32_at(ta + c0);
        a[ks][1] = lds32_at(ta + 8 * 128 + c0);
        a[ks][2] = lds32_at(ta + c1);
        a[ks][3] = lds32_at(ta + 8 * 128 + c1);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bool on = nt < n_nt && nt * 8 + g < gh;
          bp[ks][nt][0] = on ? lds32(pr + nt * 8 * (R + 8) + ks * 16) : 0u;
          bp[ks][nt][1] = on ? lds32(pr + nt * 8 * (R + 8) + ks * 16 + 8) : 0u;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          if (nt < n_nt) mma_bf16_16816(ua[ks & 1][nt], a[ks], bp[ks][nt][0], bp[ks][nt][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (m0 < rows) {
      if (kt == n_t - 1 || (k_lo + (kt + 1) * kT) % CS == 0) {  // the chunk's last key tile
        const int hr = m0 / dh;  // the head of the m-tile's 16 rows
        const float f = fc_s[hr * n_loc + c];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = hr - nt * 8 - 2 * tig;  // 0 or 1 on the lane holding vp[r][hr]
          if (col == 0 || col == 1) {
            acc2[0] += (col == 0 ? ua[0][nt][0] + ua[1][nt][0] : ua[0][nt][1] + ua[1][nt][1]) * f;
            acc2[1] += (col == 0 ? ua[0][nt][2] + ua[1][nt][2] : ua[0][nt][3] + ua[1][nt][3]) * f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) ua[0][nt][e] = ua[1][nt][e] = 0.f;
        }
      }
      if (kt == n_t - 1) {  // the row block's last key tile: the rows' sums to their writers
        if ((m0 / dh) % 8 / 2 == tig) {
          const int ra = m0 + g, rb8 = m0 + g + 8, stride = G * dh;
          *cluster.map_shared_rank(acc_s + rank * stride + ra, ra % C) = acc2[0];
          *cluster.map_shared_rank(acc_s + rank * stride + rb8, rb8 % C) = acc2[1];
        }
        acc2[0] = acc2[1] = 0.f;
      }
    }
    if (++kt == n_t) kt = 0, ++rb;
  }
  // --- combine over the cluster: rows rank, rank + C, ... ---
  cluster.sync();  // every block's acc and l are in
  for (int i = rank + C * tid; i < rows; i += C * kDenseConsumers) {
    float sa = 0.f, sl = 0.f;
    for (int rk = 0; rk < C; ++rk) {
      sa += acc_s[rk * G * dh + i];
      sl += l_s[rk * kDenseMaxHeads + i / dh];
    }
    out[(long long)row0 + i] = sa / sl;
  }
}

// ---------------------------------------------------------------------------
// K7: per-head tensor-core attention, its keys split over a cluster
// ---------------------------------------------------------------------------

// Dynamic shared memory of a K7 block: at most R keys and n_loc chunks a
// block, clusters of C blocks, a ring of `stages` tiles; 1024 bytes of slack
// align the ring for TMA's 128-byte swizzle. kernels/kbench.py's mxub_smem
// mirrors it to choose the launch geometry.
struct HeadSmem {
  size_t ring, bars, s, pb, tw, pm, mc, fc, acc, l, red, total;
};

__host__ __device__ inline HeadSmem head_smem(int R, int n_loc, int C, int stages) {
  HeadSmem m;
  size_t o = 0;
  m.ring = o;  // the K/V tiles: stages x [64 rows][64 keys], swizzled
  o = align16(o + static_cast<size_t>(stages) * kHeadTileBytes);
  m.bars = o;  // full[stages], empty[stages]
  o = align16(o + 2 * static_cast<size_t>(stages) * sizeof(uint64_t));
  m.s = o;     // f32 scores [R]
  o = align16(o + static_cast<size_t>(R) * 4);
  m.pb = o;    // bf16 p [R]
  o = align16(o + static_cast<size_t>(R) * 2);
  m.tw = o;    // each consumer warp's max of each key tile [R / 64][4]
  o = align16(o + static_cast<size_t>(R / kT) * kHeadWarps * 4);
  m.pm = o;    // every block's prefix max per local chunk [C][n_loc]
  o = align16(o + static_cast<size_t>(C) * n_loc * 4);
  m.mc = o;    // m_c of the local chunks
  o = align16(o + static_cast<size_t>(n_loc) * 4);
  m.fc = o;    // exp(m_c - M)
  o = align16(o + static_cast<size_t>(n_loc) * 4);
  m.acc = o;   // every block's P.V of the features this block writes [C][64]
  o = align16(o + static_cast<size_t>(C) * kMmaDh * 4);
  m.l = o;     // every block's l [C]
  o = align16(o + static_cast<size_t>(C) * 4);
  m.red = o;   // the consumer warps' shares of l
  o = align16(o + kHeadWarps * 4);
  m.total = o + 1024;
  return m;
}

// K7: a cluster of C blocks per (head, lane); grid (H * C, B); 4 consumer
// warps and a producer warp a block. Block rank r takes keys [lo, hi) of its
// lane (key_range, as K4b) and reads only its head's 64 rows of K and V, in
// tiles of 64 rows by 64 keys (8 KB); tiles that hold no key < S are not
// read, since their p is exactly 0. The producer's one thread streams the
// range's K tiles, then its V tiles, by TMA into a ring of `stages` stages
// with a full and an empty mbarrier a stage, so that V's first tiles load
// while the cluster exchanges maxima.
//   scores: the K tile as A (keys by features, ldmatrix.trans of the
//     [features, keys] tile) against q in column 0 of B: warp w owns keys
//     [16w, 16w + 16) of each tile. Keys >= S score -inf; each warp's max
//     of each tile goes to shared memory.
//   exchange: the block's prefix max over its local chunks goes into every
//     block's shared memory; cluster.sync(); then m_c of each local chunk c
//     (the max over every block's keys in chunks 0..c: the running max the
//     TPU's walk reaches at chunk c) and M (the last chunk's m_c). p = exp(s
//     - m_c) goes to l as f32 times exp(m_c - M), and to P.V rounded to
//     bf16. A block wholly past S has -inf maxima of its own but a finite
//     m_c: chunk 0 holds key 0 < S.
//   P.V: the V tile as A (features by keys, ldmatrix) against p in column 0
//     of B: warp w owns features [16w, 16w + 16). At a chunk's last tile the
//     chunk's sum, times exp(m_c - M), joins acc: the sequential walk's acc,
//     up to f32 rounding.
//   combine: each block stores its acc of feature d into block d % C's
//     shared memory and its l into every block's; cluster.sync(); rank r
//     writes the features d = r (mod C) as acc / l.
// Blocks exchange by storing into each other's shared memory before a
// cluster.sync() and read only their own after it. The producer joins both
// cluster.sync()s: the exchange's before the first tile whose stage only
// the V phase frees, the combine's at the end.
__global__ void __launch_bounds__(kHeadThreads, 7)
kb_attn_mma_head(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __nv_bfloat16* __restrict__ q,
                 float* __restrict__ out, int HD, int S_pad, int S, int CS, int R, int n_loc,
                 int stages) {
  extern __shared__ uint8_t dyn_raw[];
  uint8_t* dyn = dyn_raw + ((1024 - (smem_u32(dyn_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  // a block stores into its peers' shared memory only once all are running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = static_cast<int>(blockIdx.x) / C, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int n_chunks = S_pad / CS;
  int k_lo, k_hi;
  key_range(rank, C, n_chunks, CS, k_lo, k_hi);
  const int c_first = k_lo / CS, n_lc = (k_hi - 1) / CS - c_first + 1;
  const int n_t = min((k_hi - k_lo) / kT, max(0, S - k_lo + kT - 1) / kT);  // tiles read
  const int row0 = b * HD + h * kMmaDh;  // the head's first row of the [B * HD, S_pad] maps

  const HeadSmem lay = head_smem(R, n_loc, C, stages);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dyn + lay.ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(dyn + lay.bars);
  uint64_t* empty = full + stages;
  float* s_s = reinterpret_cast<float*>(dyn + lay.s);
  __nv_bfloat16* pb_s = reinterpret_cast<__nv_bfloat16*>(dyn + lay.pb);
  float* tw_s = reinterpret_cast<float*>(dyn + lay.tw);
  float* pm_s = reinterpret_cast<float*>(dyn + lay.pm);
  float* mc_s = reinterpret_cast<float*>(dyn + lay.mc);
  float* fc_s = reinterpret_cast<float*>(dyn + lay.fc);
  float* acc_x = reinterpret_cast<float*>(dyn + lay.acc);
  float* l_x = reinterpret_cast<float*>(dyn + lay.l);
  float* red_s = reinterpret_cast<float*>(dyn + lay.red);

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHeadWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kHeadWarps) {
    // --- producer: tile u is K's tile u for u < n_t, else V's tile u - n_t ---
    const int join = n_t + stages;  // its stage is freed after the exchange
    for (int u = 0; u < 2 * n_t; ++u) {
      if (u == join) {  // the exchange's
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
        cluster.sync();
      }
      if (lane == 0) {
        const int s = u % stages;
        if (u >= stages) mbar_wait(&empty[s], ((u / stages) - 1) & 1);
        mbar_expect_tx(&full[s], kHeadTileBytes);
        tma_load_2d(ring + s * (kHeadTileBytes / 2), u < n_t ? &k_map : &v_map, &full[s],
                    k_lo + (u < n_t ? u : u - n_t) * kT, row0);
      }
      __syncwarp();
    }
    if (2 * n_t <= join) {  // the exchange's
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      cluster.sync();
    }
    cluster.sync();  // the combine's
    return;
  }

  // q in column 0 of B (lanes g == 0): k-step kk's features 16 kk + [0, 16)
  uint32_t qb[4][2];
  const __nv_bfloat16* qh = q + row0;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qb[kk][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 2 * tig) : 0u;
    qb[kk][1] = g == 0 ? *reinterpret_cast<const uint32_t*>(qh + 16 * kk + 8 + 2 * tig) : 0u;
  }
  // Per-thread byte offsets of ldmatrix rows in a [64][64] tile in the
  // 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)). K, as A by
  // ldmatrix.trans: matrix mi holds features 8 (mi >> 1) + [0, 8) of keys
  // 16 warp + 8 (mi & 1) + [0, 8); k-step kk adds 16 rows. V, as A by
  // ldmatrix: matrix mi holds keys 8 (mi >> 1) + [0, 8) of features
  // 16 warp + 8 (mi & 1) + [0, 8); k-step ks adds 2 chunks.
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t k_off = ((mi >> 1) * 8 + rr) * 128 + (((2 * warp + (mi & 1)) ^ rr) << 4);
  const uint32_t v_row = (16 * warp + (mi & 1) * 8 + rr) * 128;

  // --- K: warp w scores keys [16w, 16w + 16) of each tile ---
  for (int u = 0; u < n_t; ++u) {
    const int s = u % stages;
    mbar_wait(&full[s], (u / stages) & 1);
    const uint32_t tile = ring_u32 + s * kHeadTileBytes + k_off;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4_trans(a, tile + kk * 16 * 128);
      mma_bf16_16816(d, a, qb[kk][0], qb[kk][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    // column 0 of D, on the lanes tig == 0: keys 16 warp + g and + g + 8
    const int j = u * kT + 16 * warp + g;
    const float v0 = k_lo + j < S ? d[0] : -INFINITY, v1 = k_lo + j + 8 < S ? d[2] : -INFINITY;
    if (tig == 0) {
      s_s[j] = v0;
      s_s[j + 8] = v1;
    }
    const float mx = warp_max(tig == 0 ? fmaxf(v0, v1) : -INFINITY);
    if (lane == 0) tw_s[u * kHeadWarps + warp] = mx;
  }

  // --- the exchange: every score and tile max of the range is in ---
  consumers_sync<kHeadConsumers>();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every peer is running
  for (int lc = tid; lc < n_lc; lc += kHeadConsumers) {  // into every block's pm_s[rank]
    float run = -INFINITY;
    for (int t = 0; t < n_t && (k_lo + t * kT) / CS - c_first <= lc; ++t)
#pragma unroll
      for (int w = 0; w < kHeadWarps; ++w) run = fmaxf(run, tw_s[t * kHeadWarps + w]);
    for (int rk = 0; rk < C; ++rk) *cluster.map_shared_rank(pm_s + rank * n_loc + lc, rk) = run;
  }
  cluster.sync();  // every block's prefix maxima are in every block
  for (int lc = tid; lc < n_lc; lc += kHeadConsumers) {  // m_c and exp(m_c - M)
    const int c = c_first + lc;
    float m = -INFINITY, mM = -INFINITY;
    for (int rk = 0; rk < C; ++rk) {
      int lo, hi;
      key_range(rk, C, n_chunks, CS, lo, hi);
      const int first = lo / CS, last = (hi - 1) / CS;
      if (first <= c) m = fmaxf(m, pm_s[rk * n_loc + min(c, last) - first]);
      mM = fmaxf(mM, pm_s[rk * n_loc + last - first]);
    }
    mc_s[lc] = m;
    fc_s[lc] = expf(m - mM);
  }
  consumers_sync<kHeadConsumers>();
  float lsum = 0.f;  // l = sum of the f32 p exp(m_c - M)
  for (int j = tid; j < n_t * kT; j += kHeadConsumers) {
    const int lc = (k_lo + j) / CS - c_first;
    const float p = expf(s_s[j] - mc_s[lc]);  // 0 for a key >= S
    pb_s[j] = __float2bfloat16_rn(p);
    lsum += p * fc_s[lc];
  }
  lsum = warp_sum(lsum);
  if (lane == 0) red_s[warp] = lsum;
  consumers_sync<kHeadConsumers>();  // p and the warps' shares of l are whole
  if (tid < C) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kHeadWarps; ++w) l += red_s[w];
    *cluster.map_shared_rank(l_x + rank, tid) = l;
  }

  // --- V: warp w sums features [16w, 16w + 16) over each tile ---
  float acc[2] = {0.f, 0.f};  // features 16 warp + g and + g + 8, on the lanes tig == 0
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < n_t; ++t) {
    const int u = n_t + t, s = u % stages;
    mbar_wait(&full[s], (u / stages) & 1);
    const uint32_t tile = ring_u32 + s * kHeadTileBytes + v_row;
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(pb_s + t * kT + 2 * tig);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, tile + (((2 * ks + (mi >> 1)) ^ rr) << 4));
      mma_bf16_16816(d, a, g == 0 ? pw[8 * ks] : 0u, g == 0 ? pw[8 * ks + 4] : 0u);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (t == n_t - 1 || (k_lo + (t + 1) * kT) % CS == 0) {  // the chunk's last tile
      const float f = fc_s[(k_lo + t * kT) / CS - c_first];
      acc[0] += d[0] * f;
      acc[1] += d[2] * f;
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = 0.f;
    }
  }

  // --- combine over the cluster: features rank, rank + C, ... ---
  if (tig == 0) {
    const int d0 = 16 * warp + g, d1 = d0 + 8;
    *cluster.map_shared_rank(acc_x + rank * kMmaDh + d0, d0 % C) = acc[0];
    *cluster.map_shared_rank(acc_x + rank * kMmaDh + d1, d1 % C) = acc[1];
  }
  cluster.sync();  // every block's acc and l are in
  for (int dd = rank + C * tid; dd < kMmaDh; dd += C * kHeadConsumers) {
    float sa = 0.f, sl = 0.f;
    for (int rk = 0; rk < C; ++rk) {
      sa += acc_x[rk * kMmaDh + dd];
      sl += l_x[rk];
    }
    out[(long long)row0 + dd] = sa / sl;
  }
}

// ---------------------------------------------------------------------------
// K4a: f32 attention on the CUDA cores, its keys split over a cluster
// ---------------------------------------------------------------------------

constexpr int kF32Consumers = 128;                 // 4 consumer warps
constexpr int kF32Warps = kF32Consumers / 32;
constexpr int kF32Threads = kF32Consumers + 32;    // and one producer warp
constexpr int kF32RingBytes = 32768;               // 4 tiles at Dh = 64, 2 at Dh = 128
constexpr int kF32MaxStages = 8;
constexpr int kF32PassTiles = 8;                   // key tiles of a pass
constexpr int kF32Pass = kF32PassTiles * kT;       // keys of a pass: 512
constexpr int kF32MaxCluster = 8;

// K4a: a cluster of C blocks per (head, lane); grid (H * C, B); 4 consumer
// warps and a producer warp a block. Block rank r takes keys [lo, hi): the
// ceil(S / 64) tiles of 64 keys split as evenly as they go
// (kernels/kbench.py's vpu_ranges), the last range ending at S, so no tile
// at or past S is read and no range is empty when C <= ceil(S / 64). A tile
// is the head's Dh rows by 64 keys, unswizzled: row d's 128 bytes at d * 128,
// so a warp reading one row touches each bank once. The block walks its
// range in passes of up to 512 keys; for each pass the producer streams its
// K tiles, then its V tiles, into a ring of 32 KB (2 to 8 stages by Dh) with
// a full and an empty mbarrier a stage: by TMA (kTma: S_pad % 8 == 0, so the
// row stride is a multiple of 16 bytes), else by 4-byte cp.async of its lanes.
// Warp w owns the rows w, w + 4, ... (kRows of them) of every tile, lane j
// keys 2j and 2j + 1, so every warp consumes every stage in order.
//   scores: each warp's partial f32 dots of its rows, by key, into part_s;
//     after a barrier a thread a key sums the 4 partials, keys >= hi at -inf.
//   softmax: the pass's max over the block (a second barrier), m and alpha
//     as the online softmax; each thread's p = exp(s - m) of its keys into
//     p_s and into its share of l (a third barrier: p_s is whole).
//   P.V: lane j multiplies the p of its two keys into each of its warp's V
//     rows and keeps a partial acc of those rows over every tile and pass;
//     the sums over the lanes are taken once, at the end (warp_sum_many).
//   combine, as K8's: each block stores its acc of row d into block d % C's
//     shared memory and its (m, l) into every block's; cluster.sync(); block
//     r writes rows d = r (mod C): sum_j e^(m_j - M) acc_j / sum_j e^(m_j -
//     M) l_j. Each m_j is finite (every range holds a key < S). The producer
//     joins the cluster.sync().
// What bounds it is bytes: each K/V byte of the keys < S (up to the end of
// the last tile) is read once, and the ring keeps up to 32 KB a block in
// flight.
template <int kRows, bool kTma>
__global__ void __launch_bounds__(kF32Threads, kRows == 16 ? 5 : 4)
kb_attn_f32_split(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                  float* __restrict__ out, int HD, int S_pad, int S, int H) {
  __shared__ __align__(128) uint8_t ring[kF32RingBytes];
  __shared__ __align__(8) uint64_t full[kF32MaxStages], empty[kF32MaxStages];
  __shared__ __align__(16) float part_s[kF32Warps][kF32Pass];  // each warp's partial dots
  __shared__ __align__(16) float p_s[kF32Pass];                 // the pass's p
  __shared__ float q_s[kMaxDh];
  __shared__ float red_s[kF32Warps];
  // every block's acc of this block's rows: block j's of row d at
  // [j * n_own + d / C], n_own = ceil(Dh / C), so C * n_own <= Dh + C - 1
  __shared__ float acc_x[kMaxDh + kF32MaxCluster];
  __shared__ float2 ml_x[kF32MaxCluster];  // every block's (m, l)
  cg::cluster_group cluster = cg::this_cluster();
  // a block stores into its peers' shared memory only once all are running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = static_cast<int>(blockIdx.x) / C, b = blockIdx.y, dh = HD / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (S + kT - 1) / kT;
  const int lo = kT * (rank * tiles / C);
  const int hi = min(S, kT * ((rank + 1) * tiles / C));
  const int row0 = b * HD + h * dh;  // the head's first row of [B * HD, S_pad]
  const int tile_bytes = dh * kT * 2;
  const int stages = min(kF32MaxStages, kF32RingBytes / tile_bytes);

  if (tid == 0) {
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);  // TMA's transaction, or each producer lane
      mbar_init(&empty[s], kF32Warps);     // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kF32Warps) {
    // --- producer: per pass, its K tiles, then its V tiles ---
    int u = 0;
    for (int p0 = lo; p0 < hi; p0 += kF32Pass) {
      const int n_t = min(kF32PassTiles, (hi - p0 + kT - 1) / kT);
      for (int i = 0; i < 2 * n_t; ++i, ++u) {
        const bool is_k = i < n_t;
        const int x = p0 + (is_k ? i : i - n_t) * kT, s = u % stages;
        uint8_t* dst = ring + s * tile_bytes;
        if constexpr (kTma) {
          if (lane == 0) {
            if (u >= stages) mbar_wait(&empty[s], ((u / stages) - 1) & 1);
            mbar_expect_tx(&full[s], tile_bytes);
            tma_load_2d(dst, is_k ? &k_map : &v_map, &full[s], x, row0);
          }
          __syncwarp();
        } else {
          // lane j copies keys x + 2j and x + 2j + 1 of every row (S_pad is
          // even, so the pair lies wholly inside or wholly past the row) by
          // 4-byte cp.async, zeros past S_pad as TMA would; the stage's full
          // barrier counts each lane's arrival once its copies have landed
          if (u >= stages) mbar_wait(&empty[s], ((u / stages) - 1) & 1);
          const bool in = x + 2 * lane < S_pad;
          const __nv_bfloat16* src = (is_k ? k : v) + (long long)row0 * S_pad + (in ? x + 2 * lane : 0);
          const uint32_t dst0 = smem_u32(dst) + 4 * lane;
          for (int d = 0; d < dh; ++d)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst0 + d * 128),
                         "l"(src + (long long)d * S_pad), "r"(in ? 4 : 0)
                         : "memory");
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(&full[s]))
                       : "memory");
        }
      }
    }
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    cluster.sync();  // the combine's
    return;
  }

  // q, while the producer's first tiles load
  for (int d = tid; d < dh; d += kF32Consumers) q_s[d] = __bfloat162float(q[row0 + d]);
  consumers_sync<kF32Consumers>();
  float qv[kRows];  // q of this warp's rows w, w + 4, ...
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int d = warp + kF32Warps * i;
    qv[i] = d < dh ? q_s[d] : 0.f;
  }
  float m = -INFINITY, l = 0.f;  // l: this thread's share
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  int u = 0;
  for (int p0 = lo; p0 < hi; p0 += kF32Pass) {
    const int n_t = min(kF32PassTiles, (hi - p0 + kT - 1) / kT);
    // --- scores: each warp's partial dots over its rows of every K tile ---
    for (int t = 0; t < n_t; ++t) {
      const int ut = u + t, s = ut % stages;
      mbar_wait(&full[s], (ut / stages) & 1);
      const uint32_t* tile = reinterpret_cast<const uint32_t*>(ring + s * tile_bytes) + lane;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int d = warp + kF32Warps * i;
        if (d < dh) {
          const uint32_t w = tile[d * 32];
          a0 = fmaf(qv[i], bf16_lo(w), a0);
          a1 = fmaf(qv[i], bf16_hi(w), a1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
      *reinterpret_cast<float2*>(&part_s[warp][t * kT + 2 * lane]) = make_float2(a0, a1);
    }
    consumers_sync<kF32Consumers>();  // every warp's partial dots are in
    // --- softmax: a thread the keys tid, tid + 128, ... of the pass ---
    constexpr int kKeys = kF32Pass / kF32Consumers;
    float sc[kKeys], t_max = -INFINITY;
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      const int j = tid + kF32Consumers * e;
      float a = -INFINITY;
      if (j < n_t * kT && p0 + j < hi) {
        a = 0.f;
#pragma unroll
        for (int w = 0; w < kF32Warps; ++w) a += part_s[w][j];
      }
      sc[e] = a;
      t_max = fmaxf(t_max, a);
    }
    t_max = warp_max(t_max);
    if (lane == 0) red_s[warp] = t_max;
    consumers_sync<kF32Consumers>();  // the warps' maxima are in
    float m_pass = red_s[0];
#pragma unroll
    for (int w = 1; w < kF32Warps; ++w) m_pass = fmaxf(m_pass, red_s[w]);
    const float m_new = fmaxf(m, m_pass);  // finite: key p0 < hi
    const float alpha = expf(m - m_new);   // 0 on the first pass
    float t_sum = 0.f;
#pragma unroll
    for (int e = 0; e < kKeys; ++e) {
      const int j = tid + kF32Consumers * e;
      const float p = expf(sc[e] - m_new);  // 0 for a masked key
      t_sum += p;
      if (j < n_t * kT) p_s[j] = p;
    }
    l = l * alpha + t_sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] *= alpha;
    consumers_sync<kF32Consumers>();  // p_s is whole

    // --- P.V: every warp takes every V tile of the pass, for its own rows ---
    for (int t = 0; t < n_t; ++t) {
      const int ut = u + n_t + t, s = ut % stages;
      mbar_wait(&full[s], (ut / stages) & 1);
      const uint32_t* tile = reinterpret_cast<const uint32_t*>(ring + s * tile_bytes) + lane;
      const float2 p = *reinterpret_cast<const float2*>(p_s + t * kT + 2 * lane);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int d = warp + kF32Warps * i;
        if (d < dh) {
          const uint32_t w = tile[d * 32];
          acc[i] = fmaf(p.x, bf16_lo(w), acc[i]);
          acc[i] = fmaf(p.y, bf16_hi(w), acc[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }
    u += 2 * n_t;
    // the next pass writes part_s, red_s and p_s only after its first
    // barrier or later, which every warp reaches after reading them here
  }

  // --- combine over the cluster ---
  const float l_warp = warp_sum(l);
  if (lane == 0) red_s[warp] = l_warp;
  const float a = warp_sum_many<kRows>(acc);
  consumers_sync<kF32Consumers>();
  float l_blk = 0.f;
#pragma unroll
  for (int w = 0; w < kF32Warps; ++w) l_blk += red_s[w];
  constexpr int kCopies = 32 / kRows;                     // lanes that hold one row's sum
  const int d_own = warp + kF32Warps * (lane / kCopies);  // warp_sum_many's row of this lane
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  const int n_own = (dh + C - 1) / C;
  if (lane % kCopies == 0 && d_own < dh)
    *cluster.map_shared_rank(&acc_x[rank * n_own + d_own / C], d_own % C) = a;
  if (tid < C) *cluster.map_shared_rank(&ml_x[rank], tid) = make_float2(m, l_blk);
  cluster.sync();  // every block's acc and (m, l) are in
  for (int d = rank + C * tid; d < dh; d += C * kF32Consumers) {
    float M = -INFINITY;
    for (int j = 0; j < C; ++j) M = fmaxf(M, ml_x[j].x);
    float num = 0.f, den = 0.f;
    for (int j = 0; j < C; ++j) {
      const float f = expf(ml_x[j].x - M);
      num += f * acc_x[j * n_own + d / C];
      den += f * ml_x[j].y;
    }
    out[row0 + d] = num / den;
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. Every function launches on `stream`, allocates nothing and
// returns cudaGetLastError() after its launches (or the error of the
// attribute call that sized shared memory).
// ---------------------------------------------------------------------------

// k, v: contiguous bf16 [slabs, HD, S] (S % 8 == 0, 16-byte aligned);
// out: f32 [slabs, HD]. cols == S: 16 rows a block over whole rows, one
// launch. cols < S (S % cols == 0, cols % 8 == 0): split tiling, 16 rows by
// `cols` columns a block into part (f32 [slabs, S / cols, HD]), then the
// combine launch.
extern "C" int wtt_kb_rowsum(const void* k, const void* v, float* out, float* part, int slabs,
                             int HD, int S, int cols, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = S / cols;
  const dim3 grid((HD + kSplitRows - 1) / kSplitRows, n_parts, slabs);
  kv_rowsum_kernel<<<grid, kSumThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      n_parts == 1 ? out : part, HD, S, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const long long n = (long long)slabs * HD;
  kv_rowsum_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(part, out, HD,
                                                                            n_parts, n);
  return static_cast<int>(cudaGetLastError());
}

// K5: k, v contiguous bf16 [n_rows, S] (S % 8 == 0, 16-byte aligned); out f32
// [n_rows]: one warp a row, one launch.
extern "C" int wtt_kb_rowsum_rows(const void* k, const void* v, float* out, long long n_rows,
                                  int S, void* stream) {
  const long long blocks = (n_rows + kSumWarps - 1) / kSumWarps;
  if (n_rows < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kv_rowsum_rows<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const __nv_bfloat16*>(k),
                                                        static_cast<const __nv_bfloat16*>(v), out,
                                                        n_rows, S);
  return static_cast<int>(cudaGetLastError());
}

using Int8Kernel = void (*)(const __nv_bfloat16*, const int8_t*, const int8_t*, const float*,
                            const float*, float*, int, int, int, int);

// The launch of K8 for clusters of C blocks and vec-byte loads, into cfg
// (whose attrs point at attr) and fn: cudaErrorInvalidValue for a shape or
// geometry the kernel does not take (see wtt_kb_attn_int8_split).
static cudaError_t int8_config(int B, int HD, int S_pad, int S, int H, int C, int vec,
                               cudaStream_t st, cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& attr, Int8Kernel& fn) {
  if (B < 1 || H < 1 || HD % H || HD / H > kMaxDh || S < 1 || S > S_pad || S_pad % 2 ||
      C < 1 || C > kI8MaxCluster || C > (S + kI8Group - 1) / kI8Group ||
      (vec == 16 ? S_pad % 16 != 0 : vec != 2))
    return cudaErrorInvalidValue;
  if (HD / H <= 8 * kI8Warps)
    fn = vec == 16 ? kb_attn_int8_split<16, 8> : kb_attn_int8_split<2, 8>;
  else
    fn = vec == 16 ? kb_attn_int8_split<16, 16> : kb_attn_int8_split<2, 16>;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(H * C, B);
  cfg.blockDim = dim3(kI8Threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// K8, clusters of C blocks over the keys (kernels/kbench.py's vpu8_geometry
// chooses C). q: bf16 [B, HD]; k, v: contiguous int8 [B, HD, S_pad];
// k_scale, v_scale: f32 [B, S_pad]; out: f32 [B, HD]. Dh = HD / H <= 128,
// 1 <= S <= S_pad, S_pad even, 1 <= C <= min(8, ceil(S / 16)). vec = 16
// (S_pad % 16 == 0, k and v 16-byte aligned) or 2 (k and v 2-byte aligned).
extern "C" int wtt_kb_attn_int8_split(const void* q, const void* k, const void* v,
                                      const float* k_scale, const float* v_scale, float* out,
                                      int B, int HD, int S_pad, int S, int H, int C, int vec,
                                      void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Int8Kernel fn;
  cudaError_t err = int8_config(B, HD, S_pad, S, H, C, vec, static_cast<cudaStream_t>(stream),
                                cfg, attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), k_scale,
                           v_scale, out, HD, S_pad, S, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of K8's launch the card holds at once, into *n.
extern "C" int wtt_kb_attn_int8_clusters(int B, int HD, int S_pad, int S, int H, int C, int vec,
                                         int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Int8Kernel fn;
  const cudaError_t err = int8_config(B, HD, S_pad, S, H, C, vec, nullptr, cfg, attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, fn, &cfg));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over [rows, S_pad] bf16 (row stride S_pad), boxes of box_rows
// rows by 64 keys, in the 128-byte swizzle unless told otherwise; rows and
// keys past the end read as zeros.
static CUresult encode_kv_map(EncodeTiled enc, CUtensorMap* map, const void* base, long long rows,
                              int S_pad, int box_rows,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {(cuuint64_t)S_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)S_pad * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kT, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The keys R and chunks n_loc that a block of a cluster of C over n CS-wide
// chunks takes at most (key_range).
static void range_extent(int C, int n, int CS, int& R, int& n_loc) {
  R = n_loc = 0;
  for (int r = 0; r < C; ++r) {
    int lo, hi;
    key_range(r, C, n, CS, lo, hi);
    R = hi - lo > R ? hi - lo : R;
    n_loc = (hi - 1) / CS - lo / CS + 1 > n_loc ? (hi - 1) / CS - lo / CS + 1 : n_loc;
  }
}

// The launch of K4b for G heads a group and clusters of C blocks over the
// keys, into cfg (whose attrs point at attr): cudaErrorInvalidValue for a
// geometry the kernel does not take (see wtt_kb_attn_mma_dense).
static cudaError_t dense_config(int B, int HD, int S_pad, int H, int CS, int G, int C,
                                cudaStream_t st, cudaLaunchConfig_t& cfg,
                                cudaLaunchAttribute& attr, int& R, int& n_loc) {
  const int dh = HD / H, n = S_pad / CS;
  if (G < 1 || G > kDenseMaxHeads || dh % 16 || C < 1 || C > 8 ||
      (C > n && (C % n || (n * CS / C) % kT)))
    return cudaErrorInvalidValue;
  range_extent(C, n, CS, R, n_loc);
  const size_t smem = dense_smem(G * dh, G, R, n_loc, C).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kb_attn_mma_dense, smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((H + G - 1) / G * C, B);
  cfg.blockDim = dim3(kDenseThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// K4b, head-masked dense, G heads a group and clusters of C blocks over the
// keys (kernels/kbench.py's mxu_geometry chooses both). Operands as for K7;
// Dh % 16 == 0, G <= 16, C <= 8, and when C exceeds the S_pad / CS chunks it
// is a multiple of them that cuts each chunk into parts of whole 64-key
// tiles. cudaErrorInvalidValue for any other geometry or one whose shared
// memory exceeds a block's; 10000 + the CUresult when a tensor map cannot
// be encoded, and cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled.
extern "C" int wtt_kb_attn_mma_dense(const void* q, const void* k, const void* v, float* out,
                                     int B, int HD, int S_pad, int S, int H, int CS, int G, int C,
                                     void* stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int R, n_loc;
  cudaError_t err = dense_config(B, HD, S_pad, H, CS, G, C, static_cast<cudaStream_t>(stream),
                                 cfg, attr, R, n_loc);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[2];
  CUresult r = encode_kv_map(enc, &maps[0], k, (long long)B * HD, S_pad, kDenseTileRows);
  if (r == CUDA_SUCCESS) r = encode_kv_map(enc, &maps[1], v, (long long)B * HD, S_pad, kDenseTileRows);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  err = cudaLaunchKernelEx(&cfg, kb_attn_mma_dense, maps[0], maps[1],
                           static_cast<const __nv_bfloat16*>(q), out, HD, S_pad, S, H, CS, G, R,
                           n_loc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of K4b's launch for this geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int wtt_kb_attn_mma_dense_clusters(int B, int HD, int S_pad, int H, int CS, int G,
                                              int C, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int R, n_loc;
  cudaError_t err = dense_config(B, HD, S_pad, H, CS, G, C, nullptr, cfg, attr, R, n_loc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kb_attn_mma_dense, &cfg));
}

// The launch of K7 for clusters of C blocks over the keys and a ring of
// `stages` tiles, into cfg (whose attrs point at attr): cudaErrorInvalidValue
// for a shape or geometry the kernel does not take (see wtt_kb_attn_mma_head).
static cudaError_t head_config(int B, int HD, int S_pad, int S, int H, int CS, int C, int stages,
                               cudaStream_t st, cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& attr, int& R, int& n_loc) {
  if (B < 1 || H < 1 || HD != kMmaDh * H || CS < kT || CS % kT || S_pad % CS || S < 1 ||
      S > S_pad || C < 1 || C > 8 || stages < 2 || stages > kHeadMaxStages)
    return cudaErrorInvalidValue;
  const int n = S_pad / CS;
  if (C > n && (C % n || (n * CS / C) % kT)) return cudaErrorInvalidValue;
  range_extent(C, n, CS, R, n_loc);
  const size_t smem = head_smem(R, n_loc, C, stages).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kb_attn_mma_head, smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(H * C, B);
  cfg.blockDim = dim3(kHeadThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// K7, per head (Dh == 64), clusters of C blocks over the keys and a ring of
// `stages` tiles (kernels/kbench.py's mxub_geometry chooses both). q: bf16
// [B, HD]; k, v: contiguous bf16 [B, HD, S_pad], 16-byte aligned; out: f32
// [B, HD] (K7's [B, H, Dh] is the same memory). S_pad % CS == 0, CS % 64 ==
// 0, 1 <= S <= S_pad, C <= 8 and, when C exceeds the S_pad / CS chunks, a
// multiple of them that cuts each chunk into parts of whole 64-key tiles,
// 2 <= stages <= 4. cudaErrorInvalidValue for any other shape or geometry,
// or one whose shared memory exceeds a block's; 10000 + the CUresult when a
// tensor map cannot be encoded, and cudaErrorNotSupported when the driver
// has no cuTensorMapEncodeTiled.
extern "C" int wtt_kb_attn_mma_head(const void* q, const void* k, const void* v, float* out,
                                    int B, int HD, int S_pad, int S, int H, int CS, int C,
                                    int stages, void* stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int R, n_loc;
  cudaError_t err = head_config(B, HD, S_pad, S, H, CS, C, stages,
                                static_cast<cudaStream_t>(stream), cfg, attr, R, n_loc);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[2];
  CUresult r = encode_kv_map(enc, &maps[0], k, (long long)B * HD, S_pad, kMmaDh);
  if (r == CUDA_SUCCESS) r = encode_kv_map(enc, &maps[1], v, (long long)B * HD, S_pad, kMmaDh);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  err = cudaLaunchKernelEx(&cfg, kb_attn_mma_head, maps[0], maps[1],
                           static_cast<const __nv_bfloat16*>(q), out, HD, S_pad, S, CS, R, n_loc,
                           stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of K7's launch for this geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int wtt_kb_attn_mma_head_clusters(int B, int HD, int S_pad, int H, int CS, int C,
                                             int stages, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int R, n_loc;
  const cudaError_t err =
      head_config(B, HD, S_pad, S_pad, H, CS, C, stages, nullptr, cfg, attr, R, n_loc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kb_attn_mma_head, &cfg));
}

using F32Kernel = void (*)(CUtensorMap, CUtensorMap, const __nv_bfloat16*, const __nv_bfloat16*,
                           const __nv_bfloat16*, float*, int, int, int, int);

// The launch of K4a for clusters of C blocks, into cfg (whose attrs point at
// attr) and fn: cudaErrorInvalidValue for a shape or geometry the kernel
// does not take (see wtt_kb_attn_f32_split).
static cudaError_t f32_config(int B, int HD, int S_pad, int S, int H, int C, cudaStream_t st,
                              cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, F32Kernel& fn) {
  if (B < 1 || H < 1 || HD % H || HD / H > kMaxDh || S < 1 || S > S_pad || S_pad % 2 || C < 1 ||
      C > kF32MaxCluster || C > (S + kT - 1) / kT)
    return cudaErrorInvalidValue;
  const bool tma = S_pad % 8 == 0;
  if (HD / H <= 16 * kF32Warps)
    fn = tma ? kb_attn_f32_split<16, true> : kb_attn_f32_split<16, false>;
  else
    fn = tma ? kb_attn_f32_split<32, true> : kb_attn_f32_split<32, false>;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(H * C, B);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// K4a, clusters of C blocks over the keys (kernels/kbench.py's vpu_geometry
// chooses C). q: bf16 [B, HD]; k, v: contiguous bf16 [B, HD, S_pad], 16-byte
// aligned; out: f32 [B, HD]. Dh = HD / H <= 128, 1 <= S <= S_pad, S_pad
// even, 1 <= C <= min(8, ceil(S / 64)). The ring is filled by TMA where
// S_pad % 8 == 0 (tensor maps encoded per call, boxes of Dh rows by 64
// keys), else by the producer's 4-byte cp.async. cudaErrorInvalidValue for any
// other shape or geometry; 10000 + the CUresult when a tensor map cannot be
// encoded, and cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled.
extern "C" int wtt_kb_attn_f32_split(const void* q, const void* k, const void* v, float* out,
                                     int B, int HD, int S_pad, int S, int H, int C,
                                     void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  F32Kernel fn;
  cudaError_t err = f32_config(B, HD, S_pad, S, H, C, static_cast<cudaStream_t>(stream), cfg,
                               attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[2] = {};
  if (S_pad % 8 == 0) {
    const EncodeTiled enc = encode_tiled();
    if (!enc) return static_cast<int>(cudaErrorNotSupported);
    const int dh = HD / H;
    CUresult r = encode_kv_map(enc, &maps[0], k, (long long)B * HD, S_pad, dh,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r == CUDA_SUCCESS)
      r = encode_kv_map(enc, &maps[1], v, (long long)B * HD, S_pad, dh, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  err = cudaLaunchKernelEx(&cfg, fn, maps[0], maps[1], static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), out, HD, S_pad, S, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of K4a's launch the card holds at once, into *n.
extern "C" int wtt_kb_attn_f32_clusters(int B, int HD, int S_pad, int S, int H, int C, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  F32Kernel fn;
  const cudaError_t err = f32_config(B, HD, S_pad, S, H, C, nullptr, cfg, attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, fn, &cfg));
}
