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
//   kb_attn_cuda_core  per lane and head, softmax over the keys s < S of the
//                      unscaled q . K[:, s], then P.V, all in f32 (K4a; K8 on
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
// 3.35 TB/s; K8's int8 K/V and their scales are 1,009,778,688 B, 0.301 ms.
// The attention kernels do 4 flops per K/V element, far below the ~295
// flop/byte where the tensor cores would matter; K4b's dense formulation
// does 20x the useful flops (~64 GFLOP a pass, 0.065 ms at 989 TFLOP/s),
// still under the bytes bound.
//
// Design. The TPU walked the chunk axis of its grid in order on one core,
// carrying sums in VMEM scratch; Hopper blocks run in parallel and carry
// nothing. kv_rowsum has two tilings: split (K3, K6, K9), where blocks over
// (16 rows, one CS-wide chunk, slab) write partial row sums and a combine
// kernel adds them, the structure of the decode kernel's split-S; and
// whole-row (K5), where a block over RB rows walks all of S_PAD and writes
// the sums itself. Warps run along a row so every load is 16 coalesced bytes
// a thread. K6 (grid (L, B, chunks) on the TPU) and K9 (grid (L * B,
// chunks)) differ only in the TPU's grid nesting and so are one launch
// configuration over L * B slabs here (the split pass, then the combine). The attention kernels deliberately keep the TPU's
// sequential chunk walk as a loop inside the block (one block per lane and
// head, or per lane and 16 heads for K4b) carrying m, l and acc across
// CS-wide chunks, so that the microbenchmark sets that structure against
// the decode kernel's split-S at the same shape. Each chunk's scores are
// finished before its softmax, so p is rounded to bf16 at the chunk's
// running max, as on the TPU. K and V tiles go through shared memory by
// 16-byte cp.async copies; K's B fragments ([Dh, S] rows, contracted over Dh) come
// from ldmatrix.trans, V's (contracted over S, contiguous) from plain 32-bit
// loads. Masked keys score -inf, as on the TPU; S >= 1 keeps the first
// chunk's max finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

template <int kWarps>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

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

// the two bf16 of a 32-bit word, low address first, as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// kv_rowsum: K3, K5, K6, K9
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;

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

// Block (row tile, column chunk, slab): rows [x * rows, +rows) x columns
// [y * cols, +cols). One warp per row at a time, lanes along the row.
// dst is [slabs, gridDim.y, HD]: the output itself when gridDim.y == 1.
__global__ void __launch_bounds__(kSumThreads)
kv_rowsum_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                 float* __restrict__ dst, int HD, int S, int rows, int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows;
  const int r_end = min(r0 + rows, HD);
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
// kb_attn_cuda_core: K4a (bf16 K/V), K8 (int8 K/V + column scales)
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kMaxDh = 128;

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// One block per (head, lane) walks the CS-wide chunks in order. Each thread
// owns column pairs of the chunk: it makes their scores (a 64-deep f32 dot,
// coalesced along S), then their p; the warps then run along Dh for P.V.
template <typename TKV>
__global__ void __launch_bounds__(kAttnThreads)
kb_attn_cuda_core(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, float* __restrict__ out, int HD, int S_pad,
                  int S, int H, int CS) {
  constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
  extern __shared__ float p_s[];  // [CS]: the chunk's scores, then p (times v_scale)
  __shared__ float q_s[kMaxDh];
  __shared__ float acc_s[kMaxDh];
  __shared__ float red[kAttnWarps];
  const int h = blockIdx.x, b = blockIdx.y, dh = HD / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = ((long long)b * HD + (long long)h * dh) * S_pad;
  const TKV* kb = k + row0;
  const TKV* vb = v + row0;
  const float* skb = kScaled ? k_scale + (long long)b * S_pad : nullptr;
  const float* svb = kScaled ? v_scale + (long long)b * S_pad : nullptr;
  for (int d = tid; d < dh; d += kAttnThreads) {
    q_s[d] = __bfloat162float(q[(long long)b * HD + h * dh + d]);
    acc_s[d] = 0.f;
  }
  __syncthreads();

  float m = -INFINITY, l = 0.f;
  for (int c0 = 0; c0 < S_pad; c0 += CS) {
    float t_max = -INFINITY;
    for (int j = 2 * tid; j < CS; j += 2 * kAttnThreads) {
      const TKV* kc = kb + c0 + j;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) {
        const float2 x = load_pair(kc + (long long)d * S_pad);
        a0 += q_s[d] * x.x;
        a1 += q_s[d] * x.y;
      }
      if constexpr (kScaled) {
        a0 *= skb[c0 + j];
        a1 *= skb[c0 + j + 1];
      }
      if (c0 + j >= S) a0 = -INFINITY;
      if (c0 + j + 1 >= S) a1 = -INFINITY;
      p_s[j] = a0;
      p_s[j + 1] = a1;
      t_max = fmaxf(t_max, fmaxf(a0, a1));
    }
    const float m_new = fmaxf(m, block_max<kAttnWarps>(t_max, red));
    const float alpha = expf(m - m_new);  // 0 on the first chunk
    float t_sum = 0.f;
    for (int j = 2 * tid; j < CS; j += 2 * kAttnThreads) {
      const float p0 = expf(p_s[j] - m_new), p1 = expf(p_s[j + 1] - m_new);
      t_sum += p0 + p1;
      p_s[j] = kScaled ? p0 * svb[c0 + j] : p0;
      p_s[j + 1] = kScaled ? p1 * svb[c0 + j + 1] : p1;
    }
    l = l * alpha + block_sum<kAttnWarps>(t_sum, red);  // syncs: p_s is complete
    m = m_new;
    for (int d = warp; d < dh; d += kAttnWarps) {
      const TKV* vr = vb + (long long)d * S_pad + c0;
      float a = 0.f;
      for (int j = 2 * lane; j < CS; j += 64) {
        const float2 x = load_pair(vr + j);
        a += p_s[j] * x.x + p_s[j + 1] * x.y;
      }
      a = warp_sum(a);
      if (lane == 0) acc_s[d] = acc_s[d] * alpha + a;
    }
    __syncthreads();  // the next chunk rewrites p_s
  }
  for (int d = tid; d < dh; d += kAttnThreads) out[(long long)b * HD + h * dh + d] = acc_s[d] / l;
}

// ---------------------------------------------------------------------------
// tensor-core attention: K7 (per head), K4b (head-masked dense)
// ---------------------------------------------------------------------------

constexpr int kT = 64;          // keys per shared-memory tile
constexpr int kLds = kT + 8;    // padded tile row: 144 B, conflict-free fragment loads
constexpr int kMmaDh = 64;      // K7's head dim
constexpr int kHeadThreads = 128;
constexpr int kDenseThreads = 256;
constexpr int kHeadsPerBlock = 16;  // K4b: one m-tile of qm^T's rows per block

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [0, n_rows) x columns [0, 64) of a row-major bf16 array (row stride
// ld elements) into a padded shared tile, 16 bytes a thread. cp.async keeps
// every copy of the tile in flight at once (a load-then-store loop would
// wait out one memory latency per 16 bytes); the caller syncs the block.
template <int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLds], const __nv_bfloat16* src,
                                          long long ld, int n_rows) {
  for (int c = threadIdx.x; c < n_rows * (kT / 8); c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(&dst[r][col]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + (long long)r * ld + col));
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// K7: one block of 4 warps per (head, lane). Scores: q in row 0 of a 16-row
// A tile (rows 1-15 zero) against 64-key K tiles, B fragments by
// ldmatrix.trans of the [Dh, keys] tile; warp w owns keys [16w, 16w + 16).
// P.V: p (bf16) in row 0 of A against the [Dh, keys] V tile, whose rows are
// already B's columns; warp w owns features [16w, 16w + 16).
__global__ void __launch_bounds__(kHeadThreads)
kb_attn_mma_head(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int HD, int S_pad,
                 int S, int H, int CS) {
  extern __shared__ float p_s[];  // [CS]: the chunk's scores, then p
  __shared__ __align__(16) __nv_bfloat16 tile[kMmaDh][kLds];
  __shared__ float red[kHeadThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, rr = lane & 7;
  const long long row0 = ((long long)b * HD + (long long)h * kMmaDh) * S_pad;
  const __nv_bfloat16* kb = k + row0;
  const __nv_bfloat16* vb = v + row0;
  const __nv_bfloat16* qh = q + (long long)b * HD + h * kMmaDh;

  uint32_t qf[4][4];  // one A fragment per 16-wide slice of Dh
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(qh + kk * 16 + 2 * tig) : 0u;
    qf[kk][1] = 0u;
    qf[kk][2] = g == 0 ? *reinterpret_cast<const uint32_t*>(qh + kk * 16 + 8 + 2 * tig) : 0u;
    qf[kk][3] = 0u;
  }

  float m = -INFINITY, l = 0.f;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // lanes 0-3: features (2w + j) * 8 + 2 tig + {0, 1}
  for (int c0 = 0; c0 < S_pad; c0 += CS) {
    for (int t0 = 0; t0 < CS; t0 += kT) {
      __syncthreads();
      load_tile<kHeadThreads>(tile, kb + c0 + t0, S_pad, kMmaDh);
      __syncthreads();
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &tile[kk * 16 + (mi & 1) * 8 + rr][(2 * warp + (mi >> 1)) * 8]);
        mma_bf16_16816(s0, qf[kk], r[0], r[1]);
        mma_bf16_16816(s1, qf[kk], r[2], r[3]);
      }
      if (g == 0) {  // row 0 of D
        const int j = t0 + 16 * warp + 2 * tig;
        p_s[j] = s0[0];
        p_s[j + 1] = s0[1];
        p_s[j + 8] = s1[0];
        p_s[j + 9] = s1[1];
      }
    }
    __syncthreads();
    float t_max = -INFINITY;
    for (int j = tid; j < CS; j += kHeadThreads) {
      if (c0 + j >= S) p_s[j] = -INFINITY;
      t_max = fmaxf(t_max, p_s[j]);
    }
    const float m_new = fmaxf(m, block_max<kHeadThreads / 32>(t_max, red));
    const float alpha = expf(m - m_new);
    float t_sum = 0.f;
    for (int j = tid; j < CS; j += kHeadThreads) {
      const float p = expf(p_s[j] - m_new);
      t_sum += p;
      p_s[j] = p;
    }
    l = l * alpha + block_sum<kHeadThreads / 32>(t_sum, red);  // syncs: p_s is complete
    m = m_new;

    float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int t0 = 0; t0 < CS; t0 += kT) {
      __syncthreads();
      load_tile<kHeadThreads>(tile, vb + c0 + t0, S_pad, kMmaDh);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kc = ks * 16 + 2 * tig;
        const float* pr = p_s + t0 + kc;
        const uint32_t a[4] = {g == 0 ? pack_bf16(pr[0], pr[1]) : 0u, 0u,
                               g == 0 ? pack_bf16(pr[8], pr[9]) : 0u, 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n0 = (2 * warp + j) * 8;
          mma_bf16_16816(u[j], a, lds32(&tile[n0 + g][kc]), lds32(&tile[n0 + g][kc + 8]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][0] = acc[j][0] * alpha + u[j][0];
      acc[j][1] = acc[j][1] * alpha + u[j][1];
    }
  }
  if (g == 0) {
    float* o = out + (long long)b * HD + h * kMmaDh;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = (2 * warp + j) * 8 + 2 * tig;
      o[d] = acc[j][0] / l;
      o[d + 1] = acc[j][1] / l;
    }
  }
}

// K4b: one block of 8 warps per (16 heads, lane), as the TPU's head-masked
// dense formulation. Scores [16 heads, keys] = qm^T K with qm^T[h][r] = q[r]
// where row r belongs to head h, else 0, contracted over all HD rows (20x
// the useful products at large-v2); a 64-key K tile of all HD rows sits in
// shared memory and warp w owns keys [8w, 8w + 8). P.V is vp[HD, 16 heads] =
// V p^T, warp w owning the 16-row tiles w / 2 (mod 4) and heads 8 (w % 2) +
// [0, 8), then the head mask: row r keeps only vp[r][head(r)], added to the
// running acc (rescaled by the chunk's alpha first).
__global__ void __launch_bounds__(kDenseThreads)
kb_attn_mma_dense(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int HD, int S_pad,
                  int S, int H, int CS) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __nv_bfloat16(*tile)[kLds] = reinterpret_cast<__nv_bfloat16(*)[kLds]>(dyn);  // [HD][kLds]
  float* p_s = reinterpret_cast<float*>(dyn + (size_t)HD * kLds * 2);        // [16][CS]
  float* acc_s = p_s + kHeadsPerBlock * CS;                                    // [HD]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(acc_s + HD);          // [HD]
  __shared__ float m_s[kHeadsPerBlock], l_s[kHeadsPerBlock], alpha_s[kHeadsPerBlock];
  const int h0 = blockIdx.x * kHeadsPerBlock, b = blockIdx.y, dh = HD / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3, rr = lane & 7;
  const long long lane0 = (long long)b * HD * S_pad;
  const __nv_bfloat16* kb = k + lane0;
  const __nv_bfloat16* vb = v + lane0;
  const int r_lo = h0 * dh, r_hi = min(h0 + kHeadsPerBlock, H) * dh;  // this block's heads' rows
  for (int i = tid; i < HD; i += kDenseThreads) {
    q_s[i] = q[(long long)b * HD + i];
    acc_s[i] = 0.f;
  }
  if (tid < kHeadsPerBlock) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  for (int c0 = 0; c0 < S_pad; c0 += CS) {
    for (int t0 = 0; t0 < CS; t0 += kT) {
      __syncthreads();
      load_tile<kDenseThreads>(tile, kb + c0 + t0, S_pad, HD);
      __syncthreads();
      // two accumulators (even and odd k-steps) halve the chain of
      // dependent products over the HD / 16 k-steps
      float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int r2 = 0; r2 < HD; r2 += 32) {  // two k-steps of 16 rows
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &tile[r2 + mi * 8 + rr][warp * 8]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r2 + half * 16;
          const int head = r / dh;  // every row of the k-step (dh % 16 == 0)
          const uint32_t q0 = lds32(&q_s[r + 2 * tig]), q8 = lds32(&q_s[r + 8 + 2 * tig]);
          const uint32_t a[4] = {head == h0 + g ? q0 : 0u, head == h0 + g + 8 ? q0 : 0u,
                                 head == h0 + g ? q8 : 0u, head == h0 + g + 8 ? q8 : 0u};
          mma_bf16_16816(s2[half], a, bf[2 * half], bf[2 * half + 1]);
        }
      }
      const float s[4] = {s2[0][0] + s2[1][0], s2[0][1] + s2[1][1], s2[0][2] + s2[1][2],
                          s2[0][3] + s2[1][3]};
      const int j = t0 + 8 * warp + 2 * tig;
      p_s[g * CS + j] = s[0];
      p_s[g * CS + j + 1] = s[1];
      p_s[(g + 8) * CS + j] = s[2];
      p_s[(g + 8) * CS + j + 1] = s[3];
    }
    __syncthreads();
    for (int hh = warp; hh < kHeadsPerBlock; hh += kDenseThreads / 32) {
      float* row = p_s + hh * CS;
      const float m_old = m_s[hh];
      float mx = -INFINITY;
      for (int j = lane; j < CS; j += 32) {
        if (c0 + j >= S) row[j] = -INFINITY;
        mx = fmaxf(mx, row[j]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < CS; j += 32) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
        alpha_s[hh] = alpha;
      }
    }
    __syncthreads();
    for (int r = r_lo + tid; r < r_hi; r += kDenseThreads) acc_s[r] *= alpha_s[r / dh - h0];

    const int n0 = (warp & 1) * 8;
    for (int t0 = 0; t0 < CS; t0 += kT) {
      __syncthreads();
      load_tile<kDenseThreads>(tile, vb + c0 + t0, S_pad, HD);
      __syncthreads();
      for (int m0 = (warp >> 1) * 16; m0 < HD; m0 += 64) {
        float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int kc = ks * 16 + 2 * tig;
          const uint32_t a[4] = {lds32(&tile[m0 + g][kc]), lds32(&tile[m0 + g + 8][kc]),
                                 lds32(&tile[m0 + g][kc + 8]), lds32(&tile[m0 + g + 8][kc + 8])};
          const float* pr = p_s + (n0 + g) * CS + t0 + kc;
          mma_bf16_16816(u, a, pack_bf16(pr[0], pr[1]), pack_bf16(pr[8], pr[9]));
        }
        // the head mask: u = vp[m0 + g (+8)][h0 + n0 + 2 tig (+1)]
        const int ra = m0 + g, hc = h0 + n0 + 2 * tig;
        if (ra / dh == hc) acc_s[ra] += u[0];
        if (ra / dh == hc + 1) acc_s[ra] += u[1];
        if ((ra + 8) / dh == hc) acc_s[ra + 8] += u[2];
        if ((ra + 8) / dh == hc + 1) acc_s[ra + 8] += u[3];
      }
    }
  }
  __syncthreads();
  for (int r = r_lo + tid; r < r_hi; r += kDenseThreads)
    out[(long long)b * HD + r] = acc_s[r] / l_s[r / dh - h0];
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
// out: f32 [slabs, HD]. cols == S: whole-row tiling, `rows` rows a block,
// one launch. cols < S (S % cols == 0, cols % 8 == 0): split tiling, 16 rows
// by `cols` columns a block into part (f32 [slabs, S / cols, HD]), then the
// combine launch.
extern "C" int wtt_kb_rowsum(const void* k, const void* v, float* out, float* part, int slabs,
                             int HD, int S, int rows, int cols, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_parts = S / cols;
  const dim3 grid((HD + rows - 1) / rows, n_parts, slabs);
  kv_rowsum_kernel<<<grid, kSumThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      n_parts == 1 ? out : part, HD, S, rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const long long n = (long long)slabs * HD;
  kv_rowsum_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(part, out, HD,
                                                                            n_parts, n);
  return static_cast<int>(cudaGetLastError());
}

// kv_type 1: bf16 K/V (K4a); 2: int8 K/V with k_scale/v_scale f32 [B, S_pad]
// (K8). q: bf16 [B, HD]; k, v: contiguous [B, HD, S_pad]; out: f32 [B, HD].
// S_pad % CS == 0, CS even, Dh = HD / H <= 128, 1 <= S <= S_pad.
extern "C" int wtt_kb_attn_cuda_core(int kv_type, const void* q, const void* k, const void* v,
                                     const float* k_scale, const float* v_scale, float* out, int B,
                                     int HD, int S_pad, int S, int H, int CS, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, B);
  const size_t smem = (size_t)CS * sizeof(float);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  cudaError_t err;
  if (kv_type == 1) {
    if ((err = allow_smem(kb_attn_cuda_core<__nv_bfloat16>, smem)) != cudaSuccess) return err;
    kb_attn_cuda_core<__nv_bfloat16><<<grid, kAttnThreads, smem, st>>>(
        qb, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), nullptr,
        nullptr, out, HD, S_pad, S, H, CS);
  } else if (kv_type == 2 && k_scale && v_scale) {
    if ((err = allow_smem(kb_attn_cuda_core<int8_t>, smem)) != cudaSuccess) return err;
    kb_attn_cuda_core<int8_t><<<grid, kAttnThreads, smem, st>>>(
        qb, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), k_scale, v_scale, out,
        HD, S_pad, S, H, CS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory that wtt_kb_attn_mma's dense form needs (the wrapper checks
// it against the card's 227 KB).
extern "C" long long wtt_kb_attn_mma_dense_smem(int HD, int CS) {
  return (long long)HD * kLds * 2 + ((long long)kHeadsPerBlock * CS + HD) * 4 + (long long)HD * 2;
}

// dense 0: per head (K7; Dh == 64); dense 1: head-masked dense (K4b; Dh %
// 16 == 0, HD % 32 == 0). q: bf16 [B, HD]; k, v: contiguous bf16 [B, HD,
// S_pad]; out: f32 [B, HD] (K7's [B, H, Dh] is the same memory). S_pad % CS
// == 0, CS % 64 == 0, 1 <= S <= S_pad.
extern "C" int wtt_kb_attn_mma(int dense, const void* q, const void* k, const void* v, float* out,
                               int B, int HD, int S_pad, int S, int H, int CS, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  cudaError_t err;
  if (dense) {
    const size_t smem = static_cast<size_t>(wtt_kb_attn_mma_dense_smem(HD, CS));
    if ((err = allow_smem(kb_attn_mma_dense, smem)) != cudaSuccess) return err;
    const dim3 grid((H + kHeadsPerBlock - 1) / kHeadsPerBlock, B);
    kb_attn_mma_dense<<<grid, kDenseThreads, smem, st>>>(qb, kb, vb, out, HD, S_pad, S, H, CS);
  } else {
    const size_t smem = (size_t)CS * sizeof(float);
    if ((err = allow_smem(kb_attn_mma_head, smem)) != cudaSuccess) return err;
    kb_attn_mma_head<<<dim3(H, B), kHeadThreads, smem, st>>>(qb, kb, vb, out, HD, S_pad, S, H, CS);
  }
  return static_cast<int>(cudaGetLastError());
}
