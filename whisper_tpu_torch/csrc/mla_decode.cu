// Latent attention for one token a lane, for Hopper (sm_90a):
//
//   out[b, h] = softmax_t(scale * q[b, h] . c[b, t]) @ c[b, t, :512],   t in [start_b, valid_b)
//
// for B lanes of 64 query heads, q bf16 [B, 64, 576], and each lane's cache
// rows c bf16 [C, 576] (the normed latent, 512 columns, then the rotated
// shared key, 64): one latent "head" that every query head reads, its keys
// whole rows and its values their first 512 columns. out is f32 [B, 64, 512].
//
// Replaces no TPU kernel: the JAX package has no latent attention. It is the
// absorbed form of LongCat-Flash's MLA in the token step (model/longcat.py):
// q_nope taken through kv_b's K half into the latent's width beside q_rope,
// and the output taken through the V half afterwards, outside this kernel.
// K2 (csrc/decode_attention.cu) takes a head of at most 128 columns with its
// own K and V; here 64 heads share 576-column rows.
//
// What bounds it on an H100: a lane's rows are read once for 64 heads, so at
// 560 columns a call of 64 lanes reads ~41 MB (12 us at 3.35 TB/s) for ~5
// GFLOP (5 us at 989 TFLOP/s): bytes, but only ~2.4x over the operations.
// The tensor cores must be fed too, so the heads are the MMA's M dimension.
//
// Design.
//  - Grid: per lane, two blocks (the value columns' halves, 256 each) times
//    `splits` key ranges; the two halves of a lane and range are adjacent,
//    so the second reads the rows from L2. With splits = 1 (64 lanes: 128
//    blocks for 132 SMs) the block writes the normalised output; otherwise
//    each range writes its unnormalised sum, max and denominator, and a
//    second launch combines the ranges.
//  - A block: 8 warps; warp w takes heads 16 (w % 4) .. + 15 and, of each
//    32-key tile, keys 16 (w / 4) .. + 15, with its own running max and
//    denominator (log2 units, ex2). The two warps of a head tile are
//    combined at the end through shared memory.
//  - q's 64 rows stay in shared memory for the whole block (72 KB); key
//    tiles of 32 rows stream through a 2-stage cp.async ring (16-byte copies,
//    rows past valid zero-filled, so a masked key adds 0 and never NaN).
//    Rows are 1168 bytes apart (1152 + 16), so the eight 16-byte rows of an
//    ldmatrix fall in distinct banks.
//  - S = q K^T by mma.sync m16n8k16 (bf16 in, f32 sums): A from q by
//    ldmatrix, B from the key rows by ldmatrix (a row's consecutive columns
//    are the MMA's k); P, rounded to bf16, is the A operand of P V straight
//    from the S accumulators, and V's B fragments come from the same rows by
//    ldmatrix.trans. 128 f32 accumulators a thread hold a warp's 16 heads x
//    256 value columns.
//
// Arithmetic: the scores' f32 sums in the MMA's order, the softmax in log2
// units with ex2.approx, P rounded to bf16 for P V, the denominator summed
// from the unrounded P; the plain version (kernels/mla.py) is an f32
// softmax, so the two differ by bf16's rounding of P: at most 2^-8 (bf16's unit
// roundoff) of each term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeads = 64;
constexpr int kDim = 576;                  // columns a row: latent 512, rope 64
constexpr int kVDim = 512;
constexpr int kHalf = kVDim / 2;           // value columns a block
constexpr int kTile = 32;                  // keys a stage (kernels/mla.py: KEY_TILE)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = 2 * kDim;
constexpr int kPitch = kRowBytes + 16;     // bytes between rows in shared memory
constexpr int kChunks = kRowBytes / 16;    // 16-byte copies a row
constexpr int kQBytes = kHeads * kPitch;
constexpr int kStageBytes = kTile * kPitch;
constexpr int kSmemBytes = kQBytes + 2 * kStageBytes;
constexpr float kNegInf = -INFINITY;

struct Args {
  const __nv_bfloat16* q;  // [B, 64, 576]
  const __nv_bfloat16* c;  // lane b's rows at c + b * lane_stride, 576 apart
  long long lane_stride;   // elements
  const int* start;        // [B]
  const int* valid;        // [B]
  float* out;              // [B, 64, 512]
  float* o_part;           // splits > 1: [B, splits, 64, 512], each range's unnormalised sum
  float* ml_part;          // splits > 1: [B, splits, 2, 64], its max (log2 units) and denominator
  float scale_log2;        // scale * log2(e)
  int splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Grid: B * splits * 2 blocks, block (b, range r, half g) = ((b * splits + r) * 2 + g).
__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* ks = smem + kQBytes;
  const int g = static_cast<int>(blockIdx.x) & 1;
  const int br = static_cast<int>(blockIdx.x) >> 1;
  const int b = br / a.splits, range = br % a.splits;
  const int start = a.start[b], end = a.valid[b];
  const int n_tiles = end > start ? (end - start + kTile - 1) / kTile : 0;
  const int t0 = range * n_tiles / a.splits, t1 = (range + 1) * n_tiles / a.splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ht = warp & 3, kh = warp >> 2;
  const uint8_t* rows = reinterpret_cast<const uint8_t*>(a.c + static_cast<long long>(b) * a.lane_stride);

  const uint8_t* qg = reinterpret_cast<const uint8_t*>(a.q + static_cast<long long>(b) * kHeads * kDim);
  for (int i = tid; i < kHeads * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    cp_async16(qs + r * kPitch + ch * 16, qg + r * kRowBytes + ch * 16, 16);
  }
  auto load_tile = [&](int t, int stage) {
    const int k0 = start + t * kTile;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool live = k0 + r < end;
      const uint8_t* src = rows + static_cast<long long>(live ? k0 + r : start) * kRowBytes + ch * 16;
      cp_async16(ks + stage * kStageBytes + r * kPitch + ch * 16, src, live ? 16 : 0);
    }
  };
  if (t0 < t1) load_tile(t0, 0);
  cp_commit();

  const int gq = lane >> 2, tq = lane & 3;       // the MMA fragments' row group and column pair
  const int mi = lane >> 3, ri = lane & 7;       // ldmatrix: this lane's matrix and row
  // q: matrix m holds rows 8 (m & 1) + r, columns 8 (m >> 1): a0..a3
  const uint8_t* qa = qs + (16 * ht + 8 * (mi & 1) + ri) * kPitch + 16 * (mi >> 1);
  float o[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) load_tile(t + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const uint8_t* kt = ks + stage * kStageBytes + 16 * kh * kPitch;   // this warp's 16 keys
    // keys: matrix m holds keys 8 (m >> 1) + r, columns 8 (m & 1): b0, b1 of key groups 0 and 1
    const uint8_t* kb = kt + (8 * (mi >> 1) + ri) * kPitch + 16 * (mi & 1);
    float s[2][4] = {};
#pragma unroll 6
    for (int kk = 0; kk < kDim / 16; ++kk) {
      uint32_t a0, a1, a2, a3, b0, b1, b2, b3;
      ldsm_x4(qa + 32 * kk, a0, a1, a2, a3);
      ldsm_x4(kb + 32 * kk, b0, b1, b2, b3);
      mma_bf16(s[0], a0, a1, a2, a3, b0, b1);
      mma_bf16(s[1], a0, a1, a2, a3, b2, b3);
    }
    // s[n][i]: head 16 ht + gq + 8 (i >> 1), key 16 kh + 8 n + 2 tq + (i & 1) of the tile
    const int key0 = start + t * kTile + 16 * kh + 2 * tq;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = key0 + 8 * n + (i & 1) < end ? s[n][i] * a.scale_log2 : kNegInf;
        s[n][i] = v;
        mx[i >> 1] = fmaxf(mx[i >> 1], v);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float base = mx[r] == kNegInf ? 0.f : mx[r];
      corr[r] = ex2(m_run[r] - base);   // 0 while nothing was seen
      m_run[r] = mx[r];
      mx[r] = base;
    }
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[n][i] = ex2(s[n][i] - mx[i >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + p[0][2 * r] + p[0][2 * r + 1] + p[1][2 * r] + p[1][2 * r + 1];
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] *= corr[i >> 1];
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]), pa1 = pack_bf16(p[0][2], p[0][3]);
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]), pa3 = pack_bf16(p[1][2], p[1][3]);
    // values: matrix m holds keys 8 (m & 1) + r, columns 8 (m >> 1) of a 16-column pair, transposed
    const uint8_t* vb = kt + (8 * (mi & 1) + ri) * kPitch + 2 * (kHalf * g + 8 * (mi >> 1));
#pragma unroll
    for (int nn = 0; nn < 16; ++nn) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(vb + 32 * nn, b0, b1, b2, b3);
      mma_bf16(o[2 * nn], pa0, pa1, pa2, pa3, b0, b1);
      mma_bf16(o[2 * nn + 1], pa0, pa1, pa2, pa3, b2, b3);
    }
    __syncthreads();  // the stage is read: the next iteration's copy may overwrite it
  }
  cp_wait<0>();
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // the second key half's warps hand over their sums; the first's combine and write
  float* ob = reinterpret_cast<float*>(ks);   // [4 head tiles][16 heads][256]
  float* mlb = reinterpret_cast<float*>(qs);  // [4 head tiles][16 heads][2]
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        *reinterpret_cast<float2*>(ob + (16 * ht + gq + 4 * i) * kHalf + 8 * n + 2 * tq) = make_float2(o[n][i], o[n][i + 1]);
    if (tq == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mlb[(16 * ht + gq + 8 * r) * 2] = m_run[r];
        mlb[(16 * ht + gq + 8 * r) * 2 + 1] = l_run[r];
      }
  }
  __syncthreads();
  if (kh == 1) return;
  float w_mine[2], w_other[2], denom[2], m_all[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = mlb[(16 * ht + gq + 8 * r) * 2], l1 = mlb[(16 * ht + gq + 8 * r) * 2 + 1];
    const float m = fmaxf(m_run[r], m1);
    const float base = m == kNegInf ? 0.f : m;
    w_mine[r] = ex2(m_run[r] - base);
    w_other[r] = ex2(m1 - base);
    denom[r] = l_run[r] * w_mine[r] + l1 * w_other[r];
    m_all[r] = m;
  }
  const int bh = b * kHeads + 16 * ht + gq;  // this thread's head of row group 0
  if (a.splits == 1) {
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int r = i >> 1;
        const float2 other = *reinterpret_cast<const float2*>(ob + (16 * ht + gq + 8 * r) * kHalf + 8 * n + 2 * tq);
        const float inv = denom[r] > 0.f ? 1.f / denom[r] : 0.f;
        const float2 v = make_float2((o[n][i] * w_mine[r] + other.x * w_other[r]) * inv,
                                     (o[n][i + 1] * w_mine[r] + other.y * w_other[r]) * inv);
        *reinterpret_cast<float2*>(a.out + static_cast<long long>(bh + 8 * r) * kVDim + kHalf * g + 8 * n + 2 * tq) = v;
      }
    return;
  }
  const long long part = static_cast<long long>(b) * a.splits + range;
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int r = i >> 1;
      const float2 other = *reinterpret_cast<const float2*>(ob + (16 * ht + gq + 8 * r) * kHalf + 8 * n + 2 * tq);
      const float2 v = make_float2(o[n][i] * w_mine[r] + other.x * w_other[r],
                                   o[n][i + 1] * w_mine[r] + other.y * w_other[r]);
      *reinterpret_cast<float2*>(a.o_part + (part * kHeads + 16 * ht + gq + 8 * r) * kVDim + kHalf * g + 8 * n + 2 * tq) = v;
    }
  if (g == 0 && tq == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a.ml_part[(part * 2) * kHeads + 16 * ht + gq + 8 * r] = m_all[r];
      a.ml_part[(part * 2 + 1) * kHeads + 16 * ht + gq + 8 * r] = denom[r];
    }
}

// Grid: B * 64 blocks of 128 threads, one a (lane, head), 4 value columns a thread.
__global__ void __launch_bounds__(128) mla_combine_kernel(const __grid_constant__ Args a) {
  const int b = static_cast<int>(blockIdx.x) / kHeads, h = static_cast<int>(blockIdx.x) % kHeads;
  float m = kNegInf;
  for (int r = 0; r < a.splits; ++r) m = fmaxf(m, a.ml_part[((static_cast<long long>(b) * a.splits + r) * 2) * kHeads + h]);
  const float base = m == kNegInf ? 0.f : m;
  float denom = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < a.splits; ++r) {
    const long long part = static_cast<long long>(b) * a.splits + r;
    const float w = ex2(a.ml_part[(part * 2) * kHeads + h] - base);
    denom += w * a.ml_part[(part * 2 + 1) * kHeads + h];
    const float4 v = *reinterpret_cast<const float4*>(a.o_part + (part * kHeads + h) * kVDim + 4 * threadIdx.x);
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = denom > 0.f ? 1.f / denom : 0.f;
  *reinterpret_cast<float4*>(a.out + (static_cast<long long>(b) * kHeads + h) * kVDim + 4 * threadIdx.x) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One call: q bf16 [B, 64, 576] contiguous; c bf16, lane b's rows at c + b *
// lane_stride (elements, a multiple of 8), each 576 contiguous; start, valid
// int32 [B]; out f32 [B, 64, 512]; with splits > 1, o_part f32 [B, splits,
// 64, 512] and ml_part f32 [B, splits, 2, 64] as scratch. scale: the scores'
// factor. One launch, two where splits > 1, on `stream`. Returns
// cudaGetLastError() after them, or cudaErrorInvalidValue for what it does
// not take.
extern "C" int wtt_mla_decode(const void* q, const void* c, long long lane_stride, const int* start,
                              const int* valid, float* out, float* o_part, float* ml_part, int B, int splits,
                              float scale, void* stream) {
  if (B < 1 || splits < 1 || lane_stride % 8 || !aligned16(q) || !aligned16(c) || !aligned16(out) ||
      (splits > 1 && (!o_part || !ml_part || !aligned16(o_part))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.c = static_cast<const __nv_bfloat16*>(c);
  a.lane_stride = lane_stride;
  a.start = start;
  a.valid = valid;
  a.out = out;
  a.o_part = o_part;
  a.ml_part = ml_part;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.splits = splits;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  mla_decode_kernel<<<B * splits * 2, kThreads, kSmemBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  mla_combine_kernel<<<B * kHeads, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
