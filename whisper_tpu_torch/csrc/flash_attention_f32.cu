// Fused encoder self-attention for Hopper (sm_90a), f32 in, f32 out: the
// f32 instance of K1, which DtypePolicy.f32() runs.
//
// Replaces the Pallas kernel whisper_tpu/kernels/attention.py:flash_attention
// (body _attn_kernel) for f32 q/k/v. Computes softmax(q k^T) v per (batch,
// head) over pre-scaled q, k in [B, T, H, Dh] layout, read in place through
// their strides (the strided views that qkv_proj returns). Scores, softmax,
// P and P.V are all f32, on the CUDA cores: no tensor-core type keeps the
// 1e-5 the f32 tier is held to (TF32 keeps ~3 decimal digits).
//
// What bounds it on an H100: operations. At large-v2 (T = 1500, H = 20,
// Dh = 64) one layer does 4 * 20 * 1500^2 * 64 = 11.52 GFLOP per lane on
// 23 MB of q/k/v/out: 0.172 ms at the 67 TFLOP/s of f32 FMA against
// 0.009 ms for the bytes.
//
// Design, plain and simple (this tier is held for exactness, not speed):
//  - One block per (64 q rows, batch * head), 8 warps of 8 q rows each.
//  - Q stays in shared memory; K and V tiles of 64 keys are staged in
//    shared memory by all 256 threads with 16-byte loads (so the wrapper
//    asks for 16-byte aligned bases and strides), rows past T zero-filled.
//  - S = Q K^T: lane j of a warp holds keys j and j + 32 of the tile for the
//    warp's 8 rows, reading its K rows as float4 (rows padded to 68 floats so
//    a quarter-warp's 16-byte reads fall on distinct banks) and Q as float4
//    broadcasts: 10 shared loads per 64 FMAs.
//  - Online softmax in f32 (expf), row max and sum by warp shuffles; keys
//    >= Tk in the last tile are -inf. Each warp writes its P rows to shared
//    memory; P.V then gives lane j the output columns 2j and 2j + 1 of the
//    warp's 8 rows (float4 broadcasts of P, float2 reads of V). The output
//    is normalised at the end; rows >= Tq are never written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;               // head dim of every whisper model
constexpr int kBq = 64;               // q rows per block
constexpr int kBk = 64;               // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBq / kWarps;   // q rows per warp
constexpr int kPad = kDh + 4;         // Q and K row stride in floats

struct Smem {
  float q[kBq][kPad];
  float k[kBk][kPad];
  float v[kBk][kDh];
  float p[kWarps][kRows][kBk];
};

// Rows [t0, t0 + 64) of one (batch, head) slice into a [64][stride] tile,
// 16 bytes a thread per step; rows at or past T are zero.
__device__ __forceinline__ void load_tile(float* dst, int stride, const float* src, long long st,
                                          int t0, int T) {
#pragma unroll
  for (int it = 0; it < 64 * kDh / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = i / (kDh / 4), col = i % (kDh / 4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + row < T) x = *reinterpret_cast<const float4*>(src + (t0 + row) * st + col);
    *reinterpret_cast<float4*>(dst + row * stride + col) = x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int H, int Tq,
                           int Tk, long long q_sb, long long q_st, long long q_sh, long long k_sb,
                           long long k_st, long long k_sh, long long v_sb, long long v_st,
                           long long v_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBq;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  load_tile(&s.q[0][0], kPad, q + b * q_sb + h * q_sh, q_st, q0, Tq);

  float o[kRows][2], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    o[r][0] = o[r][1] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBk) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(&s.k[0][0], kPad, kb, k_st, k0, Tk);
    load_tile(&s.v[0][0], kDh, vb, v_st, k0, Tk);
    __syncthreads();

    float sc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&s.k[lane][d]);
      const float4 kc = *reinterpret_cast<const float4*>(&s.k[lane + 32][d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&s.q[warp * kRows + r][d]);
        sc[r][0] = fmaf(qv.x, ka.x, fmaf(qv.y, ka.y, fmaf(qv.z, ka.z, fmaf(qv.w, ka.w, sc[r][0]))));
        sc[r][1] = fmaf(qv.x, kc.x, fmaf(qv.y, kc.y, fmaf(qv.z, kc.z, fmaf(qv.w, kc.w, sc[r][1]))));
      }
    }

    // key k0 < Tk is in every tile, so each row's tile max is finite
    const bool in0 = k0 + lane < Tk, in1 = k0 + lane + 32 < Tk;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s0 = in0 ? sc[r][0] : -INFINITY;
      const float s1 = in1 ? sc[r][1] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float scale = expf(m[r] - m_new);  // 0 on the first tile
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      l[r] = l[r] * scale + warp_sum(p0 + p1);
      m[r] = m_new;
      o[r][0] *= scale;
      o[r][1] *= scale;
      s.p[warp][r][lane] = p0;
      s.p[warp][r][lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBk; j += 4) {
      const float2 v0 = *reinterpret_cast<const float2*>(&s.v[j][2 * lane]);
      const float2 v1 = *reinterpret_cast<const float2*>(&s.v[j + 1][2 * lane]);
      const float2 v2 = *reinterpret_cast<const float2*>(&s.v[j + 2][2 * lane]);
      const float2 v3 = *reinterpret_cast<const float2*>(&s.v[j + 3][2 * lane]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(&s.p[warp][r][j]);
        o[r][0] = fmaf(p.w, v3.x, fmaf(p.z, v2.x, fmaf(p.y, v1.x, fmaf(p.x, v0.x, o[r][0]))));
        o[r][1] = fmaf(p.w, v3.y, fmaf(p.z, v2.y, fmaf(p.y, v1.y, fmaf(p.x, v0.y, o[r][1]))));
      }
    }
    __syncwarp();  // P is rewritten on the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row < Tq) {
      const float inv = 1.f / l[r];
      *reinterpret_cast<float2*>(out + ((long long)(b * Tq + row) * H + h) * kDh + 2 * lane) =
          make_float2(o[r][0] * inv, o[r][1] * inv);
    }
  }
}

}  // namespace

// q, k, v: f32 [B, T, H, 64] with unit stride along Dh and the given element
// strides for B, T and H (multiples of 4, i.e. of 16 bytes; 16-byte aligned
// bases); out: contiguous f32 [B, Tq, H, 64]. Returns cudaGetLastError()
// after the launch, so a refused launch reaches the caller.
extern "C" int wtt_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int Tq, int Tk,
                                       long long q_sb, long long q_st, long long q_sh,
                                       long long k_sb, long long k_st, long long k_sh,
                                       long long v_sb, long long v_st, long long v_sh,
                                       void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));  // 67,584 B: above the 48 KB static limit
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBq - 1) / kBq, B * H);
  flash_attention_f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}
