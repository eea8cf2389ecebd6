// Fused encoder self-attention for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the Pallas kernel whisper_tpu/kernels/attention.py:flash_attention
// (body _attn_kernel). Computes softmax(q k^T) v per (batch, head) over
// pre-scaled q, k in [B, T, H, Dh] layout, softmax in f32, P cast to bf16 for
// the PV product, f32 accumulation, bf16 output.
//
// What bounds it on an H100: operations. At large-v2 (T = 1500, H = 20,
// Dh = 64) one layer does 4 * 20 * 1500^2 * 64 = 11.5 GFLOP on 11.5 MB of
// q/k/v/out, so the tensor cores, not the 3.35 TB/s of HBM, set the floor
// (about 11.6 us at 989 TFLOP/s bf16).
//
// Design: one block of 4 warps per (64-row q tile, b*h). The TPU kernel held
// a whole 1536-key row in VMEM; a Hopper block has far less fast memory, so
// this one streams 64-key K/V tiles through shared memory with an f32 online
// softmax (running max and sum per row) and keeps the score tile in
// registers, never in device memory. Products run on the tensor cores as
// mma.sync m16n8k16 bf16 with f32 accumulators: each warp owns 16 q rows,
// its q fragments stay in registers for the whole key loop, the P fragments
// are re-packed from the score accumulators without a trip through shared
// memory, and V's B fragments come from ldmatrix.trans. The block reads q, k
// and v in place through their strides (no fold, transpose or pad copy) and
// masks the ragged Tq and Tk edges itself. wgmma/TMA pipelining is later
// work; this version loads each tile synchronously.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;          // head dim of every whisper model
constexpr int kBq = 64;          // q rows per block (16 per warp)
constexpr int kBk = 64;          // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kLds = kDh + 8;    // padded smem row: 144 B, conflict-free fragment loads

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

// Copy rows [r0, r0 + 64) of a [T, Dh] head slice (row stride `st` elements)
// into a padded smem tile, zero-filling rows >= T.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLds], const __nv_bfloat16* src,
                                          long long st, int r0, int T) {
  for (int c = threadIdx.x; c < kBk * (kDh / 8); c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       int H, int Tq, int Tk,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBq][kLds];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBk][kLds];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBk][kLds];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group / thread in group
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBq;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  load_tile(Qs, qb, q_st, q0, Tq);
  __syncthreads();

  // This warp's 16 q rows as A fragments, one per 16-wide slice of Dh.
  uint32_t qf[4][4];
  const int ra = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = lds32(&Qs[ra][kk * 16 + tig * 2]);
    qf[kk][1] = lds32(&Qs[ra + 8][kk * 16 + tig * 2]);
    qf[kk][2] = lds32(&Qs[ra][kk * 16 + 8 + tig * 2]);
    qf[kk][3] = lds32(&Qs[ra + 8][kk * 16 + 8 + tig * 2]);
  }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums

  for (int k0 = 0; k0 < Tk; k0 += kBk) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(Ks, kb, k_st, k0, Tk);
    load_tile(Vs, vb, v_st, k0, Tk);
    __syncthreads();

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys, 4 k-steps over Dh.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = lds32(&Ks[j * 8 + g][kk * 16 + tig * 2]);
        const uint32_t b1 = lds32(&Ks[j * 8 + g][kk * 16 + 8 + tig * 2]);
        mma_bf16_16816(s[j], qf[kk], b0, b1);
      }
    }
    if (k0 + kBk > Tk) {  // ragged last tile: keys >= Tk do not exist
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + j * 8 + tig * 2;
        if (col >= Tk) s[j][0] = s[j][2] = -INFINITY;
        if (col + 1 >= Tk) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // Online softmax in f32. Each row's 64 scores sit in the 4 threads of a
    // row group, so the row max is a 2-step shuffle among them. Every tile
    // holds at least one real key, so the new max is finite.
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= a0; o[j][1] *= a0;
      o[j][2] *= a1; o[j][3] *= a1;
      s[j][0] = __expf(s[j][0] - m0); s[j][1] = __expf(s[j][1] - m0);
      s[j][2] = __expf(s[j][2] - m1); s[j][3] = __expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V: 4 k-steps of 16 keys. The score accumulators of n-tiles 2t
    // and 2t+1 are exactly the A fragment of k-step t.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vs[t * 16 + (mi & 1) * 8 + rr][(2 * jp + (mi >> 1)) * 8]);
        mma_bf16_16816(o[2 * jp], a, r[0], r[1]);
        mma_bf16_16816(o[2 * jp + 1], a, r[2], r[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  const int row0 = q0 + ra, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (row0 < Tq) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * Tq + row0) * H + h) * kDh + col) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    }
    if (row1 < Tq) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * Tq + row1) * H + h) * kDh + col) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

}  // namespace

// q, k, v: bf16 [B, T, H, 64] with unit stride along Dh and the given
// element strides for B, T and H (multiples of 8, 16-byte aligned bases);
// out: contiguous bf16 [B, Tq, H, 64]. Returns cudaGetLastError() after the
// launch, so a refused launch reaches the caller.
extern "C" int wtt_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        int B, int H, int Tq, int Tk,
                                        long long q_sb, long long q_st, long long q_sh,
                                        long long k_sb, long long k_st, long long k_sh,
                                        long long v_sb, long long v_st, long long v_sh,
                                        void* stream) {
  const dim3 grid((Tq + kBq - 1) / kBq, B * H);
  flash_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Tq, Tk,
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}
