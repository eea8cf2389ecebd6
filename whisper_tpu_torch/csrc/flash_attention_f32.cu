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
// 0.009 ms for the bytes. So the design keeps the FMA pipes fed:
//
//  - Register tiles with broadcast shared-memory reads. A block holds 256
//    q rows: 8 warps of 32 rows. Lane (rg, kg) = (lane / 8, lane % 8) of a
//    warp owns rows rg + 4r (r < 8) of the warp's 32 and, for S = Q K^T,
//    keys kg + 8i (i < 8) of each 64-key tile: an 8 x 8 tile of scores in
//    registers. Per 4 d's it reads its 8 rows of Q and 8 keys of K as
//    float4 (16 LDS.128) for 256 FMAs. The warp's Q reads touch 4 distinct
//    rows and its K reads 8 distinct keys, and rows are padded to 68 floats
//    so each read is one wavefront: 4 FMAs a wavefront.
//  - P.V from the same rows: the lane owns columns 4kg..4kg+3 and
//    32+4kg..32+4kg+3 of its 8 rows. P goes through a per-warp buffer in
//    two halves of 32 keys, written with keys permuted so that a lane's 4
//    keys of a half are contiguous (one STS.128 a row); per 4 keys a lane
//    reads 8 float4 of P (4 distinct addresses, broadcast) and 8 float4 of
//    V (one 128-byte row segment): again 16 LDS.128 for 256 FMAs.
//  - An asynchronous K/V ring of 3 stages of 64-key tiles, filled by every
//    thread's 16-byte cp.async (.cg), rows at or past T zero-filled; each
//    stage has a full mbarrier (each thread arrives as its copies land) and
//    an empty one (each thread arrives when it is done with the stage).
//    After tile j a thread refills the stage of tile j - 1 with tile j + 2,
//    so its wait for the other warps to release that stage is a tile old,
//    tile j + 2 loads while tile j + 1 is computed, and no block-wide
//    barrier is taken per tile. The wrapper asks for 16-byte aligned bases
//    and strides. (A separate producer warp would make 9 warps, 3 of them
//    on one SM sub-partition, which caps every thread at 168 registers.)
//  - Online softmax in f32 with log2(e) folded in: the running max is kept
//    in log2 units, each score costs one FFMA and one ex2.approx (~2 ulp),
//    keys >= Tk of the last tile are -inf; row maxima by 3 shuffles over
//    the 8 lanes of a row group, row sums kept per lane and reduced once at
//    the end, where the output is scaled by 1/l. Rows >= Tq are never
//    written.
//  - Filling the card: 207,928 B of shared memory and 256 threads of up to
//    255 registers a block give one block per SM; T = 1500 makes 6 q tiles
//    of 256 rows, so large-v2 at B = 1 is 120 blocks, one round on the 132
//    SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;                 // head dim of every whisper model
constexpr int kBk = 64;                 // keys per K/V tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kWarps = 8;
constexpr int kWarpRows = 32;           // q rows per warp
constexpr int kBq = kWarps * kWarpRows; // q rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kPad = kDh + 4;           // Q and K row stride in floats
constexpr int kHalf = kBk / 2;          // keys per pass of P through shared memory
constexpr int kPPad = kHalf + 4;        // P row stride in floats
constexpr int kR = 8;                   // q rows per lane
constexpr int kC = 8;                   // keys (S) and columns (P.V) per lane
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  float q[kBq][kPad];
  float k[kStages][kBk][kPad];
  float v[kStages][kBk][kDh];
  float p[kWarps][kWarpRows][kPPad];  // P'[row][4a + t] = P[row][32 * half + a + 8t]
  uint64_t q_full, full[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity. A
// wait that outlasts ~2^24 suspended tries (seconds; a real one takes
// microseconds) traps, so a broken pipeline fails the launch instead of
// hanging the card.
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

// Rows [t0, t0 + ROWS) of one (batch, head) slice into a [ROWS][stride]
// tile by every thread's 16-byte cp.async: 16 threads a 256-byte row, 16
// rows a step; rows at or past T are zero.
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, int stride, const float* src, long long st,
                                          int t0, int T) {
  const int c = threadIdx.x % 16;
  const uint32_t d0 = smem_u32(dst) + 16 * c;
#pragma unroll
  for (int it = 0; it < ROWS / (kThreads / 16); ++it) {
    const int r = threadIdx.x / 16 + it * (kThreads / 16);
    const bool in = t0 + r < T;
    const float* p = in ? src + (t0 + r) * st + 4 * c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d0 + r * stride * 4), "l"(p),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
}

// The barrier counts this thread's arrival once all its earlier cp.async
// copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads, 1)
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
  const int n_tiles = (Tk + kBk - 1) / kBk;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, kThreads);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], kThreads);
      mbar_init(&s.empty[st], kThreads);
    }
  }
  __syncthreads();

  // Q once, then the ring's first stages
  copy_rows<kBq>(&s.q[0][0], kPad, q + b * q_sb + h * q_sh, q_st, q0, Tq);
  cp_async_arrive(&s.q_full);
  for (int j = 0; j < kStages && j < n_tiles; ++j) {
    copy_rows<kBk>(&s.k[j][0][0], kPad, kb, k_st, j * kBk, Tk);
    copy_rows<kBk>(&s.v[j][0][0], kDh, vb, v_st, j * kBk, Tk);
    cp_async_arrive(&s.full[j]);
  }

  const int rg = lane >> 3, kg = lane & 7;
  const float* qr = &s.q[warp * kWarpRows + rg][0];  // row rg + 4r at qr + 4r * kPad
  float* pw = &s.p[warp][rg][0];                      // the warp's P', row rg + 4r

  float o[kR][kC], m[kR], l[kR];  // m in log2 units; l this lane's keys only
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) o[r][c] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  mbar_wait(&s.q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&s.full[st], (j / kStages) & 1);

    // S = Q K^T for rows rg + 4r and keys kg + 8i
    float sc[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < kC; ++i) sc[r][i] = 0.f;
    const float* kt = &s.k[st][kg][0];
#pragma unroll 2
    for (int d = 0; d < kDh; d += 4) {
      float4 kf[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) kf[i] = *reinterpret_cast<const float4*>(kt + 8 * i * kPad + d);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 qf = *reinterpret_cast<const float4*>(qr + 4 * r * kPad + d);
#pragma unroll
        for (int i = 0; i < kC; ++i)
          sc[r][i] = fmaf(qf.w, kf[i].w, fmaf(qf.z, kf[i].z, fmaf(qf.y, kf[i].y,
                                                                  fmaf(qf.x, kf[i].x, sc[r][i]))));
      }
    }

    // online softmax; key j * 64 < Tk is in every tile, so each row's max is finite
    const int n_valid = Tk - j * kBk;
    if (n_valid < kBk) {
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (kg + 8 * i >= n_valid)
#pragma unroll
          for (int r = 0; r < kR; ++r) sc[r][i] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float mx = sc[r][0];
#pragma unroll
      for (int i = 1; i < kC; ++i) mx = fmaxf(mx, sc[r][i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx * kLog2e);
      const float alpha = ex2(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        sc[r][i] = ex2(fmaf(sc[r][i], kLog2e, -m_new));
        sum += sc[r][i];
      }
      l[r] = fmaf(l[r], alpha, sum);
#pragma unroll
      for (int c = 0; c < kC; ++c) o[r][c] *= alpha;
    }

    // O += P V, keys [32 * half, 32 * half + 32): the lane's keys kg + 8t of
    // the half at P'[row][4kg + t]; P'[row][4u + t] is key 32 * half + u + 8t
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        *reinterpret_cast<float4*>(pw + 4 * r * kPPad + 4 * kg) =
            make_float4(sc[r][4 * half], sc[r][4 * half + 1], sc[r][4 * half + 2], sc[r][4 * half + 3]);
      __syncwarp();
      const float* vt = &s.v[st][kHalf * half][4 * kg];
#pragma unroll 2
      for (int u = 0; u < kHalf / 4; ++u) {
        float4 v0[4], v1[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v0[t] = *reinterpret_cast<const float4*>(vt + (u + 8 * t) * kDh);
          v1[t] = *reinterpret_cast<const float4*>(vt + (u + 8 * t) * kDh + 32);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float4 pf = *reinterpret_cast<const float4*>(pw + 4 * r * kPPad + 4 * u);
          o[r][0] = fmaf(pf.w, v0[3].x, fmaf(pf.z, v0[2].x, fmaf(pf.y, v0[1].x, fmaf(pf.x, v0[0].x, o[r][0]))));
          o[r][1] = fmaf(pf.w, v0[3].y, fmaf(pf.z, v0[2].y, fmaf(pf.y, v0[1].y, fmaf(pf.x, v0[0].y, o[r][1]))));
          o[r][2] = fmaf(pf.w, v0[3].z, fmaf(pf.z, v0[2].z, fmaf(pf.y, v0[1].z, fmaf(pf.x, v0[0].z, o[r][2]))));
          o[r][3] = fmaf(pf.w, v0[3].w, fmaf(pf.z, v0[2].w, fmaf(pf.y, v0[1].w, fmaf(pf.x, v0[0].w, o[r][3]))));
          o[r][4] = fmaf(pf.w, v1[3].x, fmaf(pf.z, v1[2].x, fmaf(pf.y, v1[1].x, fmaf(pf.x, v1[0].x, o[r][4]))));
          o[r][5] = fmaf(pf.w, v1[3].y, fmaf(pf.z, v1[2].y, fmaf(pf.y, v1[1].y, fmaf(pf.x, v1[0].y, o[r][5]))));
          o[r][6] = fmaf(pf.w, v1[3].z, fmaf(pf.z, v1[2].z, fmaf(pf.y, v1[1].z, fmaf(pf.x, v1[0].z, o[r][6]))));
          o[r][7] = fmaf(pf.w, v1[3].w, fmaf(pf.z, v1[2].w, fmaf(pf.y, v1[1].w, fmaf(pf.x, v1[0].w, o[r][7]))));
        }
      }
      __syncwarp();  // P' is rewritten next
    }
    mbar_arrive(&s.empty[st]);

    // refill the stage of tile j - 1, released by every thread a tile ago
    // unless a warp lags, with tile j + 2
    if (j >= 1 && j + 2 < n_tiles) {
      const int ps = (j + 2) % kStages;
      mbar_wait(&s.empty[ps], ((j - 1) / kStages) & 1);
      copy_rows<kBk>(&s.k[ps][0][0], kPad, kb, k_st, (j + 2) * kBk, Tk);
      copy_rows<kBk>(&s.v[ps][0][0], kDh, vb, v_st, (j + 2) * kBk, Tk);
      cp_async_arrive(&s.full[ps]);
    }
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const int row = q0 + warp * kWarpRows + rg + 4 * r;
    if (row < Tq) {
      const float inv = 1.f / lr;
      float* op = out + ((long long)(b * Tq + row) * H + h) * kDh + 4 * kg;
      *reinterpret_cast<float4*>(op) =
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
      *reinterpret_cast<float4*>(op + 32) =
          make_float4(o[r][4] * inv, o[r][5] * inv, o[r][6] * inv, o[r][7] * inv);
    }
  }
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(flash_attention_f32_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
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
  const cudaError_t err = allow_smem();  // above the 48 KB static limit
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBq - 1) / kBq, B * H);
  flash_attention_f32_kernel<<<grid, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry: q rows and threads a block, dynamic shared memory,
// and how many blocks the current card holds on one SM.
extern "C" int wtt_flash_attention_f32_geometry(int* rows_per_block, int* threads, int* smem_bytes,
                                                int* blocks_per_sm) {
  *rows_per_block = kBq;
  *threads = kThreads;
  *smem_bytes = static_cast<int>(sizeof(Smem));
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_attention_f32_kernel, kThreads, sizeof(Smem)));
}
