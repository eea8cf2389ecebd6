// Fused encoder self-attention for Hopper (sm_90a), bf16 in, bf16 out.
//
// Replaces the Pallas kernel whisper_tpu/kernels/attention.py:flash_attention
// (body _attn_kernel). Computes softmax(q k^T) v per (batch, head) over
// pre-scaled q, k in [B, T, H, Dh] layout, softmax in f32, P cast to bf16 for
// the PV product, f32 accumulation, bf16 output.
//
// What bounds it on an H100: operations. At large-v2 (T = 1500, H = 20,
// Dh = 64) one layer does 4 * 20 * 1500^2 * 64 = 11.5 GFLOP per lane on
// 11.5 MB of q/k/v/out, so the tensor cores, not the 3.35 TB/s of HBM, set
// the floor (11.6 us per lane at 989 TFLOP/s bf16). At Dh = 64 the softmax
// is as costly as the products: a 64 x 128 score tile takes as long in the
// SM's exp unit (16 a clock) as its two products take on the tensor cores.
//
// Design, the warp-specialised shape of a Hopper attention kernel:
//  - One block per (q tile, batch * head): consumer warpgroups of 64 q rows
//    each and one producer warp, one block per SM. Two shapes (Config):
//    Wide, two consumers (128 q rows, 288 threads) over 128-key tiles in a
//    3-stage ring (114 KB of shared memory, 156 registers); Deep, three
//    consumers (192 q rows, 416 threads) over 64-key tiles in a 4-stage ring
//    (90 KB, 111 registers). Deep keeps a third warpgroup's softmax and
//    products in flight on each SM and is the faster at B = 8; Wide is the
//    faster at B = 1, where Deep gives 160 blocks for 132 SMs (both shapes'
//    times: chip_smoke.py's [kernels] phase, PERF.md). The launch takes the
//    shape whose rounds of one block per SM cost less (use_deep).
//  - Wave quantization: at B = 1 Wide gives 12 x 20 = 240 blocks on 132
//    SMs, 1.82 waves (91 % of the second wave busy); 64-row blocks would
//    give 480 on 528 slots, the same 91 %, at twice the K/V traffic. At
//    B = 8 Deep gives 1280 blocks, 9.7 waves.
//  - The producer's one thread loads Q once and then K_j, V_j into the ring
//    by TMA (cp.async.bulk.tensor, 4-D maps over (Dh, H, T, B) that read the
//    strided q/k/v views in place, 128-byte swizzle: one Dh = 64 bf16 row is
//    128 B), with a full and an empty mbarrier per stage. TMA zero-fills rows
//    past T. The maps are encoded on the host on every call
//    (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so
//    nothing links -lcuda) and passed as __grid_constant__ parameters.
//  - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory, both
//    K-major (Dh contiguous), four k-steps over Dh. O += P V is wgmma
//    m64n64k16 with P from registers (the score accumulator re-packs into the
//    A fragment) and V in shared memory read through the transposed-B form
//    (keys are V's rows, not its contiguous axis), BK / 16 k-steps.
//  - In each consumer, S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
//    together; S_j's softmax runs while the tensor cores finish
//    P_{j-1} V_{j-1}; then stage j - 1 is released to the producer.
//  - Online softmax in f32 with exp2 (one FFMA + one ex2 a score), row max
//    and sum per accumulator row over the quad that holds it. Keys >= Tk in
//    the last tile are -inf; unnormalised P is rounded to bf16 for P.V and the
//    output is normalised at the end. Rows >= Tq are never written.
//  - A wait on an mbarrier that outlasts seconds traps, so a fault in the
//    pipeline fails the launch instead of hanging the card.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;  // head dim of every whisper model

// A block's shape: consumer warpgroups of 64 q rows each, keys per K/V tile,
// depth of the K/V ring. One producer warp besides.
template <int CONSUMERS, int BK, int STAGES>
struct Config {
  static constexpr int kConsumers = CONSUMERS;
  static constexpr int kBq = 64 * CONSUMERS;  // q rows per block
  static constexpr int kBk = BK;
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = 128 * CONSUMERS + 32;
  static constexpr uint32_t kTileBytes = BK * kDh * 2;
  static constexpr uint32_t kQBytes = kBq * kDh * 2;
  struct __align__(1024) Smem {  // every tile 1024-byte aligned, as the 128-byte swizzle needs
    __nv_bfloat16 q[kBq * kDh];
    __nv_bfloat16 k[STAGES][BK * kDh];
    __nv_bfloat16 v[STAGES][BK * kDh];
    uint64_t q_full;
    uint64_t full[STAGES];
    uint64_t empty[STAGES];
  };
  static constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // room to align the dynamic base
};
// Two shapes, both measured on the H100 (PERF.md): Wide fills the card's
// waves better where there are few blocks (B = 1); Deep keeps three
// warpgroups' softmax and products in flight on each SM where there are many.
using Wide = Config<2, 128, 3>;
using Deep = Config<3, 64, 4>;

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

// One box of the 4-D map at coordinates (dh, head, row, batch) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle TMA wrote: 8-row groups 1024 B apart (SBO), layout type 1 (B128).
// A K-major k-step of 16 elements advances the start by 32 B (+2), an
// MN-major k-step of 16 rows by 2048 B (+128).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // wait until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S[64 x 128] (+)= Q[64 x 16] K[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S[64 x 64] (+)= Q[64 x 16] K[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 64] += P[64 x 16] V[16 x 64]: P from registers, V MN-major in
// shared memory (transposed B).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one tile of BK keys: 4 k-steps of 16 over Dh.
template <int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wgmma_qk(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
}

// O += P V for one tile: 8 k-steps of 16 keys, P from registers.
template <int BK>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[BK / 4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
    wgmma_pv(o, pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3], v_desc + 128 * t);
}

// Online softmax of one score tile in place, keys from key0: sc[4 n + e] is
// key key0 + 8 n + 2 tig + (e & 1) of row g (e < 2) or g + 8. Keys >= Tk are
// -inf. Updates the running max and this thread's share of the running sum,
// and returns the factors (a0, a1) that rescale the rows' earlier output.
// Every tile holds a real key, so the new max is finite; on the first tile
// the old max is -inf and the factors are 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int key0, int Tk, int tig,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  constexpr float kLog2e = 1.4426950408889634f;
  if (key0 + BK > Tk) {  // ragged last tile: keys >= Tk do not exist
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int col = key0 + n * 8 + tig * 2;
      if (col >= Tk) sc[4 * n] = sc[4 * n + 2] = -INFINITY;
      if (col + 1 >= Tk) sc[4 * n + 1] = sc[4 * n + 3] = -INFINITY;
    }
  }
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    t0 = fmaxf(t0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    t1 = fmaxf(t1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
  t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
  t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
  const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
  a0 = ex2((m0 - mn0) * kLog2e);
  a1 = ex2((m1 - mn1) * kLog2e);
  m0 = mn0;
  m1 = mn1;
  const float mb0 = mn0 * kLog2e, mb1 = mn1 * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    sc[4 * n] = ex2(fmaf(sc[4 * n], kLog2e, -mb0));
    sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], kLog2e, -mb0));
    sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], kLog2e, -mb1));
    sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], kLog2e, -mb1));
    s0 += sc[4 * n] + sc[4 * n + 1];
    s1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
}

// The score accumulators of key blocks 2t and 2t + 1, rounded to bf16, are
// exactly the A fragment of P.V's k-step t.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    pa[4 * t] = pack_bf16(sc[8 * t], sc[8 * t + 1]);
    pa[4 * t + 1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
    pa[4 * t + 2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
    pa[4 * t + 3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
  }
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                       int H, int Tq, int Tk) {
  constexpr int kConsumers = Cfg::kConsumers, kBq = Cfg::kBq, kBk = Cfg::kBk;
  constexpr int kStages = Cfg::kStages;
  using Smem = typename Cfg::Smem;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBq;
  const int n_tiles = (Tk + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // Producer warp: one thread keeps the ring's loads in flight.
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(&sm.q_full, Cfg::kQBytes);
      tma_load(sm.q, &q_map, &sm.q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&sm.empty[s], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * Cfg::kTileBytes);
        tma_load(sm.k[s], &k_map, &sm.full[s], h, j * kBk, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h, j * kBk, b);
      }
    }
    return;
  }

  // Consumer warpgroup wg: q rows [q0 + 64 wg, q0 + 64 wg + 64). Thread
  // (warp, g, tig) holds rows 16 warp + g and 16 warp + g + 8 of them.
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint64_t q_desc = sw128_desc(sm.q + wg * 64 * kDh);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float a0, a1;
  float sc[kBk / 2];
  uint32_t pa[kBk / 4];

  // Tile 0: S_0, its softmax and P_0.
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  issue_qk<kBk>(sc, q_desc, sw128_desc(sm.k[0]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<kBk>(sc, 0, Tk, tig, m0, m1, l0, l1, a0, a1);
  pack_p<kBk>(pa, sc);

  // Tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} go out together; S_j's
  // softmax runs while the tensor cores still work on P_{j-1} V_{j-1}. Then
  // stage j-1 is freed, O is rescaled to S_j's max and P_j packed.
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    fence_regs(o);
    wgmma_fence();
    issue_qk<kBk>(sc, q_desc, sw128_desc(sm.k[s]));
    wgmma_commit();
    issue_pv<kBk>(o, pa, sw128_desc(sm.v[sp]));
    wgmma_commit();
    wgmma_wait<1>();  // S_j is done
    fence_regs(sc);
    softmax_tile<kBk>(sc, j * kBk, Tk, tig, m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} is done
    fence_regs(o);
    mbar_arrive(&sm.empty[sp]);  // this thread is done with stage j - 1
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      o[4 * n] *= a0;
      o[4 * n + 1] *= a0;
      o[4 * n + 2] *= a1;
      o[4 * n + 3] *= a1;
    }
    pack_p<kBk>(pa, sc);
  }
  fence_regs(o);
  wgmma_fence();
  issue_pv<kBk>(o, pa, sw128_desc(sm.v[(n_tiles - 1) % kStages]));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  const int row0 = q0 + wg * 64 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < Tq) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * Tq + row0) * H + h) * kDh + col) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    }
    if (row1 < Tq) {
      *reinterpret_cast<uint32_t*>(out + (((long long)b * Tq + row1) * H + h) * kDh + col) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
EncodeTiled encode_tiled() {
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

// A 4-D map over one [B, T, H, 64] bf16 view, dims (Dh, H, T, B) innermost
// first, element strides given for B, T and H; box (64, 1, rows, 1).
CUresult encode_map(EncodeTiled enc, CUtensorMap* map, const void* base, int B, int T, int H,
                    long long sb, long long st, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kDh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kDh, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <class Cfg>
int launch(EncodeTiled enc, const void* q, const void* k, const void* v, void* out, int B, int H,
           int Tq, int Tk, const long long (&st)[9], cudaStream_t stream) {
  CUtensorMap maps[3];
  CUresult r = encode_map(enc, &maps[0], q, B, Tq, H, st[0], st[1], st[2], Cfg::kBq);
  if (r == CUDA_SUCCESS) r = encode_map(enc, &maps[1], k, B, Tk, H, st[3], st[4], st[5], Cfg::kBk);
  if (r == CUDA_SUCCESS) r = encode_map(enc, &maps[2], v, B, Tk, H, st[6], st[7], st[8], Cfg::kBk);
  if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  // per device, so on every launch
  const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<Cfg>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(Cfg::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + Cfg::kBq - 1) / Cfg::kBq, B * H);
  flash_attention_kernel<Cfg><<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), H, Tq, Tk);
  return static_cast<int>(cudaGetLastError());
}

// Deep where its rounds of one block per SM cost less than Wide's. A Deep
// round (192 q rows) costs about 1.4 Wide rounds (128 rows) on the H100
// (PERF.md), so B = 1 (160 Deep blocks, 2 rounds, against 240 Wide, 2
// rounds) takes Wide, and B = 8 (1280 Deep blocks, 10 rounds, against 1920
// Wide, 15) takes Deep.
bool use_deep(int B, int H, int Tq) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = (long long)B * H;
  const long long deep = ((Tq + Deep::kBq - 1) / Deep::kBq * rows + sms - 1) / sms;
  const long long wide = ((Tq + Wide::kBq - 1) / Wide::kBq * rows + sms - 1) / sms;
  return deep * 14 < wide * 10;
}

}  // namespace

// q, k, v: bf16 [B, T, H, 64] with unit stride along Dh and the given
// element strides for B, T and H (multiples of 8, i.e. of 16 bytes; 16-byte
// aligned bases), as TMA reads them; out: contiguous bf16 [B, Tq, H, 64];
// shape: 0 lets use_deep choose, 1 is Wide, 2 is Deep. Returns cudaGetLastError() after the launch, so a refused launch reaches
// the caller; 10000 + the CUresult when a tensor map cannot be encoded, and
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled.
extern "C" int wtt_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        int B, int H, int Tq, int Tk,
                                        long long q_sb, long long q_st, long long q_sh,
                                        long long k_sb, long long k_st, long long k_sh,
                                        long long v_sb, long long v_st, long long v_sh,
                                        int shape, void* stream) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return static_cast<int>(cudaErrorNotSupported);
  if (shape < 0 || shape > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool deep = shape == 0 ? use_deep(B, H, Tq) : shape == 2;
  return deep ? launch<Deep>(enc, q, k, v, out, B, H, Tq, Tk, st, s)
              : launch<Wide>(enc, q, k, v, out, B, H, Tq, Tk, st, s);
}
