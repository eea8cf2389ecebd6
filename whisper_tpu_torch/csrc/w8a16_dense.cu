// W8A16 dense for Hopper (sm_90a): y[M, N] = (x[M, K] @ W[K, N]) * s[N] + b[N]
// for a few rows of bf16 x (M <= 64) and int8 weight codes W with one f32
// scale per output column.
//
// Replaces no TPU kernel. The JAX package left this product to XLA, which
// fuses the int8 -> bf16 conversion of W into the matmul. The port's dense
// (model/layers.py) instead wrote a bf16 copy of W on every call (1 byte
// read and 2 written a weight), read the copy back in a cuBLAS GEMM, then
// scaled and added the bias in two more passes: four launches and 5 bytes a
// weight. This kernel is that product for the decoder's token steps (M =
// lanes, or lanes x beams): the serving tier's int8 weights are read once and
// converted in registers, and the scale and bias are applied in the same
// launch.
//
// Layouts: NN, W contiguous [K, N] (the blocks' [in, out], out contiguous);
// NT, W the transpose of a contiguous [N, K] (the token table [V, d], read
// as tok.T by the logits). s: f32 [N]; b: f32 [N] or null. With s null the
// kernel writes the raw product (tensor parallelism's row-parallel calls sum
// it over the ranks before the scale).
//
// Arithmetic: each code becomes its exact bf16 value (every integer in
// [-128, 127] is exact in bf16); bf16 x bf16 products are summed in f32 on
// the tensor cores (mma.sync m16n8k16); then y = acc * s, rounded, then + b,
// rounded: the steps of the plain version (kernels/w8a16.py), with the f32
// sums taken in another order.
//
// What bounds it on an H100: bytes. At M = 8 it does 16 flops a weight byte,
// far below the ~295 at which the tensor cores would bound it. A large-v2
// token step reads 800 MB of int8 weights in 193 calls (a layer's qkv 4.9
// MB; o, xq, xo 1.6 MB each; fc1, fc2 6.6 MB each; the table 66.4 MB): 0.24 ms
// at 3.35 TB/s. A layer's matrix reads in 0.5-2 us, so what a launch costs
// besides its bytes (its start, the first round trip to memory, the
// reduction) matters as much as the bytes.
//
// Design.
//  - Swapped operands: the weight tile is the MMA's 16-row A operand (its
//    rows are output columns n), the batch the 8-wide B operand, so M = 1..8
//    fills one B tile and up to 64 rows take MT = 2, 4 or 8 of them.
//  - No shared memory on the way in: each thread loads its weight bytes
//    straight into registers and builds the A fragments there. The MMA's k is
//    a summed index, so A and B may permute it alike: a thread's four k slots
//    of a 16-deep step (2t, 2t+1, 2t+8, 2t+9) are four consecutive k (4t..4t+3
//    of the step). On NT a thread's A word is then 4 consecutive codes of one
//    row. On NN, whose rows run along n, the output rows are permuted as well:
//    thread group g's rows of the warp's T tiles are 2T consecutive n, so one
//    load of 2T bytes of a k row feeds every tile, and the byte permute that
//    makes each code a float also transposes. x's B fragment is 4 consecutive
//    bf16 of a row: one 8-byte load (from L2; x is shared by every block).
//  - Codes to bf16: K8's byte permute into the mantissa of 2^23 and one
//    subtract give the code as an f32 integer, whose upper half is its bf16
//    (a second byte permute packs two): 2.75 integer and float operations a
//    weight, about a third of the time its byte takes to arrive.
//  - A chunk is 4 KB of weights a warp, 32 words a thread, 16 MMA tile-steps:
//    T = 4 tiles (64 n) x 64 k where M <= 32, T = 2 tiles (32 n) x 128 k where
//    M <= 64 and the accumulators of 8 batch tiles need the registers. Where
//    M <= 16, x's fragments of a chunk are loaded with its weights into
//    registers (else a step's before its MMAs). A warp of K = 5,120 takes 2-3
//    chunks one after another: a second register buffer, to keep two in
//    flight, took 0.3 us off fc2's 8.7, a fraction of a percent of a step.
//  - Split K over a thread-block cluster: N = 1,280 gives only 20 column tiles
//    of 64, far too few for 132 SMs. C blocks of 4 warps (C = min(8, ceil(K
//    chunks / 4)), kernels/w8a16.py's w8a16_geometry) share a column tile and
//    split its chunks evenly: at large-v2, C = 5 and one chunk a warp for K =
//    1,280 (100-400 blocks, all of a matrix in flight at once), C = 8 and 2-3
//    chunks for K = 5,120, and 4,055 blocks of one chunk a warp for the table.
//    A block first adds its 4 warps' tiles in shared memory; each block then
//    sends its sums through distributed shared memory to the block that owns
//    them (unit u to rank u % C); after one cluster barrier each owner adds
//    the C blocks' sums in a fixed order and applies the scale and the bias:
//    one launch, no atomics, no second pass, and the same result on every run.
//  - Programmatic dependent launch: the weights and the scales depend on no
//    earlier kernel, so a block issues its first chunk's loads and the
//    epilogue's scale and bias loads before griddepcontrol.wait, and reads x
//    and writes y only after it (0.2 us a call).
//  - A ragged N or K, or a base or row stride off the load width, takes byte
//    loads in the chunks that need them; rows of x past M and k past K read as
//    zeros, and batch tiles past M are not multiplied.
//  - Measured at large-v2's shapes, M = 8 (H100 SXM, 700 W; PERF.md): 3.8-4.3
//    us a call for the 1.6 MB products, 6-7 for the 4.9-6.6 MB ones at K =
//    1,280, 8.7 for fc2, 37 for the table. A call costs ~4 us before its bytes:
//    its start, one round trip to memory and the cluster's reduction (~1.3
//    us; a reduction by st.async into an mbarrier instead of the cluster
//    barrier was no faster). Tried and slower: 8 and 16 warps a block, 128-
//    wide NN tiles (16-byte loads of a k row), 16-row NT tiles that read 256
//    bytes of a row a chunk, one block (no cluster) over the whole K.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;
constexpr int kMaxRows = 64;
constexpr int kWords = 32;  // weight words a thread holds per chunk

// An instantiation's geometry (MT batch tiles of 8 rows): T 16-row MMA tiles
// a warp, so a column tile WN = 16 T wide; chunks of KC = 256 / T rows of k
// in S = KC / 16 MMA steps; NN loads NW = 2 T bytes of a k row a thread, NT
// L 16-byte pieces of a row a chunk.
template <bool NT, int MT>
struct Geo {
  static constexpr int T = MT <= 4 ? 4 : 2;
  static constexpr int WN = 16 * T;
  static constexpr int KC = 256 / T;
  static constexpr int S = KC / 16;
  static constexpr int NW = 2 * T;
  static constexpr int L = 4 / T;
  static constexpr int kUnits = T * MT;  // accumulator tiles (16 n x 8 rows) a warp
};

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* w;         // NN: [K, N]; NT: [N, K]
  const float* s;          // [N], or null: the raw product
  const float* b;          // [N] or null
  float* y;                // [M, N]
  int M, N, K;
  int x_vec;               // x 8-byte aligned and K % 4 == 0
  int w_vec;               // W's base and rows aligned to the load width
};

template <int NB>
__device__ __forceinline__ void ldg_stream(uint32_t* r, const int8_t* p);
template <>
__device__ __forceinline__ void ldg_stream<16>(uint32_t* r, const int8_t* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "l"(p));
}
template <>
__device__ __forceinline__ void ldg_stream<8>(uint32_t* r, const int8_t* p) {
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "l"(p));
}
template <>
__device__ __forceinline__ void ldg_stream<4>(uint32_t* r, const int8_t* p) {
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r[0]) : "l"(p));
}

__device__ __forceinline__ float ldg_f32(const float* p) {
  float r;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

template <int NB>
struct Words {
  uint32_t w[NB / 4];
};

// NB bytes from p of which the first `valid` exist (none where valid <= 0),
// byte by byte; the rest read as zero codes. Not inlined: the edges of a
// ragged or unaligned matrix are rare, and one copy a width keeps the
// kernels' code (and their build) small.
template <int NB>
__device__ __noinline__ Words<NB> ldg_edge_words(const int8_t* p, int valid) {
  Words<NB> r;
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) r.w[i] = 0u;
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (i < valid)
      r.w[i / 4] |= static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned char*>(p + i)))
                    << (8 * (i % 4));
  return r;
}

template <int NB>
__device__ __forceinline__ void ldg_edge(uint32_t* r, const int8_t* p, int valid) {
  const Words<NB> v = ldg_edge_words<NB>(p, valid);
#pragma unroll
  for (int i = 0; i < NB / 4; ++i) r[i] = v.w[i];
}

// Chunk c's weight words of this thread (thread group g, thread t of it) in
// the column tile from n0. NN: words [(j * 4 + i) * NW / 4, +NW / 4) hold
// bytes [n0 + NW g, +NW) of k row c KC + 16 j + 4 t + i. NT: words
// [((r * 2 + h) * L + l) * 4, +4) hold bytes [c KC + 64 l + 16 t, +16) of row
// n0 + 16 r + 8 h + g.
template <bool NT, int MT>
__device__ __forceinline__ void load_chunk(uint32_t (&raw)[kWords], const Args& a, int c, int n0,
                                           int g, int t) {
  using G = Geo<NT, MT>;
  const int kc = c * G::KC;
  if constexpr (NT) {
    const bool full = a.w_vec && kc + G::KC <= a.K;
#pragma unroll
    for (int r = 0; r < G::T; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 16 * r + 8 * h + g;
#pragma unroll
        for (int l = 0; l < G::L; ++l) {
          const int k = kc + 64 * l + 16 * t;
          uint32_t* dst = raw + ((r * 2 + h) * G::L + l) * 4;
          const int8_t* p = a.w + static_cast<long long>(n) * a.K + k;
          if (full && n < a.N)
            ldg_stream<16>(dst, p);
          else
            ldg_edge<16>(dst, p, n < a.N ? a.K - k : 0);
        }
      }
  } else {
    const int n = n0 + G::NW * g;
    const bool full = a.w_vec && kc + G::KC <= a.K && n + G::NW <= a.N;
#pragma unroll
    for (int j = 0; j < G::S; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kc + 16 * j + 4 * t + i;
        uint32_t* dst = raw + (j * 4 + i) * (G::NW / 4);
        const int8_t* p = a.w + static_cast<long long>(k) * a.N + n;
        if (full)
          ldg_stream<G::NW>(dst, p);
        else
          ldg_edge<G::NW>(dst, p, k < a.K ? a.N - n : 0);
      }
  }
}

// Byte e of a biased word (codes + 128) as the f32 integer code, exact.
__device__ __forceinline__ float code_f32(uint32_t biased, int e) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650u | e)) - 8388736.f;
}

// Two f32 integers in [-128, 127] as bf16x2 (lo in the low half): their
// upper halves, exactly.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// x[m, k0..k0 + 3] as bf16x2 pairs (zeros past M or K).
__device__ __forceinline__ uint2 load_x(const Args& a, int m, int k0) {
  if (m >= a.M) return make_uint2(0u, 0u);
  const __nv_bfloat16* p = a.x + static_cast<long long>(m) * a.K + k0;
  if (a.x_vec && k0 + 4 <= a.K) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = k0 + i < a.K ? __ldg(reinterpret_cast<const unsigned short*>(p) + i) : 0u;
  return make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x's B fragments of a chunk's steps are held in registers, loaded with the
// chunk's weights, where they take at most 8 (M <= 16); else each step loads
// its own.
template <bool NT, int MT>
struct XFrag {
  static constexpr bool kHeld = Geo<NT, MT>::S * MT <= 8;
  uint2 v[kHeld ? Geo<NT, MT>::S : 1][MT];
};

// x[8 q + g, k0..k0 + 3] of step j of chunk c, each batch tile q.
template <bool NT, int MT>
__device__ __forceinline__ void load_step_x(uint2 (&v)[MT], const Args& a, int c, int j, int g,
                                            int t) {
  using G = Geo<NT, MT>;
  const int kc = c * G::KC;
  const int k0 = NT ? kc + 64 * (j / 4) + 16 * t + 4 * (j % 4) : kc + 16 * j + 4 * t;
#pragma unroll
  for (int q = 0; q < MT; ++q) v[q] = load_x(a, 8 * q + g, k0);
}

template <bool NT, int MT>
__device__ __forceinline__ void load_chunk_x(XFrag<NT, MT>& xf, const Args& a, int c, int g,
                                             int t) {
  if constexpr (XFrag<NT, MT>::kHeld) {
#pragma unroll
    for (int j = 0; j < Geo<NT, MT>::S; ++j) load_step_x<NT, MT>(xf.v[j], a, c, j, g, t);
  }
}

// The chunk's MMAs into acc[tile][batch tile]: A from the thread's words
// (load_chunk's layout), B from x at the same permuted k.
template <bool NT, int MT>
__device__ __forceinline__ void mma_chunk(const uint32_t (&raw)[kWords], const XFrag<NT, MT>& xf,
                                          float (&acc)[Geo<NT, MT>::T][MT][4], const Args& a, int c,
                                          int g, int t) {
  using G = Geo<NT, MT>;
#pragma unroll
  for (int j = 0; j < G::S; ++j) {
    uint2 bf[MT];
    if constexpr (XFrag<NT, MT>::kHeld) {
#pragma unroll
      for (int q = 0; q < MT; ++q) bf[q] = xf.v[j][q];
    } else {
      load_step_x<NT, MT>(bf, a, c, j, g, t);
    }
#pragma unroll
    for (int r = 0; r < G::T; ++r) {
      uint32_t A[4];
      if constexpr (NT) {
        const int l = j / 4, wd = j % 4;
        const uint32_t lo = raw[(r * 2 * G::L + l) * 4 + wd] ^ 0x80808080u;
        const uint32_t hi = raw[((r * 2 + 1) * G::L + l) * 4 + wd] ^ 0x80808080u;
        A[0] = pack_bf16(code_f32(lo, 0), code_f32(lo, 1));
        A[1] = pack_bf16(code_f32(hi, 0), code_f32(hi, 1));
        A[2] = pack_bf16(code_f32(lo, 2), code_f32(lo, 3));
        A[3] = pack_bf16(code_f32(hi, 2), code_f32(hi, 3));
      } else {
        const int e = 2 * (r % 2);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = raw[(j * 4 + i) * (G::NW / 4) + r / 2] ^ 0x80808080u;
        A[0] = pack_bf16(code_f32(w[0], e), code_f32(w[1], e));
        A[1] = pack_bf16(code_f32(w[0], e + 1), code_f32(w[1], e + 1));
        A[2] = pack_bf16(code_f32(w[2], e), code_f32(w[3], e));
        A[3] = pack_bf16(code_f32(w[2], e + 1), code_f32(w[3], e + 1));
      }
#pragma unroll
      for (int q = 0; q < MT; ++q)
        if (8 * q < a.M) mma_bf16(acc[r][q], A, bf[q].x, bf[q].y);
    }
  }
}

// Output (u, i) of a column tile from n0: value i (0..127: lane i / 4, its
// i % 4-th accumulator) of unit u (tile u / MT, batch tile u % MT), where m
// >= M or n >= N drop it; else y = v * s + b, rounded twice, or the raw v.
template <bool NT, int MT>
__device__ __forceinline__ void store_out(const Args& a, const float (&sb)[2][Geo<NT, MT>::WN],
                                          int n0, int u, int i, float v) {
  using G = Geo<NT, MT>;
  const int ln = i >> 2, e = i & 3, r = u / MT, q = u % MT;
  const int m = 8 * q + 2 * (ln & 3) + (e & 1), hi = e >> 1, g = ln >> 2;
  const int n = NT ? n0 + 16 * r + 8 * hi + g : n0 + G::NW * g + 2 * r + hi;
  if (m >= a.M || n >= a.N) return;
  if (a.s) {
    v = __fmul_rn(v, sb[0][n - n0]);
    if (a.b) v = __fadd_rn(v, sb[1][n - n0]);
  }
  a.y[static_cast<long long>(m) * a.N + n] = v;
}

// Grid: (column tiles x C), clusters of C blocks along x; dynamic shared
// memory: (kWarps units + C ceil(units / C)) x 32 float4 (the warps' units,
// then the cluster's blocks' sums of the units this block owns).
template <bool NT, int MT>
__global__ void __launch_bounds__(kThreads) w8a16_dense_kernel(const Args a) {
  using G = Geo<NT, MT>;
  extern __shared__ float4 part[];   // [warp][unit][lane], then from[block][unit owned][lane]
  __shared__ float sb_s[2][G::WN];  // the column tile's scales and biases
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // a block stores into its peers' shared memory only once all are running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = static_cast<int>(blockIdx.x) / C * G::WN;
  const int gw = rank * kWarps + warp, n_warps = C * kWarps;
  const int n_chunks = (a.K + G::KC - 1) / G::KC;
  const int c_lo = gw * n_chunks / n_warps, c_hi = (gw + 1) * n_chunks / n_warps;

  float acc[G::T][MT][4];
#pragma unroll
  for (int r = 0; r < G::T; ++r)
#pragma unroll
    for (int q = 0; q < MT; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][q][i] = 0.f;
  uint32_t raw[kWords];
  XFrag<NT, MT> xf;
  if (c_lo < c_hi) load_chunk<NT, MT>(raw, a, c_lo, n0, g, t);
  // the epilogue's scales and biases, fetched while the weights are in flight
  // (into registers: a store to shared memory here would wait for them)
  float sv = 0.f, bv = 0.f;
  if (a.s && tid < G::WN && n0 + tid < a.N) {
    sv = ldg_f32(a.s + n0 + tid);
    if (a.b) bv = ldg_f32(a.b + n0 + tid);
  }
  // x is the previous kernel's output (under programmatic dependent launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (c_lo < c_hi) load_chunk_x<NT, MT>(xf, a, c_lo, g, t);
  for (int c = c_lo; c < c_hi; ++c) {
    mma_chunk<NT, MT>(raw, xf, acc, a, c, g, t);
    if (c + 1 < c_hi) {
      load_chunk<NT, MT>(raw, a, c + 1, n0, g, t);
      load_chunk_x<NT, MT>(xf, a, c + 1, g, t);
    }
  }

  // --- the split-K sum: the block's warps in shared memory, then the cluster's blocks ---
#pragma unroll
  for (int r = 0; r < G::T; ++r)
#pragma unroll
    for (int q = 0; q < MT; ++q)
      if (8 * q < a.M)
        part[(warp * G::kUnits + r * MT + q) * 32 + lane] =
            make_float4(acc[r][q][0], acc[r][q][1], acc[r][q][2], acc[r][q][3]);
  if (tid < G::WN) {
    sb_s[0][tid] = sv;
    sb_s[1][tid] = bv;
  }
  __syncthreads();
  float4* from = part + kWarps * G::kUnits * 32;
  const int per_rank = (G::kUnits + C - 1) / C;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // warp w adds the warps' units w, w + kWarps, ... and sends each to its owner
  for (int u = warp; u < G::kUnits; u += kWarps) {
    if (8 * (u % MT) >= a.M) continue;
    float4 v = part[u * 32 + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 o = part[(w * G::kUnits + u) * 32 + lane];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    *cluster.map_shared_rank(from + (rank * per_rank + u / C) * 32 + lane, u % C) = v;
  }
  cluster.sync();  // every block's units are in their owners
  const float* rf = reinterpret_cast<const float*>(from);
  for (int idx = tid; idx < per_rank * 128; idx += kThreads) {
    const int j = idx >> 7, i = idx & 127, u = j * C + rank;
    if (u >= G::kUnits || 8 * (u % MT) >= a.M) continue;
    float v = 0.f;
    for (int src = 0; src < C; ++src) v += rf[(src * per_rank + j) * 128 + i];
    store_out<NT, MT>(a, sb_s, n0, u, i, v);
  }
}

template <bool NT, int MT>
cudaError_t launch(Args a, int C, cudaStream_t st) {
  using G = Geo<NT, MT>;
  const int align = NT ? 16 : G::NW;  // bytes of a weight load
  a.w_vec = reinterpret_cast<uintptr_t>(a.w) % align == 0 && (NT ? a.K : a.N) % align == 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[2];
  cfg.gridDim = dim3(static_cast<unsigned>((a.N + G::WN - 1) / G::WN * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(kWarps * G::kUnits + C * ((G::kUnits + C - 1) / C)) * 32 * sizeof(float4);
  cfg.stream = st;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, w8a16_dense_kernel<NT, MT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool NT>
cudaError_t launch_rows(const Args& a, int C, cudaStream_t st) {
  if (a.M <= 8) return launch<NT, 1>(a, C, st);
  if (a.M <= 16) return launch<NT, 2>(a, C, st);
  if (a.M <= 32) return launch<NT, 4>(a, C, st);
  return launch<NT, 8>(a, C, st);
}

}  // namespace

// x: bf16 [M, K], contiguous; w: int8, nt = 0: contiguous [K, N], nt = 1:
// contiguous [N, K] (the product reads its transpose); s: f32 [N] or null
// (the raw product; then b must be null); b: f32 [N] or null; y: f32 [M, N].
// 1 <= M <= 64; C: blocks a cluster, 1..8 (kernels/w8a16.py's
// w8a16_geometry). Launched with programmatic stream serialization. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what it
// does not take.
extern "C" int wtt_w8a16_dense(const void* x, const void* w, const float* s, const float* b,
                               float* y, int M, int N, int K, int nt, int C, void* stream) {
  if (M < 1 || M > kMaxRows || N < 1 || K < 1 || C < 1 || C > kMaxCluster || (b && !s))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), s, b, y, M, N,
               K, reinterpret_cast<uintptr_t>(x) % 8 == 0 && K % 4 == 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nt ? launch_rows<true>(a, C, st) : launch_rows<false>(a, C, st));
}
