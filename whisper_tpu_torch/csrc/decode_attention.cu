// Single-query (decode-step) attention over transposed K/V for Hopper (sm_90a).
//
// Replaces the Pallas kernel whisper_tpu/kernels/decode_attention.py:
// decode_attention_hd (body _kernel). Per lane b and head h: scores over the
// keys s of K^T [B/G, H*Dh, S] (row h*Dh + d holds feature d of every key),
// keys outside [start_b, valid_len_b) masked, softmax in f32, output
// sum_s p_s V[:, s] as f32 [B, H*Dh, 1]. Lane b reads K/V lane b / G
// (kv_group: beams share one cross cache without a copy). K/V are bf16 or
// f32 like q, or int8 with one f32 scale per key column (k_scale, v_scale
// [B/G, 1, S], the serving tier's caches): the raw q.K dot is multiplied by
// k_scale[s] before masking, the softmax sum takes the weights p before the
// V fold, and P.V sums p * v_scale[s] * V8[:, s], as the TPU body does.
//
// What bounds it on an H100: bytes. It does 4 flops per K/V element it
// reads, far below the ~295 flop/byte at which the tensor cores would
// matter, so the floor is streaming K and V once: at large-v2 cross
// attention (S = 1500, H*Dh = 1280, bf16) 7.7 MB per lane and layer, about
// 2.3 us at 3.35 TB/s; int8 K/V halve that (3.85 MB with the scales).
//
// Design: split-S flash decoding on vector loads. The TPU kernel walked
// S-chunks in order on one core, carrying the running max and sum in
// scratch; Hopper blocks run in parallel and cannot carry state, and one
// block per (lane, head) would give only 20 blocks at B = 1 for 132 SMs. So
// a first kernel runs one block of 256 threads per (chunk, head, lane) and
// writes a partial (max, sum, P.V), and a second kernel combines the
// partials of each (lane, head). A chunk is 256 bytes of each row: 128 keys
// of bf16 (240 blocks at B = 1, 1920 at B = 8), 256 of int8.
//  - Inside a block each lane holds 4 consecutive keys (8 on int8) and the 8
//    warps split the Dh rows: a lane reads its keys of a row in one load
//    (8 B of bf16, 4 B of int8, 16 B of f32), a warp one contiguous 256-byte
//    row segment. Every load of a thread (its q feature, K and V of its 8
//    rows, its key's int8 scales) goes out before anything waits, so a block
//    makes one round trip to memory; the main path's instantiations hold at
//    most 64 registers, so 4 blocks share an SM.
//  - Each thread keeps independent dot accumulators over its rows; the
//    warps' partial dots meet in shared memory. The softmax max and sum go
//    per warp, then across warps in one step. P.V uses the same tiling, each
//    row's products reduced by shuffles. int8 codes become floats by a byte
//    permute and one add.
//  - Where a row of S keys is not aligned to the vector (S * itemsize, or a
//    base, not a multiple of it: S = 150 or 151 in the tests), the wrapper
//    picks the 2- or 1-key instantiation of the same kernel.
//  - Masked scores are -1e30, never -inf, so no NaN appears; a chunk with no
//    attended key is skipped without reading its K/V (the self-attention
//    cache is mostly empty early in a window), a vector that holds no
//    attended key is not read, and a key outside the interval adds nothing
//    whatever its stored value. A lane whose interval is empty gets mean(V)
//    over [0, S), as the plain version's softmax over S scores of -1e30
//    gives.
//  - The combine issues all its loads at once too: up to 16 chunks' P.V in
//    registers and every (max, sum) pair into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // Dh rows are split over the warps
constexpr int kMaxDh = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<1> { using type = uint8_t; };

// VEC consecutive elements of a row as loaded (one load), then as floats.
template <typename T, int VEC>
using RawVec = typename Raw<sizeof(T) * VEC>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(float (&f)[VEC], RawVec<T, VEC> raw) {
  if constexpr (std::is_same<T, int8_t>::value && VEC == 4) {
    // biased bytes b + 128 as the low mantissa bits of 2^23: one permute and
    // one add a code, where a conversion instruction runs at a quarter rate
    const uint32_t w = raw ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | e)) - 8388736.f;
  } else {
    T x[VEC];
    memcpy(x, &raw, sizeof(raw));
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = to_f32(x[e]);
  }
}

// Everything a launch needs. k_scale/v_scale: int8 K/V's column scales
// [B/G, S] (null otherwise); start/valid_len: int32 [B] or null; part_ml
// [B, H, n_splits, 2] and part_o [B, H, n_splits, Dh]: the chunks' partials.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* start;
  const int* valid_len;
  float* out;
  float* part_ml;
  float* part_o;
  int B, HD, S, H, G;
};

// Keys per block: 256 B of each row, so an int8 block moves as many bytes
// as a bf16 one.
template <typename TKV>
__host__ __device__ constexpr int chunk_of() {
  return sizeof(TKV) == 1 ? 256 : 128;
}

// The main path's shapes (bf16 or int8 K/V, 4 keys a load, Dh = 64) hold
// at most 64 registers a thread, so 4 blocks share an SM and one block's
// loads overlap another's reductions; the others take what they need.
template <typename TKV, int VEC, int ROWS>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(TKV) <= 2 && VEC == 4 && ROWS == 64 / kWarps ? 4 : 1;
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

// TQ: the query's type; TKV: the K/V type; VEC: keys per load (4, or 2 or 1
// where S's rows are not aligned to 4); ROWS: Dh rows per warp (Dh <= 8
// ROWS). One block per (chunk, head, lane).
template <typename TQ, typename TKV, int VEC, int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks<TKV, VEC, ROWS>())
decode_attention_kernel(const Args a) {
  constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
  constexpr int kChunk = chunk_of<TKV>();
  constexpr int kLaneKeys = kChunk / 32;   // keys per lane
  constexpr int kVecs = kLaneKeys / VEC;   // loads per lane and row
  using R = RawVec<TKV, VEC>;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, S = a.S, HD = a.HD, H = a.H;
  const int dh = HD / H;
  const int s0 = split * kChunk;
  int lo = a.start ? max(a.start[b], 0) : 0;
  int hi = a.valid_len ? min(a.valid_len[b], S) : S;
  // A lane that attends no key has every score at -1e30, so the plain
  // version's softmax weighs all S keys alike: give it mean(V) over [0, S).
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = S;
  }
  const long long head = (long long)b * H + h;
  float* ml = a.part_ml + (head * n_splits + split) * 2;
  float* po = a.part_o + (head * n_splits + split) * dh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  __shared__ float q_s[kMaxDh];
  __shared__ float dot_s[kWarps][kChunk];  // each warp's partial dots over its rows
  __shared__ float p_s[kChunk];
  __shared__ float red_m[kWarps], red_l[kWarps];

  // attended keys of this chunk: [s0 + j_lo, s0 + j_hi)
  const int j_lo = max(lo - s0, 0);
  const int j_hi = min(hi - s0, kChunk);
  if (j_lo >= j_hi) {  // nothing attended here: K/V of this chunk are never read
    if (tid == 0) {
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    for (int d = tid; d < dh; d += kThreads) po[d] = 0.f;
    return;
  }
  // This lane's keys: vector i holds chunk keys i * 32 VEC + lane VEC + e.
  // A vector is read only if it holds an attended key; one inside
  // [0, j_hi) lies inside S, since S is a multiple of VEC.
  bool use[kVecs];
  bool in[kLaneKeys];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j0 = i * 32 * VEC + lane * VEC;
    use[i] = j0 < j_hi && j0 + VEC > j_lo;
#pragma unroll
    for (int e = 0; e < VEC; ++e) in[i * VEC + e] = j0 + e >= j_lo && j0 + e < j_hi;
  }

  // Every load of this thread goes out at once, before anything waits: its
  // feature of q, and K and V of its rows d = warp + 8 r. One round trip to
  // memory a block.
  const long long row0 = ((long long)(b / a.G) * HD + (long long)h * dh) * S;
  const TKV* kb = static_cast<const TKV*>(a.k) + row0 + s0 + lane * VEC;
  const TKV* vb = static_cast<const TKV*>(a.v) + row0 + s0 + lane * VEC;
  const long long col0 = (long long)(b / a.G) * S + s0;  // this chunk's scale columns
  const float qv = tid < dh ? to_f32(static_cast<const TQ*>(a.q)[(long long)b * HD + h * dh + tid])
                            : 0.f;
  // thread tid scores chunk key tid; int8 K/V's column scales of that key
  const bool attended = tid >= j_lo && tid < j_hi;
  float k_sc = 1.f, v_sc = 1.f;
  if constexpr (kScaled) {
    if (attended) {
      if (!uniform) k_sc = a.k_scale[col0 + tid];
      v_sc = a.v_scale[col0 + tid];
    }
  }
  R kr[ROWS][kVecs], vr[ROWS][kVecs];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int d = warp + r * kWarps;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const long long off = (long long)d * S + i * 32 * VEC;
      const bool read = d < dh && use[i];
      kr[r][i] = read && !uniform ? *reinterpret_cast<const R*>(kb + off) : R{};
      vr[r][i] = read ? *reinterpret_cast<const R*>(vb + off) : R{};
    }
  }

  if (tid < dh) q_s[tid] = qv;
  __syncthreads();

  if (!uniform) {
    float acc[kLaneKeys];
#pragma unroll
    for (int c = 0; c < kLaneKeys; ++c) acc[c] = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int d = warp + r * kWarps;
      const float qd = d < dh ? q_s[d] : 0.f;  // rows past Dh read nothing
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        float f[VEC];
        unpack<TKV, VEC>(f, kr[r][i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = fmaf(qd, f[e], acc[i * VEC + e]);
      }
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dot_s[warp][i * 32 * VEC + lane * VEC + e] = acc[i * VEC + e];
  }
  __syncthreads();

  // Thread tid scores chunk key tid. Keys past S do not exist (-inf,
  // weight 0); keys inside S but outside [lo, hi) are masked to -1e30 as
  // in the TPU kernel. The max and sum go per warp, then across warps in
  // one step.
  float score = -INFINITY;
  if (tid < kChunk && s0 + tid < S) {
    score = -1e30f;
    if (!uniform && attended) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += dot_s[w][tid];
      if constexpr (kScaled) dot *= k_sc;
      score = dot;
    }
  }
  const float mw = warp_max(score);
  const float lw = warp_sum(mw == -INFINITY ? 0.f : __expf(score - mw));
  if (lane == 0) {
    red_m[warp] = mw;
    red_l[warp] = lw;
  }
  __syncthreads();
  float m = -INFINITY, l = 0.f;  // m is finite: the chunk holds an attended key
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w]);
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (red_m[w] != -INFINITY) l += red_l[w] * __expf(red_m[w] - m);
  // the softmax sum takes p before the V fold
  const float p = __expf(score - m);
  if (tid < kChunk) p_s[tid] = p * v_sc;
  __syncthreads();

  // P.V: a key outside [lo, hi) adds nothing, whatever its stored value.
  float pr[kLaneKeys];
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      pr[i * VEC + e] = in[i * VEC + e] ? p_s[i * 32 * VEC + lane * VEC + e] : 0.f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int d = warp + r * kWarps;
    if (d < dh) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        float f[VEC];
        unpack<TKV, VEC>(f, vr[r][i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc = fmaf(pr[i * VEC + e], in[i * VEC + e] ? f[e] : 0.f, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) po[d] = acc;
    }
  }
  if (tid == 0) {
    ml[0] = m;
    ml[1] = l;
  }
}

// One block per (head, lane), one thread per feature: rescale each chunk's
// partial to the global max and normalise. Every load goes out before
// anything waits: up to kHeld chunks' P.V in registers, all (max, sum)
// pairs into shared memory.
__global__ void decode_attention_combine(const float* __restrict__ part_ml,
                                         const float* __restrict__ part_o,
                                         float* __restrict__ out, int HD, int H, int n_splits) {
  constexpr int kHeld = 16;
  extern __shared__ float ml_s[];  // [n_splits][2]
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, dh = blockDim.x;
  const long long head = (long long)b * H + h;
  const float* ml = part_ml + head * n_splits * 2;
  const float* po = part_o + head * n_splits * dh + d;
  float held[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) held[i] = i < n_splits ? po[(long long)i * dh] : 0.f;
  for (int i = d; i < 2 * n_splits; i += dh) ml_s[i] = ml[i];
  __syncthreads();
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, ml_s[2 * i]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {  // every lane attends some key of a chunk (S > 0)
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      if (i < n_splits) {
        const float w = __expf(ml_s[2 * i] - M);
        L += w * ml_s[2 * i + 1];
        acc += w * held[i];
      }
    }
    for (int i = kHeld; i < n_splits; ++i) {
      const float w = __expf(ml_s[2 * i] - M);
      L += w * ml_s[2 * i + 1];
      acc += w * po[(long long)i * dh];
    }
  }
  out[(long long)b * HD + h * dh + d] = L > 0.f ? acc / L : 0.f;
}

template <typename TQ, typename TKV, int VEC>
void launch_rows(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.HD / a.H > 64) {
    decode_attention_kernel<TQ, TKV, VEC, kMaxDh / kWarps><<<grid, kThreads, 0, st>>>(a);
  } else {  // Dh <= 64: every whisper model
    decode_attention_kernel<TQ, TKV, VEC, 64 / kWarps><<<grid, kThreads, 0, st>>>(a);
  }
}

template <typename TQ, typename TKV>
int launch(int vec, const Args& a, cudaStream_t st) {
  const int n_splits = (a.S + chunk_of<TKV>() - 1) / chunk_of<TKV>();
  const dim3 grid(n_splits, a.H, a.B);
  if (vec == 4) {
    launch_rows<TQ, TKV, 4>(a, grid, st);
  } else if (vec == 2) {
    launch_rows<TQ, TKV, 2>(a, grid, st);
  } else {
    launch_rows<TQ, TKV, 1>(a, grid, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_combine<<<dim3(a.H, a.B), a.HD / a.H, 2 * n_splits * sizeof(float), st>>>(
      a.part_ml, a.part_o, a.out, a.HD, a.H, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Keys per chunk (one block) for K/V of the given type code.
extern "C" int wtt_decode_attention_chunk(int kv_type) {
  return kv_type == 2 ? chunk_of<int8_t>() : chunk_of<float>();
}

// Type codes: 0 f32, 1 bf16, 2 int8. q: [B, HD] (HD = H * Dh), f32 or bf16;
// k/v: contiguous [B / G, HD, S], of q's type, or int8 (kv_type 2) with
// k_scale/v_scale f32 [B / G, S] (null otherwise); start/valid_len: int32
// [B] or null; out: f32 [B, HD]; part_ml: f32 [B, H, n_splits, 2] and
// part_o: f32 [B, H, n_splits, Dh] scratch, n_splits =
// ceil(S / wtt_decode_attention_chunk(kv_type)); vec: keys per load, 4, 2
// or 1, with S and both bases aligned to vec elements. Returns
// cudaGetLastError() after both launches, or cudaErrorInvalidValue for a
// type pair or vec it does not take.
extern "C" int wtt_decode_attention_hd(int q_type, int kv_type, const void* q, const void* k,
                                       const void* v, const float* k_scale,
                                       const float* v_scale, const int* start,
                                       const int* valid_len, float* out, float* part_ml,
                                       float* part_o, int B, int HD, int S, int H,
                                       int G, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((vec != 4 && vec != 2 && vec != 1) || S % vec) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, start, valid_len, out, part_ml, part_o, B, HD, S, H, G};
  if (q_type == 1 && kv_type == 1) return launch<__nv_bfloat16, __nv_bfloat16>(vec, a, st);
  if (q_type == 0 && kv_type == 0) return launch<float, float>(vec, a, st);
  if (k_scale && v_scale && kv_type == 2) {
    if (q_type == 1) return launch<__nv_bfloat16, int8_t>(vec, a, st);
    if (q_type == 0) return launch<float, int8_t>(vec, a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
