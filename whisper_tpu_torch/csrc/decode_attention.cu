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
// Design: split-S flash decoding. The TPU kernel walked S-chunks in order on
// one core, carrying the running max and sum in scratch; Hopper blocks run
// in parallel and cannot carry state, and one block per (lane, head) would
// give only 20 blocks at B = 1 for 132 SMs. So a first kernel runs one block
// per (128-key chunk, head, lane) and writes a partial (max, sum, P.V), and
// a second kernel combines the partials of each (lane, head). In the first
// kernel threads run along S, so each K row is read coalesced, and q sits in
// shared memory; scores are f32 dots over Dh. For P.V the warps run along Dh
// and the lanes along the chunk's keys (again coalesced), reducing by
// shuffles. Masked scores are -1e30, never -inf, so no NaN appears; a chunk
// with no attended key is skipped without reading its K/V (the self-attention
// cache is mostly empty early in a window), and only attended columns are
// ever read. A lane whose interval is empty gets mean(V) over [0, S), as
// the plain version's softmax over S scores of -1e30 gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 128;  // keys per block = threads per block
constexpr int kWarps = kChunk / 32;
constexpr int kMaxDh = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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

// TQ: the query's type; TKV: the K/V type. int8 K/V read their column
// scales k_scale/v_scale [B/G, S]; other types ignore them (null).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kChunk)
decode_attention_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ start,
                       const int* __restrict__ valid_len, float* __restrict__ part_ml,
                       float* __restrict__ part_o, int HD, int S, int H, int G) {
  constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int dh = HD / H;
  const int s0 = split * kChunk;
  int lo = start ? max(start[b], 0) : 0;
  int hi = valid_len ? min(valid_len[b], S) : S;
  // A lane that attends no key has every score at -1e30, so the plain
  // version's softmax weighs all S keys alike: give it mean(V) over [0, S).
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = S;
  }
  const long long part = ((long long)b * H + h) * n_splits + split;
  float* ml = part_ml + part * 2;
  float* po = part_o + part * dh;
  const int tid = threadIdx.x;

  // attended keys of this chunk: [s0 + j_lo, s0 + j_hi)
  const int j_lo = max(lo - s0, 0);
  const int j_hi = min(hi - s0, kChunk);
  if (j_lo >= j_hi) {  // nothing attended here: K/V of this chunk are never read
    if (tid == 0) {
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    for (int d = tid; d < dh; d += kChunk) po[d] = 0.f;
    return;
  }

  __shared__ float q_s[kMaxDh];
  __shared__ float p_s[kChunk];
  __shared__ float red[kWarps];

  const long long row0 = ((long long)(b / G) * HD + (long long)h * dh) * S;
  const TKV* kb = k + row0 + s0;
  const TKV* vb = v + row0 + s0;
  const long long col0 = (long long)(b / G) * S + s0;  // this chunk's scale columns
  const bool attended = tid >= j_lo && tid < j_hi;
  for (int d = tid; d < dh; d += kChunk) q_s[d] = to_f32(q[(long long)b * HD + h * dh + d]);
  __syncthreads();

  // Keys past S do not exist (-inf, weight 0); keys inside S but outside
  // [lo, hi) are masked to -1e30 as in the TPU kernel, and their K is not read.
  float score = -INFINITY;
  if (s0 + tid < S) {
    score = -1e30f;
    if (!uniform && attended) {
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) acc += q_s[d] * to_f32(kb[(long long)d * S + tid]);
      if constexpr (kScaled) acc *= k_scale[col0 + tid];
      score = acc;
    }
  }
  const float m = block_max(score, red);  // finite: the chunk holds an attended key
  const float p = __expf(score - m);
  const float l = block_sum(p, red);      // the softmax sum takes p before the V fold
  p_s[tid] = (kScaled && attended) ? p * v_scale[col0 + tid] : p;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int d = warp; d < dh; d += kWarps) {
    const TKV* vrow = vb + (long long)d * S;
    float acc = 0.f;
    for (int j = j_lo + lane; j < j_hi; j += 32) acc += p_s[j] * to_f32(vrow[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) po[d] = acc;
  }
  if (tid == 0) {
    ml[0] = m;
    ml[1] = l;
  }
}

// One block per (head, lane), one thread per feature: rescale each chunk's
// partial to the global max and normalise.
__global__ void decode_attention_combine(const float* __restrict__ part_ml,
                                         const float* __restrict__ part_o,
                                         float* __restrict__ out, int HD, int H, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, dh = blockDim.x;
  const long long base = (long long)b * H + h;
  const float* ml = part_ml + base * n_splits * 2;
  const float* po = part_o + base * n_splits * dh;
  float M = -INFINITY;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {  // every lane attends some key of a chunk (S > 0)
    for (int i = 0; i < n_splits; ++i) {
      const float w = __expf(ml[2 * i] - M);
      L += w * ml[2 * i + 1];
      acc += w * po[(long long)i * dh + d];
    }
  }
  out[(long long)b * HD + h * dh + d] = L > 0.f ? acc / L : 0.f;
}

}  // namespace

extern "C" int wtt_decode_attention_chunk() { return kChunk; }

namespace {

template <typename TQ, typename TKV>
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale, const int* start,
                  const int* valid_len, float* part_ml, float* part_o, int HD, int S, int H,
                  int G) {
  decode_attention_split<TQ, TKV><<<grid, kChunk, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      k_scale, v_scale, start, valid_len, part_ml, part_o, HD, S, H, G);
}

}  // namespace

// Type codes: 0 f32, 1 bf16, 2 int8. q: [B, HD] (HD = H * Dh), f32 or bf16;
// k/v: contiguous [B / G, HD, S], of q's type, or int8 (kv_type 2) with
// k_scale/v_scale f32 [B / G, S] (null otherwise); start/valid_len: int32
// [B] or null; out: f32 [B, HD]; part_ml: f32 [B, H, n_splits, 2] and
// part_o: f32 [B, H, n_splits, Dh] scratch, n_splits =
// ceil(S / wtt_decode_attention_chunk()). Returns cudaGetLastError() after
// both launches, or cudaErrorInvalidValue for a type pair it does not take.
extern "C" int wtt_decode_attention_hd(int q_type, int kv_type, const void* q, const void* k,
                                       const void* v, const float* k_scale,
                                       const float* v_scale, const int* start,
                                       const int* valid_len, float* out, float* part_ml,
                                       float* part_o, int B, int HD, int S, int H, int G,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = (S + kChunk - 1) / kChunk;
  const dim3 grid(n_splits, H, B);
  if (q_type == 1 && kv_type == 1) {
    launch_split<__nv_bfloat16, __nv_bfloat16>(grid, st, q, k, v, nullptr, nullptr, start,
                                               valid_len, part_ml, part_o, HD, S, H, G);
  } else if (q_type == 0 && kv_type == 0) {
    launch_split<float, float>(grid, st, q, k, v, nullptr, nullptr, start, valid_len, part_ml,
                               part_o, HD, S, H, G);
  } else if (q_type == 1 && kv_type == 2 && k_scale && v_scale) {
    launch_split<__nv_bfloat16, int8_t>(grid, st, q, k, v, k_scale, v_scale, start, valid_len,
                                        part_ml, part_o, HD, S, H, G);
  } else if (q_type == 0 && kv_type == 2 && k_scale && v_scale) {
    launch_split<float, int8_t>(grid, st, q, k, v, k_scale, v_scale, start, valid_len, part_ml,
                                part_o, HD, S, H, G);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attention_combine<<<dim3(H, B), HD / H, 0, st>>>(part_ml, part_o, out, HD, H, n_splits);
  return static_cast<int>(cudaGetLastError());
}
