// Int8 K/V column write for the decoder's self cache (sm_90a): from the
// qkv product's f32 rows, quantize this token's K and V (one f32 scale per
// column), write codes and scales into the cache at the device's column, and
// write q in the compute dtype, in one launch a layer.
//
// Replaces no TPU kernel. XLA fused the JAX package's quantize_cols and its
// dynamic_update_slice into its neighbours. The port ran them apart, eagerly
// or captured in the step's graph: the two strided K/V views of the head-major
// product copied to contiguous rows, eight elementwise and reduction passes
// each for K and V (cast, abs, amax, clamp_min, two divides, round, clamp,
// cast to int8), four index_copy_ for the codes and the scales, and q's cast:
// 23 launches a layer, 736 a large-v2 token step, each over 8 x 1,280 floats.
//
// Input: qkv f32 [B, S, H, 3, Dh], contiguous, as model/layers.py's
// head-major product gives it (no copy first). For each row (b, s) and each
// of K and V over HD = H Dh values x:
//   amax  = max |x|
//   scale = max(amax, 1e-8) * f32(1 / 127)
//   code  = clamp(rint(x / scale), -127, 127)
// codes into k or v [B, HD, C] and scales into ks or vs [B, 1, C] at column
// col + s, where col is read on the device (int64, the token step's write_pos:
// the launch is captured in a CUDA graph and reads no host value) or given by
// the host (the prompt ingest). q [B, S, HD] in bf16 (round to nearest even)
// or f32.
//
// Arithmetic: the split path's, bit for bit (kernels/quant.py:quantize_cols
// on the card). Its scale is PyTorch's `amax.clamp_min(1e-8) / 127.0`, which
// on a CUDA tensor and a host scalar multiplies by the f32 reciprocal of 127;
// its codes divide by the scale tensor, an IEEE division, and round half to
// even. No fast-math flag is set (kernels/_build.py), so x / scale is the
// correctly rounded quotient and rintf rounds half to even. A max is exact in
// any order. NaN inputs are not propagated into the scale as torch.amax
// would (fmaxf drops them); the step never feeds one.
//
// What bounds it on an H100: latency, not bytes. At B = 8 a layer's call reads
// 8 x 3 x 5 KB and writes 20 KB of codes, 64 B of scales and 20 KB of q: 0.06
// us at 3.35 TB/s, against one round trip to memory (~1 us) and a launch.
//
// Design: one block per (row, part), part 0 q, 1 K, 2 V: B S x 3 blocks of
// ceil(HD / 8) threads rounded up to a warp (160 at HD = 1,280). Each thread
// issues its 8 loads at once into registers, so a block makes one round trip
// to memory; a warp max by shuffles and one across warps in shared memory
// give the row's amax; each thread then writes its 8 codes. The cache is
// transposed, so a column's codes are C bytes apart: each is a 1-byte store
// of its own, as the index_copy_ it replaces stored them. Launched with
// programmatic stream serialization: the block starts while the qkv product
// finishes and waits for it (griddepcontrol.wait) before its first load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPer = 8;              // values a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kMaxHD = kPer * kMaxThreads;

struct Args {
  const float* qkv;       // [B, S, H, 3, Dh]
  int8_t* k;              // [B, HD, C]
  int8_t* v;
  float* ks;              // [B, 1, C]
  float* vs;
  void* q;                // [B, S, HD], bf16 or f32
  const int64_t* col_dev; // column of s = 0 on the device, or null
  int col_host;           // the same from the host, where col_dev is null
  int S, H, Dh, C;
  int q_f32;
};

__global__ void __launch_bounds__(kMaxThreads) kv_quant_write_kernel(Args a) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x;            // b S + s
  const int part = blockIdx.y;           // 0 q, 1 K, 2 V
  const int hd = a.H * a.Dh;
  const float* src = a.qkv + static_cast<size_t>(row) * 3 * hd + part * a.Dh;

  float x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    x[j] = 0.f;
    if (i < hd) {
      const int h = i / a.Dh;
      x[j] = src[h * 3 * a.Dh + (i - h * a.Dh)];
    }
  }

  if (part == 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i >= hd) break;
      const size_t at = static_cast<size_t>(row) * hd + i;
      if (a.q_f32)
        static_cast<float*>(a.q)[at] = x[j];
      else
        static_cast<__nv_bfloat16*>(a.q)[at] = __float2bfloat16_rn(x[j]);
    }
    return;
  }

  float m = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) m = fmaxf(m, fabsf(x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = lane < static_cast<int>(blockDim.x >> 5) ? warp_max[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  // PyTorch's clamp_min(1e-8) casts the double to f32; its `/ 127.0` by a
  // host scalar on a CUDA tensor multiplies by the f32 reciprocal
  const float scale = fmaxf(m, static_cast<float>(1e-8)) * (1.0f / 127.0f);
  const int b = row / a.S;
  const int col = (a.col_dev ? static_cast<int>(*a.col_dev) : a.col_host) + (row - b * a.S);
  int8_t* codes = (part == 1 ? a.k : a.v) + static_cast<size_t>(b) * hd * a.C + col;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i >= hd) break;
    const float r = fminf(fmaxf(rintf(x[j] / scale), -127.f), 127.f);
    codes[static_cast<size_t>(i) * a.C] = static_cast<int8_t>(r);
  }
  if (threadIdx.x == 0) (part == 1 ? a.ks : a.vs)[static_cast<size_t>(b) * a.C + col] = scale;
}

}  // namespace

// qkv: f32 [B, S, H, 3, Dh], contiguous; k, v: int8 [B, H Dh, C]; ks, vs: f32
// [B, 1, C], all contiguous; q: [B, S, H Dh], bf16 (q_f32 = 0) or f32. The
// column of s = 0 is *col_dev (int64, on the device) where col_dev is not
// null, else col_host; a host column must leave S columns in the cache, a
// device column is not checked (its caller checks the range). H Dh <= 8,192.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// what it does not take.
extern "C" int wtt_kv_quant_write(const float* qkv, int8_t* k, int8_t* v, float* ks, float* vs,
                                  void* q, const int64_t* col_dev, int col_host, int B, int S,
                                  int H, int Dh, int C, int q_f32, void* stream) {
  const long hd = static_cast<long>(H) * Dh;
  if (B < 1 || S < 1 || H < 1 || Dh < 1 || C < 1 || hd > kMaxHD ||
      static_cast<long>(B) * S > 0x7fffffffL ||
      (!col_dev && (col_host < 0 || col_host > C - S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{qkv, k, v, ks, vs, q, col_dev, col_host, S, H, Dh, C, q_f32};
  const int threads = static_cast<int>((hd + kPer * 32 - 1) / (kPer * 32) * 32);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attrs[1];
  cfg.gridDim = dim3(static_cast<unsigned>(B * S), 3);
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kv_quant_write_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
