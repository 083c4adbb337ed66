// Shared helpers of the port's kernels: element loads/stores in float32 and
// bfloat16, warp reductions, and the dtype codes the Python wrappers pass
// (0 = float32, 1 = bfloat16; see repro_torch/kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NEG_INF (-1e30f)

enum DtypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and widened back: the value x has once it is stored as T.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Threads of a one-row-per-block norm over d columns: ~4 columns a thread, 32..256.
inline int norm_threads(int d) {
  const int t = ((d / 4 + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

// Sum over the block; every thread gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : 0.f;
  return warp_sum(v);
}
