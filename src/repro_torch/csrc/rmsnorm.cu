// RMSNorm over the rows of a (rows, d) matrix: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (launched by rmsnorm_fwd).
// Bound on Hopper: bytes. One read of x and one write of y, 3 flops an
//   element; at d = 5120 the card needs ~1,000 flops a byte to be compute bound.
// Design: one block per row, the sum of squares taken in float32 by each
//   thread over a strided slice of the row (neighbouring threads on
//   neighbouring elements, so loads coalesce), then warp shuffles and one
//   shared-memory step across warps. The second pass reads the row again,
//   which hits L1/L2, rather than holding d / blockDim values in registers.
//   The TPU kernel's 256-row VMEM tiles have no use here: a row is the unit.
#include "common.cuh"

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ y, int d, float eps) {
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * scale[i]);
}

extern "C" int launch_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((unsigned)rows), block(norm_threads(d));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    rmsnorm_kernel<float><<<grid, block, 0, s>>>((const float*)x, (const float*)scale,
                                                 (float*)y, d, eps);
  else if (dtype == kBF16)
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)y, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
