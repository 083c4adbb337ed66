// Fused residual add + RMSNorm over rows: r = x + res (in float32, stored in
// x's dtype), y = rmsnorm(r) * scale computed from the UNROUNDED float32 r.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _fused_res_kernel
//   (launched by rmsnorm_residual_fwd).
// Bound on Hopper: bytes. Two reads (x, res) and two writes (y, r) a row; the
//   fusion saves the read of r that a separate norm would make.
// Design: one block per row. Pass 1 forms r in float32, writes it, and sums
//   r^2; pass 2 forms r again from x and res (the same float32 sum, bit for
//   bit, and the loads hit L1/L2) instead of reading back the rounded r, so y
//   comes from the unrounded sum as in the TPU kernel.
#include "common.cuh"

template <typename T>
__global__ void rmsnorm_residual_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                        const float* __restrict__ scale, T* __restrict__ y,
                                        T* __restrict__ r, int d, float eps) {
  __shared__ float scratch[32];
  const long long off = (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(x[off + i]) + to_f32(res[off + i]);
    r[off + i] = from_f32<T>(v);
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, scratch) / d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(x[off + i]) + to_f32(res[off + i]);
    y[off + i] = from_f32<T>(v * inv * scale[i]);
  }
}

extern "C" int launch_rmsnorm_residual(const void* x, const void* res, const void* scale, void* y,
                                       void* r, long long rows, int d, float eps, int dtype,
                                       void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((unsigned)rows), block(norm_threads(d));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    rmsnorm_residual_kernel<float><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)res, (const float*)scale, (float*)y, (float*)r, d, eps);
  else if (dtype == kBF16)
    rmsnorm_residual_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)res, (const float*)scale,
        (__nv_bfloat16*)y, (__nv_bfloat16*)r, d, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
