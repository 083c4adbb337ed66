// Backward of RMSNorm and of the fused residual-add RMSNorm, over rows.
//
// Not a port of a TPU kernel: JAX differentiates apply_norm and rms_head_norm
// (src/repro/models/layers.py) by autodiff in jnp. Forward: y = r * inv * scale,
// inv = rsqrt(mean(r^2) + eps), with r = x, or r = x + res summed in float32
// and never rounded (rmsnorm_residual.cu). Given dy, and for the fused norm the
// cotangent dr of its second output r, this computes in float32
//   dr_total = inv * (dy * scale) - r * inv^3 * mean(dy * scale * r) + dr,
// rounded once to the input dtype (the fused norm's x and res both take it),
// and dscale = sum over rows of dy * r * inv.
// Bound on Hopper: bytes. x (and res), dy (and dr) read, dx written; ~10 flops
//   an element.
// Design: a row is one warp when d <= 1024 (eight rows at a time in a block
//   of 256 threads; the qk-norm's d = 128) and the whole block when it is
//   wider (d = 2560, 5120), reduced by shuffles, and across warps through
//   shared memory. Pass 1 over the row sums r^2 and dy * scale * r, pass 2
//   reads the row again (from L1/L2) and writes dx. Each block walks rows
//   blockIdx.x, blockIdx.x + gridDim.x, ... and sums its rows' dscale terms
//   per column in shared memory, each column owned by one thread of a row
//   group, so no two threads add to one float; it writes its partial sums,
//   float32 (blocks, d), and a second launch adds them over the blocks in a
//   fixed order. No atomics: the result is the same on every run.
#include "common.cuh"

namespace rmsbwd {

constexpr int THREADS = 256;

// Sum over a group of `lanes` threads (32: a warp; THREADS: the block). Every
// thread of the group gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float group_sum(float v, int lanes, float* scratch) {
  return lanes == 32 ? warp_sum(v) : block_sum(v, scratch);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dr, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, int lanes, float eps) {
  extern __shared__ float acc[];  // [groups][d]: this block's dscale sums, per row group
  __shared__ float scratch[2][32];
  const int groups = THREADS / lanes, g = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  float* mine = acc + g * d;
  for (int c = lane; c < d; c += lanes) mine[c] = 0.f;

  // every group takes the same number of turns, so the block-wide reductions line up
  const long long turns = (rows + (long long)gridDim.x * groups - 1) / ((long long)gridDim.x * groups);
  for (long long t = 0; t < turns; ++t) {
    const long long row = (t * gridDim.x + blockIdx.x) * groups + g;
    const bool in = row < rows;
    const long long off = in ? row * d : 0;
    float ss = 0.f, dot = 0.f;
    if (in) {
      for (int c = lane; c < d; c += lanes) {
        const float r = to_f32(x[off + c]) + (res ? to_f32(res[off + c]) : 0.f);
        ss += r * r;
        dot += to_f32(dy[off + c]) * scale[c] * r;
      }
    }
    ss = group_sum(ss, lanes, scratch[0]);
    dot = group_sum(dot, lanes, scratch[1]);
    if (!in) continue;
    const float inv = rsqrtf(ss / d + eps);
    const float coef = dot * inv * inv * inv / d;
    for (int c = lane; c < d; c += lanes) {
      const float r = to_f32(x[off + c]) + (res ? to_f32(res[off + c]) : 0.f);
      const float gy = to_f32(dy[off + c]);
      float v = inv * (gy * scale[c]) - r * coef;
      if (dr) v += to_f32(dr[off + c]);
      dx[off + c] = from_f32<T>(v);
      mine[c] += gy * r * inv;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += acc[gg * d + c];
    partial[(long long)blockIdx.x * d + c] = s;
  }
}

// dscale[c] = sum over the blocks of partial[block][c], in block order.
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int blocks,
                       int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += partial[(long long)blk * d + c];
  dscale[c] = s;
}

}  // namespace rmsbwd

// x, res (null: the plain norm), scale, dy, dr (null: none), dx, partial
// (float32 (blocks, d) scratch), dscale (float32 (d,)), rows, d, eps, dtype,
// lanes (32 or 256), blocks, stream. The plan comes from
// kernels/rmsnorm/rmsnorm_bwd.py::launch_plan and is checked here.
extern "C" int launch_rmsnorm_bwd(const void* x, const void* res, const void* scale,
                                  const void* dy, const void* dr, void* dx, void* partial,
                                  void* dscale, long long rows, int d, float eps, int dtype,
                                  int lanes, int blocks, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (!(lanes == 32 || lanes == rmsbwd::THREADS) || blocks < 1 || (lanes == 32 && d > 1024))
    return (int)cudaErrorInvalidValue;
  const int smem = (rmsbwd::THREADS / lanes) * d * (int)sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    rmsbwd::rmsnorm_bwd_kernel<float><<<blocks, rmsbwd::THREADS, smem, s>>>(
        (const float*)x, (const float*)res, (const float*)scale, (const float*)dy,
        (const float*)dr, (float*)dx, (float*)partial, rows, d, lanes, eps);
  else if (dtype == kBF16)
    rmsbwd::rmsnorm_bwd_kernel<__nv_bfloat16><<<blocks, rmsbwd::THREADS, smem, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)res, (const float*)scale,
        (const __nv_bfloat16*)dy, (const __nv_bfloat16*)dr, (__nv_bfloat16*)dx, (float*)partial,
        rows, d, lanes, eps);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsbwd::reduce_partials_kernel<<<(d + rmsbwd::THREADS - 1) / rmsbwd::THREADS, rmsbwd::THREADS, 0,
                                   s>>>((const float*)partial, (float*)dscale, blocks, d);
  return (int)cudaGetLastError();
}
