// RMSNorm over the rows of a (rows, d) matrix: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (launched by rmsnorm_fwd).
// Bound on Hopper: bytes. One read of x and one write of y, 3 flops an
//   element; at d = 5120 the card needs ~1,000 flops a byte to be compute bound.
// Design: x is read once. Each thread loads V elements at a time (16 bytes:
//   8 bf16 or 4 fp32; neighbouring threads on neighbouring vectors) and keeps
//   its VPT loads in registers between the sum of squares (fp32) and the
//   scaling, so nothing is read twice. A row is `lanes` threads: for rows
//   of up to 128 vectors (bf16 d <= 1024; the qk-norm's 128 is 16 lanes) a
//   group of <= 32 lanes with several rows per 256-thread block, reduced by
//   shuffles inside the group; for wider rows (d = 5120: 160 threads of 4
//   vectors) a block per row, reduced across warps through shared memory.
//   Rows whose width or base address does not allow 16-byte loads take the
//   scalar instance of the same kernel (V = 1). The launch plan (V, lanes,
//   rows per block, VPT) is made by `rmsnorm.py::launch_plan` and checked
//   here. Arithmetic as the TPU kernel: inv = rsqrt(ss / d + eps), y = x *
//   inv * scale, one rounding. The TPU kernel's 256-row VMEM tiles have no
//   use here.
#include "common.cuh"

template <typename T, int V, int VPT>
__global__ void __launch_bounds__(1024)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               long long rows, int d, int lanes, float eps) {
  __shared__ float scratch[32];
  using P = Pack<T, V>;
  const int nvec = d / V;
  const int lane = threadIdx.x % lanes;
  const long long row = (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;  // a group past the last row still joins the shuffles
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  P xv[VPT];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + j * lanes;
    if (live && i < nvec) {
      xv[j] = load_pack(xr + i);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(xv[j].v[e]);
        ss += f * f;
      }
    }
  }
  if (lanes > 32) {
    ss = block_sum(ss, scratch);  // one row per block
  } else {
    for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float inv = rsqrtf(ss / d + eps);
  P* yr = reinterpret_cast<P*>(y + row * d);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + j * lanes;
    if (i < nvec) {
      float sc[V];
      load_gains<V>(scale, i, sc);
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = from_f32<T>(to_f32(xv[j].v[e]) * inv * sc[e]);
      store_pack(yr + i, out);
    }
  }
}

template <typename T, int V>
static int launch_v(const void* x, const void* scale, void* y, long long rows, int d, float eps,
                    int lanes, int rows_per_block, int vpt, cudaStream_t s) {
  const dim3 grid((unsigned)((rows + rows_per_block - 1) / rows_per_block));
  const dim3 block(lanes * rows_per_block);
  const T* xp = (const T*)x;
  const float* sp = (const float*)scale;
  T* yp = (T*)y;
  switch (vpt) {
    case 1: rmsnorm_kernel<T, V, 1><<<grid, block, 0, s>>>(xp, sp, yp, rows, d, lanes, eps); break;
    case 2: rmsnorm_kernel<T, V, 2><<<grid, block, 0, s>>>(xp, sp, yp, rows, d, lanes, eps); break;
    case 4: rmsnorm_kernel<T, V, 4><<<grid, block, 0, s>>>(xp, sp, yp, rows, d, lanes, eps); break;
    case 8: rmsnorm_kernel<T, V, 8><<<grid, block, 0, s>>>(xp, sp, yp, rows, d, lanes, eps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// vec: elements per load (16 bytes' worth, or 1); lanes: threads of a row (a
// power of two up to 32, or a whole block of a multiple of 32 up to 1024);
// rows_per_block; vpt: loads per thread. They must cover the row.
extern "C" int launch_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                              float eps, int dtype, int vec, int lanes, int rows_per_block,
                              int vpt, void* stream) {
  if (rows == 0) return 0;
  const int threads = lanes * rows_per_block;
  const bool group = lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (lanes < 1 || rows_per_block < 1 || threads > 1024 || threads % 32 ||
      !(group || rows_per_block == 1) || vec < 1 || d % vec || (long long)lanes * vpt * vec < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32 && vec == 4)
    return launch_v<float, 4>(x, scale, y, rows, d, eps, lanes, rows_per_block, vpt, s);
  if (dtype == kF32 && vec == 1)
    return launch_v<float, 1>(x, scale, y, rows, d, eps, lanes, rows_per_block, vpt, s);
  if (dtype == kBF16 && vec == 8)
    return launch_v<__nv_bfloat16, 8>(x, scale, y, rows, d, eps, lanes, rows_per_block, vpt, s);
  if (dtype == kBF16 && vec == 1)
    return launch_v<__nv_bfloat16, 1>(x, scale, y, rows, d, eps, lanes, rows_per_block, vpt, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
