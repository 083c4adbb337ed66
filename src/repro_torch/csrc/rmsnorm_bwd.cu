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
// Design: one pass, as the forward (rmsnorm.cu). Each thread loads its V
//   elements at a time (16 bytes: 8 bf16 or 4 fp32; neighbouring threads on
//   neighbouring vectors) of x, res and dy once and keeps its VPT loads of each
//   in registers through both row sums (r^2 and dy * scale * r, fp32) and the
//   write of dx, so nothing is read twice; dr is read only for that write. The
//   plain and the fused norm are instances of their own, so the plain one
//   holds no registers for res. The kernel is bound by how many rows are in
//   flight on an SM, and so by registers: a thread holds at most 32 elements
//   of x and dy (16 of x, res and dy in the fused norm) in at most 128
//   registers, and a row takes the fewest loads a thread that keep it to
//   192 threads or fewer. A row is `lanes` threads: for rows that 32 lanes
//   cover (bf16 d <= 1024; the qk-norm's 128 is 16 lanes) a group of <= 32
//   lanes, several rows to a 256-thread block, reduced by shuffles inside
//   the group; for wider rows (d = 2560: 160 threads of 2 vectors; d = 5120:
//   160 threads of 4, 320 of 2 when fused) whole warps, reduced across the
//   row's warps through shared memory. ptxas (sm_90a, CUDA 12.8): 123
//   registers at d 2560 (127 fused), 128 and 188 bytes of spill stores at
//   d 5120 (plain), where that plan was still the fastest that
//   scripts/rmsnorm_bwd_plans.py timed. Rows whose width or base address
//   does not allow 16-byte access take the scalar instance of the same kernel
//   (V = 1). The blocks walk the rows blockIdx.x, blockIdx.x + gridDim.x, ...
//   (a row group each), and a thread owns the same columns in
//   every row it walks, so it sums its dscale terms in registers. At the end
//   the block adds its row groups' sums in shared memory in group order and
//   writes its partial sums, float32 (blocks, d); a second launch adds them
//   over the blocks in a fixed order. No atomics: the result is the same on
//   every run. The launch plan (V, lanes, rows per block, VPT, blocks) is made
//   by `rmsnorm_bwd.py::launch_plan` and checked here.
#include "common.cuh"

namespace rmsbwd {

constexpr int MAX_THREADS = 512;  // and so at most 128 registers a thread
// Elements of each row tensor a thread holds (V x VPT): what 128 registers hold
// beside the dscale sums, for x and dy (plain) or x, res and dy (fused).
constexpr int max_elems(bool fused) { return fused ? 16 : 32; }

// FUSED: res is given (the fused norm); dr may be given with it or alone.
template <typename T, int V, int VPT, bool FUSED>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const float* __restrict__ scale, const T* __restrict__ dy,
                   const T* __restrict__ dr, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, int lanes, float eps) {
  extern __shared__ float sums[];  // [groups][d]: the row groups' dscale sums, at the end
  __shared__ float scratch[MAX_THREADS / 32][2];
  using P = Pack<T, V>;
  const int groups = blockDim.x / lanes, g = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const int nvec = d / V;
  float acc[VPT][V];  // dscale terms of this thread's columns (lane + j lanes) V + e
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;

  // every group takes the same number of turns, so the block-wide reductions line up
  const long long stride = (long long)gridDim.x * groups;
  const long long turns = (rows + stride - 1) / stride;
  for (long long turn = 0; turn < turns; ++turn) {
    const long long row = turn * stride + (long long)blockIdx.x * groups + g;
    const bool in = row < rows;
    const long long off = in ? row * d : 0;
    P xv[VPT], rv[VPT], gv[VPT];  // x, res (fused), dy: held through both row sums
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = lane + j * lanes;
      if (in && i < nvec) {
        xv[j] = load_pack(reinterpret_cast<const P*>(x + off) + i);
        if constexpr (FUSED) rv[j] = load_pack(reinterpret_cast<const P*>(res + off) + i);
        gv[j] = load_pack(reinterpret_cast<const P*>(dy + off) + i);
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = lane + j * lanes;
      if (in && i < nvec) {
        float sc[V];
        load_gains<V>(scale, i, sc);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float r = to_f32(xv[j].v[e]) + (FUSED ? to_f32(rv[j].v[e]) : 0.f);
          ss += r * r;
          dot += to_f32(gv[j].v[e]) * sc[e] * r;
        }
      }
    }
    if (lanes > 32) {  // whole warps a row: shuffles, then the row's warps in order
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      const int warp = threadIdx.x >> 5, per_row = lanes >> 5;
      __syncthreads();  // scratch may still be read from the previous turn
      if ((threadIdx.x & 31) == 0) scratch[warp][0] = ss, scratch[warp][1] = dot;
      __syncthreads();
      ss = dot = 0.f;
      for (int w = g * per_row; w < (g + 1) * per_row; ++w) ss += scratch[w][0], dot += scratch[w][1];
    } else {
      for (int o = lanes >> 1; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
    }
    if (!in) continue;
    const float inv = rsqrtf(ss / d + eps);
    const float coef = dot * inv * inv * inv / d;
    P dv[VPT];  // dr, the cotangent of the fused norm's r: read only now, added to dx
    if (dr) {
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        if (lane + j * lanes < nvec) dv[j] = load_pack(reinterpret_cast<const P*>(dr + off) + lane + j * lanes);
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = lane + j * lanes;
      if (i < nvec) {
        float sc[V];
        load_gains<V>(scale, i, sc);
        P o;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float r = to_f32(xv[j].v[e]) + (FUSED ? to_f32(rv[j].v[e]) : 0.f);
          const float gy = to_f32(gv[j].v[e]);
          float v = inv * (gy * sc[e]) - r * coef;
          if (dr) v += to_f32(dv[j].v[e]);
          o.v[e] = from_f32<T>(v);
          acc[j][e] += gy * r * inv;
        }
        store_pack(reinterpret_cast<P*>(dx + off) + i, o);
      }
    }
  }

  // this block's dscale sums: one group writes them; several add theirs in group order
  float* part = partial + (long long)blockIdx.x * d;
  float* mine = groups == 1 ? part : sums + g * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = lane + j * lanes;
    if (i < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) mine[i * V + e] = acc[j][e];
    }
  }
  if (groups == 1) return;
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += sums[gg * d + c];
    part[c] = s;
  }
}

// dscale[c] = sum over the blocks of partial[block][c]: 32 columns to a block
// of 32 x 32 threads; thread (y, x) adds blocks y, y + 32, ... in order, then
// the 32 sums of a column are added in order. The same bits on every run.
__global__ void __launch_bounds__(1024)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int blocks,
                       int d) {
  __shared__ float part[32][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5, c = blockIdx.x * 32 + x;
  float s = 0.f;
  if (c < d)
    for (int blk = y; blk < blocks; blk += 32) s += partial[(long long)blk * d + c];
  part[y][x] = s;
  __syncthreads();
  if (y == 0 && c < d) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t += part[i][x];
    dscale[c] = t;
  }
}

template <typename T, int V, bool FUSED>
static int launch_v(const void* x, const void* res, const void* scale, const void* dy,
                    const void* dr, void* dx, void* partial, long long rows, int d, float eps,
                    int lanes, int rows_per_block, int vpt, int blocks, cudaStream_t s) {
  const int threads = lanes * rows_per_block;
  const int smem = rows_per_block > 1 ? rows_per_block * d * (int)sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const T *xp = (const T*)x, *rp = (const T*)res, *gp = (const T*)dy, *dp = (const T*)dr;
  const float* sp = (const float*)scale;
  T* op = (T*)dx;
  float* pp = (float*)partial;
#define RMSBWD_CASE(VPT)                                                                       \
  case VPT:                                                                                   \
    if constexpr (V * VPT <= max_elems(FUSED)) {                                              \
      rmsnorm_bwd_kernel<T, V, VPT, FUSED><<<blocks, threads, smem, s>>>(xp, rp, sp, gp, dp, op, pp, \
                                                                       rows, d, lanes, eps);  \
      break;                                                                                  \
    }                                                                                         \
    return (int)cudaErrorInvalidValue;
  switch (vpt) {
    RMSBWD_CASE(1)
    RMSBWD_CASE(2)
    RMSBWD_CASE(4)
    RMSBWD_CASE(8)
    RMSBWD_CASE(16)
    RMSBWD_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RMSBWD_CASE
  return (int)cudaGetLastError();
}

template <typename T, int V>
static int launch_t(const void* x, const void* res, const void* scale, const void* dy,
                    const void* dr, void* dx, void* partial, long long rows, int d, float eps,
                    int lanes, int rows_per_block, int vpt, int blocks, cudaStream_t s) {
  return res ? launch_v<T, V, true>(x, res, scale, dy, dr, dx, partial, rows, d, eps, lanes,
                                    rows_per_block, vpt, blocks, s)
             : launch_v<T, V, false>(x, res, scale, dy, dr, dx, partial, rows, d, eps, lanes,
                                     rows_per_block, vpt, blocks, s);
}

}  // namespace rmsbwd

// x, res (null: the plain norm), scale, dy, dr (null: none), dx, partial
// (float32 (blocks, d) scratch), dscale (float32 (d,)), rows, d, eps, dtype,
// then the plan of kernels/rmsnorm/rmsnorm_bwd.py::launch_plan: vec (elements
// per load: 16 bytes' worth, or 1), lanes (threads of a row: a power of two up
// to 32, or whole warps), rows per block, vpt (loads per thread), blocks;
// stream. The plan must cover the row.
extern "C" int launch_rmsnorm_bwd(const void* x, const void* res, const void* scale,
                                  const void* dy, const void* dr, void* dx, void* partial,
                                  void* dscale, long long rows, int d, float eps, int dtype,
                                  int vec, int lanes, int rows_per_block, int vpt, int blocks,
                                  void* stream) {
  if (rows == 0 || d == 0) return 0;
  const int threads = lanes * rows_per_block;
  const bool group = lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (lanes < 1 || rows_per_block < 1 || blocks < 1 || threads > rmsbwd::MAX_THREADS ||
      threads % 32 || !(group || lanes % 32 == 0) || vec < 1 || d % vec ||
      (long long)lanes * vpt * vec < d)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (dtype == kF32 && vec == 4)
    err = rmsbwd::launch_t<float, 4>(x, res, scale, dy, dr, dx, partial, rows, d, eps, lanes,
                                     rows_per_block, vpt, blocks, s);
  else if (dtype == kF32 && vec == 1)
    err = rmsbwd::launch_t<float, 1>(x, res, scale, dy, dr, dx, partial, rows, d, eps, lanes,
                                     rows_per_block, vpt, blocks, s);
  else if (dtype == kBF16 && vec == 8)
    err = rmsbwd::launch_t<__nv_bfloat16, 8>(x, res, scale, dy, dr, dx, partial, rows, d, eps,
                                             lanes, rows_per_block, vpt, blocks, s);
  else if (dtype == kBF16 && vec == 1)
    err = rmsbwd::launch_t<__nv_bfloat16, 1>(x, res, scale, dy, dr, dx, partial, rows, d, eps,
                                             lanes, rows_per_block, vpt, blocks, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  rmsbwd::reduce_partials_kernel<<<(d + 31) / 32, 1024, 0, s>>>((const float*)partial,
                                                                (float*)dscale, blocks, d);
  return (int)cudaGetLastError();
}
