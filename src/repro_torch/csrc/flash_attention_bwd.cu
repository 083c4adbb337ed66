// Backward of causal GQA flash attention with an optional sliding window.
//
// Not a port of a TPU kernel: JAX computes this backward in jnp, in
// src/repro/models/flash_vjp.py::_bwd_rule. It takes what the forward saved,
// q, k, v, out and the float32 log-sum-exp `lse` of every query row
// (flash_attention.cu), and dout, and gives dq, dk and dv by Dao's
// recurrences, as _bwd_rule writes them:
//   P  = exp(q.k * scale - lse)            (recomputed, masked entries 0)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q,  delta = rowsum(dO * O),
// every sum in float32, each output rounded once to the inputs' dtype.
// Bound on Hopper: operations. 10 * dh flops per live (query, key) pair in the
//   three products of Dao's backward that the forward did not do, plus the
//   recomputed q.k^T; at danube's training shape (dh 80) that is ~800 flops a
//   byte. This first version runs on fp32 FMAs (67 TFLOP/s at most), not the
//   tensor cores: right and simple first.
//
// Deterministic, with no atomics: three launches on one stream.
// 1. delta_kernel: delta = rowsum(dO * O) in float32, one warp per query row.
// 2. dkdv_kernel: one block per (64-key tile, kv head, batch). It keeps its K
//    and V tiles and its dK and dV accumulators for the whole launch and walks,
//    for each of the G query heads of its kv head, the 64-row query tiles that
//    the causal diagonal and the window leave live for its keys: the GQA sum
//    over the G heads happens in registers, in a fixed order.
// 3. dq_kernel: one block per (64-row query tile, query head, batch). It keeps
//    its Q, dO, lse and delta and its dQ accumulator, and walks the live key
//    tiles, as the forward does.
// Every tile is staged in shared memory as float32 (bf16 widened on load), rows
// padded by one float so that the 16 lanes reading a column hit 16 banks. A
// 64 x 64 product of two such tiles gives each of the 256 threads a 4 x 4
// block of it: rows 4 ty.. 4 ty + 3, columns tx + 16 j. Tensors are read and
// written through their strides, so the model's (B, S, H, dh) views are taken
// in place; rows past S read as zeros and are masked, and nothing is written
// past S.
#include "common.cuh"

namespace fabwd {

constexpr int BQ = 64, BK = 64, THREADS = 256;

struct Strides {  // (batch, head, position) strides in elements; dh is contiguous
  long long b, h, s;
};

// Rows row0.. of one (batch, head) slice into a float32 tile [rows][DH + 1].
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st, int row0, int S,
                                          int rows) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += THREADS) {
    const int r = idx / DH, d = idx % DH, row = row0 + r;
    dst[r * (DH + 1) + d] = row < S ? to_f32(src[row * st.s + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[4 ty + i][d] * B[tx + 16 j][d] over two [64][DH + 1] tiles.
template <int DH>
__device__ __forceinline__ void product_abt(float (&acc)[4][4], const float* A, const float* B,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// acc[i][j] += sum_r W[r][4 ty + i] * X[r][tx + 16 j] (W: [64][65] read transposed, X:
// [64][DH + 1]) when `transposed`, else sum_r W[4 ty + i][r] * X[r][tx + 16 j].
template <int DH, bool transposed>
__device__ __forceinline__ void accumulate(float (&acc)[4][DH / 16], const float* W, const float* X,
                                           int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < 64; ++r) {
    float w[4], x[DH / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = transposed ? W[r * (BK + 1) + 4 * ty + i] : W[(4 * ty + i) * (BK + 1) + r];
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) x[j] = X[r * (DH + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) acc[i][j] += w[i] * x[j];
  }
}

// Rows 4 ty + i of a [64][DH] accumulator, columns tx + 16 j, to rows row0.. of dst (< S).
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, Strides st, const float (&acc)[4][DH / 16],
                                           int row0, int S, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) dst[row * st.s + tx + 16 * j] = from_f32<T>(acc[i][j]);
    }
  }
}

__device__ __forceinline__ bool live(int q, int key, int S, int window) {
  return q < S && key <= q && (window <= 0 || key > q - window);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             Strides os, Strides ds, int Hq, int S, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31, s = row % S, h = (row / S) % Hq, b = row / ((long long)S * Hq);
  const T* op = o + b * os.b + h * os.h + s * os.s;
  const T* dp = dout + b * ds.b + h * ds.h + s * ds.s;
  float sum = 0.f;
  for (int d = lane; d < DH; d += 32) sum += to_f32(op[d]) * to_f32(dp[d]);
  sum = warp_sum(sum);
  if (lane == 0) delta[row] = sum;
}

template <int DH>
constexpr int dkdv_smem_floats() {  // K, V, Q, dO tiles, P and dS, lse and delta
  return 4 * 64 * (DH + 1) + 2 * 64 * (BK + 1) + 2 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Strides qs,
            Strides ks, Strides vs, Strides ds, Strides dks, Strides dvs, int Hq, int S, int G,
            int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * (DH + 1);
  float* Qs = Vs + BK * (DH + 1);
  float* dOs = Qs + BQ * (DH + 1);
  float* Ps = dOs + BQ * (DH + 1);    // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);    // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * BK;
  load_tile<T, DH>(Ks, k + b * ks.b + hk * ks.h, ks, k0, S, BK);
  load_tile<T, DH>(Vs, v + b * vs.b + hk * vs.h, vs, k0, S, BK);

  float dK[4][DH / 16], dV[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dK[i][j] = dV[i][j] = 0.f;

  // query tiles live for keys k0 .. k0 + BK - 1: from the diagonal to the window's end
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  const int qt_lo = k0 / BQ, qt_hi = (q_end + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long row_base = ((long long)b * Hq + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
      load_tile<T, DH>(Qs, q + b * qs.b + h * qs.h, qs, q0, S, BQ);
      load_tile<T, DH>(dOs, dout + b * ds.b + h * ds.h, ds, q0, S, BQ);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[row_base + q0 + r] : 0.f;
        delta_s[r] = in ? delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      product_abt<DH>(s, Qs, Ks, ty, tx);
      product_abt<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = live(q0 + r, k0 + c, S, window) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();
      accumulate<DH, true>(dV, Ps, dOs, ty, tx);
      accumulate<DH, true>(dK, dSs, Qs, ty, tx);
    }
  }
  store_rows<T, DH>(dk + b * dks.b + hk * dks.h, dks, dK, k0, S, ty, tx);
  store_rows<T, DH>(dv + b * dvs.b + hk * dvs.h, dvs, dV, k0, S, ty, tx);
}

template <int DH>
constexpr int dq_smem_floats() {  // Q, dO, K, V tiles, dS, lse and delta
  return 4 * 64 * (DH + 1) + 64 * (BK + 1) + 2 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
          Strides ds, Strides dqs, int Hq, int S, int G, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (DH + 1);
  float* Ks = dOs + BQ * (DH + 1);
  float* Vs = Ks + BK * (DH + 1);
  float* dSs = Vs + BK * (DH + 1);  // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);
  float* delta_s = lse_s + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) query tiles start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * BQ;
  const long long row_base = ((long long)b * Hq + h) * S;
  load_tile<T, DH>(Qs, q + b * qs.b + h * qs.h, qs, q0, S, BQ);
  load_tile<T, DH>(dOs, dout + b * ds.b + h * ds.h, ds, q0, S, BQ);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[row_base + q0 + r] : 0.f;
    delta_s[r] = in ? delta[row_base + q0 + r] : 0.f;
  }

  float dQ[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) dQ[i][j] = 0.f;

  // key tiles live for queries q0 .. q0 + BQ - 1: the window's first to the diagonal
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = (min(S, q0 + BQ) + BK - 1) / BK;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_tile<T, DH>(Ks, k + b * ks.b + hk * ks.h, ks, k0, S, BK);
    load_tile<T, DH>(Vs, v + b * vs.b + hk * vs.h, vs, k0, S, BK);
    __syncthreads();
    float s[4][4], dp[4][4];
    product_abt<DH>(s, Qs, Ks, ty, tx);
    product_abt<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = live(q0 + r, k0 + c, S, window) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * (BK + 1) + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    accumulate<DH, false>(dQ, dSs, Ks, ty, tx);
  }
  store_rows<T, DH>(dq + b * dqs.b + h * dqs.h, dqs, dQ, q0, S, ty, tx);
}

template <typename T, int DH>
static int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                  int Hkv, int S, const long long* st, int window, float scale, cudaStream_t s) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]}, ds{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const long long rows = (long long)B * Hq * S;
  delta_kernel<T, DH><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, s>>>(
      (const T*)o, (const T*)dout, delta, os, ds, Hq, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int G = Hq / Hkv, tiles = (S + 63) / 64;
  const int smem_kv = dkdv_smem_floats<DH>() * (int)sizeof(float);
  auto dkdv = dkdv_kernel<T, DH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(tiles, Hkv, B), THREADS, smem_kv, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, qs, ks,
      vs, ds, dks, dvs, Hq, S, G, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_q = dq_smem_floats<DH>() * (int)sizeof(float);
  auto dqk = dq_kernel<T, DH>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(tiles, Hq, B), THREADS, smem_q, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, qs, ks, vs, ds,
      dqs, Hq, S, G, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dh(int dh, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int B, int Hq, int Hkv, int S, const long long* st, int window,
                     float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, st, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, st, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, st, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, st, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fabwd

// q, k, v, out, dout, lse (float32 (B, Hq, S)), delta (float32 (B, Hq, S)
// scratch), dq, dk, dv; B, Hq, Hkv, S, dh; (b, h, s) strides of q, k, v, out,
// dout, dq, dk and dv in that order; window (<= 0: none), scale, dtype, stream.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Hq, int Hkv, int S, int dh, const long long* strides,
                                          int window, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return fabwd::launch_dh<float>(dh, q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk,
                                   dv, B, Hq, Hkv, S, strides, window, scale, s);
  if (dtype == kBF16)
    return fabwd::launch_dh<__nv_bfloat16>(dh, q, k, v, o, dout, (const float*)lse, (float*)delta,
                                           dq, dk, dv, B, Hq, Hkv, S, strides, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
