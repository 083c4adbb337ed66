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
//   byte. Only the tensor cores (wgmma, 989 TFLOP/s in bf16) reach that rate;
//   fp32 FMAs top out at 67 TFLOP/s.
//
// Deterministic, with no atomics: three launches on one stream.
// 1. delta_kernel: delta = rowsum(dO * O) in float32, one warp per query row.
// 2. a dK/dV kernel: one block per (64-key tile, kv head, batch). It keeps its
//    K and V tiles and its dK and dV accumulators for the whole launch and
//    walks, for each of the G query heads of its kv head, the 64-row query
//    tiles that the causal diagonal and the window leave live for its keys:
//    the GQA sum over the G heads happens in registers, in a fixed order.
// 3. a dQ kernel: one block per (64-row query tile, query head, batch). It
//    keeps its Q, dO, lse and delta and its dQ accumulator, and walks the live
//    key tiles, as the forward does, heaviest tiles first.
// Splitting dK/dV from dQ recomputes S and dP in both: 14 dh flops are
// executed per live pair against the bound's 10. That is the price of no
// atomics: a dQ summed across the key tiles' blocks would need them.
//
// Two routes, chosen by (dtype, dh) in the launcher, as the forward's:
//
// A. bf16, dh 64, 80 and 128 (the model's path): dkdv_tc_kernel and
//   dq_tc_kernel, every product on wgmma. A block is one warpgroup (128
//   threads) over 64 rows. Every tile is a TMA box of 64 rows read from the
//   model's (B, S, H, dh) layout through 4-D (dh, heads, S, B) maps, as the
//   forward reads it, 128-byte swizzled; rows past S arrive as zeros.
//   - dK/dV: the K and V tiles are loaded once; the (g, query tile) walk
//     streams Q and dO through a 2-stage TMA ring (tile i + 1 loads while
//     tile i is multiplied), and each tile's lse (times log2 e) and delta are
//     read from global memory one tile ahead into registers and parked in
//     shared memory. Keys are the M rows, so the transposes come out
//     directly: S^T = K.Q^T and dP^T = V.dO^T are SS products with both
//     operands K-major (the forward's Q.K^T form); P^T = exp2(S^T scale
//     log2 e - lse log2 e), masked entries 0, and dS^T = P^T (dP^T - delta)
//     scale are formed in fp32 registers and rounded to bf16 pairs there, so
//     the accumulator fragment is the A fragment of dV += P^T.dO and dK +=
//     dS^T.Q, whose B operands (dO, Q: queries are rows, dh contiguous) are
//     MN-major (the forward's P.V form).
//   - dQ: Q and dO are loaded once; a 2-stage ring walks the K and V tiles
//     from the window's first live tile to the diagonal. S = Q.K^T and dP =
//     dO.V^T are SS; dS is rounded to bf16 in registers, and dQ += dS.K reads
//     K MN-major.
//   Rounding P and dS to bf16 before their products is the one departure
//   from _bwd_rule, which keeps them in float32 (BWD_BAR_NOTE's bf16 bar
//   holds it). dh 80 runs in the forward's padded 128-column tiles: maps
//   whose dh extent stays 80, so TMA zero-fills columns 80-127; S and dP walk
//   the 5 real k16 steps; dQ, dK and dV are n128 products whose columns past
//   80 are zero and never stored. Results are staged in shared memory with
//   the tiles' swizzle and leave as guarded 16-byte stores through the (b, h,
//   s) strides; rows past S are never written.
//   Occupancy is what to watch. At dh 80 and 128 the dK/dV accumulators are
//   64 + 64 fp32 registers a thread and S^T, dP^T 32 each:
//   __launch_bounds__(128, 2) leaves up to 255 registers, and two blocks of
//   100,376 bytes of shared memory (51,224 at dh 64) share an SM, so one
//   block's exponentials overlap the other's products. ptxas (sm_90a, CUDA
//   12.8, printed by chip_smoke.py's build phase): dkdv_tc_kernel 239 / 238 /
//   173 registers at dh 128 / 80 / 64, dq_tc_kernel 156 / 155 / 122, no
//   spills.
//
// B. fp32 (dh 32, 64, 80, 128) and bf16 at dh 32: dkdv_kernel and dq_kernel
//   on fp32 FMAs. fp32 has no tensor-core route that keeps BWD_BAR_NOTE's
//   1e-4 bar (TF32 keeps ~3 decimal digits), and dh 32 is only in the sweeps.
//   Every tile is staged in shared memory as float32 (bf16 widened on load),
//   rows padded by one float so that the 16 lanes reading a column hit 16
//   banks. A 64 x 64 product of two such tiles gives each of the 256 threads
//   a 4 x 4 block of it: rows 4 ty.. 4 ty + 3, columns tx + 16 j. Tensors are
//   read and written through their strides, so the model's (B, S, H, dh)
//   views are taken in place; rows past S read as zeros and are masked, and
//   nothing is written past S.
#include "common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------ tensor-core route
namespace fabwd_tc {

constexpr int ROWS = 64;           // rows of every tile: keys of a dK/dV block, queries of a dQ block
constexpr int THREADS = 128;       // one warpgroup
constexpr int STAGES = 2;          // ring depth
constexpr int BOX_D = SW128_COLS;  // dh columns of one TMA box: one 128-byte swizzle row
constexpr int ROW = BOX_D * 2;     // bytes of a tile row
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of both kernels: a pair of tiles held for the whole launch (K
// and V; Q and dO), a ring of STAGES pairs (Q and dO; K and V), the ring's
// lse and delta [STAGES][2][ROWS] (dK/dV only), then the mbarriers (the held
// pair's, one per stage). A tile is [DP / 64][ROWS][64] bf16, DP being dh in
// whole 64-column boxes; every tile is 1024-byte aligned.
template <int DH>
struct Layout {
  static constexpr int DP = sw128_tile_cols(DH);
  static constexpr int TILE = ROWS * DP * 2, PAIR = 2 * TILE;
  static constexpr int RING_OFF = PAIR, STAT_OFF = RING_OFF + STAGES * PAIR;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * ROWS * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;  // + slack to align the base
};

using fabwd::Strides;

// Rows pos.. of head `head` of two maps into the tile pair at `dst` (one thread).
template <int DH>
__device__ __forceinline__ void load_pair(const CUtensorMap* a, const CUtensorMap* b, uint32_t dst,
                                          uint32_t bar, int head, int pos, int batch) {
  using L = Layout<DH>;
  mbar_expect_tx(bar, L::PAIR);
#pragma unroll
  for (int hh = 0; hh < L::DP / BOX_D; ++hh) {
    tma_load_4d(dst + hh * ROWS * ROW, a, bar, hh * BOX_D, head, pos, batch);
    tma_load_4d(dst + L::TILE + hh * ROWS * ROW, b, bar, hh * BOX_D, head, pos, batch);
  }
}

// D (64 x 64) = A (64 x DH) . B (64 x DH)^T, both tiles K-major, over the real
// k16 steps of dh; issued, not waited for.
template <int DH>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {  // 4 k16 steps per 128-byte box
    const uint32_t off = (kk / 4) * ROWS * ROW + (kk % 4) * 32;
    wgmma_m64n64k16_ss(d, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// D (64 x DP) += A (64 x 64, registers: bf16 pairs, a[4 kk..4 kk + 3] the
// fragment of columns 16 kk..) . B (a 64-row tile, MN-major); issued, not waited for.
template <int DP>
__device__ __forceinline__ void product_rs(float (&d)[DP / 2], const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {  // 16 rows of B a step: two 8-row groups
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_pv<DP>(d, frag, sw128_desc(b + kk * 16 * ROW, ROWS * ROW, 1024));
  }
}

// The DH real columns of a 64 x DP fp32 accumulator, rounded to bf16, to rows
// row0.. (< S) of dst: staged in `tile` (shared memory no longer read by any
// product; the tiles' swizzle, conflict-free), then 16-byte stores.
template <int DH>
__device__ __forceinline__ void store_tile(uint8_t* tile, const float (&acc)[sw128_tile_cols(DH) / 2],
                                           __nv_bfloat16* dst, long long ss, int row0, int S) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rl = warp * 16 + (lane >> 2);  // the thread's rows rl and rl + 8
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int hh = j / 8, c = j % 8;
    uint8_t* base = tile + hh * ROWS * ROW + (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(base + rl * ROW + ((c ^ (rl & 7)) << 4)) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * ROW + ((c ^ ((rl + 8) & 7)) << 4)) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < DH / 16; ++it) {  // 64 rows x DH / 8 chunks of 16 bytes
    const int idx = it * THREADS + t, row = idx / (DH / 8), cc = idx % (DH / 8);
    const uint4 val = *reinterpret_cast<const uint4*>(tile + (cc / 8) * ROWS * ROW + row * ROW +
                                                      (((cc % 8) ^ (row & 7)) << 4));
    if (row0 + row < S) *reinterpret_cast<uint4*>(dst + (row0 + row) * ss + cc * 8) = val;
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void init_bars(uint32_t bar0) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Whether every (query, key) pair of the 64-row tiles at q0 and k0 is live.
__device__ __forceinline__ bool whole_tile(int q0, int k0, int S, int window) {
  return q0 + ROWS <= S && k0 + ROWS - 1 <= q0 && (window <= 0 || k0 > q0 + ROWS - 1 - window);
}

__device__ __forceinline__ bool live(int q, int key, int S, int window) {
  return q < S && key <= q && (window <= 0 || key > q - window);
}

// Accumulator fragment (m64n64, fp32) of thread t: element e sits at row
// 16 (t / 32 % 4) + (t % 32) / 4 + 8 ((e / 2) % 2), column 8 (e / 4) + 2 (t % 4) + e % 2.
__device__ __forceinline__ int frag_row(int e) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int e) { return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1); }

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides dks,
               Strides dvs, int Hq, int S, int G, int window, float scale, float scale_log2) {
  using L = Layout<DH>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + L::TILE, sRing = sK + L::RING_OFF;
  float* stats = reinterpret_cast<float*>(smem + L::STAT_OFF);  // [stage][lse log2 e | delta][ROWS]
  const uint32_t barKV = sK + L::BAR_OFF, barRing = barKV + 8;  // stage s: barRing + 8 s

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int k0 = kt * ROWS;
  // query tiles live for keys k0 .. k0 + 63: from the diagonal to the window's end
  const int q_end = window > 0 ? min(S, k0 + ROWS - 1 + window) : S;
  const int qt_lo = kt, nq = (q_end + ROWS - 1) / ROWS - qt_lo, n_it = G * nq;
  // this thread's share of a tile's stats: t < 64 the lse of query t, else the delta of t - 64
  const float* stat_src = t < ROWS ? lse : delta;
  const float stat_mul = t < ROWS ? LOG2E : 1.f;
  auto stat = [&](int it) {
    const int q = (qt_lo + it % nq) * ROWS + (t & (ROWS - 1));
    return q < S ? stat_src[((long long)b * Hq + hk * G + it / nq) * S + q] * stat_mul : 0.f;
  };

  init_bars(barKV);
  if (t == 0) {
    load_pair<DH>(&kmap, &vmap, sK, barKV, hk, k0, b);
    load_pair<DH>(&qmap, &dmap, sRing, barRing, hk * G, qt_lo * ROWS, b);
  }
  stats[t] = stat(0);
  __syncthreads();

  float dK[DP / 2], dV[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dK[i] = dV[i] = 0.f;
  mbar_wait(barKV, 0);

  for (int it = 0; it < n_it; ++it) {
    const bool more = it + 1 < n_it;
    if (t == 0 && more)  // into the stage freed at the end of it - 1
      load_pair<DH>(&qmap, &dmap, sRing + ((it + 1) % STAGES) * L::PAIR,
                    barRing + 8 * ((it + 1) % STAGES), hk * G + (it + 1) / nq,
                    (qt_lo + (it + 1) % nq) * ROWS, b);
    const float next_stat = more ? stat(it + 1) : 0.f;
    const int st = it % STAGES, q0 = (qt_lo + it % nq) * ROWS;
    const uint32_t sQ = sRing + st * L::PAIR, sdO = sQ + L::TILE;
    mbar_wait(barRing + 8 * st, (it / STAGES) & 1);

    float s[32] = {}, dp[32] = {};  // S^T and dP^T: keys are rows, queries columns
    wgmma_fence();
    product_abt<DH>(s, sK, sQ);
    product_abt<DH>(dp, sV, sdO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const float* lse2 = stats + st * 2 * ROWS;
    const float* dlt = lse2 + ROWS;
    const bool whole = whole_tile(q0, k0, S, window);
    uint32_t pa[16], da[16];  // P^T and dS^T as bf16 pairs
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float p[2], ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int c = frag_col(e + x);
        const bool ok = whole || live(q0 + c, k0 + frag_row(e + x), S, window);
        p[x] = ok ? exp2f(fmaf(s[e + x], scale_log2, -lse2[c])) : 0.f;
        ds[x] = p[x] * (dp[e + x] - dlt[c]) * scale;
      }
      pa[e / 2] = pack_bf16(p[0], p[1]);
      da[e / 2] = pack_bf16(ds[0], ds[1]);
    }
    wgmma_fence();  // pa, da and the accumulators were written by this thread
    product_rs<DP>(dV, pa, sdO);  // dV += P^T dO
    product_rs<DP>(dK, da, sQ);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dV);
    fence_regs(dK);
    stats[((it + 1) % STAGES) * 2 * ROWS + t] = next_stat;  // that stage's stats were read in it - 1
    __syncthreads();  // stage st is read by every warp before it is loaded again
  }

  store_tile<DH>(smem, dK, dk + b * dks.b + hk * dks.h, dks.s, k0, S);  // over the K tile
  store_tile<DH>(smem + L::TILE, dV, dv + b * dvs.b + hk * dvs.h, dvs.s, k0, S);  // over V
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, Strides dqs, int S, int G, int window, float scale,
             float scale_log2) {
  using L = Layout<DH>;
  constexpr int DP = L::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + L::TILE, sRing = sQ + L::RING_OFF;
  const uint32_t barQ = sQ + L::BAR_OFF, barRing = barQ + 8;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) query tiles start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G, t = threadIdx.x;
  const int q0 = qt * ROWS;
  // key tiles live for queries q0 .. q0 + 63: the window's first to the diagonal
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / ROWS : 0;
  const int n_it = (min(S, q0 + ROWS) + ROWS - 1) / ROWS - kt_lo;

  init_bars(barQ);
  if (t == 0) {
    load_pair<DH>(&qmap, &dmap, sQ, barQ, h, q0, b);
    load_pair<DH>(&kmap, &vmap, sRing, barRing, hk, kt_lo * ROWS, b);
  }
  // the stats of this thread's rows frag_row(0) and frag_row(2) (8 further)
  float lse2[2], dlt[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int q = q0 + frag_row(2 * x);
    const long long i = ((long long)b * gridDim.y + h) * S + q;
    lse2[x] = q < S ? lse[i] * LOG2E : 0.f;
    dlt[x] = q < S ? delta[i] : 0.f;
  }

  float dQ[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dQ[i] = 0.f;
  mbar_wait(barQ, 0);

  for (int it = 0; it < n_it; ++it) {
    if (t == 0 && it + 1 < n_it)  // into the stage freed at the end of it - 1
      load_pair<DH>(&kmap, &vmap, sRing + ((it + 1) % STAGES) * L::PAIR,
                    barRing + 8 * ((it + 1) % STAGES), hk, (kt_lo + it + 1) * ROWS, b);
    const int st = it % STAGES, k0 = (kt_lo + it) * ROWS;
    const uint32_t sK = sRing + st * L::PAIR, sV = sK + L::TILE;
    mbar_wait(barRing + 8 * st, (it / STAGES) & 1);

    float s[32] = {}, dp[32] = {};  // S and dP: queries are rows, keys columns
    wgmma_fence();
    product_abt<DH>(s, sQ, sK);
    product_abt<DH>(dp, sdO, sV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool whole = whole_tile(q0, k0, S, window);
    uint32_t da[16];  // dS as bf16 pairs
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int x = (e >> 1) & 1;  // row frag_row(0) or the one 8 further
      float ds[2];
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const bool ok = whole || live(q0 + frag_row(e + y), k0 + frag_col(e + y), S, window);
        const float p = ok ? exp2f(fmaf(s[e + y], scale_log2, -lse2[x])) : 0.f;
        ds[y] = p * (dp[e + y] - dlt[x]) * scale;
      }
      da[e / 2] = pack_bf16(ds[0], ds[1]);
    }
    wgmma_fence();
    product_rs<DP>(dQ, da, sK);  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dQ);
    __syncthreads();  // stage st is read by every warp before it is loaded again
  }

  store_tile<DH>(smem, dQ, dq + b * dqs.b + h * dqs.h, dqs.s, q0, S);  // over the Q tile
}

template <int DH>
static int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                  int Hkv, int S, const long long* st, int window, float scale, cudaStream_t s) {
  CUtensorMap qm, km, vm, dm;
  if (!make_map(&qm, q, DH, Hq, S, B, st[0], st[1], st[2], ROWS) ||
      !make_map(&km, k, DH, Hkv, S, B, st[3], st[4], st[5], ROWS) ||
      !make_map(&vm, v, DH, Hkv, S, B, st[6], st[7], st[8], ROWS) ||
      !make_map(&dm, dout, DH, Hq, S, B, st[12], st[13], st[14], ROWS))
    return (int)cudaErrorInvalidValue;
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const Strides os{st[9], st[10], st[11]}, ds{st[12], st[13], st[14]};
  const long long rows = (long long)B * Hq * S;
  fabwd::delta_kernel<__nv_bfloat16, DH>
      <<<(unsigned)((rows + fabwd::THREADS / 32 - 1) / (fabwd::THREADS / 32)), fabwd::THREADS, 0, s>>>(
          (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, os, ds, Hq, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int G = Hq / Hkv, tiles = (S + ROWS - 1) / ROWS, smem = Layout<DH>::BYTES;
  const float scale_log2 = scale * LOG2E;
  auto dkdv = dkdv_tc_kernel<DH>;
  auto dqk = dq_tc_kernel<DH>;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return (int)err;
  dkdv<<<dim3(tiles, Hkv, B), THREADS, smem, s>>>(qm, km, vm, dm, lse, delta, (__nv_bfloat16*)dk,
                                                  (__nv_bfloat16*)dv, dks, dvs, Hq, S, G, window,
                                                  scale, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dqk<<<dim3(tiles, Hq, B), THREADS, smem, s>>>(qm, km, vm, dm, lse, delta, (__nv_bfloat16*)dq, dqs,
                                                S, G, window, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace fabwd_tc

// q, k, v, out, dout, lse (float32 (B, Hq, S)), delta (float32 (B, Hq, S)
// scratch), dq, dk, dv; B, Hq, Hkv, S, dh; (b, h, s) strides of q, k, v, out,
// dout, dq, dk and dv in that order; box_d, box_q, box_k: the TMA boxes the
// caller planned for the tensor-core route (64, 64, 64), or zeros for the
// fp32-tile kernels, any other value refused, so that the Python plan
// (kernels/flash_attention/flash_attention_bwd.py::launch_plan) and this file
// cannot drift apart silently; window (<= 0: none), scale, dtype, stream.
extern "C" int launch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Hq, int Hkv, int S, int dh, const long long* strides,
                                          int box_d, int box_q, int box_k, int window, float scale,
                                          int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool tc = dtype == kBF16 && (dh == 64 || dh == 80 || dh == 128);
  if (tc != (box_d != 0) ||
      (tc && (box_d != fabwd_tc::BOX_D || box_q != fabwd_tc::ROWS || box_k != fabwd_tc::ROWS)))
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)lse;
  float* d = (float*)delta;
  if (tc && dh == 64)
    return fabwd_tc::launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S, strides, window, scale, s);
  if (tc && dh == 80)
    return fabwd_tc::launch<80>(q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S, strides, window, scale, s);
  if (tc)
    return fabwd_tc::launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S, strides, window, scale, s);
  if (dtype == kF32)
    return fabwd::launch_dh<float>(dh, q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S, strides,
                                   window, scale, s);
  if (dtype == kBF16 && dh == 32)
    return fabwd::launch<__nv_bfloat16, 32>(q, k, v, o, dout, l, d, dq, dk, dv, B, Hq, Hkv, S,
                                            strides, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
