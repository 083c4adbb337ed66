// Causal GQA flash-attention forward with an optional sliding window.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, _fa_kernel
//   (launched by flash_attention_fwd).
// Computes, for each batch b, query head h (kv head h / G) and query row i:
//   out[i] = sum_j softmax_j(q[i].k[j] * scale) v[j] over keys j <= i (and
//   j > i - window), with the online softmax of the TPU kernel: m, l and acc
//   in float32, masked scores at -1e30, l clamped at 1e-30, p rounded to v's
//   dtype before the PV product.
// Bound on Hopper: operations. 4 * dh flops per unmasked (i, j) pair against
//   one read of q, k, v and one write of out; at dh = 128 and S = 1024 that is
//   ~330 flops a byte, above the card's ~295 for bf16 tensor cores. Only the
//   tensor cores (wgmma) reach that rate: fp32 FMAs top out at 67 TFLOP/s.
//
// With a non-null `lse` (training), each kernel also writes the log-sum-exp of
// every query row's scaled scores, float32 (B, Hq, S) contiguous, as
// repro/models/flash_vjp.py's _fwd does: m + log(max(l, 1e-30)) in natural
// units. The backward (flash_attention_bwd.cu) recomputes P from it. Serving
// passes null and writes nothing more.
//
// Two kernels, chosen explicitly by (dtype, dh) in the launcher:
//
// 1. bf16, dh 64, 80 and 128 (the model's path): flash_attention_tc_kernel.
//   A block takes 128 query rows of one (batch, query head): two warpgroups,
//   64 rows each. TMA loads Q once and walks the K/V tiles (64 keys) through
//   a 2-stage ring in shared memory, each stage completed on an mbarrier, so
//   tile j+1 loads while tile j is multiplied. S = Q.K^T is a wgmma from
//   shared memory (both operands K-major: rows with dh contiguous) into fp32
//   registers: the TPU kernel's bf16 inputs widened to fp32, since a product
//   of two bf16 is exact in fp32. The online softmax runs on that fragment
//   (a row's max from shuffles in the quad of threads that holds it); P is
//   rounded to bf16 in registers and is the A operand of O += P.V, whose B
//   operand V is MN-major (keys are rows, dh contiguous) and so transposed.
//   The tensor maps read the model's (B, S, H, dh) layout in place as 4-D
//   (dh, heads, S, B) boxes of 64 dh columns (one 128-byte swizzle row);
//   rows past S arrive as zeros, so the key < S mask stays explicit. dh 80
//   (h2o-danube) runs in tiles of 128 columns (two boxes) over maps whose dh
//   extent stays 80: TMA zero-fills columns 80-127, so no extra byte is read.
//   Q.K^T walks only the 5 real k16 steps; P.V is the n128 product, whose
//   columns past 80 come out zero and are never stored. Output
//   rows are staged through the Q tile and leave as guarded 16-byte stores.
//   The loop starts at the window's first live tile and stops at the causal
//   diagonal; each warpgroup skips the tiles that are dead for its rows.
//   Registers are capped at 128 a thread so that two blocks share an SM
//   (2 x 97 KB of shared memory): one block's softmax overlaps the other's
//   products. Within a block the loads overlap the products through the
//   ring; there is no warp specialisation yet.
//
// 2. fp32 (dh 32, 64, 80, 128) and bf16 at dh 32: flash_attention_kernel, fp32 FMAs from
//   float32 shared-memory tiles. fp32 has no tensor-core route that keeps
//   the 2e-5 bar (TF32 keeps ~3 decimal digits), and dh 32 is only in the
//   sweeps. One block of 256 threads per (64-row q block, query head,
//   batch); four threads own a query row: each computes 16 of the 64 scores
//   of a key tile, the row max and sum come from two shuffles, and each
//   keeps dh/4 accumulator columns in registers. Layouts arrive as strides.
#include "common.cuh"
#include "hopper.cuh"

constexpr int BQ = 64, BK = 64, THREADS = 256;

template <int DH>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (2 * BQ * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, float* __restrict__ lse, int S, int G,
                       long long qsb, long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss, long long osb,
                       long long osh, long long oss, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DH + 1]
  float* Ks = Qs + BQ * (DH + 1);      // [BK][DH + 1]
  float* Vs = Ks + BK * (DH + 1);      // [BK][DH]
  float* Ps = Vs + BK * DH;            // [BQ][BK + 1]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest (last) q blocks start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int t = threadIdx.x, r = t >> 2, c0 = t & 3;
  const int q_start = qb * BQ, qpos = q_start + r;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;

  for (int idx = t; idx < BQ * DH; idx += THREADS) {
    const int rr = idx / DH, d = idx % DH, row = q_start + rr;
    Qs[rr * (DH + 1) + d] = row < S ? to_f32(qp[row * qss + d]) : 0.f;
  }

  const int k_end = min(S, q_start + BQ);  // keys past the last row's diagonal are masked
  int kb_lo = 0;
  if (window > 0) kb_lo = max(0, q_start - window + 1) / BK;
  const int kb_hi = (k_end + BK - 1) / BK;

  float m = NEG_INF, l = 0.f, acc[DH / 4];
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) acc[i] = 0.f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the previous block's tiles are no longer read
    for (int idx = t; idx < BK * DH; idx += THREADS) {
      const int j = idx / DH, d = idx % DH, key = k_start + j;
      const bool in = key < S;
      Ks[j * (DH + 1) + d] = in ? to_f32(kp[key * kss + d]) : 0.f;
      Vs[j * DH + d] = in ? to_f32(vp[key * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * (DH + 1);
    for (int d = 0; d < DH; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < BK / 4; ++jj) s[jj] += qv * Ks[(c0 + 4 * jj) * (DH + 1) + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const int key = k_start + c0 + 4 * jj;
      bool ok = key <= qpos && key < S;
      if (window > 0) ok = ok && key > qpos - window;
      s[jj] = ok ? s[jj] * scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 4; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      Ps[r * (BK + 1) + c0 + 4 * jj] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same four lanes
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) acc[i] *= corr;
    const float* prow = Ps + r * (BK + 1);
    for (int j = 0; j < BK; ++j) {
      const float pj = prow[j];
      const float* vrow = Vs + j * DH + c0;
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) acc[i] += pj * vrow[4 * i];
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + b * osb + h * osh + qpos * oss;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) op[c0 + 4 * i] = from_f32<T>(acc[i] * inv);
    if (lse != nullptr && c0 == 0)  // m and l are the whole row's in every lane of the four
      lse[((long long)b * gridDim.y + h) * S + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ------------------------------------------------------------ tensor-core path
namespace tc {

constexpr int BQ = 128;       // query rows of a block
constexpr int WG_ROWS = 64;   // query rows of one warpgroup (one wgmma M)
constexpr int BK = 64;        // keys of a tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int STAGES = 2;     // K/V ring depth
constexpr int BOX_D = SW128_COLS;  // dh columns of one TMA box: one 128-byte swizzle row
constexpr int ROW = BOX_D * 2;  // bytes of a tile row

// Shared memory: Q [DP/64][BQ][64], then K and V rings [STAGES][DP/64][BK][64],
// then the mbarriers (Q's, one per stage); DP is dh in whole 64-column boxes.
// Every tile is 1024-byte aligned.
template <int DH>
struct Smem {
  static constexpr int DP = sw128_tile_cols(DH);
  static constexpr int Q_BYTES = BQ * DP * 2, KV_BYTES = BK * DP * 2;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + STAGES) + 1024;  // + slack to align the base
};

// K and V tiles of keys key0.. of kv head hk into ring stage st (one thread).
template <int DH>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        uint32_t sK, uint32_t sV, uint32_t barKV, int st, int key0,
                                        int hk, int b) {
  const uint32_t bar = barKV + 8 * st;
  mbar_expect_tx(bar, 2 * Smem<DH>::KV_BYTES);
#pragma unroll
  for (int hh = 0; hh < Smem<DH>::DP / BOX_D; ++hh) {
    const uint32_t off = st * Smem<DH>::KV_BYTES + hh * BK * ROW;
    tma_load_4d(sK + off, kmap, bar, hh * BOX_D, hk, key0, b);
    tma_load_4d(sV + off, vmap, bar, hh * BOX_D, hk, key0, b);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int G, long long osb, long long osh,
                          long long oss, int window, float scale_log2) {
  using L = Smem<DH>;
  static_assert(DH % 16 == 0, "Q.K^T takes dh in k16 steps");
  constexpr int DP = L::DP, NH = DP / BOX_D;  // padded tile width, boxes per tile row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const uint32_t sQ = smem_u32(smem), sK = sQ + L::K_OFF, sV = sQ + L::V_OFF;
  const uint32_t barQ = sQ + L::BAR_OFF, barKV = barQ + 8;  // stage s: barKV + 8 s

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest (last) q blocks start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  const int q_start = qb * BQ;

  // key tiles of the block: the window's first live tile to the causal diagonal
  const int kb_lo = window > 0 ? max(0, q_start - window + 1) / BK : 0;
  const int kb_hi = (min(S, q_start + BQ) + BK - 1) / BK;
  // the tiles live for this warpgroup's 64 rows (none if they all lie past S)
  const int wq0 = q_start + wg * WG_ROWS;
  const int w_lo = window > 0 ? max(0, wq0 - window + 1) / BK : 0;
  const int w_hi = wq0 < S ? (min(S, wq0 + WG_ROWS) + BK - 1) / BK : 0;
  const int n_tiles = kb_hi - kb_lo;

  if (tid == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(barKV + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    mbar_expect_tx(barQ, L::Q_BYTES);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) tma_load_4d(sQ + hh * BQ * ROW, &qmap, barQ, hh * BOX_D, h, q_start, b);
    load_kv<DH>(&kmap, &vmap, sK, sV, barKV, 0, kb_lo * BK, hk, b);
  }

  float acc[DP / 2];  // columns past DH stay zero
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // this thread's two rows (r0, r0 + 8); l is its share of the row sum
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int r0 = wq0 + warp * 16 + (lane >> 2);
  mbar_wait(barQ, 0);

  for (int i = 0; i < n_tiles; ++i) {
    if (tid == 0 && i + 1 < n_tiles)  // into the stage freed at the end of i - 1
      load_kv<DH>(&kmap, &vmap, sK, sV, barKV, (i + 1) % STAGES, (kb_lo + i + 1) * BK, hk, b);
    const int st = i % STAGES, kb = kb_lo + i;
    mbar_wait(barKV + 8 * st, (i / STAGES) & 1);
    if (kb >= w_lo && kb < w_hi) {  // uniform over the warpgroup
      const uint32_t kt = sK + st * L::KV_BYTES, vt = sV + st * L::KV_BYTES;
      float s[32] = {};  // the first k16 step overwrites it (scale-d = 0)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // k16 steps over the real dh: 4 per 128-byte box
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 along the swizzled row
        const uint64_t da = sw128_desc(sQ + (kk / 4) * BQ * ROW + wg * WG_ROWS * ROW + col, 16, 1024);
        const uint64_t db = sw128_desc(kt + (kk / 4) * BK * ROW + col, 16, 1024);
        wgmma_m64n64k16_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const int k_start = kb * BK;
      const bool whole = k_start + BK - 1 <= wq0 && k_start + BK <= S &&
                         (window <= 0 || k_start > wq0 + WG_ROWS - 1 - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const bool lower = (e >> 1) & 1;  // row r0 + 8
        float x = s[e] * scale_log2;
        if (!whole) {
          const int key = k_start + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
          const int row = r0 + (lower ? 8 : 0);
          bool ok = key <= row && key < S;
          if (window > 0) ok = ok && key > row - window;
          x = ok ? x : NEG_INF;
        }
        s[e] = x;
        if (lower) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      uint32_t pa[16];  // P in bf16 pairs; pa[4 kk .. 4 kk + 3] is the A fragment of keys 16 kk..
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const bool lower = (e >> 1) & 1;
        const float p0 = exp2f(s[e] - (lower ? mn1 : mn0));
        const float p1 = exp2f(s[e + 1] - (lower ? mn1 : mn0));
        if (lower) ps1 += p0 + p1;
        else ps0 += p0 + p1;
        pa[e / 2] = pack_bf16(p0, p1);
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= ((e >> 1) & 1) ? c1 : c0;

      wgmma_fence();  // P and the rescaled accumulator were written by this thread
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys a step: two 8-row groups of V
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_pv<DP>(acc, a, sw128_desc(vt + kk * 16 * ROW, BK * ROW, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // stage st is read by every warpgroup before it is loaded again
  }

  // epilogue: finish the row sums, stage this warpgroup's rows in its part of
  // the Q tile (same swizzle, conflict-free), then 16-byte stores of rows < S
  // and of the DH real columns
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // m is in log2 units of the scaled scores
    float* lrow = lse + ((long long)b * gridDim.y + h) * S;
    if (r0 < S) lrow[r0] = m0 * 0.6931471805599453f + logf(fmaxf(l0, 1e-30f));
    if (r0 + 8 < S) lrow[r0 + 8] = m1 * 0.6931471805599453f + logf(fmaxf(l1, 1e-30f));
  }
  const int rl = wg * WG_ROWS + warp * 16 + (lane >> 2);  // row r0 within the block
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int hh = j / 8, c = j % 8;
    uint8_t* base = smem + hh * BQ * ROW + (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(base + rl * ROW + ((c ^ (rl & 7)) << 4)) =
        pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(base + (rl + 8) * ROW + ((c ^ ((rl + 8) & 7)) << 4)) =
        pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
  __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int it = 0; it < DH / 16; ++it) {
    const int idx = it * 128 + t, row = wg * WG_ROWS + idx / (DH / 8), cc = idx % (DH / 8);
    const uint4 val = *reinterpret_cast<const uint4*>(smem + (cc / 8) * BQ * ROW + row * ROW +
                                                      (((cc % 8) ^ (row & 7)) << 4));
    const int qrow = q_start + row;
    if (qrow < S) *reinterpret_cast<uint4*>(ob + qrow * oss + cc * 8) = val;
  }
}

template <int DH>
static int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
                  int Hkv, int S, const long long* st, int window, float scale,
                  cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, DH, Hq, S, B, st[0], st[1], st[2], BQ) ||
      !make_map(&km, k, DH, Hkv, S, B, st[3], st[4], st[5], BK) ||
      !make_map(&vm, v, DH, Hkv, S, B, st[6], st[7], st[8], BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_tc_kernel<DH>;
  const int smem = Smem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(qm, km, vm, (__nv_bfloat16*)o, lse, S, Hq / Hkv, st[9], st[10],
                                        st[11], window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, int DH>
static int launch_typed(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int Hq, int Hkv, int S, const long long* st, int window, float scale,
                        cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH>;
  const size_t smem = fa_smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S,
                                        Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
                                        st[6], st[7], st[8], st[9], st[10], st[11], window,
                                        scale);
  return (int)cudaGetLastError();
}


// box_d, box_q, box_k: the TMA boxes the caller planned for the tensor-core
// path (64, 128, 64; dh 80 reads two boxes of 64 columns), or zeros for the fp32-tile kernel; any other value is
// refused, so the Python plan and this file cannot drift apart silently.
extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                      void* lse_ptr, int B, int Hq, int Hkv, int S, int dh, long long qsb,
                                      long long qsh, long long qss, long long ksb, long long ksh,
                                      long long kss, long long vsb, long long vsh, long long vss,
                                      long long osb, long long osh, long long oss, int box_d,
                                      int box_q, int box_k, int window, float scale, int dtype,
                                      void* stream) {
  if (B == 0 || S == 0) return 0;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  float* lse = (float*)lse_ptr;  // null: no LSE
  const bool tc_path = dtype == kBF16 && (dh == 64 || dh == 80 || dh == 128);
  if (tc_path != (box_d != 0) || (tc_path && (box_d != tc::BOX_D || box_q != tc::BQ || box_k != tc::BK)))
    return (int)cudaErrorInvalidValue;
  if (tc_path && dh == 64) return tc::launch<64>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
  if (tc_path && dh == 80) return tc::launch<80>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
  if (tc_path) return tc::launch<128>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
  if (dtype == kBF16 && dh == 32)
    return launch_typed<__nv_bfloat16, 32>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_typed<float, 32>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
    case 64: return launch_typed<float, 64>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
    case 80: return launch_typed<float, 80>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
    case 128: return launch_typed<float, 128>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
