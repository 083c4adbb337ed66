// One-token GQA attention over a KV cache (flash-decode).
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py, _decode_kernel
//   (launched by flash_decode).
// Computes, for each batch b and kv head h, the G query heads of that kv head
//   together: out[g] = sum_j softmax_j(q[g].k[j] * scale) v[j] over the cache
//   slots j < n_valid. Online softmax as in the TPU kernel: scores, m, l and
//   acc in float32, -1e30 for masked slots, l clamped at 1e-30, p rounded to
//   v's dtype before PV.
// Bound on Hopper: bytes. Each valid slot's k and v rows are read once for
//   ~4 * G * dh flops; at G = 5 that is ~5 flops a byte, against the ~295 a
//   byte at which the bf16 tensor cores would become the limit.
//
// The valid slots of each (b, h) are cut into 64-slot tiles, and the tiles
// are spread over the CTAs of one thread block cluster: grid (n_split, Hkv,
// B), cluster (n_split, 1, 1), n_split <= 8 (the portable cluster size). CTA
// counts differ by at most one tile and none is empty, so every CTA's first
// tile holds a valid slot. Two kernels share this split and the combine,
// chosen by (dtype, dh) in the launcher; the launch plan (split, tiles per
// CTA, ring stages, shared memory, TMA boxes) is made in Python
// (`launch_plan`, which sizes the split by how many clusters the card holds
// at once, `decode_attention_max_active_clusters` below) and checked here.
//
// 1. bf16, dh 64, 80 and 128 (the model's path): decode_tc_kernel, one warpgroup.
//   - Bytes in flight: K and V are read by TMA straight from the model's
//     (B, T, Hkv, dh) cache through 4-D maps over (dh, Hkv, slots, B), boxes
//     of 64 dh columns by 64 slots, 128-byte swizzled, bf16 in shared memory.
//     The maps' slot extent is n_valid, so TMA zero-fills every row at or past
//     it and a stale slot (which may hold NaN: p = 0 does not protect P.V from
//     it) is never read. One thread issues the CTA's tiles at the start into a
//     ring of stages on mbarriers, sized so that at the serving shape every
//     tile of a CTA is in flight at once and two CTAs share an SM.
//   - Products on the tensor cores: S = Q.K^T is a wgmma m64n64k16 with Q as
//     the register A operand (the G query rows of a 64-row tile; the other
//     rows are zero and never written) and K K-major from shared memory. Q in
//     registers rather than in a 16 KB shared tile keeps three 32 KB stages
//     and two CTAs within an SM. P is rounded to bf16 in registers and is the
//     A operand of O += P.V (V MN-major), as in the flash kernel. At G = 5, 59
//     of the 64 rows are padding; that costs no bytes, which bound the kernel.
//   - The zero-filled rows score 0, so the slot < n_valid mask stays explicit.
//   - dh 80 (h2o-danube) runs in tiles of 128 columns (two boxes) over maps
//     whose dh extent stays 80: TMA zero-fills columns 80-127, so no extra
//     byte is read; Q.K^T takes only the 5 real k16 steps (Q's registers hold
//     the real columns alone), P.V is the n128 product, and the partial keeps
//     only the 80 real columns of acc.
// 2. fp32 (dh 32, 64, 80, 128) and bf16 at dh 32: decode_tile_kernel, fp32 FMAs from
//   float32 shared-memory tiles loaded through the strides (TF32 cannot hold
//   the 2e-5 bar); slots at or past n_valid are never read.
//
// Combine, in the same launch: CTA r of a cluster writes the output columns
// of its slice r of dh. With an lse pointer (else null), CTA 0 also writes
// each row's log-sum-exp of the scaled scores, ln 2 (M + log2 L) from the
// common max M (log2 units) and sum L it combines: the partial output of a
// part of a cache, which ranks holding the other parts join. Each CTA stages its (acc unnormalised, m, l) of the G
// rows in its own shared memory, then all its threads push (m, l) to every
// CTA and each slice of acc to the CTA that owns it, in 16-byte stores to
// distributed shared memory; one cluster barrier makes
// them visible, and each CTA rescales the partials it received to the common
// max and divides, reading only its own shared memory. No global scratch, no
// second kernel, and no CTA reads another's memory, so none has to wait for
// its readers before it exits. (Pulling the partials instead takes two
// cluster barriers and three dependent rounds of remote reads.)
#include <cooperative_groups.h>

#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

constexpr int TILE = 64;         // cache slots of a tile
constexpr int THREADS = 128;     // one warpgroup
constexpr int MAXG = 16;         // query heads per kv head
constexpr int MAX_SPLIT = 8;     // CTAs of a cluster: the portable cluster size
constexpr int BOX_D = SW128_COLS;  // dh columns of a TMA box
constexpr int ROW = BOX_D * 2;   // bytes of a tile row in shared memory
constexpr int RING_BYTES = 96 * 1024;  // ring of a CTA: two CTAs share an SM's 228 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The dh columns that CTA d of a cluster of n combines and writes: [d cols,
// (d + 1) cols) within DH, cols = ceil(DH / n) rounded up to 4 floats, so
// that a slice of a row moves in 16-byte stores (n * cols < DH + 4 n).
__host__ __device__ constexpr int slice_cols(int dh, int n) { return ((dh + n - 1) / n + 3) / 4 * 4; }

// What the CTAs of a cluster push to the CTA of rank d, in floats: acc of
// rank r, row g, column d * cols + j at ACC + (r * G + g) * cols + j; m (log2
// units) and l of rank r, row g at M + r * MAXG + g and L + r * MAXG + g.
template <int DH>
struct Recv {
  static constexpr int ACC = 0, M = MAXG * (DH + 4 * MAX_SPLIT), L = M + MAX_SPLIT * MAXG;
  static constexpr int FLOATS = L + MAX_SPLIT * MAXG;
};

template <int DH>
__host__ __device__ constexpr int tc_stage_bytes() {  // a K tile and a V tile, in whole boxes
  return 2 * TILE * sw128_tile_cols(DH) * 2;
}
template <int DH>
__host__ __device__ constexpr int tc_smem_bytes(int stages) {  // ring, receive area, mbarriers, slack to align
  return stages * tc_stage_bytes<DH>() + 4 * Recv<DH>::FLOATS + 8 * stages + 1024;
}
template <int DH>
__host__ __device__ constexpr int tile_smem_bytes(int G) {  // receive area, Ks (rows padded by one), Vs, accs, ms, ls, qs, ps, cs
  return 4 * (Recv<DH>::FLOATS + TILE * (DH + 1) + TILE * DH + 2 * G * DH + G * TILE + 3 * G);
}

// The tiles [t_lo, t_lo + n_t) of this CTA: the first `extra` CTAs take one more.
struct Share {
  int t_lo, n_t;
};
__device__ __forceinline__ Share my_tiles(int n_valid, int tiles_per_cta, int rank, int n_split) {
  const int extra = (n_valid + TILE - 1) / TILE - tiles_per_cta * n_split;
  return {rank * tiles_per_cta + min(rank, extra), tiles_per_cta + (rank < extra ? 1 : 0)};
}

// The cluster barrier, split: every thread of every CTA arrives, then waits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Push this CTA's partial (`part`: acc [G][DH] unnormalised, then m [G] in
// log2 units and l [G], in its own shared memory, 16-byte aligned) into the
// receive areas of the cluster's CTAs: every thread, 16-byte stores to
// distributed shared memory. Then one cluster barrier, and this CTA's
// columns from what it received: out[g][c] = sum_r w_r acc_r[g][c] /
// max(sum_r w_r l_r, 1e-30), w_r = 2^(m_r - M). A CTA's shared memory may be
// written only once it has started: each CTA arrives (relaxed) at its start
// and waits here, long after. CTA 0 also writes lse[g] = ln 2 (M + log2
// sum_r w_r l_r) where `lse` is not null.
template <typename T, int DH>
__device__ __forceinline__ void push_combine(const float* part, float* recv, T* __restrict__ out,
                                             float* __restrict__ lse, int G) {
  using R = Recv<DH>;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cols = slice_cols(DH, n), t = threadIdx.x;
  const float *pm = part + G * DH, *pl = pm + G;
  cluster_wait();
  for (int i = t; i < G * DH / 4; i += THREADS) {
    const int g = 4 * i / DH, c = 4 * i % DH, d = c / cols;
    float* dst = cluster.map_shared_rank(recv, d) + R::ACC + (rank * G + g) * cols + c - d * cols;
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(part + 4 * i);
  }
  for (int i = t; i < n * G; i += THREADS) {
    const int d = i / G, g = i % G;
    float* r = cluster.map_shared_rank(recv, d);
    r[R::M + rank * MAXG + g] = pm[g];
    r[R::L + rank * MAXG + g] = pl[g];
  }
  cluster_arrive_release();
  cluster_wait();  // every push has landed
  const int c0 = rank * cols, width = min(DH, c0 + cols) - c0;  // <= 0: no columns here
  for (int i = t; i < G * width; i += THREADS) {
    const int g = i / width, j = i % width;
    float M = NEG_INF;
    for (int r = 0; r < n; ++r) M = fmaxf(M, recv[R::M + r * MAXG + g]);
    float a = 0.f, L = 0.f;
    for (int r = 0; r < n; ++r) {
      const float w = exp2f(recv[R::M + r * MAXG + g] - M);
      a += w * recv[R::ACC + (r * G + g) * cols + j];
      L += w * recv[R::L + r * MAXG + g];
    }
    out[g * DH + c0 + j] = from_f32<T>(a / fmaxf(L, 1e-30f));
  }
  if (lse != nullptr && rank == 0) {
    for (int g = t; g < G; g += THREADS) {
      float M = NEG_INF, L = 0.f;
      for (int r = 0; r < n; ++r) M = fmaxf(M, recv[R::M + r * MAXG + g]);
      for (int r = 0; r < n; ++r) L += exp2f(recv[R::M + r * MAXG + g] - M) * recv[R::L + r * MAXG + g];
      lse[g] = (M + log2f(fmaxf(L, 1e-30f))) * LN2;
    }
  }
}

// ------------------------------------------------------------ tensor-core path
// The K and V tiles of slots slot0.. of kv head h into the stage at sK (one thread).
template <int DH>
__device__ __forceinline__ void load_tile(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          uint32_t sK, uint32_t bar, int slot0, int h, int b) {
  constexpr int DP = sw128_tile_cols(DH), KV_BYTES = TILE * DP * 2;
  mbar_expect_tx(bar, 2 * KV_BYTES);  // zero-filled rows and columns count too
#pragma unroll
  for (int hh = 0; hh < DP / BOX_D; ++hh) {
    tma_load_4d(sK + hh * TILE * ROW, kmap, bar, hh * BOX_D, h, slot0, b);
    tma_load_4d(sK + KV_BYTES + hh * TILE * ROW, vmap, bar, hh * BOX_D, h, slot0, b);
  }
}

// S = Q.K^T of the tile at kt into s (issued; the caller waits).
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint32_t (&qa)[DH / 16][4], uint32_t kt) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)  // k16 steps over the real dh: 4 per 128-byte box
    wgmma_m64n64k16_rs<0>(s, qa[kk], sw128_desc(kt + (kk / 4) * TILE * ROW + (kk % 4) * 32, 16, 1024));
  wgmma_commit();
}

// Shared memory: the ring [stages] x (K tile [DP/64][64][64], V tile likewise;
// DP is dh in whole 64-column boxes),
// the receive area of the combine, then one mbarrier a stage. Every tile is
// 1024-byte aligned.
template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
decode_tc_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int Hkv, int G, int n_valid, int tiles_per_cta, int stages,
                 float scale_log2) {
  static_assert(DH % 16 == 0, "Q.K^T takes dh in k16 steps");
  constexpr int DP = sw128_tile_cols(DH), KV_BYTES = TILE * DP * 2, STAGE = tc_stage_bytes<DH>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  float* recv = reinterpret_cast<float*>(smem + stages * STAGE);
  const uint32_t sK = smem_u32(smem), bar0 = smem_u32(recv + Recv<DH>::FLOATS);  // stage s: + s STAGE, + 8 s

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Share sh = my_tiles(n_valid, tiles_per_cta, rank, gridDim.x);

  cluster_arrive_relaxed();  // this CTA has started (see push_combine)
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(stages, sh.n_t); ++i)
      load_tile<DH>(&kmap, &vmap, sK + i * STAGE, bar0 + 8 * i, (sh.t_lo + i) * TILE, h, b);

  // Q as the A fragment of m64k16 per 16 dh columns: this thread's rows r0 and
  // r0 + 8, columns 16 kk + 8 (j / 2) + 2 (lane % 4) + {0, 1}; rows >= G are zero
  const long long head = (long long)b * Hkv + h;
  const __nv_bfloat16* qp = q + head * G * DH;
  const int r0 = warp * 16 + (lane >> 2);
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 8 * (j & 1), col = 16 * kk + 8 * (j >> 1) + 2 * (lane & 3);
      qa[kk][j] = row < G ? (uint32_t)__bfloat16_as_ushort(qp[row * DH + col]) |
                                ((uint32_t)__bfloat16_as_ushort(qp[row * DH + col + 1]) << 16)
                          : 0u;
    }
  }

  float acc[DP / 2];  // columns past DH stay zero
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // rows r0 and r0 + 8; l is this thread's share of the row sum
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < sh.n_t; ++i) {
    const int st = i % stages, slot0 = (sh.t_lo + i) * TILE;
    const uint32_t kt = sK + st * STAGE, vt = kt + KV_BYTES;
    mbar_wait(bar0 + 8 * st, (i / stages) & 1);
    float s[32];
    issue_qk<DH>(s, qa, kt);
    wgmma_wait_all();
    fence_regs(s);

    const bool whole = slot0 + TILE <= n_valid;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int slot = slot0 + (e >> 2) * 8 + 2 * (lane & 3) + (e & 1);
      const float x = whole || slot < n_valid ? s[e] * scale_log2 : NEG_INF;
      s[e] = x;
      if ((e >> 1) & 1) mx1 = fmaxf(mx1, x);
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
    uint32_t pa[16];  // P in bf16 pairs; pa[4 kk .. 4 kk + 3] is the A fragment of slots 16 kk..
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
    for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 slots a step: two 8-row groups of V
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
      wgmma_pv<DP>(acc, a, sw128_desc(vt + kk * 16 * ROW, TILE * ROW, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // stage st is read by every warp before it is loaded again
    if (tid == 0 && i + stages < sh.n_t)
      load_tile<DH>(&kmap, &vmap, kt, bar0 + 8 * st, (sh.t_lo + i + stages) * TILE, h, b);
  }

  // the partial of rows < G into ring stage 0 (every tile is consumed and no
  // load is in flight), then pushed to the cluster and combined
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* part = reinterpret_cast<float*>(smem);  // acc [G][DH], m [G], l [G]
  if (r0 < G) {  // warp 0 holds every row < G (MAXG = 16)
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) {  // the fragments of the DH real columns
      const int row = r0 + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (row < G) part[row * DH + col] = acc[e];
    }
    if ((lane & 3) == 0) {
      part[G * DH + r0] = m0;
      part[G * DH + G + r0] = l0;
      if (r0 + 8 < G) {
        part[G * DH + r0 + 8] = m1;
        part[G * DH + G + r0 + 8] = l1;
      }
    }
  }
  __syncthreads();
  push_combine<__nv_bfloat16, DH>(part, recv, o + head * G * DH, lse ? lse + head * G : nullptr, G);
}

// ------------------------------------------------------------ fp32-tile path
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int Hkv, int G, long long ksb,
                   long long ksh, long long kst,
                   long long vsb, long long vsh, long long vst, int n_valid, int tiles_per_cta,
                   float scale) {
  extern __shared__ float smem[];
  float* recv = smem;                     // the combine's receive area
  float* Ks = recv + Recv<DH>::FLOATS;    // [TILE][DH + 1]
  float* Vs = Ks + TILE * (DH + 1);       // [TILE][DH]
  float* accs = Vs + TILE * DH;           // [G][DH], then ms and ls: the partial
  float* ms = accs + G * DH;              // [G]
  float* ls = ms + G;                     // [G]
  float* qs = ls + G;                     // [G][DH]
  float* ps = qs + G * DH;                // [G][TILE]
  float* cs = ps + G * TILE;              // [G]

  const int h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long head = (long long)b * Hkv + h;
  const T* qp = q + head * G * DH;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const Share sh = my_tiles(n_valid, tiles_per_cta, blockIdx.x, gridDim.x);
  const int lo = sh.t_lo * TILE, hi = min(n_valid, (sh.t_lo + sh.n_t) * TILE);
  cluster_arrive_relaxed();  // this CTA has started (see push_combine)

  for (int i = t; i < G * DH; i += THREADS) {
    qs[i] = to_f32(qp[i]);
    accs[i] = 0.f;
  }
  for (int g = t; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int nk = min(TILE, hi - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = t; i < TILE * DH; i += THREADS) {
      const int j = i / DH, d = i % DH;
      const bool in = j < nk;
      Ks[j * (DH + 1) + d] = in ? to_f32(kp[(t0 + j) * kst + d]) : 0.f;
      Vs[j * DH + d] = in ? to_f32(vp[(t0 + j) * vst + d]) : 0.f;
    }
    __syncthreads();
    {  // scores: thread owns slot j and heads g = t / TILE, + 2, ...
      const int j = t % TILE;
      const float* krow = Ks + j * (DH + 1);
      for (int g = t / TILE; g < G; g += THREADS / TILE) {
        const float* qrow = qs + g * DH;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s += qrow[d] * krow[d];
        ps[g * TILE + j] = j < nk ? s * scale : NEG_INF;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {  // online softmax, one warp per head
      const float s0 = ps[g * TILE + lane], s1 = ps[g * TILE + lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      ps[g * TILE + lane] = round_to<T>(p0);
      ps[g * TILE + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = t; i < G * DH; i += THREADS) {  // PV: thread owns (g, c) = divmod(i, DH)
      const int g = i / DH, c = i % DH;
      const float* pg = ps + g * TILE;
      float a = accs[i] * cs[g];
      for (int j = 0; j < nk; ++j) a += pg[j] * Vs[j * DH + c];
      accs[i] = a;
    }
  }
  __syncthreads();
  for (int g = t; g < G; g += THREADS) ms[g] *= LOG2E;  // the combine works in log2 units
  __syncthreads();
  push_combine<T, DH>(accs, recv, o + head * G * DH, lse ? lse + head * G : nullptr, G);
}

// ------------------------------------------------------------ launch
// A launch of THREADS-thread CTAs with `smem` bytes each in clusters of
// (n_split, 1, 1); not copyable, since the config points at the attribute.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(dim3 grid, int n_split, int smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

template <typename... KArgs, typename... Args>
static int launch_cluster(void (*kern)(KArgs...), int n_split, int Hkv, int B, int smem,
                          cudaStream_t stream, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const ClusterLaunch launch(dim3(n_split, Hkv, B), n_split, smem, stream);
  err = cudaLaunchKernelEx(&launch.cfg, kern, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();  // clear it, so no later check sees it
  return (int)(err != cudaSuccess ? err : last);
}

template <int DH>
static int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hkv, int G,
                     const long long* st, int n_valid, int n_split, int tiles_per_cta, int stages,
                     int smem, float scale, cudaStream_t stream) {
  if (stages < 1 || stages * tc_stage_bytes<DH>() > RING_BYTES || smem != tc_smem_bytes<DH>(stages))
    return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;  // slot extent n_valid: rows at or past it arrive as zeros
  if (!make_map(&km, k, DH, Hkv, n_valid, B, st[0], st[1], st[2], TILE) ||
      !make_map(&vm, v, DH, Hkv, n_valid, B, st[3], st[4], st[5], TILE))
    return (int)cudaErrorInvalidValue;
  return launch_cluster(decode_tc_kernel<DH>, n_split, Hkv, B, smem, stream, km, vm,
                        (const __nv_bfloat16*)q, (__nv_bfloat16*)o, lse, Hkv, G, n_valid,
                        tiles_per_cta, stages, scale * LOG2E);
}

template <typename T, int DH>
static int launch_tile(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hkv, int G,
                       const long long* st, int n_valid, int n_split, int tiles_per_cta,
                       int smem, float scale, cudaStream_t stream) {
  if (smem != tile_smem_bytes<DH>(G)) return (int)cudaErrorInvalidValue;
  return launch_cluster(decode_tile_kernel<T, DH>, n_split, Hkv, B, smem, stream, (const T*)q,
                        (const T*)k, (const T*)v, (T*)o, lse, Hkv, G, st[0], st[1], st[2], st[3],
                        st[4], st[5], n_valid, tiles_per_cta, scale);
}

// The plan (n_split, tiles_per_cta, stages, smem, box_d, box_slots,
// slot_extent) comes from `launch_plan` in Python; anything but the plan this
// file would make is refused, so the two cannot drift apart silently.
extern "C" int launch_decode_attention(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int Hkv, int G, int T_len, int dh, long long ksb,
                                       long long ksh, long long kst, long long vsb,
                                       long long vsh, long long vst, int n_valid, int n_split,
                                       int tiles_per_cta, int stages, int smem, int box_d,
                                       int box_slots, int slot_extent, float scale, int dtype,
                                       void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  const int tiles = (n_valid + TILE - 1) / TILE;
  if (G < 1 || G > MAXG || n_valid < 1 || n_valid > T_len || n_split < 1 ||
      n_split > MAX_SPLIT || n_split > tiles || tiles_per_cta != tiles / n_split ||
      slot_extent != n_valid)
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {ksb, ksh, kst, vsb, vsh, vst};
  cudaStream_t s = (cudaStream_t)stream;
  const bool tc_path = dtype == kBF16 && (dh == 64 || dh == 80 || dh == 128);
  if (tc_path != (box_d != 0) || (tc_path && (box_d != BOX_D || box_slots != TILE)) ||
      (!tc_path && (box_slots != 0 || stages != 0)))
    return (int)cudaErrorInvalidValue;
  if (tc_path && dh == 64)
    return launch_tc<64>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, stages, smem, scale, s);
  if (tc_path && dh == 80)
    return launch_tc<80>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, stages, smem, scale, s);
  if (tc_path)
    return launch_tc<128>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, stages, smem, scale, s);
  if (dtype == kBF16 && dh == 32)
    return launch_tile<__nv_bfloat16, 32>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, smem, scale, s);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32: return launch_tile<float, 32>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, smem, scale, s);
    case 64: return launch_tile<float, 64>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, smem, scale, s);
    case 80: return launch_tile<float, 80>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, smem, scale, s);
    case 128: return launch_tile<float, 128>(q, k, v, o, lse, B, Hkv, G, st, n_valid, n_split, tiles_per_cta, smem, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of n_split CTAs of the kernel that (dtype, dh) takes, with
// `smem` bytes each, the card holds at once; a negative cudaError_t on failure.
extern "C" int decode_attention_max_active_clusters(int dtype, int dh, int n_split, int smem) {
  const bool tc_path = dtype == kBF16 && (dh == 64 || dh == 80 || dh == 128);
  const void* kern = nullptr;
  if (tc_path)
    kern = dh == 64   ? (const void*)decode_tc_kernel<64>
           : dh == 80 ? (const void*)decode_tc_kernel<80>
                      : (const void*)decode_tc_kernel<128>;
  else if (dtype == kBF16 && dh == 32) kern = (const void*)decode_tile_kernel<__nv_bfloat16, 32>;
  else if (dtype == kF32 && dh == 32) kern = (const void*)decode_tile_kernel<float, 32>;
  else if (dtype == kF32 && dh == 64) kern = (const void*)decode_tile_kernel<float, 64>;
  else if (dtype == kF32 && dh == 80) kern = (const void*)decode_tile_kernel<float, 80>;
  else if (dtype == kF32 && dh == 128) kern = (const void*)decode_tile_kernel<float, 128>;
  if (kern == nullptr || n_split < 1 || n_split > MAX_SPLIT) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  const ClusterLaunch launch(dim3(n_split), n_split, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &launch.cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}
