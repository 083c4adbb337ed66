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
//   ~330 flops a byte, above the card's ~295 for bf16 tensor cores.
// Design (simple and right first; tensor cores come in a later change): one
//   block of 256 threads per (64-row q block, query head, batch). A loop over
//   64-key blocks replaces the TPU's sequential kv grid axis; it starts at the
//   window's first block and stops at the causal diagonal, so fully masked
//   blocks cost nothing. Q, K, V and P tiles sit in shared memory as float32
//   (rows padded by one float against bank conflicts). Four threads own one
//   query row: each computes 16 of the 64 scores, the row max and sum come
//   from two shuffles, and each keeps dh/4 accumulator columns in registers.
//   Layouts arrive as strides, so the model's (B, S, H, dh) tensors are read
//   in place; rows and keys past S are masked instead of padded.
#include "common.cuh"

constexpr int BQ = 64, BK = 64, THREADS = 256;

template <int DH>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * (2 * BQ * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int S, int G, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss,
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
  }
}

template <typename T, int DH>
static int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int S, const long long* st, int window, float scale,
                        cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH>;
  const size_t smem = fa_smem_bytes<DH>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, S,
                                        Hq / Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
                                        st[6], st[7], st[8], st[9], st[10], st[11], window,
                                        scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int S, int dh, const long long* st, int window, float scale,
                     cudaStream_t s) {
  switch (dh) {
    case 32: return launch_typed<T, 32>(q, k, v, o, B, Hq, Hkv, S, st, window, scale, s);
    case 64: return launch_typed<T, 64>(q, k, v, o, B, Hq, Hkv, S, st, window, scale, s);
    case 128: return launch_typed<T, 128>(q, k, v, o, B, Hq, Hkv, S, st, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int launch_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                      int Hq, int Hkv, int S, int dh, long long qsb,
                                      long long qsh, long long qss, long long ksb, long long ksh,
                                      long long kss, long long vsb, long long vsh, long long vss,
                                      long long osb, long long osh, long long oss, int window,
                                      float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  const long long st[12] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return launch_dh<float>(q, k, v, o, B, Hq, Hkv, S, dh, st, window, scale, s);
  if (dtype == kBF16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, dh, st, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
