// One-token GQA attention over a KV cache (flash-decode).
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py, _decode_kernel
//   (launched by flash_decode).
// Computes, for each batch b and kv head h, the G query heads of that kv head
//   together: out[g] = sum_j softmax_j(q[g].k[j] * scale) v[j] over the cache
//   slots j < n_valid. Online softmax as in the TPU kernel: m, l, acc in
//   float32, -1e30 for masked slots, l clamped at 1e-30, p rounded to v's
//   dtype before PV. Slots at or past n_valid are never read.
// Bound on Hopper: bytes. Each valid slot's k and v rows are read once for
//   ~4 * G * dh flops; at G = 5 that is ~5 flops a byte.
// Design: the TPU kernel walks the slots in order on one core. Here B * Hkv
//   is 32 at the serving shape, a quarter of the 132 SMs, so the slots are
//   also split into chunks (flash-decoding): pass 1 gives each (chunk, kv
//   head, batch) a block of 128 threads that runs the online softmax over
//   its chunk and writes its m, l and unnormalised acc to a float32 scratch
//   the wrapper allocates; pass 2 rescales the chunks to a common max and
//   divides. Inside pass 1, 64-slot tiles of k and v are staged in shared
//   memory as float32 by coalesced loads (rows padded by one float against
//   bank conflicts); a thread owns one slot and half of the G query heads
//   for the scores, one warp per head updates m and l, and a thread owns
//   (head, column) accumulators for PV. G need not be a power of two
//   (qwen3-14b has G = 5). The cache is read through strides, so the model's
//   (B, T, Hkv, dh) cache is used in place.
#include "common.cuh"

constexpr int DBK = 64, DTHREADS = 128, MAXG = 16;

template <int DH>
__host__ __device__ constexpr int tile_floats() {
  return DBK * (DH + 1) + DBK * DH;  // Ks (padded) + Vs
}

// Scratch layout: part[((b * Hkv + h) * n_split + split) * G + g][DH + 2] =
//   (acc[0..DH), m, l) of one chunk.
template <typename T, int DH>
__global__ void __launch_bounds__(DTHREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      float* __restrict__ part, int Hkv, int G, long long ksb, long long ksh,
                      long long kst, long long vsb, long long vsh, long long vst, int n_valid,
                      int chunk, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // [DBK][DH + 1]
  float* Vs = Ks + DBK * (DH + 1);        // [DBK][DH]
  float* qs = Vs + DBK * DH;              // [G][DH]
  float* accs = qs + G * DH;              // [G][DH]
  float* ps = accs + G * DH;              // [G][DBK]
  float* ms = ps + G * DBK;               // [G]
  float* ls = ms + G;                     // [G]
  float* cs = ls + G;                     // [G]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, n_split = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long head = (long long)b * Hkv + h;
  const T* qp = q + head * G * DH;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const int lo = split * chunk, hi = min(n_valid, lo + chunk);

  for (int i = t; i < G * DH; i += DTHREADS) {
    qs[i] = to_f32(qp[i]);
    accs[i] = 0.f;
  }
  for (int g = t; g < G; g += DTHREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += DBK) {
    const int nk = min(DBK, hi - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = t; i < DBK * DH; i += DTHREADS) {
      const int j = i / DH, d = i % DH;
      const bool in = j < nk;
      Ks[j * (DH + 1) + d] = in ? to_f32(kp[(t0 + j) * kst + d]) : 0.f;
      Vs[j * DH + d] = in ? to_f32(vp[(t0 + j) * vst + d]) : 0.f;
    }
    __syncthreads();
    {  // scores: thread owns slot j and heads g = t / DBK, + 2, ...
      const int j = t % DBK;
      const float* krow = Ks + j * (DH + 1);
      for (int g = t / DBK; g < G; g += DTHREADS / DBK) {
        const float* qrow = qs + g * DH;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) s += qrow[d] * krow[d];
        ps[g * DBK + j] = j < nk ? s * scale : NEG_INF;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += DTHREADS / 32) {  // online softmax, one warp per head
      const float s0 = ps[g * DBK + lane], s1 = ps[g * DBK + lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      ps[g * DBK + lane] = round_to<T>(p0);
      ps[g * DBK + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = t; i < G * DH; i += DTHREADS) {  // PV: thread owns (g, c) = divmod(i, DH)
      const int g = i / DH, c = i % DH;
      const float* pg = ps + g * DBK;
      float a = accs[i] * cs[g];
      for (int j = 0; j < nk; ++j) a += pg[j] * Vs[j * DH + c];
      accs[i] = a;
    }
  }
  __syncthreads();
  float* out = part + (head * n_split + split) * G * (DH + 2);
  for (int i = t; i < G * DH; i += DTHREADS) out[(i / DH) * (DH + 2) + i % DH] = accs[i];
  for (int g = t; g < G; g += DTHREADS) {
    out[g * (DH + 2) + DH] = ms[g];
    out[g * (DH + 2) + DH + 1] = ls[g];
  }
}

// Pass 2: out[g][c] = sum_s e^(m_s - M) acc_s[c] / max(sum_s e^(m_s - M) l_s, 1e-30).
template <typename T, int DH>
__global__ void __launch_bounds__(DTHREADS)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int Hkv, int G,
                      int n_split) {
  const long long head = (long long)blockIdx.y * Hkv + blockIdx.x;
  const float* hp = part + head * n_split * G * (DH + 2);
  T* op = o + head * G * DH;
  for (int i = threadIdx.x; i < G * DH; i += DTHREADS) {
    const int g = i / DH, c = i % DH;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, hp[(s * G + g) * (DH + 2) + DH]);
    float a = 0.f, l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* row = hp + (s * G + g) * (DH + 2);
      const float w = expf(row[DH] - M);
      a += w * row[c];
      l += w * row[DH + 1];
    }
    op[i] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DH>
static int launch_typed(const void* q, const void* k, const void* v, void* o, void* part, int B,
                        int Hkv, int G, const long long* st, int n_valid, int chunk, int n_split,
                        float scale, cudaStream_t s) {
  auto kern = decode_partial_kernel<T, DH>;
  const size_t smem = sizeof(float) * (tile_floats<DH>() + 2 * G * DH + G * DBK + 3 * G);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(n_split, Hkv, B), DTHREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)part, Hkv, G, st[0], st[1], st[2], st[3],
      st[4], st[5], n_valid, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, DH><<<dim3(Hkv, B), DTHREADS, 0, s>>>((const float*)part, (T*)o, Hkv,
                                                                 G, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dh(const void* q, const void* k, const void* v, void* o, void* part, int B,
                     int Hkv, int G, int dh, const long long* st, int n_valid, int chunk,
                     int n_split, float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_typed<T, 32>(q, k, v, o, part, B, Hkv, G, st, n_valid, chunk, n_split, scale, s);
    case 64: return launch_typed<T, 64>(q, k, v, o, part, B, Hkv, G, st, n_valid, chunk, n_split, scale, s);
    case 128: return launch_typed<T, 128>(q, k, v, o, part, B, Hkv, G, st, n_valid, chunk, n_split, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int launch_decode_attention(const void* q, const void* k, const void* v, void* o,
                                       void* part, int B, int Hkv, int G, int T_len, int dh,
                                       long long ksb, long long ksh, long long kst,
                                       long long vsb, long long vsh, long long vst, int n_valid,
                                       int chunk, int n_split, float scale, int dtype,
                                       void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  // every chunk must hold a valid slot, so that each partial max is finite
  if (G < 1 || G > MAXG || n_valid < 1 || n_valid > T_len || chunk < 1 || chunk % DBK ||
      (long long)(n_split - 1) * chunk >= n_valid || (long long)n_split * chunk < n_valid)
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {ksb, ksh, kst, vsb, vsh, vst};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_dh<float>(q, k, v, o, part, B, Hkv, G, dh, st, n_valid, chunk, n_split, scale, s);
  if (dtype == kBF16)
    return launch_dh<__nv_bfloat16>(q, k, v, o, part, B, Hkv, G, dh, st, n_valid, chunk, n_split,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}
