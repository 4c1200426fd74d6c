// Kernel C, f32 route: single-head attention softmax(q k^T / sqrt(C)) v over
// (B, N, C) f32 with C = 512, the VQGAN encoder's and decoder's middle
// AttnBlock.  The bf16 route (the main path's) is flash_attn_1h_tc.cu.
//
// Replaces the TPU kernel resshift_tpu/ops/flash_attention_pallas.py
// `flash_attention_1h`.
//
// Design.  One CTA per 32-query tile; K and V stream through shared memory in
// 64-key chunks (one buffer, K then V), so the N x N scores never reach
// device memory.  C = 512 is wider than FlashAttention-style kernels are
// built for: the 32 x 512 f32 output accumulator is split over the CTA's
// 256 threads (each warp owns 4 query rows, each lane 16 columns, 64
// registers), the Q tile and one K/V chunk take 197 KB of shared memory.
// Each warp also owns its 4 rows of the 32 x 64 score tile (2 keys per lane),
// so the row max and row sum are warp shuffles.
//
// Softmax: online, with a running row max and rescaling of the accumulator.
// The TPU kernel used exp(s - 30) with no running max, which overflows f32
// above a score of about 118; the running max is a deliberate divergence
// (ROADMAP queue 3).  As in the TPU kernel, the probabilities are rounded to
// T before the product with V and the normalizer sums the unrounded ones.
//
// Bound on the H100 at the main path's shapes (q, k, v (8, 4096, 512) bf16):
// 4 N^2 C = 275 GFLOP per call against 134 MB of q, k, v and out, so the
// tensor-core rate bounds it (0.28 ms in bf16); these f32 FMA loops are
// bound by shared-memory load issue (see PERF.md for the measured time).
// f32 has no full-rate tensor-core path (TF32 would not hold the f32 bands),
// so this route stays on the FMA units.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 32;
constexpr int BK = 64;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
    flash_attn_1h_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int N) {
  constexpr int LD = C + 1, LDP = BK + 1, CPL = C / 32;
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x LD: q * scale, rounded to T
  float* kv = qs + BQ * LD;  // BK x LD: one chunk of K, then of V
  float* ps = kv + BK * LD;  // BQ x LDP: probabilities, rounded to T

  const int nqt = (N + BQ - 1) / BQ;
  const int bi = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * BQ;
  const size_t base = (size_t)bi * N * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = rnd<T>((float)(1.0 / sqrt((double)C)));

  for (int i = threadIdx.x; i < BQ * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int row = min(q0 + r, N - 1);
    qs[r * LD + c] = rnd<T>(to_f(q[base + (size_t)row * C + c]) * scale);
  }

  float acc[4][CPL];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // previous chunk's V no longer read
    for (int i = threadIdx.x; i < BK * C; i += THREADS) {
      const int r = i / C, c = i % C;
      kv[r * LD + c] = to_f(k[base + (size_t)min(k0 + r, N - 1) * C + c]);
    }
    __syncthreads();

    // scores of this warp's 4 rows against keys lane and lane + 32
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float k_a = kv[lane * LD + c], k_b = kv[(lane + 32) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(warp * 4 + i) * LD + c];
        s[i][0] = fmaf(qv, k_a, s[i][0]);
        s[i][1] = fmaf(qv, k_b, s[i][1]);
      }
    }
    const bool ok_a = k0 + lane < N, ok_b = k0 + lane + 32 < N;
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok_a) s[i][0] = -INFINITY;
      if (!ok_b) s[i][1] = -INFINITY;
      float m = fmaxf(s[i][0], s[i][1]);
      for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float m_new = fmaxf(m_run[i], m);
      const float p_a = expf(s[i][0] - m_new), p_b = expf(s[i][1] - m_new);
      float sum = p_a + p_b;
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha[i] + sum;
      m_run[i] = m_new;
      ps[(warp * 4 + i) * LDP + lane] = rnd<T>(p_a);
      ps[(warp * 4 + i) * LDP + lane + 32] = rnd<T>(p_b);
    }
    __syncthreads();  // K no longer read; ps complete

    for (int i = threadIdx.x; i < BK * C; i += THREADS) {
      const int r = i / C, c = i % C;
      kv[r * LD + c] = to_f(v[base + (size_t)min(k0 + r, N - 1) * C + c]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] *= alpha[i];
#pragma unroll 2
    for (int key = 0; key < BK; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(warp * 4 + i) * LDP + key];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float vv = kv[key * LD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      o[base + (size_t)row * C + lane + 32 * j] = from_f<T>(acc[i][j] / l_run[i]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int N,
                   cudaStream_t st) {
  constexpr int C = 512;
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * (C + 1) + (size_t)BQ * (BK + 1));
  cudaError_t e = allow_smem(flash_attn_1h_kernel<T, C>, smem);
  if (e != cudaSuccess) return e;
  const int nqt = (N + BQ - 1) / BQ;
  flash_attn_1h_kernel<T, C><<<B * nqt, THREADS, smem, st>>>((const T*)q, (const T*)k,
                                                            (const T*)v, (T*)o, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_1h(const void* q, const void* k, const void* v, void* o, int dtype,
                             int B, int N, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != 512) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)launch<float>(q, k, v, o, B, N, st);
  return (int)cudaErrorInvalidValue;
}
