// Shared device helpers of the port's kernels.
//
// Every kernel computes in f32 and rounds to the activation type T where
// the plain PyTorch version rounds (a matmul's output, a bias add, ...), so
// that in float32 all rounding steps are the identity and in bfloat16 they
// fall where the plain version's do (round to nearest even).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes passed from resshift_tpu_torch/_ext.py::dtype_code
enum { DT_F32 = 0, DT_BF16 = 1 };

// softmax of each score row (ops/attn_variants.py SOFTMAX_MODES); A and K9
// take SM_F32, P2 all five
enum { SM_F32 = 0, SM_MXSUM = 1, SM_BF16EXP = 2, SM_NOEXP = 3, SM_NONE = 4 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T's precision, returned as f32
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// C[r][c] = sum_k A(r, k) * B(k, c) for r < M, c < N, handed to store(r, c, acc).
// All 256 threads of the block take part; each holds a 4x4 register tile:
// rows rg*4 .. rg*4+3 and columns cg, cg+16, cg+32, cg+48 of a 64x64 output
// tile, so that the 16 threads of a half warp read 16 neighbouring columns.
// A and B are functors (shared or global memory); out-of-range rows and
// columns are clamped on load and skipped on store.
template <class FA, class FB, class FS>
__device__ __forceinline__ void block_mm(int M, int N, int K, FA A, FB B, FS store) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  for (int r0 = 0; r0 < M; r0 += 64) {
    for (int c0 = 0; c0 < N; c0 += 64) {
      int rows[4], cols[4], ra[4], ca[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rows[i] = r0 + rg * 4 + i;
        cols[i] = c0 + cg + 16 * i;
        ra[i] = min(rows[i], M - 1);
        ca[i] = min(cols[i], N - 1);
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A(ra[i], k);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = B(k, ca[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (rows[i] < M && cols[j] < N) store(rows[i], cols[j], acc[i][j]);
    }
  }
}

// Window-major token index of spatial (r, c) on an (H, W) map with ws x ws
// windows.
__device__ __forceinline__ int window_index(int r, int c, int W, int ws) {
  return ((r / ws) * (W / ws) + c / ws) * ws * ws + (r % ws) * ws + c % ws;
}

// The token that window-major position j reads when the map is rolled by
// -delta (delta = +shift: SW-MSA read of the unshifted layout; delta =
// -shift: the inverse).  delta == 0 is the identity.
__device__ __forceinline__ int rolled_token(int j, int H, int W, int ws, int delta) {
  if (delta == 0) return j;
  const int n = ws * ws, win = j / n, e = j % n, nww = W / ws;
  const int r = (win / nww) * ws + e / ws, c = (win % nww) * ws + e % ws;
  return window_index(((r + delta) % H + H) % H, ((c + delta) % W + W) % W, W, ws);
}

// Second pass of the GroupNorm statistics: partials (B, P, C) -> (B, C).
// A CTA takes one image and SR_CH channels; each of its SR_ROWS thread rows
// sums a contiguous range of the partials in order, then thread row 0 adds
// the SR_ROWS row sums in order, so the result is the same in every run.
// The B * C / SR_CH CTAs spread an image's P partials (4096 at a 512x512
// latent) over the card.
constexpr int SR_CH = 8, SR_ROWS = 32;

__global__ void __launch_bounds__(SR_CH * SR_ROWS)
    stats_reduce_kernel(const float* __restrict__ part_s, const float* __restrict__ part_q,
                        int P, int C, float* __restrict__ s, float* __restrict__ q) {
  __shared__ float rs[SR_ROWS][SR_CH], rq[SR_ROWS][SR_CH];
  const int b = blockIdx.x, cx = threadIdx.x % SR_CH, ry = threadIdx.x / SR_CH;
  const int c = blockIdx.y * SR_CH + cx;
  const int per = (P + SR_ROWS - 1) / SR_ROWS, p0 = ry * per, p1 = min(P, p0 + per);
  float as = 0.f, aq = 0.f;
  if (c < C) {
    const size_t base = (size_t)b * P * C + c;
#pragma unroll 4
    for (int p = p0; p < p1; ++p) {
      as += part_s[base + (size_t)p * C];
      aq += part_q[base + (size_t)p * C];
    }
  }
  rs[ry][cx] = as;
  rq[ry][cx] = aq;
  __syncthreads();
  if (ry == 0 && c < C) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < SR_ROWS; ++r) {
      ts += rs[r][cx];
      tq += rq[r][cx];
    }
    s[(size_t)b * C + c] = ts;
    q[(size_t)b * C + c] = tq;
  }
}

// Launch the second pass on `st`; returns cudaGetLastError().
static inline cudaError_t launch_stats_reduce(const float* part_s, const float* part_q, int B,
                                              int P, int C, float* s, float* q,
                                              cudaStream_t st) {
  stats_reduce_kernel<<<dim3(B, (C + SR_CH - 1) / SR_CH), SR_CH * SR_ROWS, 0, st>>>(
      part_s, part_q, P, C, s, q);
  return cudaGetLastError();
}

// Per-channel partial sums of an (M, ld) f32 tile in shared memory.
__device__ __forceinline__ void tile_stats(const float* y, int M, int C, int ld,
                                           float* ps, float* pq) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float as = 0.f, aq = 0.f;
    for (int r = 0; r < M; ++r) {
      const float v = y[r * ld + c];
      as += v;
      aq = fmaf(v, v, aq);
    }
    ps[c] = as;
    pq[c] = aq;
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
