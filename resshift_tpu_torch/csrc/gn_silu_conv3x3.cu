// Kernel F: GroupNorm affine + SiLU + 3x3 conv (zero padding, stride 1) to at
// most 8 output channels, on NCHW tensors:
//
//   y[b, o] = sum_{c, ky, kx} silu(x[b, c] * w[b, c] + bb[b, c])(shifted) * k[c, ky, kx, o]
//             + bias[o]
//
// with the zero border applied to the ACTIVATED tensor (silu(bb) is not 0, so
// zeroing x at the border would be wrong).  w, bb are the folded per-(image,
// channel) GroupNorm affine, computed beforehand by plain reductions, as the
// TPU kernel took them.
//
// Replaces the TPU kernel resshift_tpu/ops/tail_pallas.py `_fused` (K8, via
// gn_silu_conv3x3 with use_pallas=True): the UNet head (C = 160, f32, co = 3
// or 8 at 64x64) and the VQGAN decoder tail (bf16, C = 128 at 256x256 for f4,
// C = 64 at 512x512 for f8, co = 3).
//
// Rounding points (tail_pallas._reference, as ops/tail.py's plain version
// writes it): bf16 rounds after the affine, runs the SiLU as x * (1 / (1 +
// exp(-x))) rounding after each operation, sums the taps in f32, rounds the
// sum, then adds the bias in bf16; f32 keeps everything f32.
//
// Design.  One CTA of 128 threads per (image, 16-row x 32-column output tile).
// Channels go in chunks of 16: the CTA stages the chunk's 18 x 34 input tile
// (one-pixel halo) in shared memory with the affine and SiLU applied once per
// element, and the chunk's 9 x co taps beside it; the activated tensor never
// reaches device memory.  Each thread owns one column and four consecutive
// rows of the tile with co (padded to 4 or 8) f32 accumulators: per channel it
// reads the 6 x 3 inputs its four outputs need (a warp reads 32 neighbouring
// columns: no bank conflicts) and the taps as broadcast float4s.  Plain f32
// FMAs: co <= 8 is too narrow for a wgmma tile; mma.sync with n = 8 is later
// work.
//
// Bound on the H100: bytes at every main-path shape (one read of x, one write
// of y over 3.35 TB/s), e.g. 0.040 ms for the f4 tail at (8, 128, 256, 256)
// bf16; the f32 FMAs (2 * C * 9 * co per pixel over 67 TFLOP/s) bound only
// the faceir head (C = 160, co = 8).
#include "common.cuh"

namespace {

constexpr int TW = 32;               // output columns per CTA, one per lane
constexpr int RPT = 4;               // output rows per thread
constexpr int RG = 4;                // row groups (warps) per CTA
constexpr int TH = RPT * RG;         // 16 output rows per CTA
constexpr int THREADS = TW * RG;     // 128
constexpr int CC = 16;               // channels per shared-memory stage
constexpr int SH = TH + 2, SW = TW + 2;  // the staged tile with its halo

template <typename T, int COP>
__global__ void __launch_bounds__(THREADS)
    gn_silu_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ gw,
                           const float* __restrict__ gb, const float* __restrict__ taps,
                           const float* __restrict__ cbias, T* __restrict__ y, int C, int H,
                           int W, int co) {
  __shared__ float act[CC][SH][SW];
  __shared__ __align__(16) float wt[CC * 9 * COP];
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;

  float acc[RPT][COP];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int o = 0; o < COP; ++o) acc[i][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < nc * SH * SW; i += THREADS) {
      const int cc = i / (SH * SW), r = (i / SW) % SH, col = i % SW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + col;
      float s = 0.f;  // the conv's zero padding, after the SiLU
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = c0 + cc;
        // multiply, then add, each rounded: the plain version's x * w + b
        const float a = rnd<T>(__fadd_rn(
            __fmul_rn(to_f(x[(((size_t)b * C + c) * H + gy) * W + gx]), gw[(size_t)b * C + c]),
            gb[(size_t)b * C + c]));
        const float sg = rnd<T>(__fdiv_rn(1.f, rnd<T>(1.f + rnd<T>(expf(-a)))));
        s = rnd<T>(a * sg);
      }
      act[cc][r][col] = s;
    }
    for (int i = threadIdx.x; i < nc * 9 * COP; i += THREADS) {
      const int o = i % COP;
      wt[i] = o < co ? taps[((size_t)c0 * 9 + i / COP) * co + o] : 0.f;
    }
    __syncthreads();

    for (int cc = 0; cc < nc; ++cc) {
      float a[RPT + 2][3];
#pragma unroll
      for (int r = 0; r < RPT + 2; ++r)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) a[r][kx] = act[cc][ty * RPT + r][tx + kx];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float wv[COP];
#pragma unroll
        for (int q = 0; q < COP / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(wt + (cc * 9 + k) * COP)[q];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int o = 0; o < COP; ++o) acc[i][o] = fmaf(a[i + k / 3][k % 3], wv[o], acc[i][o]);
      }
    }
  }

  const int gx = x0 + tx;
  if (gx >= W) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gy = y0 + ty * RPT + i;
    if (gy >= H) continue;
#pragma unroll
    for (int o = 0; o < COP; ++o)
      if (o < co)
        y[(((size_t)b * co + o) * H + gy) * W + gx] =
            from_f<T>(rnd<T>(acc[i][o]) + rnd<T>(cbias[o]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, const void* taps,
                   const void* cbias, void* y, int B, int C, int H, int W, int co,
                   cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  if (co <= 4)
    gn_silu_conv3x3_kernel<T, 4><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const float*)w, (const float*)b, (const float*)taps,
        (const float*)cbias, (T*)y, C, H, W, co);
  else
    gn_silu_conv3x3_kernel<T, 8><<<grid, THREADS, 0, stream>>>(
        (const T*)x, (const float*)w, (const float*)b, (const float*)taps,
        (const float*)cbias, (T*)y, C, H, W, co);
  return cudaGetLastError();
}

}  // namespace

// x (B, C, H, W) and y (B, co, H, W) in the dtype `dtype`; w, b (B, C) f32;
// taps (C, 9, co) f32, tap index ky * 3 + kx; cbias (co,) f32.
extern "C" int gn_silu_conv3x3(const void* x, const void* w, const void* b, const void* taps,
                               const void* cbias, void* y, int dtype, int B, int C, int H,
                               int W, int co, void* stream) {
  if (co < 1 || co > 8 || B > 65535 || (H + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) return (int)launch<bf16>(x, w, b, taps, cbias, y, B, C, H, W, co, s);
  if (dtype == DT_F32) return (int)launch<float>(x, w, b, taps, cbias, y, B, C, H, W, co, s);
  return (int)cudaErrorInvalidValue;
}
