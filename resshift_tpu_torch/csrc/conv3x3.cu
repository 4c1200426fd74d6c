// Probe P1 `conv3x3`: a direct SAME 3x3 convolution, NHWC input, HWIO weight,
// no bias, the 9 C taps summed in f32, the output rounded to T.
//
// Replaces the TPU probe tools/profile_conv_pallas.py `conv3x3_pallas` (P1,
// with its kernel `conv_kernel`), which asked whether a hand-written conv
// can match the library's.
//
// Design.  An implicit GEMM: one CTA per tile of 64 output pixels (`rows`
// rows x 64 / `rows` columns of one image) and 64 output channels; 256
// threads, each a 4 x 4 register tile (4 pixels x 4 channels, as block_mm in
// common.cuh).  The input channels go in chunks of KC = 32: the chunk's
// (rows + 2) x (64 / rows + 2) input patch, zero outside the image, and its
// 9 x KC x 64 taps are staged in shared memory as f32, then each thread runs
// 9 KC FMA steps.  `rows` is the probe's parameter (1, 2, 4, 8, ...), as the
// TPU probe's rows per grid step r was; the TPU kernel's dy-decomposed
// im2col (three products of depth 3C) is the plain version's formulation.
//
// Bound on the H100 at (64, 64, 64, 160 -> 160) bf16: 120.8 GFLOP, 0.122 ms
// at the bf16 tensor-core rate; these f32 FMA loops are bound by issuing
// shared-memory loads and FMAs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 64;     // output pixels per CTA
constexpr int CO_BLK = 64;  // output channels per CTA
constexpr int KC = 32;      // input channels per chunk
constexpr int LDP = KC + 1;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int H,
                   int W, int C, int Co, int rows) {
  extern __shared__ float smem[];
  const int cols = PIX / rows, pw = cols + 2;
  float* ps = smem;                          // [(rows + 2) * pw][LDP]: input patch
  float* ws = ps + (rows + 2) * pw * LDP;    // [9 * KC][CO_BLK]: taps
  const int tiles_w = (W + cols - 1) / cols;
  const int y0 = (blockIdx.x / tiles_w) * rows, x0 = (blockIdx.x % tiles_w) * cols;
  const int co0 = blockIdx.y * CO_BLK, bi = blockIdx.z;
  const T* xb = x + (size_t)bi * H * W * C;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  int prow[4], pcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    prow[i] = (rg * 4 + i) / cols;
    pcol[i] = (rg * 4 + i) % cols;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's FMAs are done
    for (int i = threadIdx.x; i < (rows + 2) * pw * KC; i += THREADS) {
      const int pos = i / KC, c = i % KC;
      const int r = y0 + pos / pw - 1, s = x0 + pos % pw - 1;
      ps[pos * LDP + c] = (r >= 0 && r < H && s >= 0 && s < W && c0 + c < C)
                              ? to_f(xb[((size_t)r * W + s) * C + c0 + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < 9 * KC * CO_BLK; i += THREADS) {
      const int k = i / CO_BLK, o = i % CO_BLK, tap = k / KC, c = k % KC;
      ws[i] = (c0 + c < C && co0 + o < Co) ? to_f(w[((size_t)tap * C + c0 + c) * Co + co0 + o])
                                           : 0.f;
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int base[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) base[i] = ((prow[i] + dy) * pw + pcol[i] + dx) * LDP;
      const float* wt = ws + tap * KC * CO_BLK + cg;
#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ps[base[i] + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[c * CO_BLK + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = y0 + prow[i], s = x0 + pcol[i];
    if (r >= H || s >= W) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cg + 16 * j;
      if (co < Co) y[(((size_t)bi * H + r) * W + s) * Co + co] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int H, int W, int C, int Co,
                   int rows, cudaStream_t st) {
  const int cols = PIX / rows;
  const size_t smem = sizeof(float) * ((size_t)(rows + 2) * (cols + 2) * LDP + 9 * KC * CO_BLK);
  cudaError_t e = allow_smem(conv3x3_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(((H + rows - 1) / rows) * ((W + cols - 1) / cols), (Co + CO_BLK - 1) / CO_BLK,
                  B);
  conv3x3_kernel<T><<<grid, THREADS, smem, st>>>((const T*)x, (const T*)w, (T*)y, H, W, C, Co,
                                                 rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3(const void* x, const void* w, void* y, int dtype, int B, int H, int W,
                       int C, int Co, int rows, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || rows <= 0 ||
      rows > PIX || PIX % rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) return (int)launch<bf16>(x, w, y, B, H, W, C, Co, rows, st);
  if (dtype == DT_F32) return (int)launch<float>(x, w, y, B, H, W, C, Co, rows, st);
  return (int)cudaErrorInvalidValue;
}
