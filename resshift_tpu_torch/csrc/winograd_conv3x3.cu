// Kernel K10 `winograd_conv3x3`: a SAME, stride-1 3x3 convolution by Winograd
// F(2x2, 3x3), NHWC input, (16, C, Co) transformed weights U = G g G^T.
//
// Replaces the TPU kernel resshift_tpu/ops/winograd.py `winograd_conv3x3`
// (K10, with its kernel `_wino_kernel`).
//
// For each 2x2 output tile, d is the 4x4 input patch (zero outside the
// image), V = B^T d B its transform in f32 (rows first, then columns, each
// step one add or subtract), rounded to T; M_e = sum_c V_e[c] U_e[c][co] for
// the 16 positions e, summed in f32; the output is A^T M A, its +-1 terms
// added in the order of the plain version, plus the bias in f32, rounded to
// T.  H and W are even.
//
// Design.  One CTA per strip of TILES = 16 tiles along a tile row (output
// rows 2i, 2i+1) and CO_BLK = 64 output channels; 256 threads, each one
// output channel of 4 neighbouring tiles, holding their 16 x 4 sums M_e in
// registers.  The channels go in chunks of KC = 16: the chunk of U is staged
// in shared memory as f32, and each (tile, channel) of the chunk is
// transformed once, by one thread, into shared memory; then every thread runs
// its FMA loop over the chunk (one U value and one float4 of V per 4 FMAs).
// The output transform runs in registers and writes each tile's 2x2 pixels.
// The TPU kernel's rows-per-step budget (`_pick_tr`) and its Co blocking by
// VMEM size are not carried over.
//
// Bound on the H100 at unet res@64 (64, 64, 64, 160 -> 160) bf16: the 16
// products are 53.7 GFLOP, 0.054 ms at the bf16 tensor-core rate (the bytes,
// x and y once, take 0.050 ms); these f32 FMA loops are bound by issuing
// shared-memory loads and FMAs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILES = 16;   // tiles per CTA, along the tile row
constexpr int CO_BLK = 64;  // output channels per CTA
constexpr int KC = 16;      // input channels per chunk

// 1-D input transform, rows of B^T d: (d0 - d2, d1 + d2, d2 - d1, d1 - d3)
__device__ __forceinline__ void bt_1d(const float d[4], float o[4]) {
  o[0] = d[0] - d[2];
  o[1] = d[1] + d[2];
  o[2] = d[2] - d[1];
  o[3] = d[1] - d[3];
}

// A^T[p][i], the output transform's 0 / +-1 weights: rows (1, 1, 1, 0) and
// (0, 1, -1, -1); constexpr, so that the unrolled loops below keep only the
// non-zero terms
__device__ constexpr float at_w(int p, int i) {
  return p == 0 ? (i < 3 ? 1.f : 0.f) : (i == 0 ? 0.f : (i == 1 ? 1.f : -1.f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    winograd_kernel(const T* __restrict__ x, const T* __restrict__ u,
                    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
                    int Co, int nco) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                    // [16][KC][CO_BLK]: U of the chunk
  float* vs = us + 16 * KC * CO_BLK;   // [16][KC][TILES]: V of the chunk, rounded to T
  const int w2 = W / 2;
  const int j0 = blockIdx.x * TILES;   // first tile column
  const int ti = blockIdx.y;           // tile row
  const int bi = blockIdx.z / nco, co0 = (blockIdx.z % nco) * CO_BLK;
  const T* xb = x + (size_t)bi * H * W * C;
  const int col = threadIdx.x % CO_BLK, g = threadIdx.x / CO_BLK;  // tiles 4g .. 4g+3
  const int co = co0 + col;

  float acc[16][4];
#pragma unroll
  for (int e = 0; e < 16; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[e][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's products are done
    for (int i = threadIdx.x; i < 16 * KC * CO_BLK; i += THREADS) {
      const int e = i / (KC * CO_BLK), c = (i / CO_BLK) % KC, o = i % CO_BLK;
      us[i] = (c0 + c < C && co0 + o < Co) ? to_f(u[((size_t)e * C + c0 + c) * Co + co0 + o])
                                           : 0.f;
    }
    for (int i = threadIdx.x; i < KC * TILES; i += THREADS) {
      const int c = i % KC, t = i / KC, j = j0 + t;
      float v[4][4];
      if (c0 + c < C && j < w2) {
        float d[4][4];  // d[a][b] = input pixel (2 ti + a - 1, 2 j + b - 1)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int r = 2 * ti + a - 1, s = 2 * j + b - 1;
            d[a][b] = (r >= 0 && r < H && s >= 0 && s < W)
                          ? to_f(xb[((size_t)r * W + s) * C + c0 + c]) : 0.f;
          }
        float tr[4][4];  // tr[uu][b]: the row transform of column b
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float col4[4] = {d[0][b], d[1][b], d[2][b], d[3][b]};
          float o[4];
          bt_1d(col4, o);
#pragma unroll
          for (int uu = 0; uu < 4; ++uu) tr[uu][b] = o[uu];
        }
#pragma unroll
        for (int uu = 0; uu < 4; ++uu) bt_1d(tr[uu], v[uu]);
      } else {
#pragma unroll
        for (int uu = 0; uu < 4; ++uu)
#pragma unroll
          for (int vv = 0; vv < 4; ++vv) v[uu][vv] = 0.f;
      }
#pragma unroll
      for (int uu = 0; uu < 4; ++uu)
#pragma unroll
        for (int vv = 0; vv < 4; ++vv)
          vs[((uu * 4 + vv) * KC + c) * TILES + t] = rnd<T>(v[uu][vv]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float uv = us[(e * KC + c) * CO_BLK + col];
        const float4 v4 = *reinterpret_cast<const float4*>(vs + (e * KC + c) * TILES + 4 * g);
        acc[e][0] = fmaf(v4.x, uv, acc[e][0]);
        acc[e][1] = fmaf(v4.y, uv, acc[e][1]);
        acc[e][2] = fmaf(v4.z, uv, acc[e][2]);
        acc[e][3] = fmaf(v4.w, uv, acc[e][3]);
      }
    }
  }

  if (co >= Co) return;
  const float bv = bias ? bias[co] : 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + 4 * g + k;
    if (j >= w2) continue;
    // A^T M A: each output adds +-M_e in the plain version's (uu, vv) order
    float o[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int uu = 0; uu < 4; ++uu)
#pragma unroll
      for (int vv = 0; vv < 4; ++vv)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float wgt = at_w(p, uu) * at_w(q, vv);
            if (wgt != 0.f) o[p][q] += wgt > 0.f ? acc[uu * 4 + vv][k] : -acc[uu * 4 + vv][k];
          }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float r = bias ? o[p][q] + bv : o[p][q];
        y[(((size_t)bi * H + 2 * ti + p) * W + 2 * j + q) * Co + co] = from_f<T>(r);
      }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* u, const float* bias, void* y, int B, int H,
                   int W, int C, int Co, cudaStream_t st) {
  const size_t smem = sizeof(float) * 16 * KC * (CO_BLK + TILES);
  cudaError_t e = allow_smem(winograd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int nco = (Co + CO_BLK - 1) / CO_BLK;
  const dim3 grid((W / 2 + TILES - 1) / TILES, H / 2, B * nco);
  winograd_kernel<T><<<grid, THREADS, smem, st>>>((const T*)x, (const T*)u, bias, (T*)y, H, W,
                                                  C, Co, nco);
  return cudaGetLastError();
}

}  // namespace

extern "C" int winograd_conv3x3(const void* x, const void* u, const void* bias, void* y,
                                int dtype, int B, int H, int W, int C, int Co, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || Co <= 0 ||
      (long long)B * ((Co + CO_BLK - 1) / CO_BLK) > 65535 || H / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  if (dtype == DT_BF16) return (int)launch<bf16>(x, u, b, y, B, H, W, C, Co, st);
  if (dtype == DT_F32) return (int)launch<float>(x, u, b, y, B, H, W, C, Co, st);
  return (int)cudaErrorInvalidValue;
}
