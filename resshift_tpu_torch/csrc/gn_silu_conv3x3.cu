// Kernel F: GroupNorm + SiLU + 3x3 conv (zero padding, stride 1) to at most 8
// output channels, on NCHW tensors:
//
//   y[b, o] = sum_{c, ky, kx} silu(x[b, c] * w[b, c] + bb[b, c])(shifted) * k[o, c, ky, kx]
//             + bias[o]
//
// with the zero border applied to the ACTIVATED tensor (silu(bb) is not 0, so
// zeroing x at the border would be wrong).  w, bb are the folded per-(image,
// channel) GroupNorm affine.
//
// Replaces the TPU kernel resshift_tpu/ops/tail_pallas.py `_fused` (K8, via
// gn_silu_conv3x3 with use_pallas=True) and the group_norm_fold the JAX
// package computes before it: the UNet head (C = 160, f32, co = 3 or 8 at
// 64x64) and the VQGAN decoder tail (bf16, C = 128 at 256x256 for f4, C = 64
// at 512x512 for f8, co = 3).  This file holds two of F's three kernels:
//
// 1. `gn_stats` (gn_stats_kernel, then gn_fold_kernel): the GroupNorm's
//    statistics and fold on the card.  Every (image, channel) plane is
//    contiguous in NCHW; `stats_plan` cuts each into `slices` slices of at
//    most SLICE_MAX_BYTES (and, where that leaves the card short of
//    TARGET_CTAS CTAs, of no less than SLICE_MIN_BYTES), one CTA each, which
//    reads its slice once in x's dtype with 16-byte loads and writes its f32
//    sum and sum of squares.  gn_fold_kernel, one CTA per image, adds each
//    channel's slices in slice order and each group's channels in channel
//    order, so two calls give the same bits, then folds as `fold_stats`
//    does: mean, clamped variance, rsqrt(var + eps), scale and bias.
// 2. `gn_silu_conv3x3` (gn_silu_conv3x3_kernel): the FMA route, for f32 (the
//    UNet heads: on the tensor cores f32 would be TF32) and for bf16 at C % 16
//    != 0; gn_silu_conv3x3_tc.cu is the bf16 route.  One CTA of 128 threads
//    takes an 8 x 32 output tile and one slice of the channels
//    (`fma_plan`: enough slices for TARGET_CTAS CTAs, whole chunks of CC
//    channels each): chunk by chunk it stages the chunk's 10 x 34 input tile
//    with the affine and SiLU applied once per element and the chunk's taps,
//    and each thread accumulates one column and RPT rows in co (padded to 4
//    or 8) f32 registers.  With one slice the CTA writes y; with more, each
//    writes its f32 partial tile to the workspace and the last CTA of a tile
//    to arrive (a counter per tile, zeroed before the launch) adds the
//    partials in slice order, adds the bias and writes y.
//
// Rounding points (tail_pallas._reference, as ops/tail.py's plain version
// writes it): bf16 rounds after the affine, runs the SiLU as x * (1 / (1 +
// exp(-x))) rounding after each operation, sums the taps in f32, rounds the
// sum, then adds the bias in bf16; f32 keeps everything f32.  1 / v is
// __frcp_rn(v), which equals __fdiv_rn(1.f, v) bit for bit.
//
// Bound on the H100: bytes at every main-path shape (one read of x, one write
// of y over 3.35 TB/s), e.g. 0.040 ms for the f4 tail at (8, 128, 256, 256)
// bf16; the f32 FMAs (2 * C * 9 * co per pixel over 67 TFLOP/s) bound only
// the faceir head (C = 160, co = 8).  GroupNorm needs every pixel of a plane
// before its first output, and a tail's x does not fit on the chip, so two
// reads of x (the statistics, then the conv) are the floor of this design.
#include "common.cuh"

namespace {

// ------------------------------------------------------------- statistics

constexpr int STATS_THREADS = 256;
constexpr int SLICE_MAX_BYTES = 32768;  // of one plane, per CTA
constexpr int SLICE_MIN_BYTES = 4096;
constexpr int SLICE_ALIGN = 8;          // elements: whole 16-byte vectors in bf16 and f32
constexpr int TARGET_CTAS = 4 * 132;    // four CTAs an SM of the H100 SXM
constexpr int FOLD_THREADS = 128;

__host__ int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Slices per plane of `hw` elements of `esize` bytes, for `planes` planes.
__host__ int stats_plan(int planes, int hw, int esize, int* len) {
  const int max_len = SLICE_MAX_BYTES / esize, min_len = SLICE_MIN_BYTES / esize;
  const int lo = cdiv(hw, max_len);
  const int hi = lo > cdiv(hw, min_len) ? lo : cdiv(hw, min_len);
  int s = cdiv(TARGET_CTAS, planes);
  s = s < lo ? lo : (s > hi ? hi : s);
  *len = cdiv(cdiv(hw, s), SLICE_ALIGN) * SLICE_ALIGN;
  return cdiv(hw, *len);
}

// (sum, sum of squares) of the block's values, thread 0 holding the result:
// a butterfly within each warp, then the warps in order.
__device__ __forceinline__ float2 block_sum2(float s, float q) {
  __shared__ float2 part[STATS_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(s, q);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < STATS_THREADS / 32; ++w) {
      t.x += part[w].x;
      t.y += part[w].y;
    }
  return t;
}

__device__ __forceinline__ void acc2(float v, float& s, float& q) {
  s += v;
  q = fmaf(v, v, q);
}

__device__ __forceinline__ void acc_vec(uint4 u, const bf16*, float& s, float& q) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc2(__uint_as_float(w[i] << 16), s, q);
    acc2(__uint_as_float(w[i] & 0xffff0000u), s, q);
  }
}

__device__ __forceinline__ void acc_vec(uint4 u, const float*, float& s, float& q) {
  acc2(__uint_as_float(u.x), s, q);
  acc2(__uint_as_float(u.y), s, q);
  acc2(__uint_as_float(u.z), s, q);
  acc2(__uint_as_float(u.w), s, q);
}

// grid (planes, slices): slice `blockIdx.y` of plane `blockIdx.x`
template <typename T, bool VEC>
__global__ void __launch_bounds__(STATS_THREADS)
    gn_stats_kernel(const T* __restrict__ x, int hw, int len, float* __restrict__ ps,
                    float* __restrict__ pq) {
  const size_t plane = blockIdx.x;
  const int e0 = blockIdx.y * len, e1 = min(hw, e0 + len);
  const T* xp = x + plane * hw;
  float s = 0.f, q = 0.f;
  if (VEC) {
    constexpr int V = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(xp + e0);
    const int n = (e1 - e0) / V;
    int i = threadIdx.x;
    for (; i + 3 * STATS_THREADS < n; i += 4 * STATS_THREADS) {
      uint4 u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) u[k] = __ldg(xv + i + k * STATS_THREADS);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc_vec(u[k], xp, s, q);
    }
    for (; i < n; i += STATS_THREADS) acc_vec(__ldg(xv + i), xp, s, q);
  } else {
    for (int i = e0 + threadIdx.x; i < e1; i += STATS_THREADS) acc2(to_f(xp[i]), s, q);
  }
  const float2 t = block_sum2(s, q);
  if (threadIdx.x == 0) {
    ps[plane * gridDim.y + blockIdx.y] = t.x;
    pq[plane * gridDim.y + blockIdx.y] = t.y;
  }
}

// one CTA per image: a thread per channel adds its slices in order, then a
// thread per group adds the group's channels in order and folds as
// fold_stats does, each operation rounded as there
__global__ void __launch_bounds__(FOLD_THREADS)
    gn_fold_kernel(const float* __restrict__ ps, const float* __restrict__ pq,
                   const float* __restrict__ scale, const float* __restrict__ bias, int C, int G,
                   int slices, float n, float eps, float* __restrict__ w,
                   float* __restrict__ bb) {
  extern __shared__ float sq[];  // sums [C], then sums of squares [C]
  const int b = blockIdx.x, cpg = C / G;
  for (int c = threadIdx.x; c < C; c += FOLD_THREADS) {
    const size_t p = ((size_t)b * C + c) * slices;
    float sc = 0.f, qc = 0.f;
#pragma unroll 4
    for (int k = 0; k < slices; ++k) {
      sc += ps[p + k];
      qc += pq[p + k];
    }
    sq[c] = sc;
    sq[C + c] = qc;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += FOLD_THREADS) {
    float sg = 0.f, qg = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      sg += sq[c];
      qg += sq[C + c];
    }
    const float mean = __fdiv_rn(sg, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(qg, n), __fmul_rn(mean, mean)), 0.f);
    const float inv = rsqrtf(__fadd_rn(var, eps));
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      const float wc = __fmul_rn(inv, scale[c]);
      w[(size_t)b * C + c] = wc;
      bb[(size_t)b * C + c] = __fsub_rn(bias[c], __fmul_rn(mean, wc));
    }
  }
}

template <typename T>
cudaError_t launch_stats(const T* x, const float* scale, const float* bias, float* ws, float* w,
                         float* bb, int B, int C, int HW, int G, float eps, cudaStream_t st) {
  int len;
  const int planes = B * C, slices = stats_plan(planes, HW, sizeof(T), &len);
  float *ps = ws, *pq = ws + (size_t)planes * slices;
  const dim3 grid(planes, slices);
  if (HW % (16 / sizeof(T)) == 0 && (uintptr_t)x % 16 == 0)
    gn_stats_kernel<T, true><<<grid, STATS_THREADS, 0, st>>>(x, HW, len, ps, pq);
  else
    gn_stats_kernel<T, false><<<grid, STATS_THREADS, 0, st>>>(x, HW, len, ps, pq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = 2 * (size_t)C * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gn_fold_kernel<<<B, FOLD_THREADS, smem, st>>>(ps, pq, scale, bias, C, G, slices,
                                              (float)((long long)HW * (C / G)), eps, w, bb);
  return cudaGetLastError();
}

// ------------------------------------------------------------- FMA conv

constexpr int TW = 32;               // output columns per CTA, one per lane
constexpr int RPT = 2;               // output rows per thread
constexpr int RG = 4;                // row groups (warps) per CTA
constexpr int TH = RPT * RG;         // 8 output rows per CTA
constexpr int THREADS = TW * RG;     // 128
constexpr int CC = 16;               // channels per shared-memory stage
constexpr int SH = TH + 2, SW = TW + 2;  // the staged tile with its halo
constexpr int TILE_PIX = TH * TW;
constexpr int BATCH = 8;             // staging loads a thread in flight

struct FmaPlan {
  int tiles, chunks, cps, slices;  // tiles of all images; chunks per slice
};

__host__ FmaPlan fma_plan(int B, int C, int H, int W) {
  FmaPlan p;
  p.tiles = B * cdiv(H, TH) * cdiv(W, TW);
  p.chunks = cdiv(C, CC);
  int want = cdiv(TARGET_CTAS, p.tiles);
  want = want < p.chunks ? want : p.chunks;
  p.cps = cdiv(p.chunks, want);
  p.slices = cdiv(p.chunks, p.cps);
  return p;
}

template <typename T>
__device__ __forceinline__ float silu_rounded(float xv, float w, float b) {
  // multiply, then add, each rounded: the plain version's x * w + b
  const float a = rnd<T>(__fadd_rn(__fmul_rn(xv, w), b));
  const float r = rnd<T>(__frcp_rn(rnd<T>(1.f + rnd<T>(expf(-a)))));
  return rnd<T>(a * r);
}

// grid: tiles x slices, the slice fastest
template <typename T, int COP>
__global__ void __launch_bounds__(THREADS)
    gn_silu_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ gw,
                           const float* __restrict__ gb, const T* __restrict__ wt,
                           const T* __restrict__ cbias, T* __restrict__ y,
                           float* __restrict__ part, unsigned* __restrict__ arrived, int C,
                           int H, int W, int co, int cps, int slices) {
  __shared__ float act[CC][SH][SW];
  __shared__ __align__(16) float taps[CC * 9 * COP];
  __shared__ bool last;
  const int slice = blockIdx.x % slices, tile = blockIdx.x / slices;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int x0 = (tile % tiles_w) * TW, y0 = (tile / tiles_w % tiles_h) * TH;
  const int b = tile / tiles_w / tiles_h;
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;

  float acc[RPT][COP];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int o = 0; o < COP; ++o) acc[i][o] = 0.f;

  const int cbeg = slice * cps * CC, cend = min(C, cbeg + cps * CC);
  for (int c0 = cbeg; c0 < cend; c0 += CC) {
    const int nc = min(CC, cend - c0);
    __syncthreads();  // every thread is done with the previous chunk
    // BATCH loads a thread in flight (the element and its channel's affine),
    // then their SiLU
    for (int i0 = threadIdx.x; i0 < nc * SH * SW; i0 += BATCH * THREADS) {
      float raw[BATCH], aw[BATCH], ab[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * THREADS, cc = i / (SH * SW), r = (i / SW) % SH, col = i % SW;
        const int gy = y0 - 1 + r, gx = x0 - 1 + col;
        raw[k] = aw[k] = ab[k] = 0.f;
        if (i < nc * SH * SW && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const size_t bc = (size_t)b * C + c0 + cc;
          raw[k] = to_f(x[(bc * H + gy) * W + gx]);
          aw[k] = gw[bc];
          ab[k] = gb[bc];
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * THREADS, cc = i / (SH * SW), r = (i / SW) % SH, col = i % SW;
        if (i >= nc * SH * SW) break;
        const int gy = y0 - 1 + r, gx = x0 - 1 + col;
        // the conv's zero padding, after the SiLU
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        act[cc][r][col] = in ? silu_rounded<T>(raw[k], aw[k], ab[k]) : 0.f;
      }
    }
    // taps[(cc * 9 + k) * COP + o] = k[o, c0 + cc, k / 3, k % 3], 0 past co
    for (int i = threadIdx.x; i < nc * 9 * COP; i += THREADS) {
      const int o = i % COP, k = (i / COP) % 9, cc = i / COP / 9;
      taps[i] = o < co ? to_f(wt[((size_t)o * C + c0 + cc) * 9 + k]) : 0.f;
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
          const float4 v = reinterpret_cast<const float4*>(taps + (cc * 9 + k) * COP)[q];
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

  if (slices > 1) {
    // this slice's partial tile, [tile][slice][o][pixel]; the last CTA of
    // the tile to arrive adds all of them in slice order
    float* mine = part + ((size_t)tile * slices + slice) * co * TILE_PIX;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int o = 0; o < COP; ++o)
        if (o < co) mine[o * TILE_PIX + (ty * RPT + i) * TW + tx] = acc[i][o];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrived + tile, 1u) == (unsigned)slices - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* all = part + (size_t)tile * slices * co * TILE_PIX;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int o = 0; o < COP; ++o) acc[i][o] = 0.f;
    for (int s = 0; s < slices; ++s) {  // each slice's loads together, the sums in slice order
      float v[RPT][COP];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int o = 0; o < COP; ++o)
          v[i][o] = o < co ? __ldcg(all + ((size_t)s * co + o) * TILE_PIX +
                                    (ty * RPT + i) * TW + tx)
                           : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int o = 0; o < COP; ++o) acc[i][o] += v[i][o];
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
            from_f<T>(rnd<T>(acc[i][o]) + to_f(cbias[o]));
  }
}

template <typename T>
cudaError_t launch_conv(const T* x, const float* w, const float* b, const T* wt, const T* cbias,
                        T* y, void* ws, int B, int C, int H, int W, int co, cudaStream_t st) {
  const FmaPlan p = fma_plan(B, C, H, W);
  float* part = (float*)ws;
  unsigned* arrived = (unsigned*)(part + (size_t)p.tiles * p.slices * co * TILE_PIX);
  if (p.slices > 1) {
    cudaError_t e = cudaMemsetAsync(arrived, 0, sizeof(unsigned) * p.tiles, st);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)p.tiles * p.slices;
  if (co <= 4)
    gn_silu_conv3x3_kernel<T, 4><<<grid, THREADS, 0, st>>>(x, w, b, wt, cbias, y, part, arrived,
                                                         C, H, W, co, p.cps, p.slices);
  else
    gn_silu_conv3x3_kernel<T, 8><<<grid, THREADS, 0, st>>>(x, w, b, wt, cbias, y, part, arrived,
                                                         C, H, W, co, p.cps, p.slices);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace `gn_stats` takes: the (sum, sum of squares) of
// every slice of every plane.
extern "C" long long gn_stats_workspace(int B, int C, int HW, int dtype) {
  int len;
  const int esize = dtype == DT_BF16 ? 2 : 4;
  return 2LL * B * C * stats_plan(B * C, HW, esize, &len) * sizeof(float);
}

// x (B, C, HW) in `dtype`; scale, bias (C,) f32: the GroupNorm's parameters;
// ws of gn_stats_workspace bytes; w, bb (B, C) f32: the folded affine.
extern "C" int gn_stats(const void* x, const void* scale, const void* bias, void* ws, void* w,
                        void* bb, int dtype, int B, int C, int HW, int G, float eps,
                        void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G || (long long)B * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  float *wp = (float*)w, *bp = (float*)bb, *wsp = (float*)ws;
  if (dtype == DT_BF16)
    return (int)launch_stats<bf16>((const bf16*)x, sc, bi, wsp, wp, bp, B, C, HW, G, eps, s);
  if (dtype == DT_F32)
    return (int)launch_stats<float>((const float*)x, sc, bi, wsp, wp, bp, B, C, HW, G, eps, s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of the workspace the FMA route takes: the partial tiles and one
// arrival counter per tile, or 0 where the plan has one slice.
extern "C" long long gn_silu_conv3x3_workspace(int B, int C, int H, int W, int co) {
  const FmaPlan p = fma_plan(B, C, H, W);
  if (p.slices == 1) return 0;
  return (long long)p.tiles * p.slices * co * TILE_PIX * sizeof(float) +
         (long long)p.tiles * sizeof(unsigned);
}

// x (B, C, H, W), y (B, co, H, W), weight (co, C, 3, 3) and cbias (co,) in
// `dtype`; w, b (B, C) f32; ws of gn_silu_conv3x3_workspace bytes.
extern "C" int gn_silu_conv3x3(const void* x, const void* w, const void* b, const void* weight,
                               const void* cbias, void* y, void* ws, int dtype, int B, int C,
                               int H, int W, int co, void* stream) {
  if (co < 1 || co > 8 || B <= 0 || C <= 0 || H <= 0 || W <= 0 ||
      (long long)B * cdiv(H, TH) * cdiv(W, TW) * cdiv(C, CC) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *wp = (const float*)w, *bp = (const float*)b;
  if (dtype == DT_BF16)
    return (int)launch_conv<bf16>((const bf16*)x, wp, bp, (const bf16*)weight,
                                  (const bf16*)cbias, (bf16*)y, ws, B, C, H, W, co, s);
  if (dtype == DT_F32)
    return (int)launch_conv<float>((const float*)x, wp, bp, (const float*)weight,
                                   (const float*)cbias, (float*)y, ws, B, C, H, W, co, s);
  return (int)cudaErrorInvalidValue;
}
