// Probe P1 `conv3x3`, bf16 route: a direct SAME 3x3 convolution on the tensor
// cores, NHWC bf16 input, HWIO bf16 weight, no bias, the 9 C taps summed in
// f32, the output rounded to bf16.  The f32 route is conv3x3.cu.
//
// Replaces the TPU probe tools/profile_conv_pallas.py `conv3x3_pallas` (P1,
// with its kernel `conv_kernel`), which asked whether a hand-written conv
// can match the library's.
//
// Design.  An implicit GEMM on mma.sync m16n8k16 (bf16 in, f32 accumulate):
// M = a CTA's PIX = 128 output pixels (`rows` rows x 128 / `rows` columns of
// one image), N = a block of CO_BLK = 64 output channels, K = 9 taps x the
// input channels.  4 warps, 2 along the pixels x 2 along the channels, each
// a 64-pixel x 32-channel tile (64 f32 accumulators a thread): per k16 step
// a warp reads 4 A fragments and 2 B fragments (3 KB of shared memory) for
// 16 mma, 192 bytes an mma.  The input channels go in chunks of KC = 16:
// cp.async stages the chunk's (rows + 2) x (cols + 2) patch, zero outside the
// image, one 32-byte row a pixel, and its 9 x KC x 64 taps, one 128-byte line
// a (tap, channel), both double-buffered, the next chunk's copies in flight
// while this one's products run, one barrier a chunk.  The A operand of tap
// (dy, dx) is the patch itself: each lane's ldmatrix row address points at
// patch pixel (p / cols + dy, p % cols + dx) of its output pixel p, so the
// shift costs nothing and no im2col exists.  The B operand comes from
// ldmatrix.trans of the (tap, channel)-major taps.  Rows are XOR-swizzled
// (mma.cuh swz_row, swz) so that the eight row addresses of an ldmatrix
// matrix fall in eight different bank groups.
//
// Any C and Co: the VEC variant (C % 8 == 0 and Co % 8 == 0, x and w on 16-
// byte boundaries) copies 16 bytes with cp.async; the other one loads
// elements; both zero-fill the tail of the last channel chunk and of a short
// Co block, and the stores of a short Co block are masked.  A warp whose 32
// channels all lie past Co skips its products.
//
// Bound on the H100 at (8, 64, 64, 160 -> 160) bf16: 15.1 GFLOP, 0.0153 ms at
// the bf16 tensor-core rate; the fragments' shared-memory reads (192 bytes
// an mma) are the predicted limit (PERF.md).
#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps: 2 along the pixels x 2 along the channels
constexpr int PIX = 128;      // output pixels per CTA
constexpr int CO_BLK = 64;    // output channels per CTA
constexpr int KC = 16;        // input channels per chunk: one k16 step a tap
constexpr int WM = 64;        // pixels per warp
constexpr int WN = 32;        // output channels per warp
constexpr int RB = KC * 2;    // bytes of one patch pixel's chunk
constexpr int W_BYTES = 9 * KC * CO_BLK * 2;  // one stage of taps

__host__ __device__ constexpr int patch_pixels(int rows) { return (rows + 2) * (PIX / rows + 2); }

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, int H, int W, int C, int Co, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cols = PIX / rows, pw = cols + 2, npp = (rows + 2) * pw;
  const int stage = W_BYTES + npp * RB;  // taps, then the patch
  const int nco = (Co + CO_BLK - 1) / CO_BLK;
  const int tiles_w = (W + cols - 1) / cols, tiles_h = (H + rows - 1) / rows;
  int blk = blockIdx.x;  // the Co block varies fastest: neighbours share a patch
  const int co0 = (blk % nco) * CO_BLK;
  blk /= nco;
  const int x0 = (blk % tiles_w) * cols;
  blk /= tiles_w;
  const int y0 = (blk % tiles_h) * rows, bi = blk / tiles_h;
  const bf16* xb = x + (size_t)bi * H * W * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const bool active = co0 + wn * WN < Co;
  const bf16 zero = __float2bfloat16_rn(0.f);

  auto load = [&](int chunk, int s) {
    unsigned char* ws = smem + s * stage;
    unsigned char* ps = ws + W_BYTES;
    const int c0 = chunk * KC;
    // taps: line k = tap * KC + c holds the block's 64 output channels
    for (int i = tid; i < 9 * KC * 8; i += THREADS) {
      const int k = i >> 3, ch = i & 7, tap = k / KC, c = c0 + k % KC, co = co0 + ch * 8;
      unsigned char* dst = ws + swz(k, k, ch);
      if (VEC) {
        if (c < C && co < Co)
          cp_async16(smem_u32(dst), w + ((size_t)tap * C + c) * Co + co);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(dst);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = (c < C && co + j < Co) ? w[((size_t)tap * C + c) * Co + co + j] : zero;
      }
    }
    // the patch: pixel pp = (pr, pc) is input (y0 + pr - 1, x0 + pc - 1)
    for (int i = tid; i < npp * (KC / 8); i += THREADS) {
      const int pp = i / (KC / 8), ch = i % (KC / 8);
      const int r = y0 + pp / pw - 1, s = x0 + pp % pw - 1, c = c0 + ch * 8;
      const bool in = r >= 0 && r < H && s >= 0 && s < W;
      unsigned char* dst = ps + swz_row<RB>(pp, ch);
      if (VEC) {
        if (in && c < C)
          cp_async16(smem_u32(dst), xb + ((size_t)r * W + s) * C + c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(dst);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = (in && c + j < C) ? xb[((size_t)r * W + s) * C + c + j] : zero;
      }
    }
  };

  // ldmatrix row addresses.  A: lane l reads output pixel p = 64 wm + 16 mt +
  // (l & 15) at channel chunk l >> 4; its patch pixel for tap (0, 0) is apos.
  int apos[WM / 16];
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt) {
    const int p = wm * WM + mt * 16 + (lane & 15);
    apos[mt] = (p / cols) * pw + p % cols;
  }
  const int a_ch = lane >> 4;
  // B, stored row-major in K: row k = tap * KC + b_row, chunk of 8 channels
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_ch = wn * (WN / 8) + (lane >> 4);

  float acc[WM / 16][WN / 8][4];
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nchunk = (C + KC - 1) / KC;
  load(0, 0);
  cp_async_commit();
  for (int i = 0; i < nchunk; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // chunk i is in; every warp is done with chunk i - 1's stage
    if (i + 1 < nchunk) load(i + 1, (i + 1) & 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t ws = smem_u32(smem + (i & 1) * stage), ps = ws + W_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * pw + tap % 3;
      uint32_t af[WM / 16][4];
#pragma unroll
      for (int mt = 0; mt < WM / 16; ++mt)
        ldsm_x4(ps + swz_row<RB>(apos[mt] + shift, a_ch), af[mt]);
      const int k = tap * KC + b_row;
#pragma unroll
      for (int nb = 0; nb < WN / 16; ++nb) {
        uint32_t b[4];
        ldsm_x4_t(ws + swz(k, k, b_ch + 2 * nb), b);
#pragma unroll
        for (int mt = 0; mt < WM / 16; ++mt) {
          mma_bf16(acc[mt][2 * nb], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nb + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;

  // thread l holds pixels 16 mt + l / 4 (+ 8), channels 8 nt + 2 (l % 4) (+ 1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = wm * WM + mt * 16 + g + 8 * hr, r = y0 + p / cols, s = x0 + p % cols;
      if (r >= H || s >= W) continue;
      bf16* yp = y + (((size_t)bi * H + r) * W + s) * Co;
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const int co = co0 + wn * WN + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * hr], v1 = acc[mt][nt][2 * hr + 1];
        if (!(Co & 1) && co < Co) {
          *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Co) yp[co] = __float2bfloat16_rn(v0);
          if (co + 1 < Co) yp[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

template <bool VEC>
cudaError_t launch(const bf16* x, const bf16* w, bf16* y, int B, int H, int W, int C, int Co,
                   int rows, cudaStream_t st) {
  const int cols = PIX / rows;
  const size_t smem = 2 * ((size_t)W_BYTES + (size_t)patch_pixels(rows) * RB);
  cudaError_t e = allow_smem(conv3x3_tc_kernel<VEC>, smem);
  if (e != cudaSuccess) return e;
  const long long nblk = (long long)B * ((H + rows - 1) / rows) * ((W + cols - 1) / cols) *
                         ((Co + CO_BLK - 1) / CO_BLK);
  if (nblk > INT_MAX) return cudaErrorInvalidValue;
  conv3x3_tc_kernel<VEC><<<(unsigned)nblk, THREADS, smem, st>>>(x, w, y, H, W, C, Co, rows);
  return cudaGetLastError();
}

}  // namespace

// vec != 0 takes the 16-byte cp.async variant, which needs C % 8 == 0,
// Co % 8 == 0 and x and w on 16-byte boundaries.
extern "C" int conv3x3_tc(const void* x, const void* w, void* y, int B, int H, int W, int C,
                          int Co, int rows, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0 || rows <= 0 || rows > PIX ||
      PIX % rows)
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 8 || Co % 8 || (uintptr_t)x % 16 || (uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = (const bf16*)x, *wp = (const bf16*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) return (int)launch<true>(xp, wp, (bf16*)y, B, H, W, C, Co, rows, st);
  return (int)launch<false>(xp, wp, (bf16*)y, B, H, W, C, Co, rows, st);
}
