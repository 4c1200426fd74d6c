// Kernel K10 `winograd_conv3x3`, bf16 route: a SAME, stride-1 3x3 convolution
// by Winograd F(2x2, 3x3) on the tensor cores, NHWC bf16 input, (16, C, Co)
// bf16 transformed weights U = G g G^T.  The f32 route is
// winograd_conv3x3.cu.
//
// Replaces the TPU kernel resshift_tpu/ops/winograd.py `winograd_conv3x3`
// (K10, with its kernel `_wino_kernel`).
//
// What it computes is the f32 route's: for each 2x2 output tile, d is the
// 4x4 input patch (zero outside the image), V = B^T d B its transform in f32
// (rows first, then columns, each step one add or subtract), rounded to
// bf16; M_e = sum_c V_e[c] U_e[c][co] for the 16 positions e = 4 uu + vv,
// summed in f32; the output is A^T M A, its +-1 terms added in the plain
// version's (uu, vv) order, plus the bias in f32, rounded to bf16.  H and W
// are even.
//
// Design.  The 16 channel contractions run on mma.sync m16n8k16 (bf16 in,
// f32 accumulate) with M = tiles, N = Co and K = C for each position.  A CTA
// takes TILES = 32 tiles (TR tile rows x TC tile columns, TC the smallest
// power of two that covers W / 2, at most 32) and CO_BLK = 64 output
// channels with 16 warps, split by position: warp e computes M_e for all 32
// tiles x 64 channels (64 f32 accumulators, 128 registers a thread: one CTA
// an SM).  Per k16 step a warp reads 2 A fragments (V_e, ldmatrix) and 4 B
// fragments (U_e, ldmatrix.trans: U is (C, Co), row-major in K) for 16 mma:
// 192 bytes of shared memory an mma.  The input channels go in chunks of KC
// = 32.  cp.async stages each chunk's input patch ((2 TR + 2) x (2 TC + 2)
// pixels, zero outside the image, one 64-byte row a pixel) two chunks ahead
// and its U (16 x KC lines of 64 channels) one chunk ahead; V of the next
// chunk is computed from its patch, once per (tile, channel) for the CTA's
// 64 channels, while this chunk's products run, into the other of two V
// buffers: one barrier a chunk.  V rows, the patch and U's 128-byte rows
// are swizzled by mma.cuh swz_row.  The epilogue goes through
// shared memory once: the warps write M, then each thread reads the 16
// positions of a tile and two neighbouring channels and adds A^T M A's +-1
// terms in order, and a warp stores 64 neighbouring channels of a pixel.
//
// What sets its pace is the chunk, not the tensor cores: every CTA restages
// 64 KB of U and its patch from L2 for every 32 channels and transforms the
// patch between barriers.  U costs 2 / TILES bytes a multiply-add, the
// patch and its transform about 1 / CO_BLK, and the 16 positions' f32
// accumulators cap TILES x CO_BLK at 2048 (half the register file).  So a
// CTA over 128 channels, which would transform each patch once for twice
// the channels, holds 16 tiles and moves 1.7x the bytes a multiply-add; at
// KC = 32 its two stages would take 305 KB of shared memory, so KC = 16.
// tools/profile_winograd_tilings.py builds this source with TILES, CO_BLK
// and KC of 16, 128, 16 and of 64, 32, 16: both were slower than these
// constants at every census shape on the H100 (PERF.md).  A split with all
// 16 positions of 16 tiles x 16 channels a warp (A^T M A in registers, 128
// accumulators a thread, 512 bytes of shared memory an mma) was slower too.
//
// Any C and Co: the VEC variant (C % 8 == 0 and Co % 8 == 0, x and u on 16-
// byte boundaries) copies 16 bytes with cp.async, the other one loads
// elements; both zero-fill the tail of the last channel chunk and of a short
// Co block, and the stores of a short Co block are masked.  The products of
// 16-channel groups that lie past Co are skipped.
//
// Bound on the H100 at unet res@64 batch 8 (8, 64, 64, 160 -> 160) bf16: the
// 16 products are 6.7 GFLOP, 0.0068 ms at the bf16 tensor-core rate (x and y
// once take 0.0063 ms).  PERF.md has the measurements.
#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 512;  // 16 warps: warp e computes position e
constexpr int TILES = 32;     // 2x2 output tiles per CTA
constexpr int CO_BLK = 64;    // output channels per CTA
constexpr int KC = 32;        // input channels per chunk
constexpr int RB = KC * 2;    // bytes of one patch pixel's chunk, of one V row
constexpr int U_BYTES = 16 * KC * CO_BLK * 2;  // one stage of U
constexpr int V_BYTES = 16 * TILES * RB;       // one buffer of V: 16 positions x TILES rows
constexpr int P_PIX = 8 * (TILES + 1);         // patch pixels at most: (2 TR + 2) x (2 TC + 2)
constexpr int P_BYTES = P_PIX * RB;            // one stage of the patch
constexpr int STAGES = 2 * (U_BYTES + V_BYTES + P_BYTES);
constexpr int M_LD = CO_BLK + 8;               // floats a row of the M exchange (padded)
constexpr int M_BYTES = 16 * TILES * M_LD * 4;  // the M exchange, over the stages at the end
constexpr int SMEM = STAGES > M_BYTES ? STAGES : M_BYTES;

// Output k of the 1-D input transform, the rows of B^T d:
// (d0 - d2, d1 + d2, d2 - d1, d1 - d3); k is a constant once unrolled
__device__ __forceinline__ float bt_k(int k, float d0, float d1, float d2, float d3) {
  return k == 0 ? d0 - d2 : (k == 1 ? d1 + d2 : (k == 2 ? d2 - d1 : d1 - d3));
}

// A^T[p][i], the output transform's 0 / +-1 weights: rows (1, 1, 1, 0) and
// (0, 1, -1, -1)
__device__ constexpr float at_w(int p, int i) {
  return p == 0 ? (i < 3 ? 1.f : 0.f) : (i == 0 ? 0.f : (i == 1 ? 1.f : -1.f));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    winograd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                       const float* __restrict__ bias, bf16* __restrict__ y, int H, int W,
                       int C, int Co, int tcols) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* us = smem;                    // [2][16 * KC rows of 2 CO_BLK bytes]
  unsigned char* vs = us + 2 * U_BYTES;        // [2][16][TILES rows of RB bytes]
  unsigned char* ps = vs + 2 * V_BYTES;        // [2][P_PIX rows of RB bytes]
  const int trows = TILES / tcols, h2 = H / 2, w2 = W / 2;
  const int pw = 2 * tcols + 2, npp = (2 * trows + 2) * pw;
  const int nco = (Co + CO_BLK - 1) / CO_BLK;
  const int ntc = (w2 + tcols - 1) / tcols, ntr = (h2 + trows - 1) / trows;
  int blk = blockIdx.x;  // the Co block varies fastest: neighbours share a patch
  const int co0 = (blk % nco) * CO_BLK;
  blk /= nco;
  const int tj0 = (blk % ntc) * tcols;
  blk /= ntc;
  const int ti0 = (blk % ntr) * trows, bi = blk / ntr;
  const bf16* xb = x + (size_t)bi * H * W * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the patch of chunk `chunk`: pixel pp = (pr, pc) is input (2 ti0 + pr - 1,
  // 2 tj0 + pc - 1)
  auto load_patch = [&](int chunk, int s) {
    unsigned char* dst0 = ps + s * P_BYTES;
    const int c0 = chunk * KC;
    for (int i = tid; i < npp * (KC / 8); i += THREADS) {
      const int pp = i / (KC / 8), ch = i % (KC / 8);
      const int r = 2 * ti0 + pp / pw - 1, sc = 2 * tj0 + pp % pw - 1, c = c0 + ch * 8;
      const bool in = r >= 0 && r < H && sc >= 0 && sc < W;
      unsigned char* dst = dst0 + swz_row<RB>(pp, ch);
      if (VEC) {
        if (in && c < C)
          cp_async16(smem_u32(dst), xb + ((size_t)r * W + sc) * C + c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(dst);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = (in && c + j < C) ? xb[((size_t)r * W + sc) * C + c + j] : zero;
      }
    }
  };
  // U of chunk `chunk`: row e * KC + c holds U_e[c0 + c][co0 .. co0 + CO_BLK - 1]
  auto load_u = [&](int chunk, int s) {
    unsigned char* dst0 = us + s * U_BYTES;
    const int c0 = chunk * KC;
    for (int i = tid; i < 16 * KC * (CO_BLK / 8); i += THREADS) {
      const int line = i / (CO_BLK / 8), ch = i % (CO_BLK / 8), e = line / KC, c = c0 + line % KC;
      const int co = co0 + ch * 8;
      unsigned char* dst = dst0 + swz_row<CO_BLK * 2>(line, ch);
      if (VEC) {
        if (c < C && co < Co)
          cp_async16(smem_u32(dst), u + ((size_t)e * C + c) * Co + co);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(dst);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = (c < C && co + j < Co) ? u[((size_t)e * C + c) * Co + co + j] : zero;
      }
    }
  };
  // V of the patch in stage s into V buffer s: a thread takes one tile and
  // two neighbouring channels at a time, one row uu of V after the other
  auto transform = [&](int s) {
    const unsigned char* p0 = ps + s * P_BYTES;
    unsigned char* v0 = vs + s * V_BYTES;
    for (int i = tid; i < TILES * (KC / 2); i += THREADS) {
      const int m = i / (KC / 2), cp = i % (KC / 2);
      const int pr = 2 * (m / tcols), pc = 2 * (m % tcols);
      const uint32_t word = (cp & 3) * 4;
      float2 d[4][4];  // d[a][b]: patch pixel (pr + a, pc + b), both channels
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          d[a][b] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              p0 + swz_row<RB>((pr + a) * pw + pc + b, cp >> 2) + word));
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        float2 tr[4];  // row uu of B^T d, column b
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tr[b] = make_float2(bt_k(uu, d[0][b].x, d[1][b].x, d[2][b].x, d[3][b].x),
                              bt_k(uu, d[0][b].y, d[1][b].y, d[2][b].y, d[3][b].y));
#pragma unroll
        for (int vv = 0; vv < 4; ++vv)
          *reinterpret_cast<__nv_bfloat162*>(v0 + (uu * 4 + vv) * TILES * RB +
                                             swz_row<RB>(m, cp >> 2) + word) =
              __floats2bfloat162_rn(bt_k(vv, tr[0].x, tr[1].x, tr[2].x, tr[3].x),
                                    bt_k(vv, tr[0].y, tr[1].y, tr[2].y, tr[3].y));
      }
    }
  };

  // warp e computes position e.  ldmatrix row addresses: A (V_e), tile row
  // 16 mt + (l & 15) at chunk l >> 4 of the k16 step; B (U_e), row e * KC +
  // k + b_row at chunk 2 nb + (l >> 4) of the CO_BLK channels
  const int e = warp;
  const int a_row = lane & 15, a_ch = lane >> 4;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_ch = lane >> 4;

  float acc[TILES / 16][CO_BLK / 8][4];
#pragma unroll
  for (int mt = 0; mt < TILES / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < CO_BLK / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  const int nchunk = (C + KC - 1) / KC;
  load_patch(0, 0);
  load_u(0, 0);
  if (nchunk > 1) load_patch(1, 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  transform(0);
  for (int i = 0; i < nchunk; ++i) {
    cp_async_wait<0>();
    // V of chunk i and U of chunk i are in, the patch of chunk i + 1 too;
    // every warp is done with chunk i - 1's products and chunk i's transform
    __syncthreads();
    if (i + 2 < nchunk) load_patch(i + 2, i & 1);
    if (i + 1 < nchunk) load_u(i + 1, (i + 1) & 1);
    cp_async_commit();
    if (i + 1 < nchunk) transform((i + 1) & 1);
    const uint32_t vb = smem_u32(vs + (i & 1) * V_BYTES) + e * TILES * RB;
    const uint32_t ub = smem_u32(us + (i & 1) * U_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[TILES / 16][4];
#pragma unroll
      for (int mt = 0; mt < TILES / 16; ++mt)
        ldsm_x4(vb + swz_row<RB>(mt * 16 + a_row, kk / 8 + a_ch), a[mt]);
      const int line = e * KC + kk + b_row;
#pragma unroll
      for (int nb = 0; nb < CO_BLK / 16; ++nb) {
        if (co0 + nb * 16 >= Co) break;  // the rest of a short Co block
        uint32_t b[4];
        ldsm_x4_t(ub + swz_row<CO_BLK * 2>(line, 2 * nb + b_ch), b);
#pragma unroll
        for (int mt = 0; mt < TILES / 16; ++mt) {
          mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // M_e through shared memory, once: thread l of warp e holds tiles 16 mt +
  // l / 4 (+ 8) and channels 8 nt + 2 (l % 4) (+ 1); rows of M_LD floats
  __syncthreads();  // every warp is done with the stages
  float* ms = reinterpret_cast<float*>(smem);  // [16][TILES][M_LD]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < TILES / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < CO_BLK / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(ms + (e * TILES + mt * 16 + g + 8 * hr) * M_LD + nt * 8 +
                                   2 * t) =
            make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
  __syncthreads();

  // A^T M A: a thread takes a tile and two neighbouring channels at a time,
  // adding the +-1 terms in (uu, vv) order; a warp stores 64 neighbouring
  // channels of one pixel
  for (int i = tid; i < TILES * (CO_BLK / 2); i += THREADS) {
    const int m = i / (CO_BLK / 2), cl = 2 * (i % (CO_BLK / 2)), co = co0 + cl;
    const int ti = ti0 + m / tcols, tj = tj0 + m % tcols;
    if (ti >= h2 || tj >= w2 || co >= Co) continue;
    float2 o[2][2] = {};
#pragma unroll
    for (int uu = 0; uu < 4; ++uu)
#pragma unroll
      for (int vv = 0; vv < 4; ++vv) {
        const float2 mv =
            *reinterpret_cast<const float2*>(ms + ((uu * 4 + vv) * TILES + m) * M_LD + cl);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float wgt = at_w(p, uu) * at_w(q, vv);
            if (wgt == 0.f) continue;
            o[p][q].x += wgt > 0.f ? mv.x : -mv.x;
            o[p][q].y += wgt > 0.f ? mv.y : -mv.y;
          }
      }
    const float b0 = bias ? bias[co] : 0.f, b1 = bias && co + 1 < Co ? bias[co + 1] : 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float r0 = bias ? o[p][q].x + b0 : o[p][q].x;
        const float r1 = bias ? o[p][q].y + b1 : o[p][q].y;
        bf16* yp = y + (((size_t)bi * H + 2 * ti + p) * W + 2 * tj + q) * Co + co;
        if (!(Co & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(r0, r1);
        } else {
          yp[0] = __float2bfloat16_rn(r0);
          if (co + 1 < Co) yp[1] = __float2bfloat16_rn(r1);
        }
      }
  }
}

template <bool VEC>
cudaError_t launch(const bf16* x, const bf16* u, const float* bias, bf16* y, int B, int H,
                   int W, int C, int Co, cudaStream_t st) {
  cudaError_t e = allow_smem(winograd_tc_kernel<VEC>, SMEM);
  if (e != cudaSuccess) return e;
  const int w2 = W / 2, h2 = H / 2;
  int tcols = TILES;  // the smallest power of two that covers a tile row, at most TILES
  while (tcols > 1 && tcols / 2 >= w2) tcols /= 2;
  const int trows = TILES / tcols;
  const long long nblk = (long long)B * ((h2 + trows - 1) / trows) * ((w2 + tcols - 1) / tcols) *
                         ((Co + CO_BLK - 1) / CO_BLK);
  if (nblk > INT_MAX) return cudaErrorInvalidValue;
  winograd_tc_kernel<VEC><<<(unsigned)nblk, THREADS, SMEM, st>>>(x, u, bias, y, H, W, C, Co,
                                                                 tcols);
  return cudaGetLastError();
}

}  // namespace

// vec != 0 takes the 16-byte cp.async variant, which needs C % 8 == 0,
// Co % 8 == 0 and x and u on 16-byte boundaries.
extern "C" int winograd_conv3x3_tc(const void* x, const void* u, const void* bias, void* y,
                                   int B, int H, int W, int C, int Co, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 || C <= 0 || Co <= 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 8 || Co % 8 || (uintptr_t)x % 16 || (uintptr_t)u % 16))
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = (const bf16*)x, *up = (const bf16*)u;
  const float* b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) return (int)launch<true>(xp, up, b, (bf16*)y, B, H, W, C, Co, st);
  return (int)launch<false>(xp, up, b, (bf16*)y, B, H, W, C, Co, st);
}
