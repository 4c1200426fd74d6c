// Kernel F, bf16 route on the tensor cores: GroupNorm affine + SiLU + 3x3 conv
// (zero padding of the activated tensor) to at most 8 output channels, NCHW
// bf16 in and out, for C % 16 == 0 (the decoder tails: C = 128 at 256x256
// for f4, C = 64 at 512x512 for f8).  The folded affine w, bb comes from
// `gn_stats` (gn_silu_conv3x3.cu, which also holds the FMA route for f32 and
// for other C).
//
// Replaces, with gn_stats, the TPU kernel resshift_tpu/ops/tail_pallas.py
// `_fused` (K8) in bf16.
//
// Rounding points (tail_pallas._reference, as ops/tail.py's plain version
// writes it): the affine x * w + b in f32, rounded to bf16; the SiLU as
// a * (1 / (1 + exp(-a))), each operation rounded to bf16; the taps summed in
// f32, the sum rounded to bf16, then the bias added in bf16.  1 + e and a * r
// of two bf16 values run as bf16x2 adds and multiplies: their f32 results
// are exact (the product) or round only where the bf16 result cannot change
// (the sum), so one rounding to bf16 gives the same bits as the plain
// version's f32 operation and its rounding.  1 / v is __frcp_rn(v), equal to
// __fdiv_rn(1.f, v) bit for bit, and here (1 + e is a bf16 value of at least 1)
// rounds to the same bf16 as rcp.approx, which the kernel runs.
//
// Design.  One CTA of 256 threads per (image, TH x TW = 16 x 64 output tile):
// an implicit GEMM on mma.sync m16n8k16 (bf16 in, f32 accumulate) with M =
// the tile's pixels, N = co zero-padded to 8, K = 9 taps x C.
//  * A: the channels go in chunks of KC = 32.  The CTA stages the chunk's 18 x
//    66 halo tile of the ACTIVATED tensor in shared memory as [pixel]
//    [channel] bf16, one 64-byte row a pixel, 16-byte chunks XOR-swizzled
//    (mma.cuh swz_row<64>), the halo rows PW = 67 pixels apart.  Columns 1
//    to 64 come in through 16-byte loads: a lane reads 8 pixels of each of 4
//    channels (the next lane item's loads issued before this one's SiLU),
//    applies the affine and SiLU once per element (two pixels at a time),
//    transposes the 8 x 4 block in registers and writes 8 bytes a pixel; the
//    16 lanes of each store phase hold 8 channel groups of 2 rows, and an
//    odd PW puts the two rows in different halves of the banks, so the
//    stores do not conflict.  The two halo columns come in by 2-byte loads,
//    two channels a lane.  Pixels outside the image are 0 after the SiLU.
//    The halo costs 18 x 66 / (16 x 64) = 1.16 reads and SiLUs per pixel.
//  * B: the taps, (9, 8, C) bf16 with co zero-padded to 8 and each row C + 8
//    wide (so that the 8 rows of a fragment load fall in different banks),
//    stay in shared memory for the whole CTA: 24 KB at C = 160.
//  * The products: warp w owns output rows 8 (w / 4) .. + 7 of column quarter
//    w % 4 (16 pixels), 8 m-tiles of 16 pixels, 32 f32 accumulators a thread.
//    For each k16 step and column shift dx, it loads the A fragment of each
//    of the 10 halo rows its taps read once (ldmatrix, each lane's row
//    address at the shifted halo pixel, so the taps cost no copy) and uses it
//    for every tap (dy, dx) that reads that row: 30 ldmatrix.x4 for 72 mma.
//  * The epilogue: each accumulator rounds to bf16, the bf16 bias is added and
//    the result rounds again; co <= 8 NCHW planes are written.
//
// Bound on the H100: bytes (one read of x, one write of y over 3.35 TB/s),
// 0.040 ms at the f4 tail (8, 128, 256, 256) -> 3.  With gn_stats' read of x
// first, two reads of x are the floor of this design (0.080 ms there).  The
// pace is set by reading x and by the SiLU's issue rate (an exp and a
// correctly rounded reciprocal per element); the mma work is small (n = 8).
#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int TH = 16, TW = 64;       // output rows and columns per CTA
constexpr int KC = 32;                // channels per chunk: two k16 steps
constexpr int HR = TH + 2, HC = TW + 2;  // the halo tile: 18 x 66 pixels
constexpr int PW = HC + 1;            // 67: odd pitch of the halo rows, in pixels
constexpr int RB = KC * 2;            // 64 bytes: one halo pixel's chunk
constexpr int A_BYTES = HR * PW * RB; // 77184
constexpr int VEC_ITEMS = HR * 8 * 8; // 1152 lane items: (halo row, 8-pixel vector, 4 channels)
constexpr int BATCH = 8;              // element loads in flight a thread
constexpr int WROWS = 8;              // output rows per warp

__host__ __device__ constexpr int taps_pitch(int C) { return (C + KC - 1) / KC * KC + 8; }

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)A_BYTES + (size_t)9 * 8 * taps_pitch(C) * 2 + (size_t)2 * C * 4;
}

// 1 / v for v = bf16(1 + e) >= 1, as rcp.approx (at most 1 ulp off): for
// every such v the correctly rounded 1 / v lies at least 129 ulps from the
// nearest midpoint of two bf16 values, so the approximation rounds to the
// same bf16 as __frcp_rn (tests/test_torch_tail_split.py checks every v).
__device__ __forceinline__ float rcp_for_bf16(float v) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// affine + SiLU of the two bf16 values of `xw` (low half first; their
// affines w0, b0 and w1, b1), rounded as the plain version rounds; returns
// the two results as bf16x2
__device__ __forceinline__ uint32_t silu2(uint32_t xw, float w0, float b0, float w1, float b1) {
  const float x0 = __uint_as_float(xw << 16), x1 = __uint_as_float(xw & 0xffff0000u);
  const __nv_bfloat162 a = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(x0, w0), b0),
                                                 __fadd_rn(__fmul_rn(x1, w1), b1));
  const float2 af = __bfloat1622float2(a);
  const __nv_bfloat162 e = __floats2bfloat162_rn(expf(-af.x), expf(-af.y));
  const float2 d = __bfloat1622float2(__hadd2(__float2bfloat162_rn(1.f), e));
  const __nv_bfloat162 r = __floats2bfloat162_rn(rcp_for_bf16(d.x), rcp_for_bf16(d.y));
  const __nv_bfloat162 s = __hmul2(a, r);
  return *reinterpret_cast<const uint32_t*>(&s);
}

__device__ __forceinline__ float silu1(float xv, float w, float b) {
  const float a = rnd<bf16>(__fadd_rn(__fmul_rn(xv, w), b));
  const float r = rnd<bf16>(rcp_for_bf16(rnd<bf16>(1.f + rnd<bf16>(expf(-a)))));
  return rnd<bf16>(a * r);
}

// The SiLU of 8 pixels of 4 channels (u[i]: channel c + i), transposed into
// each pixel's 8 bytes of the 4 channels (out[j]: pixel j, channels 2k and
// 2k + 1 in word k); zeros where the pixels lie outside the image (`in`
// false).
__device__ __forceinline__ void silu_4ch(const uint4 (&u)[4], const float* sw, const float* sb,
                                         int c, bool in, uint32_t (&out)[8][2]) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    uint32_t s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};
    if (in) {
      const float w0 = sw[c + i], b0 = sb[c + i], w1 = sw[c + i + 1], b1 = sb[c + i + 1];
      const uint32_t x0w[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
      const uint32_t x1w[4] = {u[i + 1].x, u[i + 1].y, u[i + 1].z, u[i + 1].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s0[k] = silu2(x0w[k], w0, b0, w0, b0);
        s1[k] = silu2(x1w[k], w1, b1, w1, b1);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[2 * k][i / 2] = __byte_perm(s0[k], s1[k], 0x5410);
      out[2 * k + 1][i / 2] = __byte_perm(s0[k], s1[k], 0x7632);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    gn_silu_conv3x3_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ gw,
                              const float* __restrict__ gb, const bf16* __restrict__ wt,
                              const bf16* __restrict__ cbias, bf16* __restrict__ y, int C,
                              int H, int W, int co) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int TP = taps_pitch(C);
  bf16* bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* sw = reinterpret_cast<float*>(smem + A_BYTES + 9 * 8 * TP * 2);
  float* sb = sw + C;
  const uint32_t as = smem_u32(smem);
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % tiles_w) * TW, y0 = (blockIdx.x / tiles_w % tiles_h) * TH;
  const int b = blockIdx.x / tiles_w / tiles_h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* xb = x + (size_t)b * C * H * W;

  for (int i = tid; i < C; i += THREADS) {
    sw[i] = gw[(size_t)b * C + i];
    sb[i] = gb[(size_t)b * C + i];
  }
  // bs[(tap * 8 + o) * TP + c] = k[o, c, tap / 3, tap % 3], 0 past co and C
  for (int i = tid; i < 8 * TP * 9; i += THREADS) {
    const int o = i / (TP * 9), c = i / 9 % TP, tap = i % 9;
    bs[(tap * 8 + o) * TP + c] =
        o < co && c < C ? wt[((size_t)o * C + c) * 9 + tap] : __float2bfloat16_rn(0.f);
  }

  // element i of the halo tile (channel-major, then rows, then columns), for
  // maps the 16-byte loads do not fit: the image's pixel or -1 outside it
  // (the conv's zero padding, after the SiLU), then its affine, SiLU and
  // 2-byte store
  auto elem_at = [&](int i, int c0) -> long long {
    const int cc = i / (HR * HC), gy = y0 - 1 + i % (HR * HC) / HC, gx = x0 - 1 + i % HC;
    const int c = c0 + cc;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W || c >= C) return -1;
    return ((long long)c * H + gy) * W + gx;
  };
  auto elem_store = [&](int i, float v) {
    const int cc = i / (HR * HC), p = i % (HR * HC) / HC * PW + i % HC;
    *reinterpret_cast<bf16*>(smem + swz_row<RB>(p, cc >> 3) + (cc & 7) * 2) =
        __float2bfloat16_rn(v);
  };
  // the lane items of the 16-byte path: halo row, 8-pixel vector and first
  // channel of item `item` (lane bits: 4-channel group, row bit, vector
  // bit), and whether its pixels lie in the image
  auto where = [&](int item, int c0, int& hr, int& v, int& cb) -> bool {
    const int id = item >> 5;
    hr = 2 * (id % (HR / 2)) + ((item >> 3) & 1);
    v = (id / (HR / 2)) * 2 + ((item >> 4) & 1);
    cb = c0 + (item & 7) * 4;
    const int gy = y0 - 1 + hr;
    return gy >= 0 && gy < H && x0 + 8 * v < W && cb < C;  // C % 16 == 0: 4 channels or none
  };
  // the 4 channels of item `item`'s 8 pixels, one 16-byte load each
  auto load4 = [&](int item, int c0, uint4 (&u)[4]) {
    int hr, v, cb;
    const bool in = item < VEC_ITEMS && where(item, c0, hr, v, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = in ? __ldg(reinterpret_cast<const uint4*>(
                      xb + ((size_t)(cb + i) * H + y0 - 1 + hr) * W + x0 + 8 * v))
                : make_uint4(0, 0, 0, 0);
  };

  const int q = warp & 3, rh = warp >> 2;  // column quarter, row half
  const int g = lane >> 2, t = lane & 3;
  float acc[WROWS][4];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  __syncthreads();  // the affine and the taps are in
  for (int c0 = 0; c0 < C; c0 += KC) {
    if (VEC) {
      // every halo row, columns 1..64: lane item (4 channels, row bit,
      // vector bit) reads 8 pixels of 4 channels with 16-byte loads, the next
      // item's loads issued before this one's SiLU; it writes 8 bytes a
      // pixel, and the 16 lanes of each store phase (8 channel groups x 2
      // rows an odd pitch apart) fill the 32 banks once
      uint4 ua[4], ub[4];
      load4(tid, c0, ua);
#pragma unroll 1
      for (int item = tid; item < VEC_ITEMS; item += 2 * THREADS) {
        uint32_t out[8][2];
        int hr, v, cb;
        bool in = where(item, c0, hr, v, cb);
        load4(item + THREADS, c0, ub);
        silu_4ch(ua, sw, sb, cb, in, out);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint2*>(smem + swz_row<RB>(hr * PW + 1 + 8 * v + j, (item & 7) >> 1) +
                                    (item & 1) * 8) = make_uint2(out[j][0], out[j][1]);
        const int next = item + THREADS;
        if (next >= VEC_ITEMS) break;
        in = where(next, c0, hr, v, cb);
        load4(next + THREADS, c0, ua);
        silu_4ch(ub, sw, sb, cb, in, out);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint2*>(smem + swz_row<RB>(hr * PW + 1 + 8 * v + j, (next & 7) >> 1) +
                                    (next & 1) * 8) = make_uint2(out[j][0], out[j][1]);
      }
      // columns 0 and 65 of every halo row, two channels a lane: pair i is
      // channels c0 + 2 (i / 2 HR) + {0, 1} of halo pixel ((i % 2 HR) / 2,
      // column 0 or 65 by its parity); the loads first, then the SiLU as a
      // bf16x2 pair and one 4-byte store
      constexpr int NP = KC / 2 * HR * 2, PPT = (NP + THREADS - 1) / THREADS;
      uint32_t raw[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = tid + k * THREADS, cc = 2 * (i / (2 * HR)), hr = (i % (2 * HR)) >> 1;
        const int gy = y0 - 1 + hr, gx = (i & 1) ? x0 + TW : x0 - 1, c = c0 + cc;
        raw[k] = 0;
        if (i < NP && gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
          const bf16* xp = xb + ((size_t)c * H + gy) * W + gx;
          raw[k] = (uint32_t)__bfloat16_as_ushort(xp[0]) |
                   ((uint32_t)__bfloat16_as_ushort(xp[(size_t)H * W]) << 16);
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = tid + k * THREADS, cc = 2 * (i / (2 * HR)), hr = (i % (2 * HR)) >> 1;
        if (i >= NP) break;
        const int gy = y0 - 1 + hr, gx = (i & 1) ? x0 + TW : x0 - 1, c = c0 + cc;
        uint32_t v = 0;  // the conv's zero padding, after the SiLU
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
          v = silu2(raw[k], sw[c], sb[c], sw[c + 1], sb[c + 1]);
        *reinterpret_cast<uint32_t*>(smem + swz_row<RB>(hr * PW + ((i & 1) ? HC - 1 : 0), cc >> 3) +
                                     (cc & 7) * 2) = v;
      }
    } else {
      for (int i0 = tid; i0 < KC * HR * HC; i0 += BATCH * THREADS) {
        float raw[BATCH];  // BATCH loads in flight, then their SiLU
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const int i = i0 + k * THREADS;
          const long long at = i < KC * HR * HC ? elem_at(i, c0) : -1;
          raw[k] = at >= 0 ? __bfloat162float(xb[at]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const int i = i0 + k * THREADS;
          if (i >= KC * HR * HC) break;
          const int c = c0 + i / (HR * HC);
          elem_store(i, elem_at(i, c0) >= 0 ? silu1(raw[k], sw[c], sb[c]) : 0.f);
        }
      }
    }
    __syncthreads();  // the chunk is in

#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int kg = c0 + 16 * ks;
      if (kg >= C) break;  // C % 16 == 0: the chunk's second half may lie past C
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx) {
        uint32_t bf[3][2];  // taps (dy, dx), dy = 0..2
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const bf16* bp = bs + ((dy * 3 + dx) * 8 + g) * TP + kg + 2 * t;
          bf[dy][0] = *reinterpret_cast<const uint32_t*>(bp);
          bf[dy][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
        }
#pragma unroll
        for (int hr = 0; hr < WROWS + 2; ++hr) {
          // output pixel 16 q + (l & 15) of halo row 8 rh + hr, shifted by dx
          const int p = (WROWS * rh + hr) * PW + 16 * q + dx + (lane & 15);
          uint32_t a[4];
          ldsm_x4(as + swz_row<RB>(p, 2 * ks + (lane >> 4)), a);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            if (hr - dy >= 0 && hr - dy < WROWS) mma_bf16(acc[hr - dy], a, bf[dy][0], bf[dy][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk
  }

  // thread l holds pixels 16 q + l / 4 (+ 8) of each of its rows, output
  // channels 2 (l % 4) and 2 (l % 4) + 1
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    const int gy = y0 + WROWS * rh + r;
    if (gy >= H) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gx = x0 + 16 * q + g + 8 * hh;
      if (gx >= W) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = 2 * t + e;
        if (o < co)
          y[(((size_t)b * co + o) * H + gy) * W + gx] =
              __float2bfloat16_rn(rnd<bf16>(acc[r][2 * hh + e]) + __bfloat162float(cbias[o]));
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const bf16* x, const float* w, const float* b, const bf16* wt,
                   const bf16* cbias, bf16* y, int B, int C, int H, int W, int co,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(C);
  cudaError_t e = allow_smem(gn_silu_conv3x3_tc_kernel<VEC>, smem);
  if (e != cudaSuccess) return e;
  const long long nblk = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (nblk > INT_MAX) return cudaErrorInvalidValue;
  gn_silu_conv3x3_tc_kernel<VEC><<<(unsigned)nblk, THREADS, smem, st>>>(x, w, b, wt, cbias, y, C,
                                                                       H, W, co);
  return cudaGetLastError();
}

}  // namespace

// x (B, C, H, W), y (B, co, H, W), weight (co, C, 3, 3) and cbias (co,)
// bf16; w, b (B, C) f32, the folded GroupNorm affine.  C % 16 == 0, co <= 8.
extern "C" int gn_silu_conv3x3_tc(const void* x, const void* w, const void* b,
                                  const void* weight, const void* cbias, void* y, int B, int C,
                                  int H, int W, int co, void* stream) {
  if (co < 1 || co > 8 || B <= 0 || C <= 0 || C % 16 || H <= 0 || W <= 0 ||
      smem_bytes(C) > 232448)
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = (const bf16*)x, *wp = (const bf16*)weight, *cb = (const bf16*)cbias;
  const float *gw = (const float*)w, *gb = (const float*)b;
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 8 == 0 && (uintptr_t)x % 16 == 0)
    return (int)launch<true>(xp, gw, gb, wp, cb, (bf16*)y, B, C, H, W, co, st);
  return (int)launch<false>(xp, gw, gb, wp, cb, (bf16*)y, B, C, H, W, co, st);
}
