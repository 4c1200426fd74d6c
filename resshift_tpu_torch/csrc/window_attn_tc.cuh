// The tensor-core body of window attention, shared by kernel A's bf16 route
// (swin_window_attn_tc.cu: PolicyA, GroupNorm affine + W-MSA/SW-MSA +
// residual + statistics partials), kernel K9's bf16 route
// (window_attn_tc.cu: PolicyK9, W-MSA alone) and probe P2's bf16 route
// (attn_variants_tc.cu: PolicyP2<SM>, the affine and the residual without
// the statistics, P2's rounding and any of its five softmaxes).  A Policy
// is fixed at compile time: A's instantiation is the code A had before K9
// and P2 shared the body, and the others drop the parts they do not
// compute.
//
// Design.  One CTA of 8 warps takes one window in 64 token rows (a window
// of N < 64 tokens is masked on its keys and dropped on its rows).  Warp w
// owns the 16 rows 16(w % 4).. and the 32 columns 32(w / 4).. of every
// 64-column panel, so that each warp's heads (hd = 32: one, hd = 16: two)
// lie in its own columns.  The raw rows come in with cp.async (one
// contiguous 2C-byte row per token, gathered through the roll: row j reads
// token rolled_token(j, +shift)) and, in A and P2, are normalized in place to xn.
// The weights stream through two cp.async stages of one 64-column panel each
// (C lines of 128 bytes), the next panel arriving while this one's products
// run: for every panel p of the heads, Wq[:, p], Wk[:, p] and Wv[:, p],
// then Wproj by 64-column panel.  All CTAs read the same 288 KB of weights
// (C = 192), which stay in L2.  Every product is mma.sync m16n8k16 with f32
// sums: xn, k and the head outputs through ldmatrix, the weights and v
// (stored row-major in K) through ldmatrix.trans.  q stays in registers as
// the A operand of q k^T; k and v of the panel go to shared memory for the
// four warps of the window that need them.  A warp's 16 x 64 scores, their
// bias (read from global memory, where it stays in L2, straight into the
// accumulator layout), the softmax (quad shuffles for the row max and sum)
// and the rounded probabilities stay in registers: the probabilities become
// the A operand of p v without a trip through shared memory
// (FlashAttention-2's layout identity).  In A and P2, after the last panel's v
// the raw rows are gathered again into the xn tile for the residual.  The
// epilogue adds bproj (and in A and P2 the residual) in registers, in place in that
// tile, and stores y row by row; A then sums the window's per-channel
// statistics over its rows in order, and a second pass (launch_stats_reduce)
// adds the windows in a fixed order, so the bits are the same in every run.
// Tiles are 64-column panels of 128-byte lines, XOR-swizzled by row.  Shared
// memory: the token tile and the head-output tile (24 KB each at C = 192), k
// and v (8 KB each), the two stages (24 KB each) and 64 row indices: 112 KB;
// 144 KB at C = 256 (one CTA an SM).
//
// Rounding to bf16 where the plain versions (ops/window_attention.py
// window_attention_plain, ops/swin_block.py, ops/attn_variants.py) and the
// f32 routes (window_heads.cuh) round.  ROUND2 = true (A, K9): in A xn =
// rnd(x*w + b) from an f32 multiply and add; q, k, v = rnd(rnd(acc) + bqkv);
// q = rnd(q * rnd(hd^-1/2)); scores rnd(rnd(acc) + rnd(B)); a true softmax in
// f32 (row max subtracted, divided by the row sum), the probabilities
// rounded (exactly the A operand of p v); head outputs rnd(acc); proj
// rnd(rnd(acc) + bproj); in A y = rnd(x + proj).  ROUND2 = false (P2): q, k,
// v = rnd(acc + bqkv), the scores acc + B in f32, y = rnd(x + (acc +
// bproj)), and the softmax and its rounding by mode (attn_variants_tc.cu).
// Only the order of the f32 sums differs from the f32 routes.
//
// Takes N <= 64, C <= 256 with C % 16 == 0, and hd = C / nh of 16 or 32
// (ops/swin_block.attn_route, ops/window_attention.window_attn_route,
// ops/attn_variants.attn_variant_route).
#pragma once

#include "mma.cuh"

namespace {

constexpr int ROWS = 64;      // token rows a CTA: one window
constexpr int THREADS = 256;  // 8 warps: 4 row blocks of 16 x 2 column halves

// B images of T window-major tokens, nwb bias rows (1 or T / N); w and b
// are A's and P2's, the partials and the roll (ws, H, W, shift) A's alone
struct AttnArgs {
  const bf16* x;
  const float* w;
  const float* b;
  const bf16* wqkv;
  const bf16* bqkv;
  const bf16* wproj;
  const bf16* bproj;
  const float* bm;
  bf16* y;
  float* part_s;
  float* part_q;
  int B, T, C, nh, N, nwb, ws, H, W, shift;
};

// byte offset of column `col` (a multiple of 8) of row `r` in a tile of
// ROWS rows kept as 64-column panels
__device__ __forceinline__ uint32_t pan(int r, int col) {
  return swz((col >> 6) * ROWS + r, r, (col >> 3) & 7);
}

__host__ __device__ constexpr size_t smem_bytes(int C) {
  // token tile, head outputs, k, v, two weight stages, the rows' source tokens
  return (size_t)2 * ROWS * ((C + 63) / 64) * 128 + (size_t)2 * ROWS * 128 +
         (size_t)2 * C * 128 + ROWS * sizeof(int);
}

// acc += rows 16 x (its 32 columns of the stage's panel), K = C: A from the
// tile at a_s (ldmatrix), B from the stage at b_s (ldmatrix.trans)
__device__ __forceinline__ void warp_mm(uint32_t a_s, uint32_t b_s, int C, int a_row, int a_col,
                                        int b_row, int b_ch, float (&acc)[4][4]) {
#pragma unroll 2
  for (int kk = 0; kk < C; kk += 16) {
    uint32_t af[4];
    ldsm_x4(a_s + pan(a_row, kk + a_col), af);
    const int r = kk + b_row;
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b_s + swz(r, r, b_ch + np * 2), b);
      mma_bf16(acc[2 * np], af, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// What an instantiation of the body computes besides W-MSA:
//   NORM    the GroupNorm affine of the rows on the way in and the residual
//           on the way out (A, P2);
//   STATS   the window's output statistics partials (A);
//   ROUND2  window_heads.cuh's rounding policy: true for A and K9, false for
//           P2 (see above);
//   SM      the softmax (SM_*, common.cuh): SM_F32 for A and K9, any of the
//           five for P2.
template <bool NORM, bool STATS, bool ROUND2, int SM>
struct Policy {
  static constexpr bool norm = NORM, stats = STATS, round2 = ROUND2;
  static constexpr int sm = SM;
};
using PolicyA = Policy<true, true, true, SM_F32>;
using PolicyK9 = Policy<false, false, true, SM_F32>;
template <int SM>
using PolicyP2 = Policy<true, false, false, SM>;

// One window (CTA blockIdx.x) of the attention, HD-wide heads.
template <int HD, class P>
__device__ __forceinline__ void window_attn_tc_body(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, N = a.N, cpr = C / 8, panels = (C + 63) / 64;
  unsigned char* xt = smem;                       // raw x -> xn -> raw x -> y
  unsigned char* ot = xt + ROWS * panels * 128;   // head outputs
  unsigned char* kt = ot + ROWS * panels * 128;   // k of the current panel
  unsigned char* vt = kt + ROWS * 128;            // v of the current panel
  unsigned char* st0 = vt + ROWS * 128;           // two stages of C lines
  const int stage = C * 128;
  int* srow = reinterpret_cast<int*>(st0 + 2 * stage);  // each row's token in x
  const uint32_t xt_s = smem_u32(xt), ot_s = smem_u32(ot), kt_s = smem_u32(kt),
                 vt_s = smem_u32(vt);

  const int nwin = a.T / N, bi = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;

  // the token each row reads through the roll (row e >= N repeats row N - 1)
  if (tid < ROWS)
    srow[tid] = bi * a.T + rolled_token(win * N + min(tid, N - 1), a.H, a.W, a.ws, a.shift);
  __syncthreads();
  // the window's raw rows, one contiguous 2C-byte row a token
  auto load_x = [&]() {
    for (int i = tid; i < ROWS * cpr; i += THREADS) {
      const int r = i / cpr, ch = i % cpr;
      cp_async16(xt_s + pan(r, ch * 8), a.x + (size_t)srow[r] * C + ch * 8);
    }
  };
  // weight panel `ci`: Wq, Wk, Wv of head panel ci / 3, then Wproj by panel
  auto load_weights = [&](int ci) {
    const bool proj = ci >= 3 * panels;
    const int p = proj ? ci - 3 * panels : ci / 3;
    const bf16* src = proj ? a.wproj + p * 64 : a.wqkv + (ci % 3) * C + p * 64;
    const int ld = proj ? C : 3 * C;
    const uint32_t dst = smem_u32(st0 + (ci & 1) * stage);
    for (int i = tid; i < C * 8; i += THREADS) {
      const int r = i >> 3, ch = i & 7;
      if (p * 64 + ch * 8 < C) cp_async16(dst + swz(r, r, ch), src + (size_t)r * ld + ch * 8);
    }
  };
  load_x();
  cp_async_commit();
  load_weights(0);
  cp_async_commit();
  if constexpr (P::norm) {
    // the image's GroupNorm fold (w | b, f32) in the k tile, free until the first k
    float* fold = reinterpret_cast<float*>(kt);
    for (int j = tid; j < 2 * C; j += THREADS)
      fold[j] = j < C ? a.w[(size_t)bi * C + j] : a.b[(size_t)bi * C + j - C];
    cp_async_wait<1>();  // the raw rows are in
    __syncthreads();

    // GroupNorm affine in place, 8 channels a step, rounded to bf16 (a warp
    // takes 32 rows of one 8-channel chunk: the fold's reads are broadcasts)
    for (int i = tid; i < ROWS * cpr; i += THREADS) {
      const int r = i % ROWS, c = (i / ROWS) * 8;
      const float* fw = fold + c;
      uint4* ptr = reinterpret_cast<uint4*>(xt + pan(r, c));
      uint4 v = *ptr;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(__low2float(h[j]), fw[2 * j]), fw[C + 2 * j]),
            __fadd_rn(__fmul_rn(__high2float(h[j]), fw[2 * j + 1]), fw[C + 2 * j + 1]));
      *ptr = v;
    }
  } else {
    cp_async_wait<1>();  // the raw rows are in
    __syncthreads();
  }

  // ldmatrix row addresses: A (tile rows), B stored row-major in K
  // (transposed; the weights and v), B stored as N x K (k, for q k^T)
  const int a_row = rb * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_ch = half * 4 + (lane >> 4);
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;
  const int r0 = rb * 16 + g;  // this thread's accumulator rows: r0, r0 + 8
  const float* bmw = a.bm + (size_t)(a.nwb == 1 ? 0 : win) * a.nh * N * N;
  const float scale = rnd<bf16>((float)(1.0 / sqrt((double)HD)));
  // the bias of head column c0 (of panel p) for this thread's scores: keys
  // 8 nt + 2t, +1 of rows r0 and r0 + 8; 0 past the last key
  auto load_bias = [&](int p, int c0, float2 (&bb)[8][2]) {
    const float* bmh = bmw + (size_t)((p * 64 + c0) / HD) * N * N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = nt * 8 + 2 * t;
        const float* src = bmh + min(r0 + 8 * hr, N - 1) * N + key;
        if (!(N & 1))  // 8-byte aligned pairs
          bb[nt][hr] = key < N ? *reinterpret_cast<const float2*>(src) : make_float2(0.f, 0.f);
        else
          bb[nt][hr] = make_float2(key < N ? src[0] : 0.f, key + 1 < N ? src[1] : 0.f);
      }
  };

  uint32_t qf[2][4];  // q of this warp's 32 columns, as the A operand of q k^T
  const int nch = 4 * panels;
  for (int ci = 0; ci < nch; ++ci) {
    if (ci + 1 < nch) load_weights(ci + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this panel's weights (and, for A's projection, the raw rows)
    __syncthreads();
    const bool proj = ci >= 3 * panels;
    const int p = proj ? ci - 3 * panels : ci / 3, part = proj ? 3 : ci % 3;
    const int col0 = p * 64 + half * 32;  // this warp's first column
    // this warp's bias pairs of the chunk, read before the product hides their latency
    uint32_t bias2[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      bias2[nt] = col < C ? *reinterpret_cast<const uint32_t*>(
                                (proj ? a.bproj : a.bqkv + part * C) + col)
                          : 0u;
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    warp_mm(proj ? ot_s : xt_s, smem_u32(st0 + (ci & 1) * stage), C, a_row, a_col, b_row,
            b_ch, acc);

    if (part == 3) {
      // output projection and bias (A, P2: plus the residual), in place in
      // the token tile
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = col0 + nt * 8 + 2 * t;
        if (col >= C) continue;
        const __nv_bfloat162 bp = *reinterpret_cast<const __nv_bfloat162*>(&bias2[nt]);
        const float bp0 = __low2float(bp), bp1 = __high2float(bp);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          __nv_bfloat162* ptr =
              reinterpret_cast<__nv_bfloat162*>(xt + pan(r0 + 8 * hr, col & ~7) + (col & 7) * 2);
          float o0, o1;
          if constexpr (P::round2) {
            o0 = rnd<bf16>(rnd<bf16>(acc[nt][2 * hr]) + bp0);
            o1 = rnd<bf16>(rnd<bf16>(acc[nt][2 * hr + 1]) + bp1);
          } else {
            o0 = acc[nt][2 * hr] + bp0;
            o1 = acc[nt][2 * hr + 1] + bp1;
          }
          if constexpr (P::norm) {
            const __nv_bfloat162 xv = *ptr;
            *ptr = __floats2bfloat162_rn(__low2float(xv) + o0, __high2float(xv) + o1);
          } else {
            *ptr = __floats2bfloat162_rn(o0, o1);
          }
        }
      }
    } else {
      // q, k or v of this warp's columns: rnd(rnd(acc) + bias), or rnd(acc +
      // bias) under P2's rounding
      float v[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat162 bq = *reinterpret_cast<const __nv_bfloat162*>(&bias2[nt]);
        const float bq0 = __low2float(bq), bq1 = __high2float(bq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (P::round2)
            v[nt][e] = rnd<bf16>(rnd<bf16>(acc[nt][e]) + ((e & 1) ? bq1 : bq0));
          else
            v[nt][e] = rnd<bf16>(acc[nt][e] + ((e & 1) ? bq1 : bq0));
          if (part == 0) v[nt][e] = rnd<bf16>(v[nt][e] * scale);
        }
      }
      if (part == 0) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          qf[nt >> 1][(nt & 1) * 2] = pack_bf16(v[nt][0], v[nt][1]);
          qf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(v[nt][2], v[nt][3]);
        }
      } else {
        unsigned char* dst = part == 1 ? kt : vt;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = half * 32 + nt * 8 + 2 * t;  // within the panel
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(dst + pan(r0 + 8 * hr, col & ~7) + (col & 7) * 2) =
                pack_bf16(v[nt][2 * hr], v[nt][2 * hr + 1]);
        }
      }
    }

    if (part == 2) {
      __syncthreads();  // k and v of the panel are complete; xn is read no more
      if constexpr (P::norm) {
        if (p == panels - 1) {
          load_x();  // the raw rows again, for the residual
          cp_async_commit();
        }
      }
      // attention of the heads in this warp's columns
#pragma unroll
      for (int j = 0; j < 32 / HD; ++j) {
        const int c0 = half * 32 + j * HD;  // the head's first column in the panel
        if (p * 64 + c0 >= C) break;
        float2 bb[8][2];
        load_bias(p, c0, bb);

        float sc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
        for (int kq = 0; kq < HD / 16; ++kq) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            const int kr = np * 16 + k_row;
            ldsm_x4(kt_s + swz(kr, kr, (c0 + kq * 16) / 8 + k_ch), b);
            mma_bf16(sc[2 * np], qf[j * HD / 16 + kq], b[0], b[1]);
            mma_bf16(sc[2 * np + 1], qf[j * HD / 16 + kq], b[2], b[3]);
          }
        }

        // bias and mask, then the softmax over rows r0 (e = 0, 1) and r0 + 8.
        // A masked key (key >= N) must come out as p = 0: at -inf it stays
        // out of the row max, and exp() takes it to 0 (f32, mxsum, bf16exp);
        // noexp sets it to 0 after the max, none at once.
        constexpr int SM = P::sm;
        constexpr bool MAX = SM == SM_F32 || SM == SM_BF16EXP || SM == SM_NOEXP;
        const float MASKED = SM == SM_NONE ? 0.f : -INFINITY;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = nt * 8 + 2 * t + (e & 1);
            const float2 bv = bb[nt][e >> 1];
            if constexpr (P::round2)
              sc[nt][e] = key < N ? rnd<bf16>(rnd<bf16>(sc[nt][e]) +
                                              rnd<bf16>((e & 1) ? bv.y : bv.x))
                                  : MASKED;
            else
              sc[nt][e] = key < N ? sc[nt][e] + ((e & 1) ? bv.y : bv.x) : MASKED;
            if constexpr (MAX) mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
          }
        float sum[2] = {0.f, 0.f};
        if constexpr (MAX) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          }
        }
        if constexpr (SM != SM_NONE) {
          // the terms and their f32 row sum: f32 exp(s - max); mxsum
          // rnd(exp(s - 30)) (s carries the shift of 30 already); bf16exp
          // rnd(exp(rnd(s - max))); noexp s - max
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (SM == SM_F32)
                sc[nt][e] = expf(sc[nt][e] - mx[e >> 1]);
              else if constexpr (SM == SM_MXSUM)
                sc[nt][e] = rnd<bf16>(expf(sc[nt][e] - 30.f));
              else if constexpr (SM == SM_BF16EXP)
                sc[nt][e] = rnd<bf16>(expf(rnd<bf16>(sc[nt][e] - mx[e >> 1])));
              else
                sc[nt][e] = nt * 8 + 2 * t + (e & 1) < N ? sc[nt][e] - mx[e >> 1] : 0.f;
              sum[e >> 1] += sc[nt][e];
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
            if constexpr (SM == SM_BF16EXP) sum[r] = rnd<bf16>(sum[r]);
          }
        }
        // the probabilities as the A operand of p v, 16 keys a step.  f32 and
        // bf16exp: e / sum correctly rounded (Markstein: one rounded
        // reciprocal a row, then a product and two FMAs), with e scaled by
        // 2^64 so that no step leaves the normal range: the compiler's
        // division would take its slow path for the tiny terms of masked
        // keys.  The row sum is in [1, 64] (its max term is exp(0)), so a
        // term below 2^-134 divides to below half bf16's least subnormal and
        // rounds to 0; it is set to 0 first.  noexp: an IEEE division (its
        // sum is negative and unbounded).  mxsum: p unnormalised, p v scaled
        // by rc below; none: the raw scores.
        const float rc[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
        auto prob = [&](float e, int r) {
          if constexpr (SM == SM_F32 || SM == SM_BF16EXP) {
            const float x = e < 0x1p-134f ? 0.f : __fmul_rn(e, 0x1p64f);
            const float q0 = __fmul_rn(x, rc[r]);
            return __fmul_rn(__fmaf_rn(rc[r], __fmaf_rn(-sum[r], q0, x), q0), 0x1p-64f);
          } else if constexpr (SM == SM_NOEXP) {
            return __fdiv_rn(e, sum[r]);
          } else {
            return e;
          }
        };
        uint32_t pf[4][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          pf[nt >> 1][(nt & 1) * 2] = pack_bf16(prob(sc[nt][0], 0), prob(sc[nt][1], 0));
          pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(prob(sc[nt][2], 1), prob(sc[nt][3], 1));
        }

        float o[HD / 8][4];
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            uint32_t b[4];
            const int vr = ks * 16 + b_row;
            ldsm_x4_t(vt_s + swz(vr, vr, (c0 + np * 16) / 8 + (lane >> 4)), b);
            mma_bf16(o[2 * np], pf[ks], b[0], b[1]);
            mma_bf16(o[2 * np + 1], pf[ks], b[2], b[3]);
          }
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          const int col = p * 64 + c0 + nt * 8 + 2 * t;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float o0 = o[nt][2 * hr], o1 = o[nt][2 * hr + 1];
            if constexpr (SM == SM_MXSUM) o0 = __fmul_rn(o0, rc[hr]), o1 = __fmul_rn(o1, rc[hr]);
            *reinterpret_cast<uint32_t*>(ot + pan(r0 + 8 * hr, col & ~7) + (col & 7) * 2) =
                pack_bf16(o0, o1);
          }
        }
      }
    }
    __syncthreads();  // this stage, k and v no longer read
  }
  cp_async_wait<0>();

  // store the window's N rows, 16 bytes a thread
  for (int i = tid; i < N * cpr; i += THREADS) {
    const int r = i / cpr, ch = i % cpr;
    *reinterpret_cast<uint4*>(a.y + ((size_t)blockIdx.x * N + r) * C + ch * 8) =
        *reinterpret_cast<const uint4*>(xt + pan(r, ch * 8));
  }

  if constexpr (P::stats) {
    // the window's share of the output statistics, its rows summed in order
    for (int c = tid; c < C; c += THREADS) {
      float as = 0.f, aq = 0.f;
      for (int e = 0; e < N; ++e) {
        const float v =
            __bfloat162float(*reinterpret_cast<const bf16*>(xt + pan(e, c & ~7) + (c & 7) * 2));
        as += v;
        aq = fmaf(v, v, aq);
      }
      a.part_s[(size_t)blockIdx.x * C + c] = as;
      a.part_q[(size_t)blockIdx.x * C + c] = aq;
    }
  }
}

}  // namespace
