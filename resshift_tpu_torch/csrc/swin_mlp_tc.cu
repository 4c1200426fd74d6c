// Kernel B, bf16 route: fused GroupNorm affine + channel MLP (fc1, exact-erf
// GELU, fc2) + residual + output statistics over (B, T, C) window-major
// bf16 tokens on the tensor cores, optionally reading the shifted layout and
// writing the unshifted one.  The f32 route is swin_mlp.cu.
//
// Replaces the TPU kernels resshift_tpu/ops/swin_block_pallas.py
// `_norm_mlp_residual_fwd_pallas` (K2, via norm_mlp_residual_stats) and
// `_mlp_unshift_fwd_pallas` (K4, via mlp_unshift_residual_stats).
//
//   y = x + fc2(GELU(fc1(x*w + b)))
//
// Design.  One CTA of 8 warps per 64-token row tile; warps w and w + 4 own
// rows 16w..16w+15 and split each hidden chunk, warp w + 4h taking its
// channels 32h..32h+31, so that two warps a scheduler hide each other's
// latencies.  The gathered raw x tile (cp.async, one contiguous 2C-byte row
// per token: output row j reads input row rolled_token(j, -shift)) and its
// normalized bf16 copy xn stay in shared memory.  The hidden layer runs in
// chunks of 64: w1[:, chunk] and w2[chunk, :] (24 KB each at C = 192)
// stream through two cp.async stages, the next chunk's arriving while this
// one's products run; all CTAs read the same 576 KB of weights, which stay
// in L2.  fc1 is mma.sync m16n8k16 (xn through ldmatrix, w1 through
// ldmatrix.trans); its 16 x 32 f32 accumulators get the bias, the GELU and
// the roundings in registers and become the A operand of fc2 without a trip
// through shared memory.  fc2 sums into a 16 x C f32 accumulator a warp (96
// registers a thread at C = 192) over its half of every hidden chunk; the
// two halves are added (lower half first) through shared memory once, at
// the end.  The epilogue adds the bias and the residual in place in the raw
// x tile, stores it row-wise and sums this tile's per-channel statistics in
// a fixed order; a second pass (stats_reduce_kernel) adds the tiles in a
// fixed order, so the bits are the same in every run.  Tiles are 64-column
// panels of 128-byte lines, XOR-swizzled by row.
//
// Rounding to bf16 where the plain version (ops/swin_block.py
// norm_mlp_residual_plain) and the f32 route round: xn = rnd(x*w + b) from
// an f32 multiply and add; rnd(rnd(fc1) + b1), then the exact-erf GELU
// (erff, as PyTorch's), rounded; fc2 summed in f32, then rnd(rnd(.) + b2);
// rnd(x + .).
//
// Takes C <= 256 with C % 16 == 0 and hidden % 64 == 0.
//
// Bound on the H100 at the main path's shapes (x (8, 4096, 192)): 0.59 MFLOP
// per token against 768 bytes of x and y, so the tensor-core rate bounds it
// (0.0195 ms).  This design sits well above it: each CTA walks twelve
// barrier-separated hidden chunks with two warps a scheduler, so one CTA's
// latency, not the card's throughput, sets its time (a launch of 8 CTAs
// takes about as long as a wave of 132; see PERF.md for the measured times).
#include "mma.cuh"

namespace {

constexpr int ROWS = 64;
constexpr int THREADS = 256;
constexpr int HC = 64;  // hidden channels a chunk

struct MlpArgs {
  const bf16* x;
  const float* w;
  const float* b;
  const bf16* w1;
  const bf16* b1;
  const bf16* w2;
  const bf16* b2;
  bf16* y;
  float* part_s;
  float* part_q;
  int T, C, hidden, ws, H, W, shift;
};

// byte offset of column `col` (a multiple of 8) of row `r` in a tile of
// `rows` rows kept as 64-column panels
__device__ __forceinline__ uint32_t pan(int rows, int r, int col) {
  return swz((col >> 6) * rows + r, r, (col >> 3) & 7);
}

__host__ __device__ constexpr size_t smem_bytes(int C) {
  // raw x, xn, and two stages of w1 (C lines) and w2 (HC rows of panels)
  return (size_t)2 * ROWS * ((C + 63) / 64) * 128 +
         (size_t)2 * (C * 128 + HC * ((C + 63) / 64) * 128);
}

template <int CT>
__global__ void __launch_bounds__(THREADS, 1) swin_mlp_tc_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, hidden = a.hidden, cpr = C / 8;
  const int panels = (C + 63) / 64;
  unsigned char* xr = smem;                      // raw x, then y
  unsigned char* xn = xr + ROWS * panels * 128;  // normalized x
  unsigned char* st0 = xn + ROWS * panels * 128;
  const int stage = C * 128 + HC * panels * 128;

  const int nblk = (a.T + ROWS - 1) / ROWS;
  const int bi = blockIdx.x / nblk, t0 = (blockIdx.x % nblk) * ROWS;
  const int M = min(ROWS, a.T - t0);
  const bf16* x = a.x + (size_t)bi * a.T * C;
  const float* gw = a.w + (size_t)bi * C;
  const float* gb = a.b + (size_t)bi * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp & 3, hs = warp >> 2;  // row block, half of the hidden chunk
  const int g = lane >> 2, t = lane & 3;

  // 1. the raw rows; with an unshift, output row j reads input row inv(j)
  for (int i = tid; i < ROWS * cpr; i += THREADS) {
    const int r = i / cpr, ch = i % cpr;
    const int src = rolled_token(min(t0 + r, a.T - 1), a.H, a.W, a.ws, -a.shift);
    cp_async16(smem_u32(xr + pan(ROWS, r, ch * 8)), x + (size_t)src * C + ch * 8);
  }
  cp_async_commit();
  auto load_weights = [&](int chunk) {
    unsigned char* st = st0 + (chunk & 1) * stage;
    const int h0 = chunk * HC;
    for (int i = tid; i < C * 8; i += THREADS) {  // w1[:, h0:h0+64], one line a row
      const int r = i >> 3, ch = i & 7;
      cp_async16(smem_u32(st + swz(r, r, ch)), a.w1 + (size_t)r * hidden + h0 + ch * 8);
    }
    for (int i = tid; i < HC * cpr; i += THREADS) {  // w2[h0:h0+64, :]
      const int r = i / cpr, ch = i % cpr;
      cp_async16(smem_u32(st + C * 128 + pan(HC, r, ch * 8)),
                 a.w2 + (size_t)(h0 + r) * C + ch * 8);
    }
  };
  load_weights(0);
  cp_async_commit();
  cp_async_wait<1>();  // the raw rows are in
  __syncthreads();

  // 2. GroupNorm affine, rounded to bf16
  for (int i = tid; i < ROWS * (C / 2); i += THREADS) {
    const int r = i / (C / 2), c = (i % (C / 2)) * 2;
    const uint32_t off = pan(ROWS, r, c & ~7) + (c & 7) * 2;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(xr + off);
    *reinterpret_cast<__nv_bfloat162*>(xn + off) = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(__low2float(v), gw[c]), gb[c]),
        __fadd_rn(__fmul_rn(__high2float(v), gw[c + 1]), gb[c + 1]));
  }

  // ldmatrix row addresses: A (xn rows), B stored row-major in K (transposed)
  const int a_row = rw * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3), b_col = (lane >> 4) * 8;
  const uint32_t xn_s = smem_u32(xn);

  float acc[CT / 8][4];
#pragma unroll
  for (int i = 0; i < CT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nch = hidden / HC;
  for (int chunk = 0; chunk < nch; ++chunk) {
    if (chunk + 1 < nch) load_weights(chunk + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's weights are in
    __syncthreads();
    const uint32_t w1s = smem_u32(st0 + (chunk & 1) * stage), w2s = w1s + C * 128;

    // 3. fc1 for hidden channels h0 + 32hs .. h0 + 32hs + 31 of this warp's rows
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i][0] = h[i][1] = h[i][2] = h[i][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t af[4];
      ldsm_x4(xn_s + pan(ROWS, a_row, kk + a_col), af);
      const int r = kk + b_row;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(w1s + swz(r, r, hs * 4 + np * 2 + (b_col >> 3)), b);
        mma_bf16(h[2 * np], af, b[0], b[1]);
        mma_bf16(h[2 * np + 1], af, b[2], b[3]);
      }
    }

    // bias, GELU and roundings in registers: the A operand of fc2
    const int h0 = chunk * HC + hs * 32;
    uint32_t ga[2][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = h0 + nt * 8 + 2 * t;
      const float bias[2] = {__bfloat162float(a.b1[col]), __bfloat162float(a.b1[col + 1])};
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hv = rnd<bf16>(rnd<bf16>(h[nt][e]) + bias[e & 1]);
        gv[e] = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
      }
      ga[nt >> 1][(nt & 1) * 2] = pack_bf16(gv[0], gv[1]);
      ga[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(gv[2], gv[3]);
    }

    // 4. this half chunk's share of fc2, summed in f32
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < CT / 16; ++np) {
        if (np * 16 < C) {
          uint32_t b[4];
          ldsm_x4_t(w2s + pan(HC, hs * 32 + ks * 16 + b_row, np * 16 + b_col), b);
          mma_bf16(acc[2 * np], ga[ks], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], ga[ks], b[2], b[3]);
        }
      }
    __syncthreads();  // this stage no longer read
  }

  // 5. the two halves' sums (the stages are free now), then bias and
  // residual, in place in the raw tile
  float* xch = reinterpret_cast<float*>(st0) + rw * 32 + lane;
  if (hs == 1) {
#pragma unroll
    for (int nt = 0; nt < CT / 8; ++nt)
      if (nt * 8 < C)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[(nt * 4 + e) * 128] = acc[nt][e];
  }
  __syncthreads();
  const int r0 = rw * 16 + g;
#pragma unroll
  for (int nt = 0; nt < CT / 8; ++nt) {
    if (hs == 0 && nt * 8 < C) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += xch[(nt * 4 + e) * 128];
      const int col = nt * 8 + 2 * t;
      const float bias[2] = {__bfloat162float(a.b2[col]), __bfloat162float(a.b2[col + 1])};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint32_t off = pan(ROWS, r0 + 8 * hr, nt * 8) + 4 * t;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(xr + off);
        const __nv_bfloat162 xv = *p;
        const float o0 = rnd<bf16>(rnd<bf16>(acc[nt][2 * hr]) + bias[0]);
        const float o1 = rnd<bf16>(rnd<bf16>(acc[nt][2 * hr + 1]) + bias[1]);
        *p = __floats2bfloat162_rn(__low2float(xv) + o0, __high2float(xv) + o1);
      }
    }
  }
  __syncthreads();

  // 6. store the valid rows, 16 bytes a thread
  bf16* y = a.y + ((size_t)bi * a.T + t0) * C;
  for (int i = tid; i < M * cpr; i += THREADS) {
    const int r = i / cpr, ch = i % cpr;
    *reinterpret_cast<uint4*>(y + (size_t)r * C + ch * 8) =
        *reinterpret_cast<const uint4*>(xr + pan(ROWS, r, ch * 8));
  }

  // 7. this tile's share of the output statistics, rows in order
  const size_t part = ((size_t)bi * nblk + blockIdx.x % nblk) * C;
  for (int c = tid; c < C; c += THREADS) {
    float as = 0.f, aq = 0.f;
    for (int r = 0; r < M; ++r) {
      const float v = __bfloat162float(
          *reinterpret_cast<const bf16*>(xr + pan(ROWS, r, c & ~7) + (c & 7) * 2));
      as += v;
      aq = fmaf(v, v, aq);
    }
    a.part_s[part + c] = as;
    a.part_q[part + c] = aq;
  }
}

template <int CT>
cudaError_t launch(const MlpArgs& a, int B, float* s, float* q, cudaStream_t st) {
  const size_t smem = smem_bytes(a.C);
  cudaError_t e = allow_smem(swin_mlp_tc_kernel<CT>, smem);
  if (e != cudaSuccess) return e;
  const int nblk = (a.T + ROWS - 1) / ROWS;
  swin_mlp_tc_kernel<CT><<<B * nblk, THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_stats_reduce(a.part_s, a.part_q, B, nblk, a.C, s, q, st);
}

}  // namespace

extern "C" int swin_mlp_tc(const void* x, const void* w, const void* b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* y,
                           void* part_s, void* part_q, void* s, void* q, int B, int T, int C,
                           int hidden, int ws, int H, int W, int shift, void* stream) {
  if (B < 1 || T < 1 || C < 16 || C > 256 || C % 16 || hidden < HC || hidden % HC)
    return (int)cudaErrorInvalidValue;
  MlpArgs a{(const bf16*)x, (const float*)w, (const float*)b, (const bf16*)w1,
            (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (bf16*)y, (float*)part_s,
            (float*)part_q, T, C, hidden, ws, H, W, shift};
  cudaStream_t st = (cudaStream_t)stream;
  // fc2's f32 accumulator is sized for the main path's C = 192, or for 256
  if (C <= 192) return (int)launch<192>(a, B, (float*)s, (float*)q, st);
  return (int)launch<256>(a, B, (float*)s, (float*)q, st);
}
