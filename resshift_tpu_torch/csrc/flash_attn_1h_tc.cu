// Kernel C, bf16 route: single-head attention softmax(q k^T / sqrt(C)) v
// over (B, N, C) bf16 with C = 512 (the VQGAN encoder's and decoder's middle
// AttnBlock) on the tensor cores.  The f32 route is flash_attn_1h.cu.
//
// Replaces the TPU kernel resshift_tpu/ops/flash_attention_pallas.py
// `flash_attention_1h`.
//
// Design.  One CTA of 8 warps per 64-query tile; K and V stream through
// shared memory in 64-key chunks, so the N x N scores never reach device
// memory.  Warps 2p and 2p+1 share query rows 16p..16p+15: warp 2p+h owns
// output columns 256h..256h+255 (a 16 x 256 f32 accumulator, 128 registers
// a thread; a whole 16 x 512 row block would need 256) and computes the
// partial scores over depth 256h..256h+255.  The two partial 16 x 64 score
// tiles are summed through shared memory, both warps in the same order, so
// both hold the same scores and run the same softmax.  Products are
// mma.sync m16n8k16 (bf16 in, f32 sums): Q and K through ldmatrix (K is
// (N, C) row-major, already the "col" B operand of Q K^T), V through
// ldmatrix.trans, and the probabilities go from the score accumulators
// straight into the A operand of P V, as in FlashAttention-2.  Shared
// memory: Q (64 KB) stays, K and V chunks (64 KB each) are loaded with
// cp.async so that K of chunk j+1 arrives while P V runs on V of chunk j
// and V of chunk j+1 while Q K^T runs on K of chunk j+1; 32 KB of score
// exchange.  Tiles are XOR-swizzled by row against bank conflicts.
//
// Numerics, as the f32 route and the TPU kernel: q * scale rounded to bf16;
// an online softmax with a running row max (a deliberate divergence from the
// TPU kernel's fixed exp(s - 30), ROADMAP queue 3); the probabilities
// rounded to bf16 before P V while the normalizer sums the unrounded ones;
// one divide at the end.  Keys past N score -inf; query rows past N are
// clamped on load and not stored.
//
// Bound on the H100 at the main path's shapes (q, k, v (8, 4096, 512)): 4 N^2
// C = 275 GFLOP against 134 MB of q, k, v and out, so the tensor-core rate
// bounds it (0.28 ms).  With 16 query rows a warp each B fragment feeds one
// mma, so the ldmatrix traffic (about 600 KB of shared memory a chunk per
// CTA against 2048 mma) rather than the tensor cores should set this
// design's pace (see PERF.md for the measured time).
#include "mma.cuh"

namespace {

constexpr int C = 512;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int CHUNKS = C / 8;                  // 16-byte chunks a row
constexpr uint32_t TILE = BQ * C * 2;          // 64 KB: Q, a K or a V chunk
constexpr uint32_t XCH = 8 * 32 * 32 * 4;      // 32 KB: 32 score floats a thread
constexpr size_t SMEM = 3 * TILE + XCH;

// byte offset of 16-byte chunk `ch` of row `r` in a [64][512] bf16 tile
__device__ __forceinline__ uint32_t tile_off(int r, int ch) { return swz(r * 8, r, ch); }

__global__ void __launch_bounds__(THREADS, 1)
    flash_attn_1h_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem), ks = qs + TILE, vs = ks + TILE;
  float* xch = reinterpret_cast<float*>(smem + 3 * TILE);

  const int nqt = (N + BQ - 1) / BQ, nk = (N + BK - 1) / BK;
  const int bi = blockIdx.x / nqt, q0 = (blockIdx.x % nqt) * BQ;
  const size_t base = (size_t)bi * N * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp >> 1, half = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  auto load_chunk = [&](uint32_t dst, const bf16* src, int k0) {
#pragma unroll 4
    for (int i = tid; i < BK * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, ch = i % CHUNKS;
      cp_async16(dst + tile_off(r, ch), src + base + (size_t)min(k0 + r, N - 1) * C + ch * 8);
    }
  };
  load_chunk(ks, k, 0);
  cp_async_commit();
  load_chunk(vs, v, 0);
  cp_async_commit();

  // Q * scale, rounded to bf16, while the first chunks arrive
  const float scale = rnd<bf16>((float)(1.0 / sqrt((double)C)));
  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, ch = i % CHUNKS;
    const bf16* src = q + base + (size_t)min(q0 + r, N - 1) * C + ch * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(src);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    *reinterpret_cast<uint4*>(smem + tile_off(r, ch)) = raw;
  }

  // ldmatrix row addresses: A (Q rows), B of Q K^T (K rows), B of P V (V
  // rows, transposed)
  const int a_row = pair * 16 + (lane & 15), a_ch = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_ch = lane >> 4;

  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    cp_async_wait<1>();  // K of chunk j is in
    __syncthreads();

    // partial scores over this warp's half of the depth
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int ch = half * 32 + kk * 2;
      uint32_t a[4];
      ldsm_x4(qs + tile_off(a_row, ch + a_ch), a);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(ks + tile_off(np * 16 + k_row, ch + k_ch), b);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    float* mine = xch + warp * 1024;
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 32 + lane] = s[i >> 2][i & 3];
    __syncthreads();  // partials visible; K of chunk j no longer read
    if (j + 1 < nk) load_chunk(ks, k, k0 + BK);
    cp_async_commit();
    const float* other = xch + (warp ^ 1) * 1024;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i >> 2][i & 3] += other[i * 32 + lane];

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + nt * 8 + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    uint32_t pa[4][4];  // probabilities as the A operand of P V, 16 keys a step
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - m_run[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V of chunk j is in
    __syncthreads();
#pragma unroll
    for (int ks16 = 0; ks16 < 4; ++ks16)
#pragma unroll
      for (int np = 0; np < 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(vs + tile_off(ks16 * 16 + v_row, half * 32 + np * 2 + v_ch), b);
        mma_bf16(acc[2 * np], pa[ks16], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa[ks16], b[2], b[3]);
      }
    __syncthreads();  // V of chunk j no longer read
    if (j + 1 < nk) load_chunk(vs, v, k0 + BK);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const int row = q0 + pair * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 32; ++nt) {
    const int col = half * 256 + nt * 8 + 2 * t;
    if (row < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row * C + col) =
          __floats2bfloat162_rn(acc[nt][0] / l_run[0], acc[nt][1] / l_run[0]);
    if (row + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)(row + 8) * C + col) =
          __floats2bfloat162_rn(acc[nt][2] / l_run[1], acc[nt][3] / l_run[1]);
  }
}

}  // namespace

extern "C" int flash_attn_1h_tc(const void* q, const void* k, const void* v, void* o, int B,
                                int N, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flash_attn_1h_tc_kernel, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nqt = (N + BQ - 1) / BQ;
  flash_attn_1h_tc_kernel<<<B * nqt, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, N);
  return (int)cudaGetLastError();
}
