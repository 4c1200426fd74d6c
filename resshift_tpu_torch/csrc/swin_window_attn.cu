// Kernel A: fused GroupNorm affine + window attention + residual + output
// statistics over (B, T, C) window-major tokens, optionally read through the
// shifted-window roll.
//
// Replaces the TPU kernels resshift_tpu/ops/swin_block_pallas.py
// `_norm_attn_residual_fwd_pallas` (K1, via norm_attn_residual_stats) and
// `_shift_attn_fwd_pallas` (K3, via shift_attn_residual_stats).
//
//   y = x + proj(softmax_h(q k^T hd^-1/2 + B) v),  q,k,v = (x*w + b) Wqkv + bqkv
//
// Design.  One CTA per window (N <= 64 tokens x C <= 256 channels).  The
// normalized tokens, one head's q/k/v, its N x N scores and the attention
// output stay in shared memory (about 140 KB at N = 64, C = 192, hence the
// dynamic shared memory opt-in); device memory sees x read once (twice for
// the residual), the weights (from L2), the bias and y written once.  The
// shift is index arithmetic at load time: shifted-layout token j reads the
// unshifted token at ((row + shift) mod H, (col + shift) mod W), and the
// output stays in the shifted layout.  The TPU kernel's epilogue summed the
// statistics with += over a sequential grid; here each CTA writes its own
// (sum, sumsq) partial and a second small pass adds them per image in a
// fixed order, so the low bits do not change from run to run.  The TPU
// kernel's grouping of windows into 128-token MXU tiles is not carried over.
// The heads (steps 2-5) are window_heads.cuh, shared with K9 and P2.
//
// Softmax: a true softmax (row max subtracted, divided by the row sum), as in
// the plain version; the TPU kernel's exp(clip(s + B - 30)) form with a ones
// column is a deliberate divergence (ROADMAP queue 3).  Rounding to T falls
// where the plain version rounds: qkv and proj before and after the bias add,
// q * scale, the scores, the bias, the probabilities and the head outputs.
//
// Bound on the H100 at the main path's shapes (x (8, 4096, 192) bf16): about
// 22 MFLOP per window against 24 KB of x and y, so the tensor-core bound is
// far below what these FMA loops reach; the kernel is bound by issuing
// shared-memory loads and FMAs (see PERF.md for the measured time).
#include "window_heads.cuh"

namespace {

constexpr int THREADS = WH_THREADS;

struct AttnArgs {
  const void* x;
  const float* w;
  const float* b;
  const void* wqkv;
  const void* bqkv;
  const void* wproj;
  const void* bproj;
  const float* bm;
  void* y;
  float* part_s;
  float* part_q;
  int T, C, nh, N, nwb, ws, H, W, shift;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) swin_window_attn_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, N = a.N, nh = a.nh;
  const WinSmem s = win_smem(smem, N, C, nh);
  float* xs = s.xs;  // normalized tokens, later the output
  const int ldx = s.ldx;

  const int nwin = a.T / N;
  const int bi = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const T* x = (const T*)a.x + (size_t)bi * a.T * C;
  T* y = (T*)a.y + (size_t)bi * a.T * C;
  const T* wproj = (const T*)a.wproj;
  const T* bproj = (const T*)a.bproj;
  const float* gw = a.w + (size_t)bi * C;
  const float* gb = a.b + (size_t)bi * C;

  // 1. GroupNorm affine, reading through the roll when shifted
  for (int i = threadIdx.x; i < N * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int src = rolled_token(win * N + r, a.H, a.W, a.ws, a.shift);
    xs[r * ldx + c] = rnd<T>(__fadd_rn(__fmul_rn(to_f(x[(size_t)src * C + c]), gw[c]), gb[c]));
  }
  __syncthreads();

  // 2-5. q, k, v, biased scores, softmax and p v of every head
  window_heads<T, SM_F32, true>(s, N, C, nh, (const T*)a.wqkv, (const T*)a.bqkv,
                                a.bm + (size_t)(a.nwb == 1 ? 0 : win) * nh * N * N);

  // 6. output projection and residual (the rolled input when shifted)
  block_mm(N, C, C,
      [&](int r, int k) { return s.os[r * ldx + k]; },
      [&](int k, int c) { return to_f(wproj[(size_t)k * C + c]); },
      [&](int r, int c, float acc) {
        const int j = win * N + r;
        const int src = rolled_token(j, a.H, a.W, a.ws, a.shift);
        const float p = rnd<T>(rnd<T>(acc) + to_f(bproj[c]));
        const float v = rnd<T>(to_f(x[(size_t)src * C + c]) + p);
        y[(size_t)j * C + c] = from_f<T>(v);
        xs[r * ldx + c] = v;
      });
  __syncthreads();

  // 7. this window's share of the output statistics
  const size_t part = ((size_t)bi * nwin + win) * C;
  tile_stats(xs, N, C, ldx, a.part_s + part, a.part_q + part);
}

template <typename T>
cudaError_t launch(const AttnArgs& a, int B, float* s, float* q, cudaStream_t st) {
  const size_t smem = sizeof(float) * win_smem_floats(a.N, a.C, a.nh);
  cudaError_t e = allow_smem(swin_window_attn_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  swin_window_attn_kernel<T><<<B * (a.T / a.N), THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_stats_reduce(a.part_s, a.part_q, B, a.T / a.N, a.C, s, q, st);
}

}  // namespace

extern "C" int swin_window_attn(const void* x, const void* w, const void* b, const void* wqkv,
                                const void* bqkv, const void* wproj, const void* bproj,
                                const void* bias_mask, void* y, void* part_s, void* part_q,
                                void* s, void* q, int dtype, int B, int T, int C, int nh, int N,
                                int nwb, int ws, int H, int W, int shift, void* stream) {
  AttnArgs a{x, (const float*)w, (const float*)b, wqkv, bqkv, wproj, bproj,
             (const float*)bias_mask, y, (float*)part_s, (float*)part_q,
             T, C, nh, N, nwb, ws, H, W, shift};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) return (int)launch<bf16>(a, B, (float*)s, (float*)q, st);
  if (dtype == DT_F32) return (int)launch<float>(a, B, (float*)s, (float*)q, st);
  return (int)cudaErrorInvalidValue;
}
