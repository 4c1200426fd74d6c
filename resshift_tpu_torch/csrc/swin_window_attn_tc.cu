// Kernel A, bf16 route: fused GroupNorm affine + window attention + residual
// + output statistics over (B, T, C) window-major bf16 tokens on the tensor
// cores, optionally read through the shifted-window roll.  The f32 route is
// swin_window_attn.cu.
//
// Replaces the TPU kernels resshift_tpu/ops/swin_block_pallas.py
// `_norm_attn_residual_fwd_pallas` (K1, pallas_call :389, via
// norm_attn_residual_stats) and `_shift_attn_fwd_pallas` (K3, pallas_call
// :496, via shift_attn_residual_stats).
//
//   y = x + proj(softmax_h(q k^T hd^-1/2 + B) v),  q,k,v = (x*w + b) Wqkv + bqkv
//
// Bound.  At the main path's shapes (x (8, 4096, 192), 64-token windows, 6
// heads of 32) a window costs 22 MFLOP against 48 KB of x and y, so the
// tensor cores bound it: 0.0114 ms at the H100 SXM's 989 TFLOP/s bf16 (its
// peak at the 700 W limit; the bytes alone take 0.0076 ms at 3.35 TB/s).
// What stands between this design and the bound, and what it does about
// each:
//   * Shared-memory reads.  With mma.sync every warp ldmatrix'es its own A
//     and B fragments: at 16 rows x 32 columns a warp, about 384 bytes an
//     m16n8k16, which the SM's 128 bytes a cycle serve more slowly than the
//     tensor cores run.  Each fragment is read once a chunk; 32 x 64 a
//     warp would halve the reads but needs 64 accumulator registers of the
//     128 that two CTAs an SM leave, so the rest is left to wgmma.
//   * One CTA's latency.  A window is a chain of 12 barrier-separated
//     weight chunks and three softmaxes.  One window and 8 warps a CTA, at
//     112 KB of shared memory and <= 128 registers (C <= 192), let two CTAs
//     share an SM, so one CTA's products overlap the other's softmax and
//     barriers (16 warps on two windows in one CTA were slower at every
//     Swin level).
//   * Masked keys.  exp() of a shift-masked score is subnormal, and the
//     compiler's division takes its slow path for such quotients; the
//     softmax divides by a rounded reciprocal instead (Markstein), in the
//     normal range, with the same bits as a division.
//   * Scalar work off the critical path: the per-row source token of the
//     roll is computed once (both gathers of x read it), the GroupNorm fold
//     is read from shared memory as broadcasts, and the biases of a chunk
//     are read before its product.
//
// The body (design, shared-memory layout, rounding) is window_attn_tc.cuh's
// with PolicyA; kernel K9's bf16 route (window_attn_tc.cu) instantiates it
// with PolicyK9, probe P2's (attn_variants_tc.cu) with PolicyP2.
//
// Takes N <= 64, C <= 256 with C % 16 == 0, and hd = C / nh of 16 or 32
// (ops/swin_block.attn_route).
#include "window_attn_tc.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(THREADS, 2) swin_window_attn_tc_kernel(AttnArgs a) {
  window_attn_tc_body<HD, PolicyA>(a);
}

template <int HD>
cudaError_t launch(const AttnArgs& a, float* s, float* q, cudaStream_t st) {
  const size_t smem = smem_bytes(a.C);
  cudaError_t e = allow_smem(swin_window_attn_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  swin_window_attn_tc_kernel<HD><<<a.B * (a.T / a.N), THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_stats_reduce(a.part_s, a.part_q, a.B, a.T / a.N, a.C, s, q, st);
}

}  // namespace

extern "C" int swin_window_attn_tc(const void* x, const void* w, const void* b, const void* wqkv,
                                   const void* bqkv, const void* wproj, const void* bproj,
                                   const void* bias_mask, void* y, void* part_s, void* part_q,
                                   void* s, void* q, int B, int T, int C, int nh, int N, int nwb,
                                   int ws, int H, int W, int shift, void* stream) {
  if (B < 1 || N < 1 || N > 64 || T < N || T % N || C < 16 || C > 256 || C % 16 || nh < 1 ||
      C % nh || (C / nh != 16 && C / nh != 32) || (nwb != 1 && nwb != T / N))
    return (int)cudaErrorInvalidValue;
  AttnArgs a{(const bf16*)x, (const float*)w, (const float*)b, (const bf16*)wqkv,
             (const bf16*)bqkv, (const bf16*)wproj, (const bf16*)bproj,
             (const float*)bias_mask, (bf16*)y, (float*)part_s, (float*)part_q,
             B, T, C, nh, N, nwb, ws, H, W, shift};
  cudaStream_t st = (cudaStream_t)stream;
  if (C / nh == 32) return (int)launch<32>(a, (float*)s, (float*)q, st);
  return (int)launch<16>(a, (float*)s, (float*)q, st);
}
