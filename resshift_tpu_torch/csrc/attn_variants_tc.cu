// Probe P2 `attn_variants_tc`, bf16 route: kernel A's attention on the
// tensor cores without its statistics, with P2's rounding and one of its
// five softmaxes, so that the probe splits A's time as A now runs.  The FMA
// route (f32 at every shape, bf16 at head widths other than 16 or 32) is
// attn_variants.cu.
//
// Replaces the TPU probe tools/profile_attn_variants.py `call_variant` (P2,
// pallas_call :106, with its kernel `attn_kernel_variant` :37).
//
//   y = x + proj(attn(x*w + b))   over (B, T, C) window-major bf16 tokens
//
// with s = q k^T rnd(hd^-1/2) + B' per head, B' the caller's bias less the
// softmax shift of 30 (the wrapper subtracts it), and the softmax:
//   0 f32      p = rnd(exp(s - max) / sum), the sum in f32;
//   1 mxsum    p = rnd(exp(s - 30)), p v scaled by 1 / (the f32 sum of p);
//   2 bf16exp  p = rnd(exp(rnd(s - max)) / rnd(sum));
//   3 noexp    p = rnd((s - max) / sum(s - max));
//   4 none     p = rnd(s).
// Rounding follows the TPU kernel, as attn_variants.cu does: q, k, v =
// rnd(acc + bqkv), the scores stay f32, y = rnd(x + (acc + bproj)).
//
// Design.  window_attn_tc.cuh's body with PolicyP2<SM>: A's CTA per window,
// its GroupNorm affine on the way in and its residual on the way out; no
// roll (shift = 0), no statistics and no second pass; ROUND2 = false.  The
// softmax runs in the body's register epilogue of the scores (quad shuffles
// for the row max and sum, the probabilities packed as the A operand of
// p v).  A window of N < 64 tokens has masked keys, which every mode must
// count as p = 0: noexp sets them to 0 after the max, none at once, the
// others take them to 0 through exp(-inf).  f32 and bf16exp divide by
// A's Markstein reciprocal (the row's largest term is 1, so the sum is in
// [1, 64]); noexp by an IEEE division (its sum is negative and unbounded);
// mxsum scales p v by the sum's rounded reciprocal.  Ten instances: hd 16 or
// 32 x the five modes, each with __launch_bounds__(256, 2) as A.
//
// Bound on the H100 at (8, 4096, 192), 6 heads: 11.3 GFLOP (qkv 7.2,
// scores 0.8, p v 0.8, proj 2.4) take 0.0114 ms at 989 TFLOP/s bf16, and
// the 25 MB of x and y 0.0075 ms at 3.35 TB/s, so the tensor cores bound
// it; at the tool's census shape (64, 4096, 192) 0.091 ms.  What holds the
// design back is A's: the ldmatrix'd fragments read from shared memory per
// mma and one CTA's chain of barrier-separated weight chunks.
//
// Takes N <= 64, C <= 256 with C % 16 == 0, and hd = C / nh of 16 or 32
// (ops/attn_variants.attn_variant_route).
#include "window_attn_tc.cuh"

namespace {

template <int HD, int SM>
__global__ void __launch_bounds__(THREADS, 2) attn_variants_tc_kernel(AttnArgs a) {
  window_attn_tc_body<HD, PolicyP2<SM>>(a);
}

template <int HD, int SM>
cudaError_t launch(const AttnArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.C);
  cudaError_t e = allow_smem(attn_variants_tc_kernel<HD, SM>, smem);
  if (e != cudaSuccess) return e;
  attn_variants_tc_kernel<HD, SM><<<a.B * (a.T / a.N), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mode(const AttnArgs& a, int softmax, cudaStream_t st) {
  switch (softmax) {
    case SM_F32: return launch<HD, SM_F32>(a, st);
    case SM_MXSUM: return launch<HD, SM_MXSUM>(a, st);
    case SM_BF16EXP: return launch<HD, SM_BF16EXP>(a, st);
    case SM_NOEXP: return launch<HD, SM_NOEXP>(a, st);
    case SM_NONE: return launch<HD, SM_NONE>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int attn_variants_tc(const void* x, const void* w, const void* b, const void* wqkv,
                                const void* bqkv, const void* wproj, const void* bproj,
                                const void* bias_mask, void* y, int softmax, int B, int T, int C,
                                int nh, int N, int nwb, void* stream) {
  if (B < 1 || N < 1 || N > 64 || T < N || T % N || C < 16 || C > 256 || C % 16 || nh < 1 ||
      C % nh || (C / nh != 16 && C / nh != 32) || (nwb != 1 && nwb != T / N))
    return (int)cudaErrorInvalidValue;
  AttnArgs a{(const bf16*)x, (const float*)w, (const float*)b, (const bf16*)wqkv,
             (const bf16*)bqkv, (const bf16*)wproj, (const bf16*)bproj,
             (const float*)bias_mask, (bf16*)y, nullptr, nullptr, B, T, C, nh, N, nwb, 0, 0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (C / nh == 32) return (int)launch_mode<32>(a, softmax, st);
  return (int)launch_mode<16>(a, softmax, st);
}
