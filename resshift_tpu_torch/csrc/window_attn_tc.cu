// Kernel K9 `window_attn_tc`, bf16 route: standalone window attention over
// (M, N, C) bf16 windows on the tensor cores.  The FMA route (f32 at every
// shape, bf16 at head widths other than 16 or 32) is window_attn.cu.
//
// Replaces the TPU kernel resshift_tpu/ops/swin_attention_pallas.py
// `_forward_pallas` (K9, pallas_call :197, via fused_window_attention).
//
//   y = proj(softmax_h(q k^T hd^-1/2 + B) v),  q, k, v = x Wqkv + bqkv
//
// B is (nW or 1, nh, N, N) f32; window m takes bias row m % nW.
//
// Design.  Kernel A's tensor-core body (window_attn_tc.cuh) with PolicyK9:
// no GroupNorm affine (xn = x), no roll (shift = 0), no residual (y = proj)
// and no statistics epilogue or second pass.  A's layout covers K9's
// windows: M windows of nW-window groups are B = M / nW images of T = nW N
// window-major tokens with nwb = nW bias rows, so that window m takes bias
// row m % nW as K9's windows do.  One window and 8 warps a CTA, cp.async
// weight panels in two stages, q in registers, the probabilities as the A
// operand of p v, the Markstein division for masked keys: all A's.  It
// rounds where window_attention_plain rounds (ops/window_attention.py).
//
// Bound on the H100 at (4096, 64, 192), 6 heads: 90.2 GFLOP (qkv 58.0,
// scores 6.4, p v 6.4, proj 19.3) take 0.091 ms at 989 TFLOP/s bf16, and
// the 201 MB of x and y 0.060 ms at 3.35 TB/s, so the tensor cores bound it.
// What holds this design back is A's: the ldmatrix'd fragments read from
// shared memory per mma and one CTA's chain of barrier-separated weight
// chunks (two CTAs an SM at C <= 192).
//
// Takes N <= 64, C <= 256 with C % 16 == 0, and hd = C / nh of 16 or 32
// (ops/window_attention.window_attn_route).
#include "window_attn_tc.cuh"

namespace {

template <int HD>
__global__ void __launch_bounds__(THREADS, 2) window_attn_tc_kernel(AttnArgs a) {
  window_attn_tc_body<HD, PolicyK9>(a);
}

template <int HD>
cudaError_t launch(const AttnArgs& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.C);
  cudaError_t e = allow_smem(window_attn_tc_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  window_attn_tc_kernel<HD><<<a.B * (a.T / a.N), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int window_attn_tc(const void* x, const void* wqkv, const void* bqkv,
                              const void* wproj, const void* bproj, const void* bias_mask,
                              void* y, int M, int N, int C, int nh, int nw, void* stream) {
  if (M < 1 || nw < 1 || M % nw || N < 1 || N > 64 || C < 16 || C > 256 || C % 16 || nh < 1 ||
      C % nh || (C / nh != 16 && C / nh != 32))
    return (int)cudaErrorInvalidValue;
  AttnArgs a{(const bf16*)x, nullptr, nullptr, (const bf16*)wqkv, (const bf16*)bqkv,
             (const bf16*)wproj, (const bf16*)bproj, (const float*)bias_mask, (bf16*)y,
             nullptr, nullptr, M / nw, nw * N, C, nh, N, nw, 0, 0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (C / nh == 32) return (int)launch<32>(a, st);
  return (int)launch<16>(a, st);
}
