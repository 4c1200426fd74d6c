// Kernel K9 `window_attn`: standalone window attention over (M, N, C) windows.
//
// Replaces the TPU kernel resshift_tpu/ops/swin_attention_pallas.py
// `_forward_pallas` (K9, via fused_window_attention).
//
//   y = proj(softmax_h(q k^T hd^-1/2 + B) v),  q, k, v = x Wqkv + bqkv
//
// B is (nW or 1, nh, N, N) f32; window m takes bias row m % nW.
//
// Design.  Kernel A without its GroupNorm affine, residual and statistics:
// one CTA per window holds the tokens, one head's q/k/v, the scores and the
// attention output in shared memory (window_heads.cuh, rounding as the plain
// version `window_attention_plain` rounds), then the output projection is
// stored straight to y.  The TPU kernel's tricks for its 128-wide matrix unit
// are not carried over: no super-windows of gw windows with a -1e9 cross
// mask, no per-head channel masks over the full width.
//
// Bound on the H100 at (4096, 64, 192) bf16, 6 heads: about 90 GFLOP (qkv
// 58.0, scores 6.4, p v 6.4, proj 19.3) against 3.1 MB of x and y, so 0.091
// ms at the bf16 tensor-core rate; these f32 FMA loops are bound by issuing
// shared-memory loads and FMAs, as A is (PERF.md has the measured time).
#include "window_heads.cuh"

namespace {

constexpr int THREADS = WH_THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    window_attn_kernel(const T* x, const T* wqkv, const T* bqkv, const T* wproj,
                       const T* bproj, const float* bm, T* y, int N, int C, int nh, int nw) {
  extern __shared__ float smem[];
  const WinSmem s = win_smem(smem, N, C, nh);
  const int ldx = s.ldx;
  const size_t m = blockIdx.x;
  const T* xm = x + m * N * C;
  T* ym = y + m * N * C;

  for (int i = threadIdx.x; i < N * C; i += THREADS) s.xs[(i / C) * ldx + i % C] = to_f(xm[i]);
  __syncthreads();

  window_heads<T, SM_F32, true>(s, N, C, nh, wqkv, bqkv,
                                bm + (size_t)(m % nw) * nh * N * N);

  block_mm(N, C, C,
      [&](int r, int k) { return s.os[r * ldx + k]; },
      [&](int k, int c) { return to_f(wproj[(size_t)k * C + c]); },
      [&](int r, int c, float acc) {
        ym[(size_t)r * C + c] = from_f<T>(rnd<T>(rnd<T>(acc) + to_f(bproj[c])));
      });
}

template <typename T>
cudaError_t launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const float* bm, void* y, int M, int N, int C, int nh,
                   int nw, cudaStream_t st) {
  const size_t smem = sizeof(float) * win_smem_floats(N, C, nh);
  cudaError_t e = allow_smem(window_attn_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  window_attn_kernel<T><<<M, THREADS, smem, st>>>((const T*)x, (const T*)wqkv, (const T*)bqkv,
                                                  (const T*)wproj, (const T*)bproj, bm, (T*)y,
                                                  N, C, nh, nw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int window_attn(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                           const void* bproj, const void* bias_mask, void* y, int dtype, int M,
                           int N, int C, int nh, int nw, void* stream) {
  if (M <= 0 || nw <= 0 || M % nw || C % nh) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* bm = (const float*)bias_mask;
  if (dtype == DT_BF16)
    return (int)launch<bf16>(x, wqkv, bqkv, wproj, bproj, bm, y, M, N, C, nh, nw, st);
  if (dtype == DT_F32)
    return (int)launch<float>(x, wqkv, bqkv, wproj, bproj, bm, y, M, N, C, nh, nw, st);
  return (int)cudaErrorInvalidValue;
}
