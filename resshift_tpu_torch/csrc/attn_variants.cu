// Probe P2 `attn_variants`, FMA route: kernel A without its statistics, with
// one of five softmaxes, to split the attention's cost between its matrix
// products and the softmax.  It takes f32 at every shape and bf16 at head
// widths other than 16 or 32; bf16 at C % 16 == 0 with heads 16 or 32 wide
// runs the tensor-core route, attn_variants_tc.cu.
//
// Replaces the TPU probe tools/profile_attn_variants.py `call_variant` (P2,
// with its kernel `attn_kernel_variant`).
//
//   y = x + proj(attn(x*w + b))   over (B, T, C) window-major tokens
//
// with s = q k^T hd^-1/2 + B' per head, where B' is the caller's bias less the
// softmax shift of 30 that the TPU kernel folds into it, and the softmax:
//   0 f32      softmax in f32 (row max subtracted), p rounded to T;
//   1 mxsum    p = T(exp(s - 30)), p v divided by the f32 sum of those p;
//   2 bf16exp  p = T(exp(T(s - max))), divided by T(sum p), rounded;
//   3 noexp    p = T((s - max) / sum(s - max));
//   4 none     p = T(s).
// Rounding follows the TPU kernel: qkv and proj add their bias to the f32
// sum and round once, the scores stay f32, y = T(x + proj) (window_heads.cuh
// with ROUND2 = false).  In f32 the f32 mode is kernel A's y up to the
// rounding of the folded shift.
//
// Design.  Kernel A's CTA per window, the mode a template parameter.  The TPU
// tool's super-windows (`_pick_gw`, `_prep_bias`: gw windows in one 128-token
// tile, the cross terms at -1e9) are not carried over; with them its noexp
// and none modes mixed the grouped windows, here every window stands alone.
//
// Bound on the H100 at (8, 4096, 192) f32, 6 heads: 11.3 GFLOP take 0.169
// ms at 67 TFLOP/s f32 (the 50 MB of x and y 0.015 ms at 3.35 TB/s); the
// FMA loops are issue-bound as A's f32 route is.
#include "window_heads.cuh"

namespace {

constexpr int THREADS = WH_THREADS;

struct VarArgs {
  const void* x;
  const float* w;
  const float* b;
  const void* wqkv;
  const void* bqkv;
  const void* wproj;
  const void* bproj;
  const float* bm;
  void* y;
  int T, C, nh, N, nwb;
};

template <typename T, int SM>
__global__ void __launch_bounds__(THREADS) attn_variant_kernel(VarArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, N = a.N, nh = a.nh;
  const WinSmem s = win_smem(smem, N, C, nh);
  const int ldx = s.ldx;
  const int nwin = a.T / N;
  const int bi = blockIdx.x / nwin, win = blockIdx.x % nwin;
  const size_t off = ((size_t)bi * a.T + (size_t)win * N) * C;
  const T* x = (const T*)a.x + off;
  T* y = (T*)a.y + off;
  const T* wproj = (const T*)a.wproj;
  const T* bproj = (const T*)a.bproj;
  const float* gw = a.w + (size_t)bi * C;
  const float* gb = a.b + (size_t)bi * C;

  for (int i = threadIdx.x; i < N * C; i += THREADS) {
    const int r = i / C, c = i % C;
    s.xs[r * ldx + c] = rnd<T>(__fadd_rn(__fmul_rn(to_f(x[i]), gw[c]), gb[c]));
  }
  __syncthreads();

  window_heads<T, SM, false>(s, N, C, nh, (const T*)a.wqkv, (const T*)a.bqkv,
                             a.bm + (size_t)(a.nwb == 1 ? 0 : win) * nh * N * N);

  block_mm(N, C, C,
      [&](int r, int k) { return s.os[r * ldx + k]; },
      [&](int k, int c) { return to_f(wproj[(size_t)k * C + c]); },
      [&](int r, int c, float acc) {
        const size_t i = (size_t)r * C + c;
        y[i] = from_f<T>(to_f(x[i]) + (acc + to_f(bproj[c])));
      });
}

template <typename T, int SM>
cudaError_t launch(const VarArgs& a, int B, cudaStream_t st) {
  const size_t smem = sizeof(float) * win_smem_floats(a.N, a.C, a.nh);
  cudaError_t e = allow_smem(attn_variant_kernel<T, SM>, smem);
  if (e != cudaSuccess) return e;
  attn_variant_kernel<T, SM><<<B * (a.T / a.N), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const VarArgs& a, int B, int softmax, cudaStream_t st) {
  switch (softmax) {
    case SM_F32: return launch<T, SM_F32>(a, B, st);
    case SM_MXSUM: return launch<T, SM_MXSUM>(a, B, st);
    case SM_BF16EXP: return launch<T, SM_BF16EXP>(a, B, st);
    case SM_NOEXP: return launch<T, SM_NOEXP>(a, B, st);
    case SM_NONE: return launch<T, SM_NONE>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int attn_variants(const void* x, const void* w, const void* b, const void* wqkv,
                             const void* bqkv, const void* wproj, const void* bproj,
                             const void* bias_mask, void* y, int dtype, int softmax, int B,
                             int T, int C, int nh, int N, int nwb, void* stream) {
  if (N <= 0 || T % N || C % nh || (nwb != 1 && nwb != T / N)) return (int)cudaErrorInvalidValue;
  VarArgs a{x, (const float*)w, (const float*)b, wqkv, bqkv, wproj, bproj,
            (const float*)bias_mask, y, T, C, nh, N, nwb};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_BF16) return (int)launch_mode<bf16>(a, B, softmax, st);
  if (dtype == DT_F32) return (int)launch_mode<float>(a, B, softmax, st);
  return (int)cudaErrorInvalidValue;
}
