// Kernel B, f32 route: fused GroupNorm affine + channel MLP (fc1, exact-erf
// GELU, fc2) + residual + output statistics over (B, T, C) window-major f32
// tokens, optionally reading the shifted layout and writing the unshifted
// one.  The bf16 route (the main path's) is swin_mlp_tc.cu.
//
// Replaces the TPU kernels resshift_tpu/ops/swin_block_pallas.py
// `_norm_mlp_residual_fwd_pallas` (K2, via norm_mlp_residual_stats) and
// `_mlp_unshift_fwd_pallas` (K4, via mlp_unshift_residual_stats).
//
//   y = x + fc2(GELU(fc1(x*w + b)))
//
// Design.  One CTA per 64-token row tile.  The normalized tile, one chunk of
// the hidden activation (up to 256 of the 768 hidden channels) and the f32
// fc2 accumulator stay in shared memory, so the 4x-wide hidden activation
// never reaches device memory.  The MLP is pointwise over tokens, so the
// unshift commutes past it: output row j (unshifted layout) reads input row
// inv(j), the shifted-layout token at ((row - shift) mod H, (col - shift)
// mod W).  Statistics as in kernel A: per-CTA partials, then a fixed-order
// reduce.
//
// GELU uses CUDA's erff, like PyTorch's exact GELU; the TPU kernel used an
// Abramowitz-Stegun erf (|error| <= 1.5e-7), a deliberate divergence below
// f32 noise (ROADMAP queue 3).  Rounding to T where the plain version rounds:
// fc1 and fc2 before and after the bias add, the GELU output, the residual.
//
// Bound on the H100 at the main path's shapes (x (8, 4096, 192) bf16): 0.59
// MFLOP per token against 768 bytes of x and y, so the tensor-core rate would
// bound it; these FMA loops are bound by issuing shared-memory loads and
// FMAs (see PERF.md for the measured time).  f32 has no full-rate
// tensor-core path (TF32 would not hold the f32 bands), so this route stays
// on the FMA units.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;

struct MlpArgs {
  const void* x;
  const float* w;
  const float* b;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  void* y;
  float* part_s;
  float* part_q;
  int T, C, hidden, hc, ws, H, W, shift;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) swin_mlp_kernel(MlpArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, HC = a.hc, hidden = a.hidden;
  const int ldx = C + 1, ldh = HC + 1;
  float* xs = smem;            // ROWS x ldx: normalized tokens
  float* hs = xs + ROWS * ldx; // ROWS x ldh: GELU(fc1) of one hidden chunk
  float* acc_s = hs + ROWS * ldh;  // ROWS x ldx: fc2 accumulator, then the output

  const int nblk = (a.T + ROWS - 1) / ROWS;
  const int bi = blockIdx.x / nblk, t0 = (blockIdx.x % nblk) * ROWS;
  const int M = min(ROWS, a.T - t0);
  const T* x = (const T*)a.x + (size_t)bi * a.T * C;
  T* y = (T*)a.y + (size_t)bi * a.T * C;
  const T* w1 = (const T*)a.w1;
  const T* b1 = (const T*)a.b1;
  const T* w2 = (const T*)a.w2;
  const T* b2 = (const T*)a.b2;
  const float* gw = a.w + (size_t)bi * C;
  const float* gb = a.b + (size_t)bi * C;

  // 1. GroupNorm affine; with an unshift, output row j reads input row inv(j)
  for (int i = threadIdx.x; i < M * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int src = rolled_token(t0 + r, a.H, a.W, a.ws, -a.shift);
    xs[r * ldx + c] = rnd<T>(__fadd_rn(__fmul_rn(to_f(x[(size_t)src * C + c]), gw[c]), gb[c]));
  }
  __syncthreads();

  for (int h0 = 0; h0 < hidden; h0 += HC) {
    // 2. fc1 + bias + GELU for hidden channels [h0, h0 + HC)
    block_mm(M, HC, C,
        [&](int r, int k) { return xs[r * ldx + k]; },
        [&](int k, int c) { return to_f(w1[(size_t)k * hidden + h0 + c]); },
        [&](int r, int c, float acc) {
          const float h = rnd<T>(rnd<T>(acc) + to_f(b1[h0 + c]));
          hs[r * ldh + c] = rnd<T>(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
        });
    __syncthreads();
    // 3. this chunk's share of fc2, accumulated in f32
    block_mm(M, C, HC,
        [&](int r, int k) { return hs[r * ldh + k]; },
        [&](int k, int c) { return to_f(w2[(size_t)(h0 + k) * C + c]); },
        [&](int r, int c, float acc) {
          acc_s[r * ldx + c] = (h0 == 0 ? 0.f : acc_s[r * ldx + c]) + acc;
        });
    __syncthreads();
  }

  // 4. bias, residual, store
  for (int i = threadIdx.x; i < M * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int j = t0 + r;
    const int src = rolled_token(j, a.H, a.W, a.ws, -a.shift);
    const float o = rnd<T>(rnd<T>(acc_s[r * ldx + c]) + to_f(b2[c]));
    const float v = rnd<T>(to_f(x[(size_t)src * C + c]) + o);
    y[(size_t)j * C + c] = from_f<T>(v);
    acc_s[r * ldx + c] = v;
  }
  __syncthreads();

  // 5. this tile's share of the output statistics
  const size_t part = ((size_t)bi * nblk + blockIdx.x % nblk) * C;
  tile_stats(acc_s, M, C, ldx, a.part_s + part, a.part_q + part);
}

template <typename T>
cudaError_t launch(const MlpArgs& a, int B, float* s, float* q, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)ROWS * (2 * (a.C + 1) + (a.hc + 1));
  cudaError_t e = allow_smem(swin_mlp_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int nblk = (a.T + ROWS - 1) / ROWS;
  swin_mlp_kernel<T><<<B * nblk, THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_stats_reduce(a.part_s, a.part_q, B, nblk, a.C, s, q, st);
}

}  // namespace

extern "C" int swin_mlp(const void* x, const void* w, const void* b, const void* w1,
                        const void* b1, const void* w2, const void* b2, void* y, void* part_s,
                        void* part_q, void* s, void* q, int dtype, int B, int T, int C,
                        int hidden, int ws, int H, int W, int shift, void* stream) {
  int hc = 64;  // largest hidden chunk of at most 256 that divides `hidden`
  for (int cand = 256; cand > 64; cand -= 64)
    if (hidden % cand == 0) { hc = cand; break; }
  MlpArgs a{x, (const float*)w, (const float*)b, w1, b1, w2, b2, y, (float*)part_s,
            (float*)part_q, T, C, hidden, hc, ws, H, W, shift};
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden % 64) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) return (int)launch<float>(a, B, (float*)s, (float*)q, st);
  return (int)cudaErrorInvalidValue;
}
