// Kernel E: the shifted-window token permutation of a Swin block that does not
// absorb the shift into kernels A and B (rows of more than 1024 tokens, i.e.
// latents wider than 128 at 8x8 windows), and its inverse.
//
// Replaces the TPU kernel resshift_tpu/ops/shift_pallas.py `_call` (K7, via
// shift_tokens_pallas).
//
//   fwd: y[b, j] = x[b, perm(j)]      inv: y[b, j] = x[b, inv(j)]
//
// perm(j) is the window-major index of spatial ((r + shift) mod H,
// (c + shift) mod W), inv(j) that of ((r - shift) mod H, (c - shift) mod W),
// where (r, c) is the position of window-major token j: `rolled_token` in
// common.cuh, the arithmetic kernel A reads through when it absorbs the shift.
//
// Design.  Pure data movement, so the kernel is bound by device memory.  One
// warp per destination token: the warp computes the source token once and its
// lanes copy the token's C channels, as 16-byte vectors when a row is a whole
// number of 16-byte units and both pointers are 16-byte aligned (24 uint4 at
// C = 192 bf16, 48 at f32), else one element per lane step.  Each token's row
// is contiguous in both layouts, so every copy is coalesced.  The bits are
// copied, never converted: the output equals the gather exactly.  The TPU
// kernel streamed window-rows plus one neighbour row through VMEM under a
// scoped-VMEM budget and fell back to an XLA gather from 448 wide up; there is
// no such budget here, and this kernel runs at every width.
//
// Bound on the H100: bytes, 2 * B * T * C * itemsize over 3.35 TB/s (0.0113 ms
// at (1, 49152, 192) bf16).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename U>
__global__ void __launch_bounds__(THREADS)
    shift_tokens_kernel(const U* __restrict__ x, U* __restrict__ y, long long tokens, int T,
                        int units, int H, int W, int ws, int delta) {
  const long long tok = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tok >= tokens) return;
  const int lane = threadIdx.x & 31;
  const long long b = tok / T;
  const int src = rolled_token((int)(tok - b * T), H, W, ws, delta);
  const U* xs = x + (size_t)(b * T + src) * units;
  U* yd = y + (size_t)tok * units;
  for (int u = lane; u < units; u += 32) yd[u] = xs[u];
}

template <typename U>
cudaError_t launch(const void* x, void* y, long long tokens, int T, int units, int H, int W,
                   int ws, int delta, cudaStream_t st) {
  const long long blocks = (tokens + WARPS - 1) / WARPS;
  shift_tokens_kernel<U><<<(unsigned)blocks, THREADS, 0, st>>>((const U*)x, (U*)y, tokens, T,
                                                                units, H, W, ws, delta);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shift_tokens(const void* x, void* y, int itemsize, int B, int T, int C, int H,
                            int W, int ws, int shift, int inverse, void* stream) {
  if ((long long)H * W != T || ws <= 0 || H % ws || W % ws || shift <= 0 || shift >= ws ||
      (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tokens = (long long)B * T;
  const int delta = inverse ? -shift : shift;
  const size_t row = (size_t)C * itemsize;
  if (row % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0)
    return (int)launch<uint4>(x, y, tokens, T, (int)(row / 16), H, W, ws, delta, st);
  if (itemsize == 2)
    return (int)launch<unsigned short>(x, y, tokens, T, C, H, W, ws, delta, st);
  return (int)launch<unsigned int>(x, y, tokens, T, C, H, W, ws, delta, st);
}
