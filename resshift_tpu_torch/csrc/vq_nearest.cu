// Kernel D: nearest-codebook search.  For each latent row z it finds the
// index of argmin_k |e_k|^2 - 2 z.e_k (|z|^2 is the same for every k and
// drops out); ties go to the first minimum, as in torch.argmin.
//
// Replaces the TPU kernel resshift_tpu/ops/vq_pallas.py `_nearest_pallas`
// (pallas_call :70, via nearest_codebook_indices).
//
// Bound on the H100 at the f4 tile batch (32768 rows x 8192 codes x 3):
// 32768 * 8192 * 8 = 2.1 GFLOP of f32 work against 0.5 MB of traffic, so the
// f32 rate bounds it (0.03 ms at 67 TFLOP/s).  K = 3 is no shape for tensor
// cores, and TF32 would round z and e.  What sets the pace is issuing: D
// FMAs, a compare and two selects per (row, code) pair, at a few
// instructions a pair more than the bound counts.
//
// Design.  The grid covers (row block x codebook slice), so that the card
// fills at every shape: a CTA of THREADS threads takes BLOCK_ROWS rows (ROWS
// a thread, in registers) and one slice of the codebook, which it stages
// into shared memory packed as {-2 e_0, .., -2 e_{D-1}, |e|^2} (padded to a
// multiple of 4 floats, and to a multiple of SLICE_ALIGN codes with codes
// that score +inf).  A score is then D FMAs from |e|^2; each code is read
// once, as a broadcast vector load, for all ROWS rows of the thread; D is a
// template parameter, so the loops unroll.  Packing in each CTA costs
// 1 / BLOCK_ROWS of the search and no extra launch.  A slice holds at most
// SLICE_FLOATS packed floats (16 KB), so several CTAs share an SM.  The slice
// count (plan()) is the fewest that fit that, raised towards CTAS_PER_SM
// CTAs for each SM of the card, and capped where a slice would fall below
// MIN_SLICE codes.
//
// Combining the slices: each thread keeps its rows' first minimum in its
// slice (a strict <, codes in order), and folds it into a 64-bit key per
// row with atomicMin: the order-preserving bits of the score (-0 made +0) in
// the high word, the index in the low word.  The smallest key is the
// smallest score with ties to the smallest index, whatever order the CTAs
// arrive in, so the result is the same in every run.  The keys live in the
// (M,) int64 output, filled with all ones first (cudaMemsetAsync); a second
// kernel (vq_finalize) keeps the low words in place.  Only the keys and the
// indices reach device memory, never the (rows, codes) distance matrix.
// tests/test_torch_vq_split.py mirrors the plan and the combine in numpy,
// reading the constants below.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;      // 4 warps a CTA
constexpr int ROWS = 4;           // rows a thread
constexpr int BLOCK_ROWS = THREADS * ROWS;
constexpr int SLICE_FLOATS = 4096;  // a slice's packed codes: 16 KB of shared memory
constexpr int SLICE_ALIGN = 8;    // slice lengths are multiples of this (the unroll)
constexpr int MIN_SLICE = 32;     // the shortest slice the plan cuts for more CTAs
constexpr int CTAS_PER_SM = 8;    // the grid aims at this many CTAs for each SM

// floats a packed code takes: D of -2e, |e|^2, padded to a float4
__host__ __device__ constexpr int packed(int D) { return (D + 4) & ~3; }

struct Plan {
  int slices, len;  // slices of len codes (the last may hold fewer)
};

Plan plan(int M, int K, int D, int sms) {
  const int max_len = SLICE_FLOATS / packed(D) / SLICE_ALIGN * SLICE_ALIGN;
  const int blocks = (M + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const int lo = (K + max_len - 1) / max_len;
  const int hi = std::max(lo, (K + MIN_SLICE - 1) / MIN_SLICE);
  const int s = std::min(hi, std::max(lo, CTAS_PER_SM * sms / blocks));
  const int len = ((K + s - 1) / s + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN;
  return {(K + len - 1) / len, len};
}

// the key of score s at code k: smaller keys are smaller scores, then
// smaller indices
__device__ __forceinline__ unsigned long long vq_key(float s, int k) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0 -> +0: they compare equal
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)k;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    vq_nearest_kernel(const float* __restrict__ z, const float* __restrict__ emb, int M, int K,
                      int len, unsigned long long* __restrict__ keys) {
  constexpr int PD = packed(D) / 4;  // float4s a code
  extern __shared__ float4 codes[];  // len x PD
  const int k0 = blockIdx.y * len, n = min(len, K - k0);
  const int n_al = (n + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN;

  // this slice, packed; the codes past K score +inf
  for (int i = threadIdx.x; i < n_al; i += THREADS) {
    float p[PD * 4];
#pragma unroll
    for (int d = 0; d < PD * 4; ++d) p[d] = 0.f;
    if (i < n) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float e = emb[(size_t)(k0 + i) * D + d];
        s = __fadd_rn(s, __fmul_rn(e, e));
        p[d] = -2.f * e;
      }
      p[D] = s;
    } else {
      p[D] = INFINITY;
    }
#pragma unroll
    for (int j = 0; j < PD; ++j)
      codes[i * PD + j] = make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  }

  // this thread's rows (past M: the last row again, not stored)
  const int row0 = blockIdx.x * BLOCK_ROWS + threadIdx.x;
  float zr[ROWS][D];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const size_t row = min(row0 + r * THREADS, M - 1);
#pragma unroll
    for (int d = 0; d < D; ++d) zr[r][d] = z[row * D + d];
  }
  __syncthreads();

  float best[ROWS];
  int arg[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    best[r] = INFINITY;
    arg[r] = 0;
  }
  for (int kb = 0; kb < n_al; kb += SLICE_ALIGN) {
#pragma unroll
    for (int j = 0; j < SLICE_ALIGN; ++j) {
      float p[PD * 4];
#pragma unroll
      for (int q = 0; q < PD; ++q) {
        const float4 v = codes[(kb + j) * PD + q];
        p[4 * q] = v.x;
        p[4 * q + 1] = v.y;
        p[4 * q + 2] = v.z;
        p[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float s = p[D];
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(zr[r][d], p[d], s);
        if (s < best[r]) {
          best[r] = s;
          arg[r] = kb + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r * THREADS;
    if (row < M) atomicMin(keys + row, vq_key(best[r], k0 + arg[r]));
  }
}

__global__ void vq_finalize_kernel(unsigned long long* keys, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) keys[i] &= 0xffffffffull;  // the index, as an int64
}

template <int D>
cudaError_t launch(const float* z, const float* emb, int M, int K, unsigned long long* keys,
                   cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const Plan p = plan(M, K, D, sms);
  const dim3 grid((M + BLOCK_ROWS - 1) / BLOCK_ROWS, p.slices);
  vq_nearest_kernel<D><<<grid, THREADS, sizeof(float) * p.len * packed(D), st>>>(z, emb, M, K,
                                                                                p.len, keys);
  return cudaGetLastError();
}

}  // namespace

// keys: the (M,) int64 output, used as 64-bit keys until vq_finalize
extern "C" int vq_nearest(const void* z, const void* emb, void* keys, int M, int K, int D,
                          void* stream) {
  if (M < 1 || K < 1 || D < 1 || D > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * M, st);
  if (e != cudaSuccess) return (int)e;
  const float *zf = (const float*)z, *ef = (const float*)emb;
  unsigned long long* kf = (unsigned long long*)keys;
  switch (D) {
    case 1: return (int)launch<1>(zf, ef, M, K, kf, st);
    case 2: return (int)launch<2>(zf, ef, M, K, kf, st);
    case 3: return (int)launch<3>(zf, ef, M, K, kf, st);
    case 4: return (int)launch<4>(zf, ef, M, K, kf, st);
    case 5: return (int)launch<5>(zf, ef, M, K, kf, st);
    case 6: return (int)launch<6>(zf, ef, M, K, kf, st);
    case 7: return (int)launch<7>(zf, ef, M, K, kf, st);
    default: return (int)launch<8>(zf, ef, M, K, kf, st);
  }
}

extern "C" int vq_finalize(void* keys, int M, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  vq_finalize_kernel<<<(M + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)keys, M);
  return cudaGetLastError();
}
