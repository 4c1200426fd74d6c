// The multi-head attention of one window, shared by kernels A
// (swin_window_attn.cu), K9 (window_attn.cu) and P2 (attn_variants.cu).
//
// One CTA of WH_THREADS threads holds one window of N <= 64 tokens x C <= 256
// channels in shared memory.  For each head it forms q, k and v from the
// window's tokens, the N x N scores plus the window's bias, a softmax over
// each row, and p v into that head's columns of the attention output; the
// kernels around it load the tokens and apply the output projection.
//
// Rounding (T is the activation type; in f32 every rounding is the identity):
//   ROUND2 = true, the PyTorch composition (`window_attention_plain`): a
//     matmul in T rounds its f32 sum to T, then the bias add rounds again;
//     the scores round, the bias rounds to T and their sum rounds.
//   ROUND2 = false, P2's Pallas kernel: the bias is added to the f32 sum and
//     the result rounds once; the scores and the bias stay in f32.
// In both, q * scale rounds (the scale already rounded to T), the
// probabilities round to T, and p v rounds to T.
#pragma once

#include "common.cuh"

constexpr int WH_THREADS = 256;

// Shared memory of one window, in floats: xs the tokens (N x ldx), qs one
// head's q | k | v (N x ldq), ss its scores and then probabilities (N x lds),
// os the attention output before the projection (N x ldx), rs one
// normaliser per row (SM_MXSUM).
struct WinSmem {
  float *xs, *qs, *ss, *os, *rs;
  int ldx, ldq, lds;
};

__host__ __device__ __forceinline__ size_t win_smem_floats(int N, int C, int nh) {
  return (size_t)N * (2 * (C + 1) + (3 * (C / nh) + 1) + (N + 1) + 1);
}

__device__ __forceinline__ WinSmem win_smem(float* smem, int N, int C, int nh) {
  WinSmem s;
  s.ldx = C + 1;
  s.ldq = 3 * (C / nh) + 1;
  s.lds = N + 1;
  s.xs = smem;
  s.qs = s.xs + N * s.ldx;
  s.ss = s.qs + N * s.ldq;
  s.os = s.ss + N * s.lds;
  s.rs = s.os + N * s.ldx;
  return s;
}

// q k^T hd^-1/2 + bias -> softmax -> p v for every head of the window in
// s.xs, into s.os.  wqkv is (C, 3C) row-major in T, bqkv (3C,), bm this
// window's (nh, N, N) f32 bias.  Ends with a __syncthreads().  The pointers
// carry no __restrict__: with it nvcc gave kernel A 78 registers instead of
// 128 and A ran about 19% slower on the H100 (PERF.md).
template <typename T, int SM, bool ROUND2>
__device__ __forceinline__ void window_heads(const WinSmem& s, int N, int C, int nh,
                                             const T* wqkv, const T* bqkv, const float* bm) {
  const int hd = C / nh;
  const int ldx = s.ldx, ldq = s.ldq, lds = s.lds;
  float *xs = s.xs, *qs = s.qs, *ss = s.ss, *os = s.os, *rs = s.rs;
  const float scale = rnd<T>((float)(1.0 / sqrt((double)hd)));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = 0; h < nh; ++h) {
    // q, k, v of head h
    block_mm(N, 3 * hd, C,
        [&](int r, int k) { return xs[r * ldx + k]; },
        [&](int k, int c) {
          return to_f(wqkv[(size_t)k * 3 * C + (c / hd) * C + h * hd + c % hd]);
        },
        [&](int r, int c, float acc) {
          const int part = c / hd;
          const float b = to_f(bqkv[part * C + h * hd + c % hd]);
          float v = ROUND2 ? rnd<T>(rnd<T>(acc) + b) : rnd<T>(acc + b);
          if (part == 0) v = rnd<T>(v * scale);
          qs[r * ldq + c] = v;
        });
    __syncthreads();

    // scores plus the bias (rel-pos bias, and shift mask) of this window
    const float* bmh = bm + (size_t)h * N * N;
    block_mm(N, N, hd,
        [&](int r, int k) { return qs[r * ldq + k]; },
        [&](int k, int c) { return qs[c * ldq + hd + k]; },
        [&](int r, int c, float acc) {
          ss[r * lds + c] = ROUND2 ? rnd<T>(rnd<T>(acc) + rnd<T>(bmh[r * N + c]))
                                   : acc + bmh[r * N + c];
        });
    __syncthreads();

    // softmax over each row, one warp per row
    for (int r = warp; r < N; r += WH_THREADS / 32) {
      float* row = ss + r * lds;
      if (SM == SM_NONE) {
        for (int c = lane; c < N; c += 32) row[c] = rnd<T>(row[c]);
        continue;
      }
      float m = 0.f;
      if (SM != SM_MXSUM) {
        m = -INFINITY;
        for (int c = lane; c < N; c += 32) m = fmaxf(m, row[c]);
        for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      float sum = 0.f;
      for (int c = lane; c < N; c += 32) {
        float e;
        if (SM == SM_F32) e = expf(row[c] - m);
        else if (SM == SM_MXSUM) e = rnd<T>(expf(row[c] - 30.f));
        else if (SM == SM_BF16EXP) e = rnd<T>(expf(rnd<T>(row[c] - m)));
        else e = row[c] - m;  // SM_NOEXP
        row[c] = e;
        sum += e;
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (SM == SM_MXSUM) {
        if (lane == 0) rs[r] = sum;  // p stays unnormalised; p v is divided below
      } else {
        if (SM == SM_BF16EXP) sum = rnd<T>(sum);
        for (int c = lane; c < N; c += 32) row[c] = rnd<T>(row[c] / sum);
      }
    }
    __syncthreads();

    // probabilities times v into this head's columns
    block_mm(N, hd, N,
        [&](int r, int k) { return ss[r * lds + k]; },
        [&](int k, int c) { return qs[k * ldq + 2 * hd + c]; },
        [&](int r, int c, float acc) {
          os[r * ldx + h * hd + c] = SM == SM_MXSUM ? rnd<T>(acc * (1.f / rs[r])) : rnd<T>(acc);
        });
    __syncthreads();
  }
}
