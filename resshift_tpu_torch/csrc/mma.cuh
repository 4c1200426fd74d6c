// Tensor-core and async-copy primitives of the bf16 kernels A
// (swin_window_attn_tc.cu), B (swin_mlp_tc.cu), C (flash_attn_1h_tc.cu),
// K10 (winograd_conv3x3_tc.cu) and P1 (conv3x3_tc.cu), as inline PTX for
// sm_90a.
//
//   mma_bf16     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: D += A B
//                for a 16x16 bf16 A (4 registers), a 16x8 bf16 B (2
//                registers) and a 16x8 f32 D (4 registers).  Thread l holds
//                D rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1.
//   ldsm_x4      ldmatrix .x4: four 8x8 bf16 matrices from shared memory,
//                lanes 8i..8i+7 giving the row addresses of matrix i.
//   ldsm_x4_t    the same with .trans, for a B operand stored row-major in K.
//   cp_async16   cp.async.cg of 16 bytes, global to shared, bypassing L1.
//
// Shared tiles are rows of 128-byte lines whose 16-byte chunks are XOR-
// swizzled by the row (chunk ^ (row % 8)), so that the eight row addresses
// of one ldmatrix matrix fall in eight different chunks of the 32 banks.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// lines, XOR-swizzled; `line` is the row's first line.
__device__ __forceinline__ uint32_t swz(uint32_t line, int row, int chunk) {
  return line * 128 + ((chunk ^ (row & 7)) << 4);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of RB-byte rows
// (RB = 32 or 64: 128 / RB rows share a 128-byte line; or a multiple of
// 128), the chunk XOR-swizzled by (row / (128 / RB)) % (RB / 16), or by
// row % 8 where RB >= 128, so that any eight consecutive rows at one chunk,
// aligned or not, fall in eight different chunks of the 32 banks.  At RB =
// 128 this is swz(row, row, chunk).
template <int RB>
__device__ __forceinline__ uint32_t swz_row(int row, int chunk) {
  constexpr int CPR = RB / 16 < 8 ? RB / 16 : 8, RPL = 8 / CPR;
  return (uint32_t)row * RB + ((chunk ^ ((row / RPL) & (CPR - 1))) << 4);
}
