// bf16 tensor-core products by warp-level mma.sync (sm_80 and later) and
// the ldmatrix loads that feed them, shared by the flash_attention and
// ssd_scan kernels.  Fragment layouts are PTX's for m16n8k16: lane l holds
// rows l/4 and l/4 + 8 and columns 2(l%4), 2(l%4) + 1 (+ 8) of each tile.
#pragma once

#include <cuda_bf16.h>

#include "cp_async.cuh"

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l%8 of matrix l/8, and receives element (l/4, 2(l%4)..+1) of each.
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a · b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment) and a 16x8 f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// Fragments of a bf16 matrix M in shared memory, rows of stride ld, for
// mma_bf16 (the backward kernels' products).  The A fragment of rows
// [r0, r0 + 16) and columns [c0, c0 + 16) of M:
__device__ __forceinline__ void frag_a(const __nv_bfloat16* m, int ld, int r0, int c0,
                                       unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(m + (r0 + lane % 8 + (lane / 8 % 2) * 8) * ld + c0 + lane / 16 * 8, f);
}
// ... the same of Mᵀ: rows [r0, r0 + 16) of Mᵀ are columns of M
__device__ __forceinline__ void frag_a_t(const __nv_bfloat16* m, int ld, int r0, int c0,
                                         unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(m + (c0 + lane / 16 * 8 + lane % 8) * ld + r0 + (lane / 8 % 2) * 8, f);
}
// B fragments of two 8-wide n-tiles [n0, n0 + 16) and the k slice
// [k0, k0 + 16) of B = Mᵀ (B's columns are rows of M): f[0], f[1] for n
// tile n0, f[2], f[3] for n0 + 8
__device__ __forceinline__ void frag_b2(const __nv_bfloat16* m, int ld, int n0, int k0,
                                        unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(m + (n0 + lane % 8 + lane / 16 * 8) * ld + k0 + (lane / 8 % 2) * 8, f);
}
// ... the same of B = M (B's rows are rows of M)
__device__ __forceinline__ void frag_b2_t(const __nv_bfloat16* m, int ld, int k0, int n0,
                                          unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(m + (k0 + lane % 8 + (lane / 8 % 2) * 8) * ld + n0 + lane / 16 * 8, f);
}
