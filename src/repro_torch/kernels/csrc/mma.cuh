// Tensor-core building blocks shared by the bfloat16 bodies of
// flash_attention.cu, ssd_scan.cu and mla_decode.cu (sm_90a):
// asynchronous 16-byte copies into shared memory (cp.async), ldmatrix
// loads of 8 x 8 bf16 tiles into mma fragments, and the warp-level
// mma.sync.m16n8k16 bf16 x bf16 -> f32 product.
//
// Fragment layout of m16n8k16 (lane = 4 * gr + tq, gr = lane / 4,
// tq = lane % 4; two bf16 to a 32-bit register, the lower column in the
// low half):
//   A (16 x 16, row-major): a[0] (row gr, cols 2tq, 2tq+1), a[1] (row
//     gr+8, same cols), a[2] (row gr, cols 2tq+8, 2tq+9), a[3] (row gr+8,
//     cols 2tq+8, 2tq+9);
//   B (16 x 8, k x n): b[0] (rows 2tq, 2tq+1, col gr), b[1] (rows 2tq+8,
//     2tq+9, col gr);
//   C/D (16 x 8, f32): c[0], c[1] (row gr, cols 2tq, 2tq+1), c[2], c[3]
//     (row gr+8, cols 2tq, 2tq+1).
// Every element of D is its own row of A times its own column of B plus
// its own element of C: a row's result does not depend on the other rows
// of the tile, which keeps prefill rows bit-identical wherever they fall.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// the same, each tile transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  return __bfloat1622float2(v);
}

// f32 pair -> bf16 pair (hi) and the bf16 pair of what hi leaves out (lo):
// hi + lo carries ~16 significant bits, so two bf16 products stand in for
// one with an f32 operand
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// ROWS x cols_pad bf16 (cols_pad a multiple of 8) from global (row stride
// g_ld elements) into shared memory (row stride s_ld), NT threads: rows >=
// rows_valid and columns >= cols_valid are written as zeros. With vec,
// whole 16-byte chunks go by cp.async (the caller commits and waits); the
// ragged chunk and the rest are plain loads and stores.
template <int ROWS, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int s_ld,
                                          const __nv_bfloat16* g,
                                          size_t g_ld, int rows_valid,
                                          int cols_valid, int cols_pad,
                                          bool vec, int tid) {
  const int CH = cols_pad / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    __nv_bfloat16* dst = s + r * s_ld + c;
    const bool row_ok = r < rows_valid;
    if (vec && c + 8 <= cols_valid) {
      cp_async16(dst, row_ok ? g + r * g_ld + c : g, row_ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = row_ok && c + e < cols_valid ? g[r * g_ld + c + e] : zero;
    }
  }
}

}  // namespace mma
