// Tensor-core building blocks shared by the bfloat16 bodies of
// flash_attention.cu, ssd_scan.cu and mla_decode.cu (and the bf16 packing
// and shared-memory address of flash_attention_bwd_bf16.cu) and the
// float32 bodies
// of flash_attention.cu, flash_attention_bwd.cu, ssd_scan.cu and
// ssd_scan_bwd.cu (through ssd_f32.cuh) (sm_90a): asynchronous
// 16-byte copies into shared memory (cp.async), ldmatrix loads of 8 x 8
// bf16 tiles into mma fragments, the warp-level mma.sync.m16n8k16 bf16 x
// bf16 -> f32 product, and the split TF32 product m16n8k8 below.
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
//
// Fragment layout of m16n8k8 with tf32 operands (one value a 32-bit
// register; not the bf16 layout):
//   A (16 x 8, row-major): a[0] (row gr, col tq), a[1] (row gr+8, col tq),
//     a[2] (row gr, col tq+4), a[3] (row gr+8, col tq+4);
//   B (8 x 8, k x n): b[0] (row tq, col gr), b[1] (row tq+4, col gr);
//   C/D: as m16n8k16.
// The split TF32 product keeps float32 accuracy on the tensor cores: each
// operand is x = hi + lo with hi = tf32(x) (round to nearest, 11
// significant bits) and lo = tf32(x - hi), so hi + lo is x within 2^-22
// relative, and a.b is lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (the lo.lo term,
// ~2^-22 of the product, is left out): three m16n8k8 into one f32
// accumulator, about 22 significant bits, at a third of the TF32 rate
// (495 / 3 = 165 TFLOP/s against the CUDA cores' 67). One TF32 product
// alone keeps 11 bits and misses the float32 contract (2e-5) some 40-fold.
// Operands are split as they load into fragments, from float32 in shared
// memory or in registers; hi and lo are never stored.
// A C fragment (16 x 8, f32) is the A fragment of a k8 step whose k index
// is permuted: k = tq holds column 2tq and k = tq + 4 column 2tq + 1, so
// A = {c[0], c[2], c[1], c[3]} with no shuffle, and that step's B rows
// come in the same order (b[0] from row 2tq, b[1] from row 2tq + 1). A
// permutation of k only reorders a sum the hardware takes in one piece.
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

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as a register: what cvt.rna.tf32.f32 gives for every finite x, in two
// integer operations (half an ulp of TF32 added to the magnitude's bits,
// then the low 13 bits cleared); ptxas expands the cvt into about four,
// guarding infinities and NaNs, which the flash bodies never split
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores, tf32 operands, f32 accumulation (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// split operands of one m16n8k8 step
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// acc[n] += a . b[n] in split TF32 for NN n8 tiles: for every tile the
// small terms first (lo.hi, hi.lo), then hi.hi, into its one accumulator;
// each of the three rounds runs across the tiles, so NN independent
// products stand between two that depend on each other
template <int NN>
__device__ __forceinline__ void mma_tf32x3(float (&acc)[NN][4], const FragA& a,
                                           const FragB (&b)[NN]) {
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32(acc[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32(acc[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32(acc[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

// A from a row-major float32 tile: p = &tile[(row0 + gr) * ld + k0 + tq]
__device__ __forceinline__ FragA load_a_tf32(const float* p, int ld) {
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}
// A of the transpose of a tile stored k-major (tile[k][m], a P^T from P
// stored [query][key]), k permuted: p = &tile[(k0 + 2 tq) * ld + m0 + gr]
__device__ __forceinline__ FragA load_at_tf32(const float* p, int ld) {
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8], f.hi[1], f.lo[1]);
  split_tf32(p[ld], f.hi[2], f.lo[2]);
  split_tf32(p[ld + 8], f.hi[3], f.lo[3]);
  return f;
}
// A from a C fragment, k permuted
__device__ __forceinline__ FragA c_to_a_tf32(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}
// B whose n runs along the tile's rows (K in Q.K^T):
// p = &tile[(n0 + gr) * ld + k0 + tq]
__device__ __forceinline__ FragB load_b_tf32(const float* p) {
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}
// B whose k runs along the tile's rows (V in P.V), k permuted:
// p = &tile[(k0 + 2 tq) * ld + n0 + gr]
__device__ __forceinline__ FragB load_bk_tf32(const float* p, int ld) {
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[ld], f.hi[1], f.lo[1]);
  return f;
}

// acc[NN] = A . B^T over DEPTH (a multiple of 8) for 16 rows of A (a =
// &A[(row0 + gr) * lda + tq]) and NN n8 tiles of B's rows (bt =
// &B[(n0 + gr) * ldb + tq]), k8 steps in order. The float32 flash bodies
// take their scores from it, so the backward's s is the forward's bit for
// bit (an element's products and their order do not depend on NN).
template <int NN, int DEPTH>
__device__ __forceinline__ void rows_dot_tf32(float (&acc)[NN][4],
                                              const float* a, int lda,
                                              const float* bt, int ldb) {
#pragma unroll
  for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 8) {
    const FragA fa = load_a_tf32(a + kk, lda);
    FragB fb[NN];
#pragma unroll
    for (int n = 0; n < NN; ++n) fb[n] = load_b_tf32(bt + n * 8 * ldb + kk);
    mma_tf32x3(acc, fa, fb);
  }
}

// ROWS x cols_pad float32 (cols_pad a multiple of 4) from global (row
// stride g_ld elements) into shared memory (row stride s_ld, a multiple of
// 4), NT threads, as load_tile below: zeros past rows_valid and
// cols_valid; with vec, whole 16-byte chunks by cp.async.
template <int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* s, int s_ld,
                                              const float* g, size_t g_ld,
                                              int rows_valid, int cols_valid,
                                              int cols_pad, bool vec,
                                              int tid) {
  const int CH = cols_pad / 4;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 4;
    float* dst = s + r * s_ld + c;
    const bool row_ok = r < rows_valid;
    if (vec && c + 4 <= cols_valid) {
      cp_async16(dst, row_ok ? g + r * g_ld + c : g, row_ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = row_ok && c + e < cols_valid ? g[r * g_ld + c + e] : 0.f;
    }
  }
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
