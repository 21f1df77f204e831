// Single-token decode attention over the paged KV cache, for Hopper
// (sm_90a), with pages in the query's type or as int8 codes with scale
// pages.
//
// Replaces the Pallas TPU kernels src/repro/kernels/paged_attention.py
// ::paged_decode_attention (_paged_kernel) and
// ::paged_decode_attention_int8 (_paged_kernel_int8): one query token per
// sequence against a shared pool of physical pages, reached through each
// sequence's block table; the G = H / Hkv query heads of a kv head share
// each row, an optional tanh softcap, and positions [0, lengths[b]) are
// live. The int8 kernel's pages hold int8 codes, and its scale pages
// (P+1, bs, Hkv) float32 one scale per (position, kv head), reached
// through the same table.
//
// Layout: q (B, H, K), k_pages and v_pages (P+1, bs, Hkv, K), table
// (B, nblk) int32, lengths (B,) int32, out (B, H, K), all contiguous;
// q, out (and the pages unless int8) float32 or bfloat16; arithmetic in
// float32.
//
// Design. The TPU kernels gathered pages in their BlockSpec index maps,
// with the table and lengths as scalar-prefetch operands and one grid step
// per logical block. Here each block (one per kv head and batch row) reads
// its own table row and computes page addresses as it walks: position j is
// the row ((table[b, j/bs]*bs + j%bs)*Hkv + hk)*K, and its scale sits at
// that row / K of the scale pages. The walk stops at lengths[b], so the
// scratch page and unowned pages (and their scale pages) are never read,
// and a row of length 0 writes 0.
//
// The kernel body is decode_attention.cuh, the same template as the dense
// ring's kernels with this address policy: same warp <-> position
// assignment, same U-row loads and dequantisation, same skip of dead rows,
// same merge. For the same logical cache each paged kernel therefore gives
// its dense sibling's bits, which keeps dense and paged greedy decode
// bit-identical on the card, in either storage.
//
// Bound. Like dense decode it is bound by device-memory bytes: each live
// key and value row once, 2*(live positions)*Hkv*K*itemsize (int8:
// 2*(live positions)*Hkv*(K + 4)), plus the table; about 4*G*K operations
// per row. Only B*Hkv blocks run; splitting positions across blocks and
// cp.async/TMA page loads are later work.
#include "decode_attention.cuh"

int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* lengths, void* out, int B,
                                  int nblk, int bs, int H, int Hkv, int K,
                                  float scale, float softcap, int is_bf16,
                                  void* stream) {
  using namespace decode_attention_detail;
  const PagedRows rows{static_cast<const int*>(table),
                       static_cast<const int*>(lengths), nblk, bs, Hkv};
  return launch_dtype(is_bf16, H / Hkv, K, q, k_pages, v_pages, rows,
                      SameType{}, out, B, Hkv, scale, softcap, stream);
}

int paged_decode_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages, const void* table,
    const void* lengths, void* out, int B, int nblk, int bs, int H, int Hkv,
    int K, float scale, float softcap, int is_bf16, void* stream) {
  using namespace decode_attention_detail;
  const PagedRows rows{static_cast<const int*>(table),
                       static_cast<const int*>(lengths), nblk, bs, Hkv};
  const Int8Scales store{static_cast<const float*>(k_scale_pages),
                         static_cast<const float*>(v_scale_pages)};
  return launch_dtype(is_bf16, H / Hkv, K, q, k_pages, v_pages, rows, store,
                      out, B, Hkv, scale, softcap, stream);
}
