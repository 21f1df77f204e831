// Single-token decode attention over the paged KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// ::paged_decode_attention (_paged_kernel): one query token per sequence
// against a shared pool of physical pages, reached through each sequence's
// block table; the G = H / Hkv query heads of a kv head share each row, an
// optional tanh softcap, and positions [0, lengths[b]) are live.
//
// Layout: q (B, H, K), k_pages and v_pages (P+1, bs, Hkv, K), table
// (B, nblk) int32, lengths (B,) int32, out (B, H, K), all contiguous,
// float32 or bfloat16; arithmetic in float32.
//
// Design. The TPU kernel gathered pages in its BlockSpec index maps, with
// the table and lengths as scalar-prefetch operands and one grid step per
// logical block. Here each block (one per kv head and batch row) reads its
// own table row and computes page addresses as it walks: position j is the
// row ((table[b, j/bs]*bs + j%bs)*Hkv + hk)*K. The walk stops at
// lengths[b], so the scratch page and unowned pages are never read, and a
// row of length 0 writes 0.
//
// The kernel body is decode_attention.cuh, the same template as the dense
// ring's kernel with this address policy: same warp <-> position
// assignment, same U-row loads, same skip of dead rows, same merge. For
// the same logical cache it therefore gives the dense kernel's bits, which
// keeps dense and paged greedy decode bit-identical on the card.
//
// Bound. Like dense decode it is bound by device-memory bytes: each live
// key and value row once, 2*(live positions)*Hkv*K*itemsize, plus the
// table; about 4*G*K operations per row. Only B*Hkv blocks run; splitting
// positions across blocks and cp.async/TMA page loads are later work.
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
  return launch_dtype(is_bf16, H / Hkv, K, q, k_pages, v_pages, rows, out, B,
                      Hkv, scale, softcap, stream);
}
