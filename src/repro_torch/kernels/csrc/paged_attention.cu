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
// The TPU kernels gathered pages in their BlockSpec index maps, with the
// table and lengths as scalar-prefetch operands and one grid step per
// logical block. Here a block computes page addresses itself: position j
// is row table[b, j/bs]*bs + j%bs of the pool, and an int8 row's scale sits
// at that row (times Hkv, plus the kv head) of the scale pages. Positions
// from lengths[b] on are never read, so neither the scratch page nor an
// unowned page (nor its scale page) is, and a row of length 0 writes 0.
//
// Which body. paged_decode_attention runs the split body of
// decode_split.cuh and paged_decode_attention_int8 the int8 split body of
// decode_int8_split.cuh, both with the paged address policy: a split
// whose first position is at or past lengths[b] returns before it reads
// the table, and a live split reads the table entry of each page it
// touches once (an int8 split then the two scales of each live
// position). Each paged kernel shares its body with its dense sibling
// (decode_attention.cu) and gives its bits for the same logical cache,
// which keeps dense and paged greedy decode bit-identical on the card,
// in either storage.
//
// Bound. Like dense decode it is bound by device-memory bytes: each live
// key and value row once, 2*(live positions)*Hkv*K*itemsize (int8:
// 2*(live positions)*Hkv*(K + 4)), plus the table's live entries; about
// 4*G*K operations per row. Each body's design is in its header.
#include "decode_int8_split.cuh"
#include "decode_split.cuh"

int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* lengths, void* out, void* work,
                                  int B, int nblk, int bs, int H, int Hkv,
                                  int K, int split, float scale,
                                  float softcap, int is_bf16, void* stream) {
  using namespace decode_split_detail;
  const PagedSplit rows{static_cast<const int*>(table),
                        static_cast<const int*>(lengths), nblk, bs};
  return launch_dtype(is_bf16, H / Hkv, K, split, q, k_pages, v_pages, rows,
                      out, work, B, Hkv, nblk * bs, scale, softcap, stream);
}

int paged_decode_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages, const void* table,
    const void* lengths, void* out, void* work, int B, int nblk, int bs,
    int H, int Hkv, int K, int split, float scale, float softcap,
    int is_bf16, void* stream) {
  using namespace decode_int8_detail;
  const PagedSplit rows{static_cast<const int*>(table),
                        static_cast<const int*>(lengths), nblk, bs};
  return launch_dtype(is_bf16, H / Hkv, K, split, q, k_pages, v_pages,
                      k_scale_pages, v_scale_pages, rows, out, work, B, Hkv,
                      nblk * bs, scale, softcap, stream);
}
