// Single-token decode attention over the dense ring cache, for Hopper
// (sm_90a), with K/V in the query's type or as int8 codes with scales.
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode_attention.py
// ::decode_attention (_decode_kernel) and ::decode_attention_int8
// (_decode_kernel_int8): one query token per sequence against a
// (B, W, Hkv, K) key/value ring, the G = H / Hkv query heads of a kv head
// sharing each key/value row, an optional tanh softcap, and a (B, W) bool
// mask of live ring slots. The int8 kernel's ring holds int8 codes and
// (B, W, Hkv) float32 scales, one per (slot, kv head); a live row is
// dequantised as it is loaded (float(code) * scale), dead rows' codes and
// scales are never read.
//
// Layout: q (B, H, K), k and v (B, W, Hkv, K), valid (B, W) bool,
// out (B, H, K), all contiguous; q, out (and K/V unless int8) float32 or
// bfloat16; arithmetic in float32.
//
// The kernel body, its design and its bound are in decode_attention.cuh,
// shared with the paged kernels (paged_attention.cu); this file gives it
// the dense address policy: slot j of row b is row ((b*W + j)*Hkv + hk)*K
// and is live iff valid[b, j]. A slot whose flag is false is neither read
// nor added, and a row with no valid slot writes 0.
#include "decode_attention.cuh"

// Plain C++ entry points for the binding; each returns the cudaError_t of
// the launch (0 on success). The caller has checked shapes, types and
// layout.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, int B, int W, int H,
                            int Hkv, int K, float scale, float softcap,
                            int is_bf16, void* stream) {
  using namespace decode_attention_detail;
  const DenseRows rows{static_cast<const unsigned char*>(valid), W, Hkv};
  return launch_dtype(is_bf16, H / Hkv, K, q, k, v, rows, SameType{}, out,
                      B, Hkv, scale, softcap, stream);
}

int decode_attention_int8_launch(const void* q, const void* k, const void* v,
                                 const void* valid, const void* k_scale,
                                 const void* v_scale, void* out, int B, int W,
                                 int H, int Hkv, int K, float scale,
                                 float softcap, int is_bf16, void* stream) {
  using namespace decode_attention_detail;
  const DenseRows rows{static_cast<const unsigned char*>(valid), W, Hkv};
  const Int8Scales store{static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale)};
  return launch_dtype(is_bf16, H / Hkv, K, q, k, v, rows, store, out, B, Hkv,
                      scale, softcap, stream);
}
