// Single-token decode attention over the dense ring cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// ::decode_attention (_decode_kernel): one query token per sequence against
// a (B, W, Hkv, K) key/value ring, the G = H / Hkv query heads of a kv head
// sharing each key/value row, an optional tanh softcap, and a (B, W) bool
// mask of live ring slots.
//
// Layout: q (B, H, K), k and v (B, W, Hkv, K), valid (B, W) bool,
// out (B, H, K), all contiguous, float32 or bfloat16; arithmetic in
// float32.
//
// The kernel body, its design and its bound are in decode_attention.cuh,
// shared with the paged kernel (paged_attention.cu); this file gives it the
// dense address policy: slot j of row b is row ((b*W + j)*Hkv + hk)*K and
// is live iff valid[b, j]. A slot whose flag is false is neither read nor
// added, and a row with no valid slot writes 0.
#include "decode_attention.cuh"

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, int B, int W, int H,
                            int Hkv, int K, float scale, float softcap,
                            int is_bf16, void* stream) {
  using namespace decode_attention_detail;
  const DenseRows rows{static_cast<const unsigned char*>(valid), W, Hkv};
  return launch_dtype(is_bf16, H / Hkv, K, q, k, v, rows, out, B, Hkv, scale,
                      softcap, stream);
}
