// Single-token decode attention over the dense ring cache, for Hopper
// (sm_90a), with K/V in the query's type or as int8 codes with scales.
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode_attention.py
// ::decode_attention (_decode_kernel) and ::decode_attention_int8
// (_decode_kernel_int8): one query token per sequence against a
// (B, W, Hkv, K) key/value ring, the G = H / Hkv query heads of a kv head
// sharing each key/value row, an optional tanh softcap, and a (B, W) bool
// mask of live ring slots. The int8 kernel's ring holds int8 codes and
// (B, W, Hkv) float32 scales, one per (slot, kv head), so a key is
// float(code) * scale (the body folds the scale onto the dot and onto the
// weight); dead rows' codes and scales are never read.
//
// Layout: q (B, H, K), k and v (B, W, Hkv, K), valid (B, W) bool,
// out (B, H, K), all contiguous; q, out (and K/V unless int8) float32 or
// bfloat16; arithmetic in float32.
//
// Which body. decode_attention runs the split body of decode_split.cuh
// and decode_attention_int8 the int8 split body of decode_int8_split.cuh:
// blocks over P-position splits of the ring (16-byte K/V loads; int8: up
// to 16 codes a lane a load, with each live row's two scales staged
// beside its cache row), then one merge pass over the splits in order,
// the same for both. Both run the dense address policy: slot j of row b is
// cache row b*W + j and is live iff valid[b, j]; a split whose P flags
// are all false reads no K/V and no scale. Each shares its body with the
// paged kernel of the same storage (paged_attention.cu), so a paged
// kernel gives its dense sibling's bits over the same logical cache. The
// design and the bound of each body are in its header. A slot whose flag
// is false is neither read nor added, and a row with no valid slot
// writes 0.
#include "decode_int8_split.cuh"
#include "decode_split.cuh"

// Plain C++ entry points for the binding; each returns the cudaError_t of
// the launch (0 on success). The caller has checked shapes, types and
// layout, 16-byte aligned K/V, and a float32 workspace of
// B*Hkv*ceil(W/split)*G*(K + 2) floats for split = 64, the bodies' P
// (another split is refused).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, void* work, int B,
                            int W, int H, int Hkv, int K, int split,
                            float scale, float softcap, int is_bf16,
                            void* stream) {
  using namespace decode_split_detail;
  const DenseSplit rows{static_cast<const unsigned char*>(valid), W};
  return launch_dtype(is_bf16, H / Hkv, K, split, q, k, v, rows, out, work,
                      B, Hkv, W, scale, softcap, stream);
}

int decode_attention_int8_launch(const void* q, const void* k, const void* v,
                                 const void* valid, const void* k_scale,
                                 const void* v_scale, void* out, void* work,
                                 int B, int W, int H, int Hkv, int K,
                                 int split, float scale, float softcap,
                                 int is_bf16, void* stream) {
  using namespace decode_int8_detail;
  const DenseSplit rows{static_cast<const unsigned char*>(valid), W};
  return launch_dtype(is_bf16, H / Hkv, K, split, q, k, v, k_scale, v_scale,
                      rows, out, work, B, Hkv, W, scale, softcap, stream);
}
