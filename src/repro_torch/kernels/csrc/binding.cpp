// Python binding of the kernels for torch.utils.cpp_extension.
// The Python wrappers (kernels/flash_attention.py, with the backward,
// kernels/decode_attention.py, kernels/paged_attention.py, each of the
// last two with an int8 entry point, kernels/ssd_scan.py, with the backward,
// kernels/mla_decode.py and kernels/rmsnorm.py, with the backward) check devices,
// types, shapes and layout, allocate the outputs and pass raw device
// pointers, sizes and the CUDA stream as integers; these functions only
// forward them and return the launch's CUDA error code. Nothing here needs the PyTorch headers, only
// pybind11, so the host compile stays short; the .cu sources include no
// PyTorch header either.
#include <pybind11/pybind11.h>

#include <cstdint>
#include <string>

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Sq, int Skv,
                           int H, int Hkv, int K, int Kv, int causal,
                           int window, float scale, float softcap,
                           int is_bf16, void* stream);
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, int B, int Sq, int Skv, int H,
                               int Hkv, int K, int Kv, int causal, int window,
                               float scale, float softcap, int is_bf16,
                               void* stream);
int rmsnorm_bwd_launch(const void* x0, const void* scale0, const void* g0,
                       void* dx0, long long rows0, long long row_stride0,
                       long long per0, int blocks0, const void* x1,
                       const void* scale1, const void* g1, void* dx1,
                       long long rows1, long long row_stride1,
                       long long per1, int blocks1, int D, float eps,
                       int warps, int slots, int vec, void* partial,
                       void* dscale, int segments, int x_bf16, int scale_bf16,
                       void* stream);
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, void* work, int B,
                            int W, int H, int Hkv, int K, int split,
                            float scale, float softcap, int is_bf16,
                            void* stream);
int paged_decode_attention_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* lengths, void* out, void* work,
                                  int B, int nblk, int bs, int H, int Hkv,
                                  int K, int split, float scale,
                                  float softcap, int is_bf16, void* stream);
int decode_attention_int8_launch(const void* q, const void* k, const void* v,
                                 const void* valid, const void* k_scale,
                                 const void* v_scale, void* out, void* work,
                                 int B, int W, int H, int Hkv, int K,
                                 int split, float scale, float softcap,
                                 int is_bf16, void* stream);
int paged_decode_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale_pages, const void* v_scale_pages, const void* table,
    const void* lengths, void* out, void* work, int B, int nblk, int bs,
    int H, int Hkv, int K, int split, float scale, float softcap,
    int is_bf16, void* stream);
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* state, void* work, int B, int S, int nh, int hd,
                    int ng, int ds, int is_bf16, void* stream);
long long ssd_scan_work_floats(int B, int S, int nh, int hd, int ng, int ds);
int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* dy, const void* dstate, void* dx,
                        void* ddt, void* dA, void* dB, void* dC, void* dD,
                        void* work, int B, int S, int nh, int hd, int ng,
                        int ds, void* stream);
long long ssd_scan_bwd_work_floats(int B, int S, int nh, int hd, int ng,
                                   int ds);
int mla_decode_launch(const void* q_lat, const void* q_rope, const void* ckv,
                      const void* k_rope, const void* valid, void* out,
                      void* work, int B, int S, int H, int r, int dr,
                      float scale, int chunk, int is_bf16, void* stream);
int rmsnorm_launch(const void* x0, const void* scale0, void* out0,
                   long long rows0, long long row_stride0, const void* x1,
                   const void* scale1, void* out1, long long rows1,
                   long long row_stride1, int D, float eps, int x_bf16,
                   int scale_bf16, int warps, int slots, int vec,
                   void* stream);
const char* kernel_error_string(int err);

namespace {

void* ptr(std::uintptr_t p) { return reinterpret_cast<void*>(p); }

int flash_attention(std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                    std::uintptr_t out, std::uintptr_t lse, int B, int Sq,
                    int Skv, int H, int Hkv, int K, int Kv, bool causal,
                    int window, float scale, float softcap, bool is_bf16,
                    std::uintptr_t stream) {
  return flash_attention_launch(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
                                B, Sq, Skv, H, Hkv, K, Kv, causal ? 1 : 0,
                                window, scale, softcap, is_bf16 ? 1 : 0,
                                ptr(stream));
}

int flash_attention_bwd(std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                        std::uintptr_t out, std::uintptr_t lse,
                        std::uintptr_t dout, std::uintptr_t dq,
                        std::uintptr_t dk, std::uintptr_t dv,
                        std::uintptr_t delta, int B, int Sq, int Skv, int H,
                        int Hkv, int K, int Kv, bool causal, int window,
                        float scale, float softcap, bool is_bf16,
                        std::uintptr_t stream) {
  return flash_attention_bwd_launch(
      ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(dout), ptr(dq),
      ptr(dk), ptr(dv), ptr(delta), B, Sq, Skv, H, Hkv, K, Kv,
      causal ? 1 : 0, window, scale, softcap, is_bf16 ? 1 : 0, ptr(stream));
}

// rows1 = 0 and blocks1 = 0: one tensor; otherwise both in one call
int rmsnorm_bwd(std::uintptr_t x0, std::uintptr_t scale0, std::uintptr_t g0,
                std::uintptr_t dx0, long long rows0, long long row_stride0,
                long long per0, int blocks0, std::uintptr_t x1,
                std::uintptr_t scale1, std::uintptr_t g1, std::uintptr_t dx1,
                long long rows1, long long row_stride1, long long per1,
                int blocks1, int D, float eps, int warps, int slots,
                bool vec, std::uintptr_t partial, std::uintptr_t dscale,
                int segments, bool x_bf16, bool scale_bf16,
                std::uintptr_t stream) {
  return rmsnorm_bwd_launch(ptr(x0), ptr(scale0), ptr(g0), ptr(dx0), rows0,
                            row_stride0, per0, blocks0, ptr(x1), ptr(scale1),
                            ptr(g1), ptr(dx1), rows1, row_stride1, per1,
                            blocks1, D, eps, warps, slots, vec ? 1 : 0,
                            ptr(partial), ptr(dscale), segments,
                            x_bf16 ? 1 : 0, scale_bf16 ? 1 : 0,
                            ptr(stream));
}

int decode_attention(std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                     std::uintptr_t valid, std::uintptr_t out,
                     std::uintptr_t work, int B, int W, int H, int Hkv,
                     int K, int split, float scale, float softcap,
                     bool is_bf16, std::uintptr_t stream) {
  return decode_attention_launch(ptr(q), ptr(k), ptr(v), ptr(valid),
                                 ptr(out), ptr(work), B, W, H, Hkv, K, split,
                                 scale, softcap, is_bf16 ? 1 : 0,
                                 ptr(stream));
}

int paged_decode_attention(std::uintptr_t q, std::uintptr_t k_pages,
                           std::uintptr_t v_pages, std::uintptr_t table,
                           std::uintptr_t lengths, std::uintptr_t out,
                           std::uintptr_t work, int B, int nblk, int bs,
                           int H, int Hkv, int K, int split, float scale,
                           float softcap, bool is_bf16,
                           std::uintptr_t stream) {
  return paged_decode_attention_launch(
      ptr(q), ptr(k_pages), ptr(v_pages), ptr(table), ptr(lengths), ptr(out),
      ptr(work), B, nblk, bs, H, Hkv, K, split, scale, softcap,
      is_bf16 ? 1 : 0, ptr(stream));
}

int decode_attention_int8(std::uintptr_t q, std::uintptr_t k,
                          std::uintptr_t v, std::uintptr_t valid,
                          std::uintptr_t k_scale, std::uintptr_t v_scale,
                          std::uintptr_t out, std::uintptr_t work, int B,
                          int W, int H, int Hkv, int K, int split,
                          float scale, float softcap, bool is_bf16,
                          std::uintptr_t stream) {
  return decode_attention_int8_launch(
      ptr(q), ptr(k), ptr(v), ptr(valid), ptr(k_scale), ptr(v_scale),
      ptr(out), ptr(work), B, W, H, Hkv, K, split, scale, softcap,
      is_bf16 ? 1 : 0, ptr(stream));
}

int paged_decode_attention_int8(
    std::uintptr_t q, std::uintptr_t k_pages, std::uintptr_t v_pages,
    std::uintptr_t k_scale_pages, std::uintptr_t v_scale_pages,
    std::uintptr_t table, std::uintptr_t lengths, std::uintptr_t out,
    std::uintptr_t work, int B, int nblk, int bs, int H, int Hkv, int K,
    int split, float scale, float softcap, bool is_bf16,
    std::uintptr_t stream) {
  return paged_decode_attention_int8_launch(
      ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale_pages),
      ptr(v_scale_pages), ptr(table), ptr(lengths), ptr(out), ptr(work), B,
      nblk, bs, H, Hkv, K, split, scale, softcap, is_bf16 ? 1 : 0,
      ptr(stream));
}

int ssd_scan(std::uintptr_t x, std::uintptr_t dt, std::uintptr_t A,
             std::uintptr_t Bm, std::uintptr_t Cm, std::uintptr_t D,
             std::uintptr_t y, std::uintptr_t state, std::uintptr_t work,
             int B, int S, int nh, int hd, int ng, int ds, bool is_bf16,
             std::uintptr_t stream) {
  return ssd_scan_launch(ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(D),
                         ptr(y), ptr(state), ptr(work), B, S, nh, hd, ng, ds,
                         is_bf16 ? 1 : 0, ptr(stream));
}

// dstate = 0: no gradient of the final state
int ssd_scan_bwd(std::uintptr_t x, std::uintptr_t dt, std::uintptr_t A,
                 std::uintptr_t Bm, std::uintptr_t Cm, std::uintptr_t D,
                 std::uintptr_t dy, std::uintptr_t dstate, std::uintptr_t dx,
                 std::uintptr_t ddt, std::uintptr_t dA, std::uintptr_t dB,
                 std::uintptr_t dC, std::uintptr_t dD, std::uintptr_t work,
                 int B, int S, int nh, int hd, int ng, int ds,
                 std::uintptr_t stream) {
  return ssd_scan_bwd_launch(ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm),
                             ptr(D), ptr(dy), ptr(dstate), ptr(dx), ptr(ddt),
                             ptr(dA), ptr(dB), ptr(dC), ptr(dD), ptr(work), B,
                             S, nh, hd, ng, ds, ptr(stream));
}

int mla_decode_ctx(std::uintptr_t q_lat, std::uintptr_t q_rope,
                   std::uintptr_t ckv, std::uintptr_t k_rope,
                   std::uintptr_t valid, std::uintptr_t out,
                   std::uintptr_t work, int B, int S, int H, int r, int dr,
                   float scale, int chunk, bool is_bf16,
                   std::uintptr_t stream) {
  return mla_decode_launch(ptr(q_lat), ptr(q_rope), ptr(ckv), ptr(k_rope),
                           ptr(valid), ptr(out), ptr(work), B, S, H, r, dr,
                           scale, chunk, is_bf16 ? 1 : 0, ptr(stream));
}

// rows1 = 0 normalises one tensor; otherwise both in one launch
int rmsnorm(std::uintptr_t x0, std::uintptr_t scale0, std::uintptr_t out0,
            long long rows0, long long row_stride0, std::uintptr_t x1,
            std::uintptr_t scale1, std::uintptr_t out1, long long rows1,
            long long row_stride1, int D, float eps, bool x_bf16,
            bool scale_bf16, int warps, int slots, bool vec,
            std::uintptr_t stream) {
  return rmsnorm_launch(ptr(x0), ptr(scale0), ptr(out0), rows0, row_stride0,
                        ptr(x1), ptr(scale1), ptr(out1), rows1, row_stride1,
                        D, eps, x_bf16 ? 1 : 0, scale_bf16 ? 1 : 0, warps,
                        slots, vec ? 1 : 0, ptr(stream));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention", &flash_attention);
  m.def("flash_attention_bwd", &flash_attention_bwd);
  m.def("decode_attention", &decode_attention);
  m.def("paged_decode_attention", &paged_decode_attention);
  m.def("decode_attention_int8", &decode_attention_int8);
  m.def("paged_decode_attention_int8", &paged_decode_attention_int8);
  m.def("ssd_scan", &ssd_scan);
  m.def("ssd_scan_work_floats", &ssd_scan_work_floats);
  m.def("ssd_scan_bwd", &ssd_scan_bwd);
  m.def("ssd_scan_bwd_work_floats", &ssd_scan_bwd_work_floats);
  m.def("mla_decode_ctx", &mla_decode_ctx);
  m.def("rmsnorm", &rmsnorm);
  m.def("rmsnorm_bwd", &rmsnorm_bwd);
  m.def("error_string",
        [](int err) { return std::string(kernel_error_string(err)); });
}
