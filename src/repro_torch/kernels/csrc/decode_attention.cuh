// The single-token decode attention body of the int8 kernels,
// decode_attention_int8 (dense ring, decode_attention.cu) and
// paged_decode_attention_int8 (page pool, paged_attention.cu), for Hopper
// (sm_90a). The kernels with K/V in the query's type run the split body
// of decode_split.cuh, which takes this file's type conversions.
//
// One body, two address policies. The dense ring and the page pool differ
// only in where logical cache position j of row b lives and whether it is
// live. Everything else (warp <-> position assignment, the U-row loads,
// the dequantisation, the skip of dead rows, the online softmax and the
// shared-memory merge) is this one template. So for the same logical
// cache the dense and the paged int8 kernel do the same float operations
// in the same order and give the same bits, which is what keeps dense and
// paged int8 greedy decode bit-identical on the card.
//
// Layout: q (B, H, K), out (B, H, K), contiguous, float32 or bfloat16;
// arithmetic in float32. An address policy gives, per block, the number
// of positions to walk (`extent`), whether position j is live (`live`)
// and the element offset of its (kv head hk) row of K/V (`row`). The
// storage policy `Int8Scales` stores int8 codes with one float32 scale per
// (position, kv head), at index row / K of the (..., Hkv) scale array, and
// a row is dequantised as it is loaded, before the dot (float(code) *
// scale), as the Pallas int8 kernels dequantise their tiles in VMEM.
//
// Design. One block per (kv head, batch row) holds that head's G query
// heads in registers and streams the live cache rows once. Each warp walks
// its own runs of U consecutive positions (the TPU kernels' sequential
// grid axis over cache tiles becomes this loop), loading the U rows' keys
// and values before it computes, so several rows are in flight per warp;
// a lane holds K/32 elements of a row, so a warp reads each row as
// contiguous 32-lane transactions. Every warp keeps its own online softmax
// (max, normaliser, accumulator) and the warps merge through shared memory
// at the end. A dead position is skipped: neither its K/V nor its scales
// are read and nothing is added, so it contributes exactly 0.0, and a row
// with no live position writes 0.
//
// Bound. int8 decode reads every live code row and its scale once and
// does about 4*G*K operations per row: it is bound by device-memory
// bytes, 2*(live positions)*Hkv*(K + 4) per sequence. Only B*Hkv blocks
// run, so at small batch the card is far from full, and a lane reads
// single bytes: position splits (as decode_split.cuh) and 16-code loads
// are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

namespace decode_attention_detail {

constexpr int NW = 16;  // warps per block
constexpr int U = 4;    // positions a warp loads before it computes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dense ring: k/v (B, W, Hkv, K), valid (B, W) bool.
struct DenseRows {
  const unsigned char* valid;
  int W, Hkv;
  __device__ int extent(int) const { return W; }
  __device__ bool live(int b, int j, int n) const {
    return j < n && valid[size_t(b) * W + j];
  }
  __device__ size_t row(int b, int j, int hk, int K) const {
    return ((size_t(b) * W + j) * Hkv + hk) * K;
  }
};

// Page pool: k/v pages (P+1, bs, Hkv, K), table (B, nblk) int32, lengths
// (B,) int32. Position j of row b lives in page table[b, j / bs] at offset
// j % bs and is live iff j < lengths[b]; the walk stops there, so neither
// the scratch page nor an unowned page is ever read.
struct PagedRows {
  const int* table;
  const int* lengths;
  int nblk, bs, Hkv;
  __device__ int extent(int b) const {
    return min(max(lengths[b], 0), nblk * bs);
  }
  __device__ bool live(int, int j, int n) const { return j < n; }
  __device__ size_t row(int b, int j, int hk, int K) const {
    const int page = table[size_t(b) * nblk + j / bs];
    return ((size_t(page) * bs + j % bs) * Hkv + hk) * K;
  }
};

// int8 K/V codes; the scale of a (position, kv head) row is at index
// row / K of k_scale / v_scale, laid out like K/V without the last axis:
// (B, W, Hkv) for the dense ring, (P+1, bs, Hkv) for the page pool.
struct Int8Scales {
  template <typename T> using Stored = int8_t;
  const float* k_scales;
  const float* v_scales;
  __device__ float k_scale(size_t i) const { return k_scales[i]; }
  __device__ float v_scale(size_t i) const { return v_scales[i]; }
};

template <typename T, typename KV, int G, int KPL, typename Rows,
          typename Store>  // KPL = K / 32
__global__ void __launch_bounds__(NW * 32)
    decode_attention_kernel(const T* __restrict__ q,
                            const KV* __restrict__ k,
                            const KV* __restrict__ v, Rows rows, Store store,
                            T* __restrict__ out, int Hkv, float scale,
                            float softcap) {
  constexpr int K = KPL * 32;
  __shared__ float sm_m[NW * G];
  __shared__ float sm_l[NW * G];
  __shared__ float sm_acc[NW * G * K];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int H = Hkv * G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[G][KPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < KPL; ++e)
      qr[g][e] = to_float(q[(size_t(b) * H + hk * G + g) * K + lane + 32 * e]);

  float m[G], l[G], acc[G][KPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < KPL; ++e) acc[g][e] = 0.f;
  }

  const int n = rows.extent(b);
  for (int j0 = warp * U; j0 < n; j0 += NW * U) {
    bool ok[U];
    float kr[U][KPL], vr[U][KPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      ok[u] = rows.live(b, j, n);
      const size_t row = ok[u] ? rows.row(b, j, hk, K) : 0;
      // a dead row's scale is not read either (it may be anything)
      const float ks = ok[u] ? store.k_scale(row / K) : 0.f;
      const float vs = ok[u] ? store.v_scale(row / K) : 0.f;
#pragma unroll
      for (int e = 0; e < KPL; ++e) {
        kr[u][e] = ok[u] ? to_float(k[row + lane + 32 * e]) * ks : 0.f;
        vr[u][e] = ok[u] ? to_float(v[row + lane + 32 * e]) * vs : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;  // same for the whole warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < KPL; ++e) s = fmaf(qr[g][e], kr[u][e], s);
        s = warp_sum(s) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);  // 0 while m[g] = -inf
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < KPL; ++e)
          acc[g][e] = fmaf(p, vr[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < KPL; ++e)
      sm_acc[(warp * G + g) * K + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * K; i += NW * 32) {
    const int g = i / K, d = i % K;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = expf(sm_m[w * G + g] - mx);  // 0 for an idle warp
        num = fmaf(sm_acc[(w * G + g) * K + d], c, num);
        den = fmaf(sm_l[w * G + g], c, den);
      }
    }
    out[(size_t(b) * H + hk * G + g) * K + d] =
        from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G, int KPL, typename Rows, typename Store>
cudaError_t launch(const void* q, const void* k, const void* v, Rows rows,
                   Store store, void* out, int B, int Hkv, float scale,
                   float softcap, cudaStream_t stream) {
  using KV = typename Store::template Stored<T>;
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, KV, G, KPL, Rows, Store>
      <<<grid, NW * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k),
          static_cast<const KV*>(v), rows, store, static_cast<T*>(out), Hkv,
          scale, softcap);
  return cudaGetLastError();
}

// G * K <= 512 keeps the per-thread registers and the merge buffer small
template <typename T, int G, typename Rows, typename Store>
cudaError_t launch_k(int K, const void* q, const void* k, const void* v,
                     Rows rows, Store st, void* out, int B, int Hkv,
                     float scale, float softcap, cudaStream_t stream) {
  switch (K) {
    case 32: return launch<T, G, 1>(q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    case 64: return launch<T, G, 2>(q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    case 128:
      if constexpr (G <= 4) return launch<T, G, 4>(q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
      return cudaErrorInvalidValue;
    case 256:
      if constexpr (G <= 2) return launch<T, G, 8>(q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows, typename Store>
cudaError_t launch_g(int G, int K, const void* q, const void* k,
                     const void* v, Rows rows, Store st, void* out, int B,
                     int Hkv, float scale, float softcap,
                     cudaStream_t stream) {
  switch (G) {
    case 1: return launch_k<T, 1>(K, q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    case 2: return launch_k<T, 2>(K, q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    case 4: return launch_k<T, 4>(K, q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    case 8: return launch_k<T, 8>(K, q, k, v, rows, st, out, B, Hkv, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Both query dtypes for one address and one storage policy; the caller
// has checked shapes and types.
template <typename Rows, typename Store>
cudaError_t launch_dtype(int is_bf16, int G, int K, const void* q,
                         const void* k, const void* v, Rows rows, Store st,
                         void* out, int B, int Hkv, float scale,
                         float softcap, void* stream) {
  if (B == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_g<__nv_bfloat16>(G, K, q, k, v, rows, st, out, B, Hkv,
                                   scale, softcap, s);
  return launch_g<float>(G, K, q, k, v, rows, st, out, B, Hkv, scale,
                         softcap, s);
}

}  // namespace decode_attention_detail
