// The single-token decode attention body of the int8 kernels,
// decode_attention_int8 (dense ring, decode_attention.cu) and
// paged_decode_attention_int8 (page pool, paged_attention.cu), for Hopper
// (sm_90a). Replaces the Pallas TPU kernels
// src/repro/kernels/decode_attention.py:124 (decode_attention_int8) and
// src/repro/kernels/paged_attention.py:211 (paged_decode_attention_int8).
//
// Layout: q (B, H, K), out (B, H, K), contiguous, float32 or bfloat16;
// K/V int8 codes, 16-byte aligned, laid out like decode_split.cuh's K/V,
// with one float32 scale per (position, kv head) at index row*Hkv + hk of
// k_scale / v_scale ((B, W, Hkv) for the ring, (P+1, bs, Hkv) for the
// pages); arithmetic in float32. G = H / Hkv query heads share each kv
// head.
//
// Reused from decode_split.cuh unchanged: the address policies
// (DenseSplit, PagedSplit), the split of P = 64 absolute positions, the
// float32 workspace layout and the merge pass (decode_merge_kernel). So
// this body is two launches a call, as the bf16/f32 pair's, and only the
// split pass is int8's own.
//
// Design, against what held the one-block-a-row body back:
// - SM fill. One block of NW = 4 warps per (split, kv head, batch row),
//   blockIdx.x the split: 32 x 8 x 4 blocks at the dense main shape (18 x
//   8 of them live) where the old body ran 8 x 4.
// - Dead slots. A dense split votes on its P flags, a paged one compares
//   its first position with lengths[b], before anything else; a split
//   with no live position writes max = -inf, normaliser 0 and returns,
//   having read no code, no scale and no table entry. The old dense body
//   walked all W slots of every row.
// - Narrow loads. A lane loads CPL codes of a row at once: 16 (one
//   16-byte load, 8 lanes a row at K = 128) for G <= 2, 8 for G = 4 and 4
//   for G = 8, whose q and accumulator would otherwise take 2*G*16
//   registers a lane. A warp holds P / NW = 16 rows, so each issues every
//   code and scale load of its rows (16 rows, K and V) before it
//   computes: one batch a split. A code becomes a float exactly by the
//   bias trick (code + 128 as the low byte of 2^23's mantissa, 2^23 + 128
//   taken off again).
// - Scale reads. A lane group loads its live rows' two scales beside
//   their codes, in the same batch, so a scale read adds no round trip to
//   the chain; a dead position's scales are never read (they count as 0).
//   Staging them in shared memory with the row map, one round trip before
//   the codes, measured 2-3 % slower (PERF.md).
// - The softmax chain. A warp's rows are one batch: it takes all G x R
//   scores of a lane group, each code converted once for the G heads and
//   the dot reduced over the row's lanes by log2(LPR) shuffles, then one
//   max per head and the weights, with no rescale.
// Dequantisation is folded: a score is (sum of q * code) * (k scale *
// softmax scale) and a value row enters as (p * v scale) * code, where
// the Pallas kernels dequantise first (float(code) * scale) and then take
// the dot; it saves K multiplies a row and holds the float32 (2e-5) and
// bfloat16 (2e-2) gates against the plain version. A dead position's
// codes are not loaded (0) and its weight is 0, so it adds exactly +0.0
// whatever its scale or codes hold. The warp's row groups, then the
// block's warps, are merged in a fixed order, and the split's
// unnormalised context and (max, normaliser) go to the workspace; the
// merge adds the live splits in split order, and a row with no live
// position writes 0. A split's bits depend only on the positions it
// covers, so the dense and the paged int8 kernel give the same bits over
// the same logical cache, and horizons 512 and 2048 do too.
//
// Bound. Every live code row and its scale once: 2 * (live positions) *
// Hkv * (K + 4) bytes; at the dense main shape (rows live to 48, 160, 300
// and 544: 1052 positions, Hkv = 8, K = 128) 2 * 1052 * 8 * 132 B, with q,
// out and the flags 0.000675 ms at 3.35 TB/s. About 4*G*K operations a
// row. At decode sizes a call is latency-bound instead: two launches and,
// in a live block, the chain flags (or length, then table) -> codes and
// scales -> the merge's workspace reads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

#include "decode_attention.cuh"
#include "decode_split.cuh"

namespace decode_int8_detail {

using decode_attention_detail::to_float;
using decode_split_detail::decode_merge_kernel;
using decode_split_detail::DenseSplit;
using decode_split_detail::FULL;
using decode_split_detail::NW;
using decode_split_detail::P;
using decode_split_detail::PagedSplit;

// codes a lane loads from a row at once
template <int G> constexpr int codes_a_lane() {
  return G <= 2 ? 16 : G == 4 ? 8 : 4;
}

// CPL codes at p (CPL-byte aligned) as CPL / 4 words, offset by 128 each
// (the sign bit flipped) for `code`
template <int CPL>
__device__ __forceinline__ void load_codes(unsigned (&w)[CPL / 4],
                                           const int8_t* p) {
  if constexpr (CPL == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (CPL == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
#pragma unroll
  for (int i = 0; i < CPL / 4; ++i) w[i] ^= 0x80808080u;
}

// code i (0..3) of an offset word, exactly: 2^23 + code + 128 - (2^23 + 128)
__device__ __forceinline__ float code(unsigned w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) -
         8388736.f;
}

// Split pass. Block (s, hk, b): as decode_split_kernel, the split's
// unnormalised context to part[at*G*K + g*K + d] and its max and
// normaliser to ml[(at*G + g)*2 + {0, 1}], at = (b*Hkv + hk)*nsplit + s,
// ml = part + B*Hkv*nsplit*G*K.
template <typename T, int G, int K, typename Rows>
__global__ void __launch_bounds__(NW * 32)
    decode_int8_split_kernel(const T* __restrict__ q,
                             const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale, Rows rows,
                             float* __restrict__ part, int Hkv, float scale,
                             float softcap) {
  constexpr int CPL = codes_a_lane<G>();  // codes a lane a row
  constexpr int WPL = CPL / 4;            // their 32-bit words
  constexpr int LPR = K / CPL;            // lanes a row
  constexpr int RPW = 32 / LPR;           // rows a warp instruction
  constexpr int R = P / NW / RPW;         // rows a lane group
  static_assert(LPR >= 2 && LPR <= 16 && NW * 32 >= P && P % 32 == 0 &&
                    R * RPW * NW == P,
                "split shape");
  __shared__ int sm_row[P];
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G * K];

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int j0 = s * P;
  const size_t at = (size_t(b) * Hkv + hk) * nsplit + s;
  float* ml = part + size_t(gridDim.z) * Hkv * nsplit * G * K;
  const int tid = threadIdx.x;

  // positions -> cache rows
  int my_row = -1;
  bool live = rows.may_live(b, j0);  // the same for the whole block
  if (live) {
    if (tid < P) {  // whole warps, as the paged policy's shuffle needs
      my_row = rows.row(b, j0, tid);
      sm_row[tid] = my_row;
    }
    live = __syncthreads_or(my_row >= 0);
  }
  if (!live) {
    if (tid < G) {
      ml[(at * G + tid) * 2] = -INFINITY;
      ml[(at * G + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, li = lane % LPR;
  const int H = Hkv * G;

  // the warp's P / NW consecutive positions: row u of lane group grp is
  // position (warp*R + u)*RPW + grp of the split
  int crow[R];
  bool ok[R], any = false;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int t = (warp * R + u) * RPW + grp;
    crow[u] = sm_row[t];
    ok[u] = crow[u] >= 0;
    any |= ok[u];
  }

  float m[G], l[G], acc[G][CPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[g][e] = 0.f;
  }

  if (__any_sync(FULL, any)) {  // else the warp's positions are all dead
    // every code and scale load of the warp's rows in flight before any
    // is used; the key scale takes the softmax scale along
    unsigned kw[R][WPL], vw[R][WPL];
    float ksc[R], vsc[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const size_t si = size_t(crow[u]) * Hkv + hk;  // the row's scales
      if (ok[u]) {
        load_codes<CPL>(kw[u], k + si * K + li * CPL);
        load_codes<CPL>(vw[u], v + si * K + li * CPL);
        ksc[u] = __ldg(k_scale + si) * scale;
        vsc[u] = __ldg(v_scale + si);
      } else {
        ksc[u] = vsc[u] = 0.f;
#pragma unroll
        for (int w = 0; w < WPL; ++w) kw[u][w] = vw[u][w] = 0x80808080u;
      }
    }
    float qr[G][CPL];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        qr[g][e] = to_float(q[(size_t(b) * H + hk * G + g) * K + li * CPL + e]);

    // all R*G scores, each code converted once for the G heads
    float sc[R][G];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = 0.f;
#pragma unroll
      for (int w = 0; w < WPL; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = code(kw[u][w], i);
#pragma unroll
          for (int g = 0; g < G; ++g) d[g] = fmaf(qr[g][w * 4 + i], c, d[g]);
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d[g] += __shfl_xor_sync(FULL, d[g], o);
        float x = d[g] * ksc[u];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        sc[u][g] = ok[u] ? x : -INFINITY;
      }
    }
    // one max per head over the warp's rows, then the weights (in sc)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mb = sc[0][g];
#pragma unroll
      for (int u = 1; u < R; ++u) mb = fmaxf(mb, sc[u][g]);
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
      m[g] = mb;  // finite: the warp has a live position
#pragma unroll
      for (int u = 0; u < R; ++u) {
        sc[u][g] = ok[u] ? expf(sc[u][g] - mb) : 0.f;
        l[g] += sc[u][g];
      }
    }
    // the weighted value rows, each code converted once; p * v scale is
    // 0 for a dead position
#pragma unroll
    for (int u = 0; u < R; ++u) {
      float pv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] = sc[u][g] * vsc[u];
#pragma unroll
      for (int w = 0; w < WPL; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c = code(vw[u][w], i);
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g][w * 4 + i] = fmaf(pv[g], c, acc[g][w * 4 + i]);
        }
    }
  }

  // the warp's row groups share m: add their normalisers and contexts
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], o);
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        sm_acc[warp][g * K + li * CPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  // the block's warps, rescaled to their common max, in warp order
  for (int i = tid; i < G * K; i += NW * 32) {
    const int g = i / K;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (sm_m[w][g] == -INFINITY) continue;  // a warp with no live row
      const float c = expf(sm_m[w][g] - mx);
      num = fmaf(sm_acc[w][i], c, num);
      den = fmaf(sm_l[w][g], c, den);
    }
    part[at * G * K + i] = num;
    if (i % K == 0) {
      ml[(at * G + g) * 2] = mx;
      ml[(at * G + g) * 2 + 1] = den;
    }
  }
}

template <typename T, int G, int K, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, Rows rows, void* out,
                   void* work, int B, int Hkv, int nsplit, float scale,
                   float softcap, cudaStream_t stream) {
  float* part = static_cast<float*>(work);
  if (nsplit > 0) {
    decode_int8_split_kernel<T, G, K, Rows>
        <<<dim3(nsplit, Hkv, B), NW * 32, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const int8_t*>(k),
            static_cast<const int8_t*>(v), ks, vs, rows, part, Hkv, scale,
            softcap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_merge_kernel<T, G, K><<<dim3(Hkv, B), G * K, 0, stream>>>(
      part, static_cast<T*>(out), Hkv, nsplit);
  return cudaGetLastError();
}

// the (G, K) of decode_split.cuh: G * K <= 512
template <typename T, int G, typename Rows>
cudaError_t launch_k(int K, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, Rows rows, void* out,
                     void* work, int B, int Hkv, int nsplit, float scale,
                     float softcap, cudaStream_t s) {
  switch (K) {
    case 32: return launch<T, G, 32>(q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 64: return launch<T, G, 64>(q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 128:
      if constexpr (G <= 4) return launch<T, G, 128>(q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
      return cudaErrorInvalidValue;
    case 256:
      if constexpr (G <= 2) return launch<T, G, 256>(q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows>
cudaError_t launch_g(int G, int K, const void* q, const void* k,
                     const void* v, const float* ks, const float* vs,
                     Rows rows, void* out, void* work, int B, int Hkv,
                     int nsplit, float scale, float softcap,
                     cudaStream_t s) {
  switch (G) {
    case 1: return launch_k<T, 1>(K, q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 2: return launch_k<T, 2>(K, q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 4: return launch_k<T, 4>(K, q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 8: return launch_k<T, 8>(K, q, k, v, ks, vs, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

// Both query dtypes for one address policy, over rows of `extent` logical
// positions; the caller has checked shapes, types and alignment, and
// sized the workspace for its `split`, which must be P: B*Hkv*nsplit*G*
// (K + 2) floats with nsplit = ceil(extent / P), as decode_split.cuh's.
template <typename Rows>
cudaError_t launch_dtype(int is_bf16, int G, int K, int split, const void* q,
                         const void* k, const void* v, const void* k_scale,
                         const void* v_scale, Rows rows, void* out,
                         void* work, int B, int Hkv, int extent, float scale,
                         float softcap, void* stream) {
  if (split != P) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int nsplit = (extent + P - 1) / P;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (is_bf16)
    return launch_g<__nv_bfloat16>(G, K, q, k, v, ks, vs, rows, out, work,
                                   B, Hkv, nsplit, scale, softcap, s);
  return launch_g<float>(G, K, q, k, v, ks, vs, rows, out, work, B, Hkv,
                         nsplit, scale, softcap, s);
}

}  // namespace decode_int8_detail
