// The single-token decode attention body of decode_attention (dense ring,
// decode_attention.cu) and paged_decode_attention (page pool,
// paged_attention.cu) for K/V in the query's type (float32 or bfloat16),
// for Hopper (sm_90a). The int8 kernels run their own split body,
// decode_int8_split.cuh, which reuses this file's policies and merge.
//
// Layout: q (B, H, K), out (B, H, K), contiguous, float32 or bfloat16, K/V
// in q's type, 16-byte aligned; arithmetic in float32. G = H / Hkv query
// heads share each kv head.
//
// Design. Two launches a call. The split pass runs one block of NW warps
// per (split, kv head, batch row), blockIdx.x the split, so the blocks of
// one row sit next to each other; split s covers the P = 64 logical
// positions [s*P, (s+1)*P) (64 beat 128 on the paged main shape and tied
// on the dense one, PERF.md). A block first maps its P positions to cache rows in
// shared memory (the address policy's `row`, one thread a position): a
// dense split reads its P valid flags, a paged split reads the table
// entry of each page it
// touches once (one lane a page; the other lanes of the page take it by a
// shuffle) and marks positions past lengths[b] dead. A split with no live
// position writes max = -inf, normaliser 0 and returns: it reads no K/V
// (and a paged one not even the table, since it compares its first
// position with lengths[b] before anything else). In a live split,
// LPR = min(32, K*itemsize/16) lanes hold a row, each lane 16-byte loads
// of it (bf16 K = 128: 16 lanes, two rows a warp instruction), and the
// block's NW*32/LPR row workers take the split's positions round robin.
// A warp issues the K and V loads of a batch of R rows a worker (R*RPW
// rows a warp, 16 at bf16 K = 128) before it computes, then all G*R scores
// of the batch (the dot reduced over the row's lanes by log2(LPR)
// shuffles), one max, one rescale of its accumulator per batch and the
// weighted V rows. A dead position is never loaded: its weight and its
// V registers are 0, so it adds exactly 0.0. At the end the warp's row
// groups and then the block's warps are merged in a fixed order and the
// split's unnormalised context acc[G][K] and its (max, normaliser) go to
// a float32 workspace. The merge pass (one block per (kv head, row), a
// thread per output element) rescales the splits to their common max and
// sums them in split order, skipping dead splits; a row with no live
// position writes 0.
//
// Why splits on absolute positions. A split's bits depend only on the
// positions it covers and what the cache holds there, never on W, nblk or
// the row's length, and the merge adds only live splits, in order. So
// the dense and the paged kernel, which differ only in the address
// policy, give the same bits for the same logical cache (dense
// and paged greedy decode stay bit-identical), and so do horizons of 512
// and 2048 over the same live prefix.
//
// Bound. Decode reads every live key and value row once and does about
// 4*G*K operations a row: it is bound by device-memory bytes,
// 2*(live positions)*Hkv*K*itemsize per sequence. The workspace adds
// (live splits)*Hkv*G*K*4 bytes each way, mostly in L2; dead splits cost
// a block that reads P flags (dense) or one length (paged). At decode
// sizes a call is latency-bound instead: two launches, and in a live
// block a chain of dependent reads (flags or length and table, then K/V,
// then the merge's workspace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

#include "decode_attention.cuh"

namespace decode_split_detail {

using decode_attention_detail::from_float;
using decode_attention_detail::to_float;

constexpr int NW = 4;                // warps per split block
constexpr int P = 64;                // positions per split
constexpr unsigned FULL = 0xffffffffu;

// element e (0 <= e < 16 / sizeof(T)) of a 16-byte load, as float32
template <typename T> __device__ __forceinline__ float elem(const uint4& v, int e);
__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const unsigned w = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Dense ring: k/v (B, W, Hkv, K), valid (B, W) bool. Position j of row b
// is cache row b*W + j (times Hkv, plus the kv head) and is live iff
// j < W and valid[b, j].
struct DenseSplit {
  const unsigned char* valid;
  int W;
  __device__ bool may_live(int, int) const { return true; }
  // the cache row of position j0 + t (a thread's own t < P), or -1
  __device__ int row(int b, int j0, int t) const {
    const int j = j0 + t;
    return (j < W && valid[size_t(b) * W + j]) ? b * W + j : -1;
  }
};

// Page pool: k/v pages (P+1, bs, Hkv, K), table (B, nblk) int32, lengths
// (B,) int32. Position j of row b is row table[b, j / bs]*bs + j % bs of
// the pool and is live iff j < lengths[b] (capped at nblk*bs), so the
// scratch page and unowned pages are never read.
struct PagedSplit {
  const int* table;
  const int* lengths;
  int nblk, bs;
  __device__ int extent(int b) const {
    return min(max(lengths[b], 0), nblk * bs);
  }
  __device__ bool may_live(int b, int j0) const { return j0 < extent(b); }
  __device__ int row(int b, int j0, int t) const {
    const int j = j0 + t;
    const bool live = j < extent(b);
    // one lane reads each page's entry: the warp's first lane, or the
    // lane of a page's first position; the others take it from that lane
    const int lane = threadIdx.x % 32;
    const int off = j % bs;
    const bool leader = lane == 0 || off == 0;
    int page = 0;
    if (live && leader) page = table[size_t(b) * nblk + j / bs];
    const int src = off >= lane ? 0 : lane - off;
    page = __shfl_sync(FULL, page, src);
    return live ? page * bs + off : -1;
  }
};

// Split pass. Block (s, hk, b): the split's unnormalised context goes to
// part[((b*Hkv + hk)*nsplit + s)*G*K + g*K + d], its max and normaliser
// to ml[(((b*Hkv + hk)*nsplit + s)*G + g)*2 + {0, 1}], ml = part +
// B*Hkv*nsplit*G*K.
template <typename T, int G, int K, typename Rows>
__global__ void __launch_bounds__(NW * 32)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Rows rows,
                        float* __restrict__ part, int Hkv, float scale,
                        float softcap) {
  constexpr int VE = 16 / sizeof(T);          // elements a 16-byte load
  constexpr int NV = K / VE;                  // 16-byte loads a row
  constexpr int LPR = NV < 32 ? NV : 32;      // lanes a row
  constexpr int VPL = NV / LPR;               // loads a lane a row
  constexpr int EPL = VPL * VE;               // elements a lane a row
  constexpr int RPW = 32 / LPR;               // rows a warp instruction
  constexpr int NWK = NW * RPW;               // row workers a block
  constexpr int RPK = P / NWK;                // rows a worker a split
  constexpr int QA = G * EPL;                 // q (and acc) floats a lane
  // rows a worker a batch: at most 8 K and 8 V loads a lane in flight,
  // fewer where q and the accumulator take more registers
  constexpr int RB0 = (QA <= 16 ? 8 : QA <= 32 ? 4 : 2) / VPL;
  constexpr int RB = RB0 > 0 ? RB0 : 1;
  constexpr int R = RB < RPK ? RB : RPK;
  static_assert(NW * 32 >= P && P % 32 == 0 && P % NWK == 0 && RPK % R == 0,
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
  const int worker = warp * RPW + grp;
  const int H = Hkv * G;

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qr[g][c * VE + e] = to_float(
            q[(size_t(b) * H + hk * G + g) * K + (c * LPR + li) * VE + e]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const uint4* k4 = reinterpret_cast<const uint4*>(k);
  const uint4* v4 = reinterpret_cast<const uint4*>(v);
#pragma unroll 1
  for (int i = 0; i < RPK / R; ++i) {
    int crow[R];
    bool ok[R], any = false;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      crow[u] = sm_row[(i * R + u) * NWK + worker];
      ok[u] = crow[u] >= 0;
      any |= ok[u];
    }
    if (!__any_sync(FULL, any)) continue;  // the warp's batch is dead

    // every K and V load of the batch in flight before any is used
    uint4 kr[R][VPL], vr[R][VPL];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const size_t base = (size_t(crow[u]) * Hkv + hk) * NV + li;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        kr[u][c] = ok[u] ? __ldg(k4 + base + c * LPR) : make_uint4(0, 0, 0, 0);
        vr[u][c] = ok[u] ? __ldg(v4 + base + c * LPR) : make_uint4(0, 0, 0, 0);
      }
    }

    // all G*R scores, then one max and one rescale per query head
    float sc[R][G];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < VPL; ++c)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            d = fmaf(qr[g][c * VE + e], elem<T>(kr[u][c], e), d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
        d *= scale;
        if (softcap > 0.f) d = tanhf(d / softcap) * softcap;
        sc[u][g] = ok[u] ? d : -INFINITY;
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mb = sc[0][g];
#pragma unroll
      for (int u = 1; u < R; ++u) mb = fmaxf(mb, sc[u][g]);
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(FULL, mb, o));
      const float m_new = fmaxf(m[g], mb);       // finite: a row is live
      const float alpha = expf(m[g] - m_new);    // 0 while m[g] = -inf
      float p[R], ps = 0.f;
#pragma unroll
      for (int u = 0; u < R; ++u) {
        p[u] = ok[u] ? expf(sc[u][g] - m_new) : 0.f;
        ps += p[u];
      }
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int c = 0; c < VPL; ++c)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          float a = acc[g][c * VE + e] * alpha;
#pragma unroll
          for (int u = 0; u < R; ++u) a = fmaf(p[u], elem<T>(vr[u][c], e), a);
          acc[g][c * VE + e] = a;
        }
      m[g] = m_new;
    }
  }

  // the warp's row groups share m: add their normalisers and contexts
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
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
      for (int c = 0; c < VPL; ++c)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          sm_acc[warp][g * K + (c * LPR + li) * VE + e] = acc[g][c * VE + e];
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

// Merge pass: block (hk, b), thread i = g*K + d of the G*K outputs; the
// live splits rescaled to their common max and summed in split order.
template <typename T, int G, int K>
__global__ void __launch_bounds__(G * K)
    decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                        int Hkv, int nsplit) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int i = threadIdx.x, g = i / K;
  const size_t at = (size_t(b) * Hkv + hk) * nsplit;   // split 0
  const float* ml = part + size_t(gridDim.y) * Hkv * nsplit * G * K;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, ml[((at + s) * G + g) * 2]);
  float num = 0.f, den = 0.f;
  if (mx != -INFINITY) {
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s) {
      const float ms = ml[((at + s) * G + g) * 2];
      if (ms == -INFINITY) continue;  // a split with no live position
      const float c = expf(ms - mx);
      den = fmaf(ml[((at + s) * G + g) * 2 + 1], c, den);
      num = fmaf(part[(at + s) * G * K + i], c, num);
    }
  }
  out[(size_t(b) * Hkv + hk) * G * K + i] =
      from_float<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int G, int K, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, Rows rows,
                   void* out, void* work, int B, int Hkv, int nsplit,
                   float scale, float softcap, cudaStream_t stream) {
  float* part = static_cast<float*>(work);
  if (nsplit > 0) {
    decode_split_kernel<T, G, K, Rows>
        <<<dim3(nsplit, Hkv, B), NW * 32, 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), rows, part, Hkv, scale, softcap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_merge_kernel<T, G, K><<<dim3(Hkv, B), G * K, 0, stream>>>(
      part, static_cast<T*>(out), Hkv, nsplit);
  return cudaGetLastError();
}

// G * K <= 512 keeps a lane's q and accumulator registers bounded
template <typename T, int G, typename Rows>
cudaError_t launch_k(int K, const void* q, const void* k,
                     const void* v, Rows rows, void* out, void* work, int B,
                     int Hkv, int nsplit, float scale, float softcap,
                     cudaStream_t stream) {
  switch (K) {
    case 32: return launch<T, G, 32>(q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, stream);
    case 64: return launch<T, G, 64>(q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, stream);
    case 128:
      if constexpr (G <= 4) return launch<T, G, 128>(q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, stream);
      return cudaErrorInvalidValue;
    case 256:
      if constexpr (G <= 2) return launch<T, G, 256>(q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows>
cudaError_t launch_g(int G, int K, const void* q, const void* k,
                     const void* v, Rows rows, void* out, void* work, int B,
                     int Hkv, int nsplit, float scale, float softcap,
                     cudaStream_t s) {
  switch (G) {
    case 1: return launch_k<T, 1>(K, q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 2: return launch_k<T, 2>(K, q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 4: return launch_k<T, 4>(K, q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    case 8: return launch_k<T, 8>(K, q, k, v, rows, out, work, B, Hkv, nsplit, scale, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}

// Both dtypes for one address policy, over rows of `extent` logical
// positions; the caller has checked shapes, types and alignment, and
// sized the workspace for its `split`, which must be P: B*Hkv*nsplit*G*
// (K + 2) floats with nsplit = ceil(extent / P).
template <typename Rows>
cudaError_t launch_dtype(int is_bf16, int G, int K, int split, const void* q,
                         const void* k, const void* v, Rows rows, void* out,
                         void* work, int B, int Hkv, int extent, float scale,
                         float softcap, void* stream) {
  if (split != P) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int nsplit = (extent + P - 1) / P;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_g<__nv_bfloat16>(G, K, q, k, v, rows, out, work, B,
                                   Hkv, nsplit, scale, softcap, s);
  return launch_g<float>(G, K, q, k, v, rows, out, work, B, Hkv, nsplit,
                         scale, softcap, s);
}

}  // namespace decode_split_detail
