// What the float32 and bfloat16 bodies of the attention gradient share
// (flash_attention_bwd.cu, flash_attention_bwd_bf16.cu): the tile sizes,
// the delta row pass, and p and ds from the recomputed scores on mma C
// fragments (whose layout m16n8k16 and m16n8k8 share, mma.cuh). Each source
// compiles its own copy (an unnamed namespace), so the two build in
// parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int GT = 128;  // threads of a warp group: four warps
constexpr int NT = 256;  // the delta and dk/dv passes' threads
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// sum over the 32 lanes of a warp
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// delta[b, h, i] = sum_c dout[b, i, h, c] * out[b, i, h, c] in float32 (a
// bfloat16 out and dout read as float32): one warp a row
template <typename T>
__global__ void __launch_bounds__(NT)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int Sq, int H,
                 int Kv) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* o = out + r * Kv;
  const T* d = dout + r * Kv;
  float acc = 0.f;
  for (int c = lane; c < Kv; c += 32)
    acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    // r = (b * Sq + i) * H + h
    const long long h = r % H, bi = r / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         int B, int Sq, int H, int Kv, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  const int per = NT / 32;
  delta_kernel<T><<<unsigned((rows + per - 1) / per), NT, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, rows,
      Sq, H, Kv);
  return cudaGetLastError();
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(GT) : "memory");
}

// p and ds in place of s and dp, on C fragments of 16 query rows (rows
// row0 + gr, row0 + gr + 8) against NN n8 tiles of keys from key0:
// p = exp2(x - lse2) where visible (0 elsewhere), x the scaled (capped)
// score in log2 units as the forward computes it; ds = p (dp - delta)
// (* (1 - t^2) under a cap t)
template <int NN>
__device__ __forceinline__ void p_and_ds(float (&s)[NN][4], float (&dp)[NN][4],
                                         const float (&lse2)[2],
                                         const float (&dl)[2], int row0,
                                         int key0, int Sq, int Skv, int off,
                                         int causal, int window, float scale,
                                         float softcap, int gr, int tq) {
  const float scale2 = scale * LOG2E;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + gr + (e >> 1) * 8;
      const int qpos = row + off;
      const int kp = key0 + n * 8 + 2 * tq + (e & 1);
      const bool ok = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      float x, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(s[n][e] * scale / softcap);
        x = t * softcap * LOG2E;
        dcap = 1.f - t * t;
      } else {
        x = s[n][e] * scale2;
      }
      const float p = ok ? exp2f(x - lse2[e >> 1]) : 0.f;
      s[n][e] = p;
      dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * dcap;
    }
}

// the rows' lse (in log2 units) and delta
__device__ __forceinline__ void row_stats(const float* lse, const float* delta,
                                          size_t base, int row0, int Sq,
                                          float (&lse2)[2], float (&dl)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    lse2[r] = row < Sq ? lse[base + row] * LOG2E : 0.f;
    dl[r] = row < Sq ? delta[base + row] : 0.f;
  }
}

// The KV tiles a query tile's rows can see, split by parity among NG warp
// groups as the forward walks them: group grp takes `count` tiles from
// t_first, NG apart. KV tiles sit on absolute 64-key boundaries. (The
// bf16 body's; the float32 body keeps the same lines inline, where
// ptxas allocates its registers without a spill.)
struct KvTiles {
  int t_first, count;
};
__device__ __forceinline__ KvTiles kv_tiles(int q0, int Sq, int Skv,
                                            int causal, int window, int grp,
                                            int NG) {
  const int off = Skv - Sq;
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const bool any = kv_end > kv_begin;
  const int t_begin = kv_begin / BK, t_end = (kv_end + BK - 1) / BK;
  const int t_first = t_begin + ((grp - t_begin % NG) + NG) % NG;
  return {t_first,
          any && t_first < t_end ? (t_end - t_first + NG - 1) / NG : 0};
}

// The query tiles whose rows can see some key of the tile at k0: [q_begin,
// q_begin + n_q * BQ) for each of the G heads of a kv head
struct QTiles {
  int q_begin, n_q;
};
__device__ __forceinline__ QTiles q_tiles(int k0, int Sq, int Skv, int causal,
                                          int window) {
  const int off = Skv - Sq;
  const int k_last = min(k0 + BK, Skv) - 1;
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = window > 0 ? min(Sq, k_last + window - off) : Sq;
  return {q_begin, q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0};
}

}  // namespace
