// Prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// ::flash_attention (_attn_kernel): causal / sliding-window / softcapped
// attention with an online softmax and GQA (query head h reads kv head
// h / (H / Hkv)), queries right-aligned against the keys (offset Skv - Sq).
//
// Layout: q (B, Sq, H, K), k (B, Skv, Hkv, K), v (B, Skv, Hkv, Kv),
// out (B, Sq, H, Kv), all contiguous, float32 or bfloat16; scores,
// softmax statistics and the output accumulator are float32.
//
// Grid. One block per (query tile of 64 rows, query head, batch row). The
// TPU kernel carried its softmax state across a sequential grid axis of KV
// tiles; here a loop inside the block walks the KV tiles, and causal /
// window bounds skip the tiles no row of the block can see. KV tiles sit
// on absolute 64-key boundaries from position 0, so a row meets the same
// tiles in the same order whichever block holds it, and a tile wholly
// masked for a row leaves its state bit-exact (alpha = 1, p = 0): a row's
// bits depend only on its query, the keys and values and its position,
// which keeps prefix sharing (the suffix prefilled against [context |
// suffix]) bitwise equal to the whole prompt. A masked score gets an exact
// 0.0 weight, and a row that sees no key at all writes 0.
//
// Bound. Causal prefill does 2*2*B*H*pairs*K operations over
// (2*B*Sq*H*K + 2*B*Skv*Hkv*K)*itemsize bytes. At the main path's shape
// (bf16, B = 1, S = 512, H = 16, Hkv = 8, K = 128) that is 1.07 GFLOP,
// 1.09 us at the bf16 tensor-core peak, against 6.3 MB, 1.88 us at 3.35
// TB/s: bound by bytes, and either way a job of a few microseconds on 128
// blocks, one wave, so latency and the overlap of loads with math set the
// time.
//
// bfloat16 body (tc::). A warp group is four warps, each owning 16 of the
// tile's 64 query rows. Both products run on the tensor cores, mma.sync
// m16n8k16 with bf16 operands and f32 accumulation: S = Q.K^T with Q's
// fragments loaded once (ldmatrix) and kept in registers, and O += P.V
// with V's fragments by transposed ldmatrix. The softmax (scale, softcap,
// masks, running max and sum, in log2 units) works on the accumulator
// fragments in registers, each row reduced over its quad by shuffles; a
// tile every row of a warp sees whole skips the per-score mask. P goes to
// bf16 straight into the A fragments of P.V, never through shared memory.
// K and V tiles are staged as bf16 by cp.async, double-buffered, so a
// group's next tile loads while its current one computes; shared rows
// are padded by 16 bytes so ldmatrix is free of bank conflicts. Two warp
// groups (where their tiles fit in shared memory: all but K > 128 with
// Kv = 256, and K > 192 with Kv >= 128) split the KV tiles by the parity
// of their absolute index and merge their softmax states at the end in a
// fixed order: at the main shape the grid is 128 blocks, one an SM, and a
// lone group of four warps left every warp's chain of loads, products and
// exponentials bare (on an H100: 35 us a call with one group, 21 us with
// two). K is zero-padded to a multiple of 64 (exact zeros add nothing), Kv
// is one of 16, 32, 64, 112 (zamba2-7b: 14 n8 output tiles, a V row 14
// cp.async chunks), 128, 256. The causal grid starts with its heaviest
// query tiles.
// mma.sync rather than wgmma: at Sq = 512 a warpgroup's 64 rows would
// leave the grid at the same 128 blocks, and the job is too short for
// wgmma's deeper pipeline to pay. What is left: the heaviest query tile's
// block still walks all 8 KV tiles on one SM.
//
// float32 body (unchanged since the first port). Q, K and V are staged in
// shared memory as float32 (row strides padded by one word); 16 x 16
// threads each own 4 query rows x 4 key columns of the score tile and 4
// rows x Kv/16 columns of the output, all on the f32 CUDA cores. It stays
// there on purpose: TF32 tensor cores keep 10 mantissa bits and would miss
// the 2e-5 float32 parity contract. Given an `lse` pointer (training: the
// backward in flash_attention_bwd.cu reads it) it also writes each row's
// log-sum-exp m + log(max(l, 1e-30)), (B, H, Sq) float32, after the row's
// output, which it leaves bit for bit as it is with a null pointer
// (serving). The bf16 body takes no lse: no bf16 backward exists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sum / max over the 16 lanes that share a row group (lane bits 0..3)
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int K, int Kv) {
  return sizeof(float) *
         (size_t(BQ) * (K + 1) + size_t(BK) * (K + 1) + size_t(BK) * Kv +
          size_t(BQ) * (BK + 1));
}

template <typename T, int NC>  // NC = Kv / 16 output columns per thread
__global__ void __launch_bounds__(NT)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H,
                           int Hkv, int K, int causal, int window,
                           float scale, float softcap) {
  constexpr int Kv = NC * 16;
  extern __shared__ float smem[];
  const int ldq = K + 1;
  const int ldp = BK + 1;
  float* qs = smem;              // BQ x ldq
  float* ks = qs + BQ * ldq;     // BK x ldq
  float* vs = ks + BK * ldq;     // BK x Kv
  float* ps = vs + BK * Kv;      // BQ x ldp

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int off = Skv - Sq;  // right-aligned queries

  for (int i = tid; i < BQ * K; i += NT) {
    const int r = i / K, d = i % K, qp = q0 + r;
    qs[r * ldq + d] =
        qp < Sq ? to_float(q[((size_t(b) * Sq + qp) * H + h) * K + d]) : 0.f;
  }

  // keys this tile can see: causal stops at the last row's position, a
  // window starts at the oldest key the first row still sees
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * K; i += NT) {
      const int r = i / K, d = i % K, kp = k0 + r;
      ks[r * ldq + d] =
          kp < Skv ? to_float(k[((size_t(b) * Skv + kp) * Hkv + hk) * K + d])
                   : 0.f;
    }
    for (int i = tid; i < BK * Kv; i += NT) {
      const int r = i / Kv, d = i % Kv, kp = k0 + r;
      vs[r * Kv + d] =
          kp < Skv ? to_float(v[((size_t(b) * Skv + kp) * Hkv + hk) * Kv + d])
                   : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i and key columns tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < K; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = row + off;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(rmax));
      // nothing visible yet: keep the (zero) state as it is
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * ldp + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + group16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * Kv + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * ldp + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t(b) * Sq + row) * H + h) * Kv;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
    if (lse != nullptr && tx == 0)
      lse[(size_t(b) * H + h) * Sq + row] = m[i] + logf(denom);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv, int K,
                   int causal, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(K, NC * 16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, Hkv,
      K, causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kv(int Kv, const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, int Sq, int Skv, int H,
                      int Hkv, int K, int causal, int window, float scale,
                      float softcap, cudaStream_t stream) {
  switch (Kv) {
    case 16: return launch<T, 1>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 32: return launch<T, 2>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 64: return launch<T, 4>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 112: return launch<T, 7>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 128: return launch<T, 8>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 256: return launch<T, 16>(q, k, v, out, lse, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 64;   // query rows per block, 16 per warp of a group
constexpr int BK = 64;   // keys per KV tile
constexpr int GT = 128;  // threads of a warp group: four warps
constexpr int PAD = 8;   // bf16 of padding a shared row: ldmatrix's eight
                         // 16-byte row reads then hit distinct banks
constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Q, then each warp group's double-buffered K and V tiles
constexpr size_t group_bytes(int KP, int KV) {
  return sizeof(bf16) * 2 * size_t(BK) * (KP + PAD + KV + PAD);
}
constexpr size_t smem_bytes(int KP, int KV, int NG) {
  return sizeof(bf16) * size_t(BQ) * (KP + PAD) + NG * group_bytes(KP, KV);
}
// two warp groups wherever their tiles fit in shared memory
constexpr int groups(int KP, int KV) {
  return smem_bytes(KP, KV, 2) <= MAX_SMEM ? 2 : 1;
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(GT) : "memory");
}

// KP: K rounded up to a multiple of 64 (zero columns add nothing), KV: Kv.
// NG warp groups share the block's query tile and split its KV tiles by
// the parity of their absolute index (group g takes the tiles t with
// t % NG == g), each walking its own in order with its own softmax state;
// the groups' states merge at the end in a fixed order. Where each tile
// goes depends on its position alone, so a row's bits still do not
// depend on Sq or on where the row falls, and twice the warps hide the
// latency of a chain that four warps an SM leave bare.
template <int KP, int KV>
__global__ void __launch_bounds__(GT * groups(KP, KV))
    flash_attention_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out,
                              int Sq, int Skv, int H, int Hkv, int K, int causal,
                              int window, float scale, float softcap, int vec) {
  constexpr int NG = groups(KP, KV);
  constexpr int LDK = KP + PAD, LDV = KV + PAD;
  constexpr int KSTEPS = KP / 16;  // depth steps of Q.K^T
  constexpr int NO = KV / 8;       // n8 tiles of the output
  // Q's fragments stay in registers unless they and the output
  // accumulator together would crowd the 255 a thread may hold (Kv = 256,
  // or K > 128 with Kv = 128): then they are reloaded from shared memory
  // each tile
  constexpr bool QREG = KP / 4 + KV / 2 <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LDK

  // the causal grid's heaviest query tiles (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, wg = warp % 4, gtid = tid % GT;
  const int gr = lane / 4, tq = lane % 4;
  const int off = Skv - Sq;  // right-aligned queries
  // this group's double-buffered K (2 x BK x LDK), then V (2 x BK x LDV)
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + sizeof(bf16) * BQ * LDK +
                                     grp * group_bytes(KP, KV));
  bf16* vs = ks + 2 * BK * LDK;

  // the same tile bounds as the float32 body: KV tiles on absolute
  // boundaries from position 0, so a row meets the same tiles whatever
  // block it is in (tiles wholly masked for it leave its state exact)
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const bool any = kv_end > kv_begin;
  const int t_begin = kv_begin / BK, t_end = (kv_end + BK - 1) / BK;
  const int t_first = t_begin + ((grp - t_begin % NG) + NG) % NG;
  const int count = any && t_first < t_end ? (t_end - t_first + NG - 1) / NG : 0;

  const size_t k_ld = size_t(Hkv) * K, v_ld = size_t(Hkv) * KV;
  auto load_kv = [&](int k0, int buf) {
    mma::load_tile<BK, GT>(ks + buf * BK * LDK, LDK,
                           k + ((size_t(b) * Skv + k0) * Hkv + hk) * K, k_ld,
                           Skv - k0, K, KP, vec, gtid);
    mma::load_tile<BK, GT>(vs + buf * BK * LDV, LDV,
                           v + ((size_t(b) * Skv + k0) * Hkv + hk) * KV, v_ld,
                           Skv - k0, KV, KV, vec, gtid);
  };
  if (any)
    mma::load_tile<BQ, GT * NG>(qs, LDK,
                                q + ((size_t(b) * Sq + q0) * H + h) * K,
                                size_t(H) * K, Sq - q0, K, KP, vec, tid);
  if (count > 0) load_kv(t_first * BK, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();  // Q and each group's first tile

  // rows gr and gr + 8 of this warp's 16: running max (log2 units), sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qf[QREG ? KSTEPS : 1][4];
  const bf16* q_row = qs + (wg * 16 + (lane & 15)) * LDK + (lane >> 4) * 8;
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) mma::ldsm_x4(qf[kk], q_row + kk * 16);
  }
  const float scale2 = scale * LOG2E;
  const int r_lo = q0 + wg * 16, r_hi = r_lo + 15;

  for (int i = 0; i < count; ++i) {
    const int k0 = (t_first + i * NG) * BK, buf = i & 1;
    if (i + 1 < count) {  // the group's next tile loads while this computes
      load_kv(k0 + NG * BK, buf ^ 1);
      mma::cp_async_commit();
    }
    const bf16* kb = ks + buf * BK * LDK;
    const bf16* vb = vs + buf * BK * LDV;

    // S = Q.K^T: 16 rows x 64 keys a warp, eight n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
      } else {
        mma::ldsm_x4(a, q_row + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        mma::ldsm_x4(bk, kb + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDK +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale (to log2 units), softcap, mask; the online softmax on the
    // fragments, each row reduced over its quad (lanes 4 gr .. 4 gr + 3)
    // in one fixed order. A tile every row of the warp sees whole skips
    // the per-score mask.
    const bool whole = k0 + BK <= Skv && r_hi < Sq &&
                       (!causal || k0 + BK - 1 <= r_lo + off) &&
                       (window <= 0 || k0 > r_hi + off - window);
    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (softcap > 0.f)
          x = tanhf(s[n][e] * scale / softcap) * softcap * LOG2E;
        else
          x = s[n][e] * scale2;
        if (!whole) {
          const int row = r_lo + gr + (e >> 1) * 8;
          const int qpos = row + off;
          const int kp = k0 + n * 8 + 2 * tq + (e & 1);
          const bool ok = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                          (window <= 0 || kp > qpos - window);
          x = ok ? x : -INFINITY;
        }
        s[n][e] = x;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
      rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
      const float m_new = fmaxf(m_run[r], rmax[r]);
      // nothing visible yet: keep the (zero) state as it is
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
    uint32_t pa[4][4];  // P as the A fragments of P.V, four k16 steps
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[n][e] == -INFINITY ? 0.f : exp2f(s[n][e] - m_run[e >> 1]);
        rsum[e >> 1] += p[e];
      }
      pa[n / 2][(n & 1) * 2] = mma::pack_bf16(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P.V, V's fragments by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        mma::ldsm_x4_t(bv, vb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                    LDV + np * 16 + (lane >> 4) * 8);
        mma::mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
        mma::mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    if (i + 1 < count) mma::cp_async_wait<0>();
    group_sync(grp);  // the next tile landed; this buffer is free again
  }

  if constexpr (NG == 2) {
    // group 1 hands its rows' (max, sum, output) to group 0 through its
    // own (now idle) tile buffers; group 0 merges them after its own
    constexpr int W = NO * 4 + 4;
    float* xch = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * BQ * LDK +
                                          group_bytes(KP, KV)) +
                 (wg * 32 + lane) * W;
    __syncthreads();
    if (grp == 1) {
      xch[0] = m_run[0];
      xch[1] = m_run[1];
      xch[2] = l_run[0];
      xch[3] = l_run[1];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[4 + n * 4 + e] = o[n][e];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xch[r], l1 = xch[2 + r];
      const float m = fmaxf(m_run[r], m1);
      const float a0 = m_run[r] == -INFINITY ? 0.f : exp2f(m_run[r] - m);
      const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - m);
      l_run[r] = l_run[r] * a0 + l1 * a1;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[n][2 * r + e] =
              o[n][2 * r + e] * a0 + xch[4 + n * 4 + 2 * r + e] * a1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + gr + r * 8;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    bf16* orow = out + ((size_t(b) * Sq + row) * H + h) * KV + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          mma::pack_bf16(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int KP, int KV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int K, int causal,
                   int window, float scale, float softcap, int vec,
                   cudaStream_t stream) {
  constexpr int NG = groups(KP, KV);
  constexpr size_t smem = smem_bytes(KP, KV, NG);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<KP, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_tc_kernel<KP, KV><<<grid, GT * NG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, Hkv,
      K, causal, window, scale, softcap, vec);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kv(int Kv, const void* q, const void* k, const void* v,
                      void* out, int B, int Sq, int Skv, int H, int Hkv, int K,
                      int causal, int window, float scale, float softcap,
                      int vec, cudaStream_t stream) {
  switch (Kv) {
    case 16: return launch<KP, 16>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    case 32: return launch<KP, 32>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    case 64: return launch<KP, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    case 112: return launch<KP, 112>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    case 128: return launch<KP, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    case 256: return launch<KP, 256>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int Hkv,
                        int K, int Kv, int causal, int window, float scale,
                        float softcap, cudaStream_t stream) {
  // whole 16-byte chunks by cp.async where every row starts on 16 bytes
  const int vec =
      K % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (K <= 64)
    return launch_kv<64>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
  if (K <= 128)
    return launch_kv<128>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
  if (K <= 192)
    return launch_kv<192>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
  if (K <= 256)
    return launch_kv<256>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout.
// `lse` is null in serving; the float32 body writes it where given, and
// the bf16 body refuses one.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Sq, int Skv,
                           int H, int Hkv, int K, int Kv, int causal,
                           int window, float scale, float softcap,
                           int is_bf16, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (lse != nullptr) return cudaErrorInvalidValue;
    return tc::launch_bf16(q, k, v, out, B, Sq, Skv, H, Hkv, K, Kv, causal,
                           window, scale, softcap, s);
  }
  return launch_kv<float>(Kv, q, k, v, out, static_cast<float*>(lse), B, Sq,
                          Skv, H, Hkv, K, causal, window, scale, softcap, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
