// The gradient of prefill attention for Hopper (sm_90a), bfloat16: the
// body flash_attention_bwd.cu's entry point takes for bfloat16 q, k, v,
// out and dout (float32 lse from the bf16 forward, flash_attention.cu),
// writing bfloat16 dq, dk and dv.
//
// It computes what src/repro/kernels/flash_ref.py::_bwd_impl computes for
// bfloat16 inputs (what flash_attention_bwd.cu's header sets out, with the
// same masks): every sum in float32, delta = sum dO * O from out and dout
// read as float32, and each output rounded to bfloat16 once.
//
// The structure is the float32 body's: three kernels a call, the delta row
// pass, dq (a block per 64-row query tile, query head and batch row, the KV
// tiles the rows can see split by parity between two warp groups, added in
// a fixed order) and dk / dv (a block per 64-key tile, kv head and batch
// row over the G heads' query tiles). No atomics; the bits repeat from run
// to run. The five products run on the tensor cores as m16n8k16 bf16
// mma.sync into float32 accumulators (mma.cuh): S = Q.K^T and dP = dO.V^T
// with the bf16 forward's fragments and k16 order (so s is the forward's s
// bit for bit), dQ += dS.K with dS rounded to bf16 into the A fragments
// straight from its accumulators, as the forward's P goes into P.V, and
// dV += P^T.dO, dK += dS^T.Q with P, then dS, through one 64 x 64 bf16
// shared tile read back by transposed ldmatrix (FlashAttention-2's
// operands: P and dS enter their products as bf16). Tiles are staged as
// bf16 by cp.async (16-byte chunks where every staged row starts on 16
// bytes, element by element otherwise, the same bits), rows padded by 8
// elements so ldmatrix is free of bank conflicts, K zero-padded to 64,
// 128, 192 or 256 columns and Kv to 64, 128 or 256.
//
// Bound. At qwen3-0.6b's training shape (B 8, S 512, H 16, Hkv 8, K = Kv =
// 128, causal) the function reads q, k, v, out, dout (bf16) and lse and
// writes dq, dk, dv (bf16): 100.8 MB, 0.030 ms at 3.35 TB/s, against
// 2 * pairs * (3K + 2Kv) = 21.5 GFLOP, 0.022 ms at 989 TFLOP/s: bound by
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;             // bf16 of padding a shared row
constexpr int LDP = BK + PAD;      // the dk/dv pass's P / dS tile row

// Shared memory (bf16 rows width + PAD apart) of the dq pass: Q and dO
// tiles, then each warp group's K and V tiles; of the dk/dv pass: K, V, Q
// and dO tiles and the P / dS tile
constexpr size_t dq_group_bytes(int KP, int KVP) {
  return sizeof(bf16) * size_t(BK) * (KP + PAD + KVP + PAD);
}
constexpr size_t dq_smem_bytes(int KP, int KVP, int NG) {
  return sizeof(bf16) * size_t(BQ) * (KP + PAD + KVP + PAD) +
         NG * dq_group_bytes(KP, KVP);
}
constexpr size_t dkdv_smem_bytes(int KP, int KVP) {
  return sizeof(bf16) * (size_t(BK + BQ) * (KP + PAD + KVP + PAD) +
                         size_t(BQ) * LDP);
}
// two warp groups wherever their tiles fit (every shape: the widest, K =
// Kv = 256, takes 202752 bytes)
constexpr int dq_groups(int KP, int KVP) {
  return dq_smem_bytes(KP, KVP, 2) <= MAX_SMEM ? 2 : 1;
}

__device__ __forceinline__ void store_pair(bf16* p, int col, int width,
                                           float x0, float x1, bool pairs) {
  if (pairs && col + 1 < width) {
    *reinterpret_cast<uint32_t*>(p + col) = mma::pack_bf16(x0, x1);
  } else {
    if (col < width) p[col] = __float2bfloat16(x0);
    if (col + 1 < width) p[col + 1] = __float2bfloat16(x1);
  }
}

// dq: KP, KVP the tiles' widths, NG warp groups of four warps, each warp
// 16 query rows of the tile
template <int KP, int KVP, int NG>
__global__ void __launch_bounds__(GT * NG)
    dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Sq, int Skv, int H, int Hkv, int K, int Kv, int causal,
                   int window, float scale, float softcap, int vec) {
  constexpr int LDK = KP + PAD, LDV = KVP + PAD;
  constexpr int NQ = KP / 8;  // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LDK
  bf16* dos = qs + BQ * LDK;                      // BQ x LDV

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, wg = warp % 4, gtid = tid % GT;
  const int gr = lane / 4, tq = lane % 4;
  const int off = Skv - Sq;
  bf16* ks = dos + BQ * LDV + grp * BK * (LDK + LDV);  // this group's K
  bf16* vs = ks + BK * LDK;                            // and V

  const KvTiles tiles = kv_tiles(q0, Sq, Skv, causal, window, grp, NG);
  const int t_first = tiles.t_first, count = tiles.count;

  const size_t kv_row = size_t(b) * Skv;
  auto load_k = [&](int k0) {
    mma::load_tile<BK, GT>(ks, LDK, k + ((kv_row + k0) * Hkv + hk) * K,
                           size_t(Hkv) * K, Skv - k0, K, KP, vec, gtid);
  };
  auto load_v = [&](int k0) {
    mma::load_tile<BK, GT>(vs, LDV, v + ((kv_row + k0) * Hkv + hk) * Kv,
                           size_t(Hkv) * Kv, Skv - k0, Kv, KVP, vec, gtid);
  };
  const size_t q_row = size_t(b) * Sq + q0;
  mma::load_tile<BQ, GT * NG>(qs, LDK, q + (q_row * H + h) * K,
                              size_t(H) * K, Sq - q0, K, KP, vec, tid);
  mma::load_tile<BQ, GT * NG>(dos, LDV, dout + (q_row * H + h) * Kv,
                              size_t(H) * Kv, Sq - q0, Kv, KVP, vec, tid);
  if (count > 0) {
    load_k(t_first * BK);
    load_v(t_first * BK);
  }
  mma::cp_async_commit();

  const int r_lo = q0 + wg * 16;
  float lse2[2], dl[2];
  row_stats(lse, delta, (size_t(b) * H + h) * Sq, r_lo + gr, Sq, lse2, dl);
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* qa = qs + wg * 16 * LDK;
  const bf16* doa = dos + wg * 16 * LDV;

  mma::cp_async_wait<0>();
  __syncthreads();  // Q, dO and each group's first K and V
  for (int i = 0; i < count; ++i) {
    const int k0 = (t_first + i * NG) * BK;
    if (i > 0) {
      mma::cp_async_wait<0>();
      group_sync(grp);  // K(i) and V(i) landed
    }
    float s[8][4], dp[8][4];
    mma::rows_dot_bf16<8, KP>(s, qa, LDK, ks, LDK);      // S = Q.K^T
    mma::rows_dot_bf16<8, KVP>(dp, doa, LDV, vs, LDV);   // dP = dO.V^T
    group_sync(grp);  // V read: the next tile's V may land
    if (i + 1 < count) load_v(k0 + NG * BK);
    mma::cp_async_commit();
    p_and_ds<8>(s, dp, lse2, dl, r_lo, k0, Sq, Skv, off, causal, window,
                scale, softcap, gr, tq);
    // dQ += dS.K: dS from its accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      mma::c_to_a_bf16(dp[2 * kk], dp[2 * kk + 1], a);
      mma::mma_bf16_kmajor<NQ>(acc, a, ks + kk * 16 * LDK, LDK);
    }
    group_sync(grp);  // K read: the next tile's K may land
    if (i + 1 < count) load_k(k0 + NG * BK);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<0>();

  if constexpr (NG == 2) {
    // group 1 hands its dQ to group 0 through the (now idle) K and V tiles
    // of both groups; group 0 adds it after its own
    float* xch = reinterpret_cast<float*>(dos + BQ * LDV) +
                 (wg * 32 + lane) * NQ * 4;
    __syncthreads();
    if (grp == 1) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xch[n * 4 + e] = acc[n][e];
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += xch[n * 4 + e];
  }

  const bool pairs = (K & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + gr + r * 8;
    if (row >= Sq) continue;
    bf16* o = dq + ((size_t(b) * Sq + row) * H + h) * K;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      store_pair(o, n * 8 + 2 * tq, K, acc[n][2 * r] * scale,
                 acc[n][2 * r + 1] * scale, pairs);
  }
}

// dk and dv: eight warps. For S and dP warp w takes query rows (w % 4) * 16
// of the tile against keys (w / 4) * 32; for dK and dV keys (w % 4) * 16
// and half (w / 4) of the columns. No minimum of blocks an SM: held to
// two (128 registers a thread), the tiles the registry reaches spilled
// 40 to 236 bytes.
template <int KP, int KVP>
__global__ void __launch_bounds__(NT)
    dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int K, int Kv, int causal, int window, float scale,
                     float softcap, int vec) {
  constexpr int LDK = KP + PAD, LDV = KVP + PAD;
  constexpr int NKH = KP / 16, NVH = KVP / 16;  // n8 tiles a column half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LDK
  bf16* vs = ks + BK * LDK;                       // BK x LDV
  bf16* qs = vs + BK * LDV;                       // BQ x LDK
  bf16* dos = qs + BQ * LDK;                      // BQ x LDV
  bf16* ps = dos + BQ * LDV;                      // BQ x LDP: P, then dS

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int gr = lane / 4, tq = lane % 4;
  const int off = Skv - Sq;

  const size_t kv_row = size_t(b) * Skv + k0;
  mma::load_tile<BK, NT>(ks, LDK, k + (kv_row * Hkv + hk) * K,
                         size_t(Hkv) * K, Skv - k0, K, KP, vec, tid);
  mma::load_tile<BK, NT>(vs, LDV, v + (kv_row * Hkv + hk) * Kv,
                         size_t(Hkv) * Kv, Skv - k0, Kv, KVP, vec, tid);

  // items j = g * n_q + t: the G heads' query tiles that see this tile
  const QTiles qt = q_tiles(k0, Sq, Skv, causal, window);
  const int q_begin = qt.q_begin, n_q = qt.n_q;
  const int items = G * n_q;
  auto item_q0 = [&](int j) { return q_begin + (j % n_q) * BQ; };
  auto item_h = [&](int j) { return hk * G + j / n_q; };
  auto load_q = [&](int j) {
    const int q0 = item_q0(j), h = item_h(j);
    mma::load_tile<BQ, NT>(qs, LDK, q + ((size_t(b) * Sq + q0) * H + h) * K,
                           size_t(H) * K, Sq - q0, K, KP, vec, tid);
  };
  auto load_do = [&](int j) {
    const int q0 = item_q0(j), h = item_h(j);
    mma::load_tile<BQ, NT>(dos, LDV,
                           dout + ((size_t(b) * Sq + q0) * H + h) * Kv,
                           size_t(H) * Kv, Sq - q0, Kv, KVP, vec, tid);
  };
  if (items > 0) {
    load_q(0);
    load_do(0);
  }
  mma::cp_async_commit();

  float dka[NKH][4], dva[NVH][4];
#pragma unroll
  for (int n = 0; n < NKH; ++n) dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NVH; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  const int ck = wc * (KP / 2), cv = wc * (KVP / 2);   // column halves
  bf16* pw = ps + (wr * 16 + gr) * LDP + wc * 32 + 2 * tq;  // C fragments
  auto store_c = [&](const float (&c)[4][4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(pw + n * 8) = mma::pack_bf16(c[n][0], c[n][1]);
      *reinterpret_cast<uint32_t*>(pw + 8 * LDP + n * 8) =
          mma::pack_bf16(c[n][2], c[n][3]);
    }
  };

  for (int j = 0; j < items; ++j) {
    const int q0 = item_q0(j), h = item_h(j);
    float lse2[2], dl[2];
    row_stats(lse, delta, (size_t(b) * H + h) * Sq, q0 + wr * 16 + gr, Sq,
              lse2, dl);
    mma::cp_async_wait<0>();
    __syncthreads();  // Q and dO of item j (and K, V) landed
    float s[4][4], dp[4][4];
    mma::rows_dot_bf16<4, KP>(s, qs + wr * 16 * LDK, LDK,
                              ks + wc * 32 * LDK, LDK);      // S = Q.K^T
    mma::rows_dot_bf16<4, KVP>(dp, dos + wr * 16 * LDV, LDV,
                               vs + wc * 32 * LDV, LDV);     // dP = dO.V^T
    p_and_ds<4>(s, dp, lse2, dl, q0 + wr * 16, k0 + wc * 32, Sq, Skv, off,
                causal, window, scale, softcap, gr, tq);
    store_c(s);
    __syncthreads();  // P stored
    // dV += P^T.dO over the tile's 64 query rows
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_at(a, ps + kk * 16 * LDP + wr * 16, LDP);
      mma::mma_bf16_kmajor<NVH>(dva, a, dos + kk * 16 * LDV + cv, LDV);
    }
    __syncthreads();  // P and dO read
    if (j + 1 < items) load_do(j + 1);
    mma::cp_async_commit();
    store_c(dp);
    __syncthreads();  // dS stored
    // dK += dS^T.Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_at(a, ps + kk * 16 * LDP + wr * 16, LDP);
      mma::mma_bf16_kmajor<NKH>(dka, a, qs + kk * 16 * LDK + ck, LDK);
    }
    __syncthreads();  // dS and Q read
    if (j + 1 < items) load_q(j + 1);
    mma::cp_async_commit();
  }

  const bool pairs = (K & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + wr * 16 + gr + r * 8;
    if (kp >= Skv) continue;
    const size_t at = (size_t(b) * Skv + kp) * Hkv + hk;
#pragma unroll
    for (int n = 0; n < NKH; ++n)
      store_pair(dk + at * K, ck + n * 8 + 2 * tq, K, dka[n][2 * r] * scale,
                 dka[n][2 * r + 1] * scale, pairs);
#pragma unroll
    for (int n = 0; n < NVH; ++n)
      store_pair(dv + at * Kv, cv + n * 8 + 2 * tq, Kv, dva[n][2 * r],
                 dva[n][2 * r + 1], true);
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  bf16 *dq, *dk, *dv;
  float* delta;
  int B, Sq, Skv, H, Hkv, K, Kv, causal, window;
  float scale, softcap;
  int vec;
  cudaStream_t stream;
};

template <int KP, int KVP>
cudaError_t launch_passes(const Args& a) {
  if (a.Sq > 0) {
    constexpr int NG = dq_groups(KP, KVP);
    constexpr size_t smem = dq_smem_bytes(KP, KVP, NG);
    static_assert(smem <= MAX_SMEM, "bf16 dq tiles exceed shared memory");
    cudaError_t err = cudaFuncSetAttribute(
        dq_bf16_kernel<KP, KVP, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    dq_bf16_kernel<KP, KVP, NG><<<grid, GT * NG, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.Sq, a.Skv, a.H,
        a.Hkv, a.K, a.Kv, a.causal, a.window, a.scale, a.softcap, a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Skv == 0) return cudaSuccess;
  constexpr size_t smem = dkdv_smem_bytes(KP, KVP);
  static_assert(smem <= MAX_SMEM, "bf16 dk/dv tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_bf16_kernel<KP, KVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.Hkv, a.B);
  dkdv_bf16_kernel<KP, KVP><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.Sq, a.Skv, a.H,
      a.Hkv, a.K, a.Kv, a.causal, a.window, a.scale, a.softcap, a.vec);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const Args& a) {
  if (a.Kv <= 64) return launch_passes<KP, 64>(a);
  if (a.Kv <= 128) return launch_passes<KP, 128>(a);
  return launch_passes<KP, 256>(a);
}

}  // namespace

// Called by flash_attention_bwd_launch for bfloat16 (B, H > 0): the delta
// pass, then dq and dk / dv.
int flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const float* lse, const void* dout,
                                    void* dq, void* dk, void* dv,
                                    float* delta, int B, int Sq, int Skv,
                                    int H, int Hkv, int K, int Kv, int causal,
                                    int window, float scale, float softcap,
                                    cudaStream_t stream) {
  // whole 16-byte chunks by cp.async where every staged row starts on 16
  // bytes (Kv is a multiple of 16)
  const int vec =
      K % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               lse, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), delta, B, Sq, Skv, H, Hkv, K, Kv,
               causal, window, scale, softcap, vec, stream};
  if (Sq > 0) {
    const cudaError_t err =
        launch_delta<bf16>(out, dout, delta, B, Sq, H, Kv, stream);
    if (err != cudaSuccess) return err;
  }
  if (K <= 64) return launch_kp<64>(a);
  if (K <= 128) return launch_kp<128>(a);
  if (K <= 192) return launch_kp<192>(a);
  if (K <= 256) return launch_kp<256>(a);
  return cudaErrorInvalidValue;
}
