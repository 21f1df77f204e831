// The gradient of prefill attention for Hopper (sm_90a), float32; the
// bfloat16 body is flash_attention_bwd_bf16.cu, behind the same entry point.
//
// Replaces no Pallas kernel: JAX trains through the custom VJP of its jnp
// flash path, src/repro/kernels/flash_ref.py::_bwd_impl, and the port's
// forward kernels (flash_attention.cu) have no gradient of their own. It
// computes what _bwd_impl computes, with the forward's masks (causal,
// window, softcap, queries right-aligned against the keys at offset
// Skv - Sq, ragged tails, GQA with query head h reading kv head
// h / (H / Hkv), K != Kv):
//
//   p     = exp(s - lse)               s the (capped) scaled score, 0 masked
//   delta = sum_c dO * O               a row
//   ds    = p * (dO . V^T - delta)     (* (1 - t^2) under a softcap t)
//   dQ    = scale * ds . K
//   dK    = scale * ds^T . Q           summed over the G heads of a kv head
//   dV    = p^T . dO                   summed likewise
//
// with lse the forward's per-row log-sum-exp (B, H, Sq), which the float32
// forward body writes when asked (flash_attention.cu).
//
// Layout: q (B, Sq, H, K), k (B, Skv, Hkv, K), v (B, Skv, Hkv, Kv), out and
// dout (B, Sq, H, Kv), lse and the delta workspace (B, H, Sq), dq, dk, dv
// as q, k, v; all float32, contiguous.
//
// Three kernels a call, as the TPU reference's two passes plus its row
// pass: delta (one warp a row); dq (one block per 64-row query tile, query
// head and batch row, a loop inside the block over the KV tiles the rows
// can see, as the forward walks them); dk and dv (one block per 64-key
// tile, kv head and batch row, a loop over the G query heads of that kv
// head and, within each, over the query tiles that can see the keys). So
// every output element has one owner and is written once: no atomics,
// and the sums run in one fixed order, so the bits repeat from run to
// run.
//
// All five products run on the tensor cores as split TF32 (mma.cuh): S =
// Q.K^T, dP = dO.V^T, dQ += dS.K, dV += P^T.dO and dK += dS^T.Q, each
// operand split into hi + lo as it loads into its fragment, each product
// three mma.sync.m16n8k8 into an f32 accumulator (about 22 significant
// bits; one TF32 product would keep 11 and miss the 5e-5 gradient
// contract). Both passes recompute S with the forward body's fragments,
// k8 steps, split and order, so s is the forward's s bit for bit and p =
// exp2(s * scale * log2 e - lse * log2 e) rests on the forward's scores. A
// warp owns 16 query rows of S and dP. In the dq pass dS goes from its
// accumulators into the A fragments of dS.K with its keys permuted in each
// k8 step (no shuffle), as the forward's P does; two warp groups split the
// KV tiles by parity where their tiles fit and add their dQ in a fixed
// order. In the dk/dv pass eight warps share a query tile: P, then dS, go
// through one 64 x 64 shared tile to be read transposed as the A fragments
// of P^T.dO and dS^T.Q, and each warp owns 16 keys and half the columns
// of dK and dV. Tiles are staged as float32 by cp.async (16-byte chunks
// where every row starts on 16 bytes, element by element otherwise), rows
// width + 4 floats apart, K zero-padded to 64, 128, 192 or 256 columns and
// Kv to 64, 128 or 256 (exact zeros add nothing; the products run over the
// padded widths, so their code unrolls).
//
// Bound. The function reads q, k, v, out, dout and lse once and writes dq,
// dk and dv once, and does 2 * pairs * (3K + 2Kv) operations over the
// visible (query, key) pairs of every head (the score, dO.V^T, dq, dk and
// dv; the dq pass recomputes the first two on top). At qwen3-0.6b's
// training shape (B 8, S 512, H 16, Hkv 8, K = Kv = 128, causal) that is
// 21.5 GFLOP against 201 MB: bound by operations, 0.13 ms at the split
// TF32 rate (495 / 3 TFLOP/s), 0.32 ms at the f32 CUDA cores' 67.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "mma.cuh"

namespace {

constexpr int LDP = BK + 4;        // the dk/dv pass's P / dS tile row

// Shared memory of the dq pass: Q and dO tiles, then each warp group's K
// and V tiles; of the dk/dv pass: K, V, Q and dO tiles and the P / dS
// tile. Widths are the tiles' (KP, KVP), rows width + 4 floats apart.
constexpr size_t dq_group_bytes(int KP, int KVP) {
  return sizeof(float) * size_t(BK) * (KP + 4 + KVP + 4);
}
constexpr size_t dq_smem_bytes(int KP, int KVP, int NG) {
  return sizeof(float) * size_t(BQ) * (KP + 4 + KVP + 4) +
         NG * dq_group_bytes(KP, KVP);
}
constexpr size_t dkdv_smem_bytes(int KP, int KVP) {
  return sizeof(float) * (size_t(BK + BQ) * (KP + 4 + KVP + 4) +
                          size_t(BQ) * LDP);
}
constexpr int dq_groups(int KP, int KVP) {
  return dq_smem_bytes(KP, KVP, 2) <= MAX_SMEM ? 2 : 1;
}
// two dk/dv blocks an SM where their tiles fit twice (of 233472 bytes,
// 1024 reserved a block): registers are then held to 128 a thread
constexpr int dkdv_min_blocks(int KP, int KVP) {
  return 2 * (dkdv_smem_bytes(KP, KVP) + 1024) <= 233472 ? 2 : 1;
}

// dq: KP, KVP the tiles' widths (K rounded up to 64, 128, 192 or 256, Kv
// to 64, 128 or 256; zero columns add nothing), NG warp groups
template <int KP, int KVP, int NG>
__global__ void __launch_bounds__(GT * NG)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int K,
              int Kv, int causal, int window, float scale, float softcap,
              int vec) {
  constexpr int LDK = KP + 4, LDV = KVP + 4;
  constexpr int NQ = KP / 8;  // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // BQ x LDK
  float* dos = qs + BQ * LDK;                       // BQ x LDV

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp / 4, wg = warp % 4, gtid = tid % GT;
  const int gr = lane / 4, tq = lane % 4;
  const int off = Skv - Sq;
  float* ks = dos + BQ * LDV + grp * BK * (LDK + LDV);  // this group's K
  float* vs = ks + BK * LDK;                            // and V

  // the forward's KV tiles for this query tile, split by parity
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const bool any = kv_end > kv_begin;
  const int t_begin = kv_begin / BK, t_end = (kv_end + BK - 1) / BK;
  const int t_first = t_begin + ((grp - t_begin % NG) + NG) % NG;
  const int count = any && t_first < t_end ? (t_end - t_first + NG - 1) / NG : 0;

  const size_t kv_row = size_t(b) * Skv;
  auto load_k = [&](int k0) {
    mma::load_tile_f32<BK, GT>(ks, LDK, k + ((kv_row + k0) * Hkv + hk) * K,
                               size_t(Hkv) * K, Skv - k0, K, KP, vec, gtid);
  };
  auto load_v = [&](int k0) {
    mma::load_tile_f32<BK, GT>(vs, LDV, v + ((kv_row + k0) * Hkv + hk) * Kv,
                               size_t(Hkv) * Kv, Skv - k0, Kv, KVP, vec, gtid);
  };
  if (any) {
    const size_t q_row = size_t(b) * Sq + q0;
    mma::load_tile_f32<BQ, GT * NG>(qs, LDK, q + (q_row * H + h) * K,
                                    size_t(H) * K, Sq - q0, K, KP, vec, tid);
    mma::load_tile_f32<BQ, GT * NG>(dos, LDV, dout + (q_row * H + h) * Kv,
                                    size_t(H) * Kv, Sq - q0, Kv, KVP, vec,
                                    tid);
  }
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
  const float* qa = qs + (wg * 16 + gr) * LDK + tq;
  const float* doa = dos + (wg * 16 + gr) * LDV + tq;
  const float* kb = ks + gr * LDK + tq;
  const float* vb = vs + gr * LDV + tq;
  const float* kr = ks + 2 * tq * LDK + gr;

  mma::cp_async_wait<0>();
  __syncthreads();  // Q, dO and each group's first K and V
  for (int i = 0; i < count; ++i) {
    const int k0 = (t_first + i * NG) * BK;
    if (i > 0) {
      mma::cp_async_wait<0>();
      group_sync(grp);  // K(i) and V(i) landed
    }
    float s[8][4], dp[8][4];
    mma::rows_dot_tf32<8, KP>(s, qa, LDK, kb, LDK);      // S = Q.K^T
    mma::rows_dot_tf32<8, KVP>(dp, doa, LDV, vb, LDV);   // dP = dO.V^T
    group_sync(grp);  // V read: the next tile's V may land
    if (i + 1 < count) load_v(k0 + NG * BK);
    mma::cp_async_commit();
    p_and_ds<8>(s, dp, lse2, dl, r_lo, k0, Sq, Skv, off, causal, window,
                scale, softcap, gr, tq);
    // dQ += dS.K, dS's n8 tiles as A fragments with their keys permuted;
    // eight dQ tiles at a time
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const mma::FragA a = mma::c_to_a_tf32(dp[kk]);
#pragma unroll
      for (int c = 0; c < NQ; c += 8) {
        mma::FragB fb[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          fb[n] = mma::load_bk_tf32(kr + kk * 8 * LDK + (c + n) * 8, LDK);
        mma::mma_tf32x3(*reinterpret_cast<float(*)[8][4]>(acc[c]), a, fb);
      }
    }
    group_sync(grp);  // K read: the next tile's K may land
    if (i + 1 < count) load_k(k0 + NG * BK);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<0>();

  if constexpr (NG == 2) {
    // group 1 hands its dQ to group 0 through its own (now idle) tiles;
    // group 0 adds it after its own
    float* xch = dos + BQ * LDV + BK * (LDK + LDV) + (wg * 32 + lane) * NQ * 4;
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + gr + r * 8;
    if (row >= Sq) continue;
    float* o = dq + ((size_t(b) * Sq + row) * H + h) * K;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        if (col < K) o[col] = acc[n][2 * r + e] * scale;
      }
  }
}

// dk and dv: KP and KVP the tiles' widths, as the dq pass's. Eight warps: for S and dP
// warp w takes query rows (w % 4) * 16 of the tile against keys
// (w / 4) * 32; for dK and dV keys (w % 4) * 16 and half (w / 4) of the
// columns.
template <int KP, int KVP>
__global__ void __launch_bounds__(NT, dkdv_min_blocks(KP, KVP))
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int K,
                int Kv, int causal, int window, float scale, float softcap,
                int vec) {
  constexpr int LDK = KP + 4, LDV = KVP + 4;
  constexpr int NKH = KP / 16, NVH = KVP / 16;  // n8 tiles a column half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // BK x LDK
  float* vs = ks + BK * LDK;                        // BK x LDV
  float* qs = vs + BK * LDV;                        // BQ x LDK
  float* dos = qs + BQ * LDK;                       // BQ x LDV
  float* ps = dos + BQ * LDV;                       // BQ x LDP: P, then dS

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int gr = lane / 4, tq = lane % 4;
  const int off = Skv - Sq;

  const size_t kv_row = size_t(b) * Skv + k0;
  mma::load_tile_f32<BK, NT>(ks, LDK, k + (kv_row * Hkv + hk) * K,
                             size_t(Hkv) * K, Skv - k0, K, KP, vec, tid);
  mma::load_tile_f32<BK, NT>(vs, LDV, v + (kv_row * Hkv + hk) * Kv,
                             size_t(Hkv) * Kv, Skv - k0, Kv, KVP, vec, tid);

  // the query tiles whose rows can see some key of this tile, for each
  // of the G heads: items j = g * n_q + t
  const int k_last = min(k0 + BK, Skv) - 1;
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = window > 0 ? min(Sq, k_last + window - off) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int items = G * n_q;
  auto item_q0 = [&](int j) { return q_begin + (j % n_q) * BQ; };
  auto item_h = [&](int j) { return hk * G + j / n_q; };
  auto load_q = [&](int j) {
    const int q0 = item_q0(j), h = item_h(j);
    mma::load_tile_f32<BQ, NT>(qs, LDK,
                               q + ((size_t(b) * Sq + q0) * H + h) * K,
                               size_t(H) * K, Sq - q0, K, KP, vec, tid);
  };
  auto load_do = [&](int j) {
    const int q0 = item_q0(j), h = item_h(j);
    mma::load_tile_f32<BQ, NT>(dos, LDV,
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
  const float* qa = qs + (wr * 16 + gr) * LDK + tq;
  const float* doa = dos + (wr * 16 + gr) * LDV + tq;
  const float* kb = ks + (wc * 32 + gr) * LDK + tq;
  const float* vb = vs + (wc * 32 + gr) * LDV + tq;
  float* pw = ps + (wr * 16 + gr) * LDP + wc * 32 + 2 * tq;  // C fragments
  const float* pt = ps + 2 * tq * LDP + wr * 16 + gr;        // A of P^T
  const int ck = wc * (KP / 2), cv = wc * (KVP / 2);          // column halves
  const float* qr = qs + 2 * tq * LDK + ck + gr;
  const float* dor = dos + 2 * tq * LDV + cv + gr;

  for (int j = 0; j < items; ++j) {
    const int q0 = item_q0(j), h = item_h(j);
    float lse2[2], dl[2];
    row_stats(lse, delta, (size_t(b) * H + h) * Sq, q0 + wr * 16 + gr, Sq,
              lse2, dl);
    mma::cp_async_wait<0>();
    __syncthreads();  // Q and dO of item j (and K, V) landed
    float s[4][4], dp[4][4];
    mma::rows_dot_tf32<4, KP>(s, qa, LDK, kb, LDK);      // S = Q.K^T
    mma::rows_dot_tf32<4, KVP>(dp, doa, LDV, vb, LDV);   // dP = dO.V^T
    p_and_ds<4>(s, dp, lse2, dl, q0 + wr * 16, k0 + wc * 32, Sq, Skv, off,
                causal, window, scale, softcap, gr, tq);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(pw + n * 8) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(pw + 8 * LDP + n * 8) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();  // P stored
    // dV += P^T.dO over the tile's 64 query rows, four dV tiles at a time
#pragma unroll 2
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const mma::FragA a = mma::load_at_tf32(pt + kk * 8 * LDP, LDP);
#pragma unroll
      for (int c = 0; c < NVH; c += 4) {
        mma::FragB fb[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          fb[n] = mma::load_bk_tf32(dor + kk * 8 * LDV + (c + n) * 8, LDV);
        mma::mma_tf32x3(*reinterpret_cast<float(*)[4][4]>(dva[c]), a, fb);
      }
    }
    __syncthreads();  // P and dO read
    if (j + 1 < items) load_do(j + 1);
    mma::cp_async_commit();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(pw + n * 8) = make_float2(dp[n][0], dp[n][1]);
      *reinterpret_cast<float2*>(pw + 8 * LDP + n * 8) =
          make_float2(dp[n][2], dp[n][3]);
    }
    __syncthreads();  // dS stored
    // dK += dS^T.Q, four dK tiles at a time
#pragma unroll 2
    for (int kk = 0; kk < BQ / 8; ++kk) {
      const mma::FragA a = mma::load_at_tf32(pt + kk * 8 * LDP, LDP);
#pragma unroll
      for (int c = 0; c < NKH; c += 4) {
        mma::FragB fb[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          fb[n] = mma::load_bk_tf32(qr + kk * 8 * LDK + (c + n) * 8, LDK);
        mma::mma_tf32x3(*reinterpret_cast<float(*)[4][4]>(dka[c]), a, fb);
      }
    }
    __syncthreads();  // dS and Q read
    if (j + 1 < items) load_q(j + 1);
    mma::cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + wr * 16 + gr + r * 8;
    if (kp >= Skv) continue;
    const size_t at = (size_t(b) * Skv + kp) * Hkv + hk;
#pragma unroll
    for (int n = 0; n < NKH; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ck + n * 8 + 2 * tq + e;
        if (col < K) dk[at * K + col] = dka[n][2 * r + e] * scale;
      }
#pragma unroll
    for (int n = 0; n < NVH; ++n) {
      const int col = cv + n * 8 + 2 * tq;
      if (col < Kv)
        *reinterpret_cast<float2*>(dv + at * Kv + col) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

struct Args {
  const float *q, *k, *v, *out, *lse, *dout;
  float *dq, *dk, *dv, *delta;
  int B, Sq, Skv, H, Hkv, K, Kv, causal, window;
  float scale, softcap;
  int vec;
  cudaStream_t stream;
};

template <int KP, int KVP>
cudaError_t launch_dq(const Args& a) {
  if constexpr (dq_smem_bytes(KP, KVP, 1) > MAX_SMEM) {
    return cudaErrorInvalidValue;  // refused by the wrapper before this
  } else {
    constexpr int NG = dq_groups(KP, KVP);
    constexpr size_t smem = dq_smem_bytes(KP, KVP, NG);
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<KP, KVP, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    dq_kernel<KP, KVP, NG><<<grid, GT * NG, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.Sq, a.Skv, a.H,
        a.Hkv, a.K, a.Kv, a.causal, a.window, a.scale, a.softcap, a.vec);
    return cudaGetLastError();
  }
}

template <int KP, int KVP>
cudaError_t launch_dkdv(const Args& a) {
  if constexpr (dkdv_smem_bytes(KP, KVP) > MAX_SMEM) {
    return cudaErrorInvalidValue;  // refused by the wrapper before this
  } else {
    constexpr size_t smem = dkdv_smem_bytes(KP, KVP);
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<KP, KVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Skv + BK - 1) / BK, a.Hkv, a.B);
    dkdv_kernel<KP, KVP><<<grid, NT, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.Sq, a.Skv, a.H,
        a.Hkv, a.K, a.Kv, a.causal, a.window, a.scale, a.softcap, a.vec);
    return cudaGetLastError();
  }
}

template <int KP, int KVP>
cudaError_t launch_passes(const Args& a) {
  if (a.Sq > 0) {
    const cudaError_t err = launch_dq<KP, KVP>(a);
    if (err != cudaSuccess) return err;
  }
  if (a.Skv == 0) return cudaSuccess;
  return launch_dkdv<KP, KVP>(a);
}

template <int KP>
cudaError_t launch_kp(const Args& a) {
  if (a.Kv <= 64) return launch_passes<KP, 64>(a);
  if (a.Kv <= 128) return launch_passes<KP, 128>(a);
  return launch_passes<KP, 256>(a);
}

}  // namespace

// The bfloat16 body (flash_attention_bwd_bf16.cu), delta pass included.
int flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const float* lse, const void* dout,
                                    void* dq, void* dk, void* dv,
                                    float* delta, int* items, int B, int Sq,
                                    int Skv, int H, int Hkv, int K, int Kv,
                                    int causal, int window, float scale,
                                    float softcap, cudaStream_t stream);

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). The caller has checked shapes, types, layout and
// that the tiles fit in shared memory (kernels/flash_attention.py,
// bwd_smem_bytes), and allocated the outputs and the delta workspace
// (B, H, Sq). q, k, v, out, dout, dq, dk and dv are float32, or bfloat16
// with is_bf16; lse and delta are float32. The bfloat16 body also takes
// `items`, one int32 zeroed for the call (its walk's count of work items
// taken); the float32 body ignores it.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, int B, int Sq, int Skv, int H,
                               int Hkv, int K, int Kv, int causal, int window,
                               float scale, float softcap, int is_bf16,
                               void* items, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return flash_attention_bwd_bf16_launch(
        q, k, v, out, static_cast<const float*>(lse), dout, dq, dk, dv,
        static_cast<float*>(delta), static_cast<int*>(items), B, Sq, Skv, H,
        Hkv, K, Kv, causal, window, scale, softcap, st);
  // whole 16-byte chunks by cp.async where every staged row starts on 16
  // bytes
  const int vec =
      K % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(out),
               static_cast<const float*>(lse),
               static_cast<const float*>(dout), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta), B, Sq, Skv, H, Hkv, K, Kv, causal,
               window, scale, softcap, vec, st};
  if (Sq > 0) {
    const cudaError_t err =
        launch_delta<float>(out, dout, a.delta, B, Sq, H, Kv, st);
    if (err != cudaSuccess) return err;
  }
  // with no query row dq is empty, and dk / dv come out 0 (no item runs)
  if (K <= 64) return launch_kp<64>(a);
  if (K <= 128) return launch_kp<128>(a);
  if (K <= 192) return launch_kp<192>(a);
  if (K <= 256) return launch_kp<256>(a);
  return cudaErrorInvalidValue;
}
