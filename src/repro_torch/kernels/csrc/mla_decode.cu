// Absorbed-MLA decode attention in the latent space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mla_decode.py
// ::mla_decode_ctx (_mla_kernel): one query token per sequence attends to
// the LATENT cache of DeepSeek's multi-head latent attention. Head h
// scores position j as scale * (q_lat[h]·ckv[j] + q_rope[h]·k_rope[j]),
// the scores are masked by `valid` and soft-maxed over the positions, and
// the context is the weighted sum of the same latent rows, ctx[h] =
// sum_j w[h, j] * ckv[j] (the caller applies W_uv and W_o). The Pallas
// kernel reads each latent tile from memory once and uses it for both
// products; so does this one.
//
// Layout: q_lat (B, H, r), q_rope (B, H, dr), ckv (B, S, r),
// k_rope (B, S, dr), valid (B, S) bool, out (B, H, r), all contiguous,
// ckv 16-byte aligned; q, cache and out float32 or bfloat16 (one type);
// softmax statistics and sums in float32.
//
// Bound. A call reads each live latent and rope row once and does
// 2 * H * (2r + dr) operations a live position: bound by device-memory
// bytes. At the main shape (bf16, B = 4, S = 2048, H = 16, r = 512,
// dr = 64, rows live to 48 / 160 / 300 / 544, 1052 live positions) that
// is 1,359,360 B, 0.000406 ms at 3.35 TB/s, against 0.037 GFLOP. At that
// size a call is latency-bound instead: two launches, and in each live
// block a chain of staging, two products and a softmax. Only 18 blocks
// are live there, on 132 SMs, so the call waits for one block's chain:
// the bf16 body keeps that chain short (one staging pass, the products
// on the tensor cores) rather than cutting the work into more blocks.
//
// Two passes, both dtypes. The split pass runs one block per (split of
// P = 64 absolute positions, batch row): the TPU kernel's sequential grid
// axis over cache tiles becomes a parallel split over positions. A block
// first reads its 64 valid flags; a split with no live position writes
// max = -inf and returns, reading nothing else. A live split leaves each
// head's unnormalised context and (max, normaliser) in a float32
// workspace. The merge pass (one block per (head, row)) collects the
// row's live splits from their maxima, loads their contexts in batches
// with the loads in flight together, and sums them in split order; a row
// with no live position writes 0. A split's arithmetic depends on its
// own positions only and the merge adds only live splits, in order, so a
// row's bits depend on its live positions alone: horizons of 512 and
// 2048, and the dense cache and the paged cache's gathered view, give the
// same bits. A dead position is never loaded (its shared row is
// zero-filled) and gets a weight of exactly 0, so whatever the cache
// holds there (NaN included) it adds exactly 0.0.
//
// bfloat16 split body (tc::), on the tensor cores. At deepseek's widths
// both products have M = H = 16 rows, the M of mma.sync.m16n8k16, so
// the heads are the MMA rows (H < 16 pads them with zero rows). The block
// (4 warps) stages its live ckv rows (64 x r), k_rope rows (64 x dr,
// zero-padded along k to a multiple of 16) and q_lat / q_rope (16 rows)
// into shared memory as bf16 by cp.async, dead rows and pad as zeros.
// Scores S (16 x 64) = q_lat.ckv^T + q_rope.k_rope^T:
// warp w takes positions 16w .. 16w + 15 over all of k = r + dr, B
// fragments straight from the row-major staged rows by ldmatrix. Softmax
// on the fragments: scale, dead positions -inf, the per-head max and sum
// across the four warps through a few floats of shared memory,
// P = exp(S - m) with exactly 0 at dead positions, rounded to bf16 into
// shared memory (the normaliser sums the rounded weights). Context
// O (16 x r) = P.ckv: warp w takes r / 4 columns over the 64 positions,
// reading the same staged ckv by transposed ldmatrix; the accumulators
// (r / 8 floats a lane) stay in registers. Each staged tile is read from
// shared memory once for S and once for O, in bf16: the CUDA-core body
// below, which serving ran before, had each of 16 head-warps read a
// float32 copy of the tile twice.
//
// float32 split body, on the CUDA cores (TF32 tensor cores keep 10
// mantissa bits and would miss the 2e-5 float32 parity contract; serving
// runs bf16). One warp per head (H <= 16) walks its split in tiles of
// TS = 32: each tile's live latent and rope rows are staged as float32 in
// shared memory and read by every head-warp, lane p scoring position p
// against the head's query, then the warp's online softmax and the
// weighted rows added into the r / 32 context elements each lane keeps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int P = 64;        // positions a split block takes
constexpr int MAX_H = 16;    // heads a call
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 w;
  w.x = mma::pack_bf16(v.x, v.y);
  w.y = mma::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = w;
}

// ---------------------------------------------------------------------------
// bfloat16 split body on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;        // warps a block
constexpr int NT = NW * 32;
constexpr int HM = 16;       // MMA rows: the heads, zero-padded
constexpr int PAD = 8;       // bf16 of padding a shared row: ldmatrix's
                             // eight 16-byte row reads hit distinct banks
constexpr int LDP = P + PAD;

// ckv and q_lat rows (r + PAD), k_rope and q_rope rows (drp + PAD), P,
// then the per-warp maxima and sums and the live flags
size_t smem_bytes(int r, int drp) {
  return sizeof(bf16) * (size_t(P + HM) * (r + PAD) +
                         size_t(P + HM) * (drp + PAD) + size_t(HM) * LDP) +
         sizeof(float) * 2 * NW * HM + sizeof(int) * P;
}

// The split's P cache rows (g_ld elements apart), cols_pad columns (a
// multiple of 8), into shared memory: a live row's whole 16-byte chunks
// by cp.async where `vec` (the caller commits and waits), its ragged
// chunk by plain loads; dead rows, columns >= cols and rows past the
// split are zeros, and nothing of a dead row is read
__device__ __forceinline__ void stage_rows(bf16* s, int s_ld, const bf16* g,
                                           int g_ld, const int* live,
                                           int cols_pad, int cols, bool vec,
                                           int tid) {
  const int ch = cols_pad / 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < P * ch; i += NT) {
    const int p = i / ch, c = (i % ch) * 8;
    bf16* dst = s + p * s_ld + c;
    const bool ok = live[p];
    const bf16* src = g + size_t(p) * g_ld + c;
    if (vec && c + 8 <= cols) {
      mma::cp_async16(dst, ok ? src : g, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = ok && c + e < cols ? src[e] : zero;
    }
  }
}

// Block (split, row b): positions [split * P, split * P + P). NO = r / 32
// n8 tiles of the context a warp (its r / 4 columns). Leaves part[b,
// split, h, :r] and ml[b, split, h, 0:2] (max, normaliser) for h < H.
template <int R>
__global__ void __launch_bounds__(NT)
    mla_partial_kernel(const bf16* __restrict__ q_lat,
                       const bf16* __restrict__ q_rope,
                       const bf16* __restrict__ ckv,
                       const bf16* __restrict__ k_rope,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ part, int S, int H, int dr,
                       float scale, int vec_q, int vec_qr, int vec_kr) {
  constexpr int LDC = R + PAD;
  constexpr int NO = R / 32;
  const int drp = (dr + 15) / 16 * 16, ldr = drp + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ckv_s = reinterpret_cast<bf16*>(smem_raw);  // P x LDC
  bf16* ql_s = ckv_s + P * LDC;                      // HM x LDC
  bf16* kr_s = ql_s + HM * LDC;                      // P x ldr
  bf16* qr_s = kr_s + P * ldr;                       // HM x ldr
  bf16* p_s = qr_s + HM * ldr;                       // HM x LDP
  float* red_m = reinterpret_cast<float*>(p_s + HM * LDP);  // NW x HM
  float* red_l = red_m + NW * HM;                           // NW x HM
  int* live_s = reinterpret_cast<int*>(red_l + NW * HM);    // P

  const int split = blockIdx.x, nsplit = gridDim.x, b = blockIdx.y;
  const int j0 = split * P;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const size_t at = (size_t(b) * nsplit + split) * H;  // (b, split, head 0)
  float* ml = part + size_t(gridDim.y) * nsplit * H * R;

  int live = 0;
  if (tid < P) {
    const int j = j0 + tid;
    live = j < S && valid[size_t(b) * S + j];
    live_s[tid] = live;
  }
  if (!__syncthreads_or(live)) {  // a dead split: no context, max -inf
    if (tid < H) {
      ml[(at + tid) * 2] = -INFINITY;
      ml[(at + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  mma::load_tile<HM, NT>(ql_s, LDC, q_lat + size_t(b) * H * R, R, H, R, R,
                         vec_q, tid);
  stage_rows(ckv_s, LDC, ckv + (size_t(b) * S + j0) * R, R, live_s, R, R,
             true, tid);
  if (drp) {
    mma::load_tile<HM, NT>(qr_s, ldr, q_rope + size_t(b) * H * dr, dr, H, dr,
                           drp, vec_qr, tid);
    stage_rows(kr_s, ldr, k_rope + (size_t(b) * S + j0) * dr, dr, live_s,
               drp, dr, vec_kr, tid);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  // S = q.[ckv | k_rope]^T: 16 heads x this warp's 16 positions, two n8
  // tiles; A (the queries) by ldmatrix, B from the position-major rows
  float s[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  auto scores = [&](const bf16* a_row, const bf16* b_row, int depth) {
#pragma unroll 4
    for (int k = 0; k < depth; k += 16) {
      uint32_t a[4], bk[4];
      mma::ldsm_x4(a, a_row + k);
      mma::ldsm_x4(bk, b_row + k);
      mma::mma_bf16(s[0], a, bk[0], bk[1]);
      mma::mma_bf16(s[1], a, bk[2], bk[3]);
    }
  };
  const int a_off = (lane & 15), a_col = (lane >> 4) * 8;
  const int b_off = warp * 16 + (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;
  scores(ql_s + a_off * LDC + a_col, ckv_s + b_off * LDC + b_col, R);
  if (drp) scores(qr_s + a_off * ldr + a_col, kr_s + b_off * ldr + b_col, drp);

  // softmax over the split: heads gr and gr + 8 of this lane, reduced
  // over the quad, then over the four warps through shared memory
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + n * 8 + 2 * tq + (e & 1);
      const float x = live_s[p] ? s[n][e] * scale : -INFINITY;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    if (tq == 0) red_m[warp * HM + gr + 8 * r] = mx[r];
  }
  __syncthreads();
  float m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = gr + 8 * r;
    m[r] = fmaxf(fmaxf(red_m[h], red_m[HM + h]),
                 fmaxf(red_m[2 * HM + h], red_m[3 * HM + h]));
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = s[n][2 * r], x1 = s[n][2 * r + 1];
      const uint32_t w = mma::pack_bf16(
          x0 == -INFINITY ? 0.f : expf(x0 - m[r]),
          x1 == -INFINITY ? 0.f : expf(x1 - m[r]));
      const float2 wr = mma::unpack_bf16(w);
      ls[r] += wr.x + wr.y;
      *reinterpret_cast<uint32_t*>(p_s + (gr + 8 * r) * LDP + warp * 16 +
                                   n * 8 + 2 * tq) = w;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] += __shfl_xor_sync(FULL, ls[r], 1);
    ls[r] += __shfl_xor_sync(FULL, ls[r], 2);
    if (tq == 0) red_l[warp * HM + gr + 8 * r] = ls[r];
  }
  __syncthreads();  // P and the per-warp sums
  if (tid < H) {
    ml[(at + tid) * 2] = fmaxf(fmaxf(red_m[tid], red_m[HM + tid]),
                               fmaxf(red_m[2 * HM + tid], red_m[3 * HM + tid]));
    ml[(at + tid) * 2 + 1] = ((red_l[tid] + red_l[HM + tid]) +
                              red_l[2 * HM + tid]) + red_l[3 * HM + tid];
  }

  // O = P.ckv: 16 heads x this warp's r / 4 columns over the 64
  // positions, ckv's B fragments by transposed ldmatrix
  uint32_t pa[P / 16][4];
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk)
    mma::ldsm_x4(pa[kk], p_s + a_off * LDP + kk * 16 + a_col);
  const int c0 = warp * (R / NW);
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if constexpr (NO % 2 == 0) {
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        mma::ldsm_x4_t(bv, ckv_s + (kk * 16 + b_col + (lane & 7)) * LDC +
                               c0 + np * 16 + a_col);
        mma::mma_bf16(o[2 * np], pa[kk], bv[0], bv[1]);
        mma::mma_bf16(o[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
  } else {  // one n8 tile a warp (r = 32): four k8 tiles a load
#pragma unroll
    for (int kk = 0; kk < P / 16; kk += 2) {
      uint32_t bv[4];
      mma::ldsm_x4_t(bv, ckv_s + (kk * 16 + lane) * LDC + c0);
      mma::mma_bf16(o[0], pa[kk], bv[0], bv[1]);
      mma::mma_bf16(o[0], pa[kk + 1], bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = gr + 8 * r;
    if (h >= H) continue;
    float* dst = part + (at + h) * R + c0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 split body on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int TS = 32;      // positions per tile (one per lane)
constexpr int FPAD = 4;     // shared row padding, in floats
constexpr int U = 4;        // staging loads a thread has in flight

size_t smem_bytes_f32(int H, int r, int dr) {
  return sizeof(float) * (size_t(TS) * (r + FPAD) + size_t(TS) * (dr + FPAD) +
                          size_t(H) * r + size_t(H) * dr) +
         sizeof(int) * TS;
}

// Block (split, row b) walks its P positions in tiles of TS, one warp per
// head, and leaves the same workspace entries as the bf16 body. One block
// an SM in the launch bounds: without it ptxas held r = 32 / 128 / 256 to
// 64 registers for two blocks an SM, and spilled.
template <int RPL>  // RPL = r / 32 context elements per lane
__global__ void __launch_bounds__(MAX_H * 32, 1)
    mla_partial_kernel(const float* __restrict__ q_lat,
                       const float* __restrict__ q_rope,
                       const float* __restrict__ ckv,
                       const float* __restrict__ k_rope,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ part, int S, int H, int dr,
                       float scale) {
  constexpr int r = RPL * 32;
  constexpr int lr = r + FPAD;
  constexpr int NV = TS * r / 4;      // 16-byte loads per latent tile
  const int ldr = dr + FPAD;
  extern __shared__ float smem[];
  float* ckv_s = smem;                    // TS x lr
  float* kr_s = ckv_s + TS * lr;          // TS x ldr
  float* ql_s = kr_s + TS * ldr;          // H x r
  float* qr_s = ql_s + H * r;             // H x dr
  int* live_s = reinterpret_cast<int*>(qr_s + H * dr);  // TS

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y;
  const int j_lo = split * P, j_hi = min(S, j_lo + P);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int h = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < H * r; i += nt) ql_s[i] = q_lat[size_t(b) * H * r + i];
  for (int i = tid; i < H * dr; i += nt)
    qr_s[i] = q_rope[size_t(b) * H * dr + i];

  float m = -INFINITY, l = 0.f, acc[RPL];
#pragma unroll
  for (int e = 0; e < RPL; ++e) acc[e] = 0.f;

  const float4* q4 = reinterpret_cast<const float4*>(ql_s + h * r);
  const float4* qr4 = reinterpret_cast<const float4*>(qr_s + h * dr);
  for (int j0 = j_lo; j0 < j_hi; j0 += TS) {
    int live = 0;
    if (tid < TS) {
      const int j = j0 + tid;
      live = j < j_hi && valid[size_t(b) * S + j];
      live_s[tid] = live;
    }
    // also orders the q staging (first tile) and this tile's flags
    if (!__syncthreads_or(live)) continue;

    // stage the tile's live rows (the TS rows are contiguous in ckv): all
    // of a thread's loads are issued before any is stored, so they are in
    // flight together
    const size_t base = size_t(b) * S + j0;
    const float4* src = reinterpret_cast<const float4*>(ckv + base * r);
    for (int v0 = 0; v0 < NV; v0 += nt * U) {
      float4 buf[U];
      bool okv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * nt + tid;
        okv[u] = v < NV && live_s[v * 4 / r];
        if (okv[u]) buf[u] = src[v];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!okv[u]) continue;
        const int e = (v0 + u * nt + tid) * 4;
        *reinterpret_cast<float4*>(ckv_s + (e / r) * lr + e % r) = buf[u];
      }
    }
    for (int i0 = 0; i0 < TS * dr; i0 += nt * U) {
      float buf[U];
      bool okr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nt + tid;
        okr[u] = i < TS * dr && live_s[i / dr];
        if (okr[u]) buf[u] = k_rope[base * dr + i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nt + tid;
        if (okr[u]) kr_s[(i / dr) * ldr + i % dr] = buf[u];
      }
    }
    __syncthreads();

    // scores: lane p against position j0 + p
    const bool ok = live_s[lane];
    float s = 0.f;
    const float4* c4 = reinterpret_cast<const float4*>(ckv_s + lane * lr);
#pragma unroll 8
    for (int k = 0; k < r / 4; ++k) {
      const float4 a = q4[k], c = c4[k];
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
    const float4* k4 = reinterpret_cast<const float4*>(kr_s + lane * ldr);
    for (int k = 0; k < dr / 4; ++k) {
      const float4 a = qr4[k], c = k4[k];
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
    // a dead lane's score is whatever its stale row gave: select it away
    s = ok ? s * scale : -INFINITY;
    const float m_new = fmaxf(m, warp_max(s));  // finite: a lane is live
    const float alpha = expf(m - m_new);        // 0 while m = -inf
    const float w = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(w);
#pragma unroll
    for (int e = 0; e < RPL; ++e) acc[e] *= alpha;
    for (int p = 0; p < TS; ++p) {
      const float wp = __shfl_sync(FULL, w, p);
      if (!live_s[p]) continue;  // same for the whole warp
      const float* row = ckv_s + p * lr;
#pragma unroll
      for (int e = 0; e < RPL; ++e)
        acc[e] = fmaf(wp, row[lane + 32 * e], acc[e]);
    }
    m = m_new;
    __syncthreads();  // the tile is consumed before the next one lands
  }

  const size_t at = (size_t(b) * nsplit + split) * H + h;
  if (m != -INFINITY) {  // same for the whole warp
#pragma unroll
    for (int e = 0; e < RPL; ++e) part[at * r + lane + 32 * e] = acc[e];
  }
  if (lane == 0) {
    float* ml = part + size_t(gridDim.y) * nsplit * H * r + at * 2;
    ml[0] = m;
    ml[1] = l;
  }
}

// ---------------------------------------------------------------------------
// merge pass, both dtypes
// ---------------------------------------------------------------------------
constexpr int MT = 128;     // merge threads: R / 4 <= 128 float4 columns
constexpr int MU = 8;       // split contexts a thread has in flight

// Block (head h, row b). Warp 0 reads the row's split maxima (32 splits
// at a time, one a lane, all in flight), takes their max and lists the
// live splits in order with their weights exp(m_s - max) and
// normalisers; then every thread loads its float4 of each listed split's
// context, MU at a time, and adds them in split order. A row with no
// live position writes 0.
template <typename T, int R>
__global__ void __launch_bounds__(MT)
    mla_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int H, int nsplit) {
  __shared__ int idx_s[32];
  __shared__ float c_s[32], l_s[32];
  __shared__ int n_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32;
  const size_t at = size_t(b) * nsplit * H + h;   // split 0 of (b, h)
  const float2* ml = reinterpret_cast<const float2*>(
      part + size_t(gridDim.y) * nsplit * H * R);
  const float2 none = make_float2(-INFINITY, 0.f);
  float2 first = none;  // warp 0: split `lane`'s (max, normaliser)
  float mx = -INFINITY;
  if (tid < 32) {
    if (lane < nsplit) first = ml[at + size_t(lane) * H];
    mx = first.x;
    for (int s = lane + 32; s < nsplit; s += 32)
      mx = fmaxf(mx, ml[at + size_t(s) * H].x);
    mx = warp_max(mx);
  }
  const bool own = tid < R / 4;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += 32) {
    if (tid < 32) {
      const int s = s0 + lane;
      const float2 v = s0 == 0 ? first
                               : (s < nsplit ? ml[at + size_t(s) * H] : none);
      const bool lv = v.x != -INFINITY;
      const unsigned mask = __ballot_sync(FULL, lv);
      if (lv) {
        const int k = __popc(mask & ((1u << lane) - 1u));
        idx_s[k] = s;
        c_s[k] = expf(v.x - mx);
        l_s[k] = v.y;
      }
      if (lane == 0) n_s = __popc(mask);
    }
    __syncthreads();
    const int n = n_s;
    for (int k0 = 0; k0 < n; k0 += MU) {
      float4 v[MU];
#pragma unroll
      for (int u = 0; u < MU; ++u)
        if (own && k0 + u < n)
          v[u] = *reinterpret_cast<const float4*>(
              part + (at + size_t(idx_s[k0 + u]) * H) * R + 4 * tid);
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        if (k0 + u >= n) break;
        const float c = c_s[k0 + u];
        den = fmaf(l_s[k0 + u], c, den);
        if (own) {
          num.x = fmaf(v[u].x, c, num.x);
          num.y = fmaf(v[u].y, c, num.y);
          num.z = fmaf(v[u].z, c, num.z);
          num.w = fmaf(v[u].w, c, num.w);
        }
      }
    }
    __syncthreads();  // the list is read before the next chunk's
  }
  if (own) {
    const float inv = 1.f / fmaxf(den, 1e-30f);
    store4(out + (size_t(b) * H + h) * R + 4 * tid,
           make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, int R>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv,
                   const void* k_rope, const void* valid, void* out,
                   void* work, int B, int S, int H, int dr, float scale,
                   cudaStream_t stream) {
  const int nsplit = (S + P - 1) / P;
  float* part = static_cast<float*>(work);
  const auto* vmask = static_cast<const unsigned char*>(valid);
  if (nsplit > 0) {
    cudaError_t err;
    if constexpr (sizeof(T) == 2) {
      const int drp = (dr + 15) / 16 * 16;
      const size_t smem = tc::smem_bytes(R, drp);
      err = cudaFuncSetAttribute(tc::mla_partial_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
      if (err != cudaSuccess) return err;
      tc::mla_partial_kernel<R><<<dim3(nsplit, B), tc::NT, smem, stream>>>(
          static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
          static_cast<const T*>(ckv), static_cast<const T*>(k_rope), vmask,
          part, S, H, dr, scale, aligned16(q_lat),
          aligned16(q_rope) && dr % 8 == 0, aligned16(k_rope) && dr % 8 == 0);
    } else {
      const size_t smem = smem_bytes_f32(H, R, dr);
      err = cudaFuncSetAttribute(mla_partial_kernel<R / 32>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
      if (err != cudaSuccess) return err;
      mla_partial_kernel<R / 32><<<dim3(nsplit, B), H * 32, smem, stream>>>(
          static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
          static_cast<const T*>(ckv), static_cast<const T*>(k_rope), vmask,
          part, S, H, dr, scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mla_merge_kernel<T, R><<<dim3(H, B), MT, 0, stream>>>(
      part, static_cast<T*>(out), H, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_r(int r, const void* q_lat, const void* q_rope,
                     const void* ckv, const void* k_rope, const void* valid,
                     void* out, void* work, int B, int S, int H, int dr,
                     float scale, cudaStream_t stream) {
  switch (r) {
    case 32: return launch<T, 32>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, stream);
    case 64: return launch<T, 64>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, stream);
    case 128: return launch<T, 128>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, stream);
    case 256: return launch<T, 256>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, stream);
    case 512: return launch<T, 512>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). The caller has checked shapes, types and
// layout: r in {32, 64, 128, 256, 512}, dr a multiple of 4 up to 256,
// 1 <= H <= 16, and `work` holds B * ceil(S / chunk) * H * (r + 2)
// floats; chunk must be P = 64; S = 0 writes zeros.
int mla_decode_launch(const void* q_lat, const void* q_rope, const void* ckv,
                      const void* k_rope, const void* valid, void* out,
                      void* work, int B, int S, int H, int r, int dr,
                      float scale, int chunk, int is_bf16, void* stream) {
  if (H < 1 || H > MAX_H || dr < 0 || dr % 4 || dr > 256 || chunk != P)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_r<__nv_bfloat16>(r, q_lat, q_rope, ckv, k_rope, valid, out,
                                   work, B, S, H, dr, scale, s);
  return launch_r<float>(r, q_lat, q_rope, ckv, k_rope, valid, out, work, B,
                         S, H, dr, scale, s);
}
