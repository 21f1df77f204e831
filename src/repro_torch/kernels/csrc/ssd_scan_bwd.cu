// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), float32.
//
// The gradients (dx, ddt, dA, dB, dC, dD) of ssd_scan (ssd_scan.cu) given
// dy and, optionally, the final state's gradient dstate. JAX has no Pallas
// kernel for it: jax.grad differentiates the jnp oracle ref.ssd_scan_seq.
// The plain version, derived by hand, is kernels/ref.py::ssd_scan_bwd; its
// docstring states the formulas this file computes.
//
// For each batch row b and head h (group g = h / (nh / ng)), the sequence
// cut into 64-position chunks (the forward's cut, whatever the caller's
// chunk; a ragged last chunk is padded with x = dt = B = C = dy = 0, which
// adds nothing to any gradient):
//
//   cum[t]  = inclusive running sum of dt * A within the chunk
//   w[t,k]  = exp(cum[t] - cum[k]) for k <= t, e[k] = exp(cum[last] - cum[k])
//   S_c     = the state entering chunk c, dS = the gradient of the state
//             leaving it (dstate, or 0, after the last chunk)
//   G = C.B^T, R = dy.x^T (over the head dim), M = G w dt[k],
//   dG = w dt[k] R, Q = G w R
//   dx[k]   = sum_t M[t,k] dy[t] + e[k] dt[k] (dS.B[k]) + D dy[k]
//   dB[k]   = sum_t dG[t,k] C[t] + e[k] dt[k] (x[k]^T.dS)
//   dC[t]   = sum_k dG[t,k] B[k] + exp(cum[t]) (dy[t]^T.S_c)
//   dcum[t] = sum_k dt[k] Q[t,k] - dt[t] sum_t' Q[t',t]
//             + exp(cum[t]) dy[t].(S_c C[t]) - U[t]
//             (+ exp(cum[last]) <dS, S_c> + sum_k U[k] at the last position;
//              U[k] = e[k] dt[k] x[k]^T.dS.B[k])
//   rc      = reverse running sum of dcum;  ddt[k] = sum_t Q[t,k]
//             + e[k] x[k]^T.dS.B[k] + A rc[k];  dA = sum dt rc;  dD = sum dy.x
//   dS     <- exp(cum[last]) dS + sum_t exp(cum[t]) dy[t] (x) C[t]
//
// Layout: x, dy, dx (B, S, nh, hd); dt, ddt (B, S, nh); B, C, dB, dC
// (B, S, ng, ds); A, D, dA, dD (nh,); dstate (B, nh, hd, ds); all float32.
//
// Every chunk in parallel, every product split TF32 on the tensor cores
// (mma.cuh: three m16n8k8 a product, ~22 significant bits; both operands
// split). Five CUDA kernels a call, on the caller's stream:
//  (a) ssd32::chunk_state_kernel (ssd_f32.cuh, the forward's own, so the
//      chunk states are its bits), one block per (chunk, head, 64 head
//      rows, batch row): each chunk's own state (wk x)^T.B, its running
//      sums and G = C.B^T as the forward forms them, and beside them the
//      chunk's own part of dS, (exp(cum) dy)^T.C, and dt, wk, exp(cum);
//  (b) ssd32::state_pass_kernel: the forward's pass over the chunks (the
//      state entering each) and the same pass in reverse over dS, from
//      dstate: dS_c = exp(cum[last]_{c+1}) dS_{c+1} + own_{c+1};
//  (c) ssd_grads_kernel, one block per (chunk, head, batch row), 8 warps: R
//      over the head dim, Q's row and column sums, E = B.dS^T and
//      Z = C.S_c^T over ds in 64-column pieces, dx = M^T.dy + e dt E + D dy
//      (M built in registers from G), then one thread the chunk's dcum, its
//      reverse running sum (restarting each chunk, as in the plain
//      version), ddt (written whole: the block owns every row of its
//      head) and the chunk's dA and dD, all in a fixed order;
//  (d) ssd_dbc_kernel, dB and dC. They sum over a group's heads (80 heads,
//      one group, for mamba2). Of the three ways to keep the partials small
//      (a block owning a head's rows, blocks adding a fixed run of heads
//      in order, or the heads' stacked rows as one product), this takes
//      the second: a block owns (chunk, 64 columns of ds, a run of heads of
//      one group, batch row) and adds its run's heads in order into
//      accumulators in registers, for each head dB += (wk x).dS + dG^T.C
//      and dC += (exp(cum) dy).S_c + dG.B, and writes one (S x 64) partial
//      a run. A block owning a head's rows would still write one partial a
//      head (84 MB at 18e's call); the stacked product is the same sum with
//      fewer, longer blocks. Runs are the fewest that fill whole waves of
//      an H100's 132 SMs at two blocks an SM (head_runs, a function of the
//      shapes alone: 8 runs of 10 heads at 18e's call);
//  (e) ssd_reduce_kernel: dB and dC add the runs in order, dA and dD the
//      chunks' partials in (batch row, chunk) order.
// Every product adds each k8 step's three split-TF32 terms in a zeroed
// accumulator and then into float32 by one rounded addition
// (ssd32::mma_tf32x3_rn). No atomics anywhere and every sum in a fixed
// order, so a call's bits do not move from run to run.
//
// Scratch, float32 (ssd_scan_bwd_work_floats): the forward's (G, decays,
// running sums, one (hd, ds) state a chunk and head), dS a chunk and head,
// three CL vectors a chunk and head, the runs' dB / dC partials and the
// chunks' dA / dD: 93,862,912 B at phase 18e's call (B 2, S 512, nh 80,
// hd 64, ng 1, ds 128): 42.5 MB states, 41.9 MB dS, 1.0 MB vectors and
// 8.4 MB partials (the first design's ~210 MB held 168 MB of dB / dC
// partials, one (S x ds) slab per head and 32-row tile).
//
// Shared memory: (a) 103.4 KB; (c) six 64 x 64 tiles and vectors, 109.6 KB;
// (d) B and C at the block's 64 columns and one head's x (then dG), dy,
// S_c and dS, 105.5 KB: two blocks an SM each. ds <= 128 (the wrapper
// refuses more; every SSM config of the registry has ds <= 128); any hd,
// in 64-row pieces.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "ssd_f32.cuh"

namespace {

using ssd32::CL;
using ssd32::LDT;
using ssd32::PT;

constexpr int MAX_DS = 128;  // state width the wrapper passes
constexpr int NT = 256;      // eight warps
constexpr int WAVE = 2 * 132;  // ssd_dbc_kernel blocks at once on an H100
                               // SXM: two an SM (its shared memory)

// the vectors of ssd_grads_kernel, CL floats each
enum { V_DT, V_CUM, V_EC, V_WK, V_DEC, V_ROW0, V_ROW1, V_COL0, V_COL1,
       V_COL2, V_COL3, V_V0, V_V1, V_W0, V_W1, V_RD, V_ROWP, V_COLQ, V_V,
       V_W, NVEC };

size_t smem_grads() {
  return sizeof(float) * (6 * size_t(CL) * LDT + NVEC * CL + NT / 32);
}

// acc[4] = sum over 64 columns of A's 16 rows (a = &A[(row0 + gr) * LDT +
// tq]) times B's rows for 4 n8 tiles (bt = &B[(n0 + gr) * LDT + tq])
__device__ __forceinline__ void rows_dot_rn(float (&acc)[4][4], const float* a,
                                            const float* bt) {
#pragma unroll 1
  for (int kk = 0; kk < 64; kk += 8) {
    const mma::FragA fa = mma::load_a_tf32(a + kk, LDT);
    mma::FragB fb[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) fb[n] = mma::load_b_tf32(bt + n * 8 * LDT + kk);
    ssd32::mma_tf32x3_rn(acc, fa, fb);
  }
}

// acc[8] += a . B for the 8 n8 tiles of a k-major tile of 64 columns (bk =
// &B[(k0 + 2 tq) * LDT + gr]), four tiles at a time: the fragments and step
// sums of four tiles live at once, not eight
__device__ __forceinline__ void mma_cols64(float (&acc)[8][4],
                                           const mma::FragA& a,
                                           const float* bk) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma::FragB fb[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      fb[n] = mma::load_bk_tf32(bk + (4 * h + n) * 8, LDT);
    ssd32::mma_tf32x3_rn(*reinterpret_cast<float(*)[4][4]>(acc + 4 * h), a, fb);
  }
}

// (c) Per (chunk, head, batch row): dx, ddt and the chunk's dA, dD. Warp
// (rs, cs) = (warp & 3, warp >> 2) owns rows 16 rs and columns 32 cs (four
// n8 tiles) of each 64 x 64 product.
__global__ void __launch_bounds__(NT, 2)
    ssd_grads_kernel(const float* __restrict__ x, const float* __restrict__ A,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ D, const float* __restrict__ dy,
                     const float* __restrict__ work, const float* __restrict__ dso,
                     ssd32::ChunkVecs vecs, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ pA,
                     float* __restrict__ pD, int S, int nh, int hd, int ng, int ds,
                     int nc, int vec_x, int vec_bc, int vec_st) {
  const int DSP = ssd32::padded_ds(ds);
  const int nps = (hd + PT - 1) / PT, ndc = DSP / 64;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // CL x LDT: x[k][p] of a 64-row piece of hd
  float* ys = xs + CL * LDT;    // CL x LDT: dy[t][p]
  float* bsd = ys + CL * LDT;   // CL x LDT: B[k][d] of 64 columns; then G
  float* csd = bsd + CL * LDT;  // CL x LDT: C[t][d]
  float* ssd = csd + CL * LDT;  // PT x LDT: S_c[p][d]
  float* dls = ssd + PT * LDT;  // PT x LDT: dS[p][d]
  float* vec = dls + PT * LDT;  // NVEC x CL
  float* red = vec + NVEC * CL; // a warp's part of <dS, S_c>
  float* dts = vec + V_DT * CL;
  float* cum = vec + V_CUM * CL;
  float* ec = vec + V_EC * CL;
  float* wk = vec + V_WK * CL;
  float* dec = vec + V_DEC * CL;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / ng), t0 = c * CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4, rs = warp & 3, cs = warp >> 2;
  const ssd32::Scratch w =
      ssd32::carve(const_cast<float*>(work), gridDim.z, nc, nh, ng);
  const size_t bch = (size_t(b) * nc + c) * nh + h;
  const float* Gg = w.G + ((size_t(b) * nc + c) * ng + g) * CL * CL;
  const size_t x_off = ((size_t(b) * S + t0) * nh + h) * hd;
  const size_t st_off = bch * hd * ds;
  const size_t bc_off = ((size_t(b) * S + t0) * ng + g) * ds;

  auto load_rows = [&](int s) {  // x and dy, rows p of piece s
    mma::load_tile_f32<CL, NT>(xs, LDT, x + x_off + s * PT, size_t(nh) * hd,
                               S - t0, hd - s * PT, PT, vec_x, tid);
    mma::load_tile_f32<CL, NT>(ys, LDT, dy + x_off + s * PT, size_t(nh) * hd,
                               S - t0, hd - s * PT, PT, vec_x, tid);
  };
  // B, C, S_c and dS at piece s of hd and columns 64 dc of ds
  auto load_cols = [&](int s, int dc) {
    const int cols = ds - dc * 64;
    mma::load_tile_f32<CL, NT>(bsd, LDT, Bm + bc_off + dc * 64,
                               size_t(ng) * ds, S - t0, cols, 64, vec_bc, tid);
    mma::load_tile_f32<CL, NT>(csd, LDT, Cm + bc_off + dc * 64,
                               size_t(ng) * ds, S - t0, cols, 64, vec_bc, tid);
    const size_t so = st_off + size_t(s) * PT * ds + dc * 64;
    mma::load_tile_f32<PT, NT>(ssd, LDT, w.st + so, size_t(ds), hd - s * PT,
                               cols, 64, vec_st, tid);
    mma::load_tile_f32<PT, NT>(dls, LDT, dso + so, size_t(ds), hd - s * PT,
                               cols, 64, vec_st, tid);
  };
  // with one piece of hd, the first columns' tiles load while R is formed
  const bool early = nps == 1;
  load_rows(0);
  mma::cp_async_commit();
  if (early) {
    load_cols(0, 0);
    mma::cp_async_commit();
  }
  if (tid < CL) {
    dts[tid] = vecs.dt[bch * CL + tid];
    cum[tid] = w.cum[bch * CL + tid];
    ec[tid] = vecs.ec[bch * CL + tid];
    wk[tid] = vecs.wk[bch * CL + tid];
  }
  __syncthreads();
  const float last = cum[CL - 1];
  if (tid < CL) dec[tid] = expf(last - cum[tid]);

  // R[t][k] = dy[t] . x[k] over the head dim
  float r[4][4] = {};
  for (int s = 0; s < nps; ++s) {
    if (s > 0) {
      __syncthreads();
      load_rows(s);
      mma::cp_async_commit();
    }
    if (early)
      mma::cp_async_wait<1>();
    else
      mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < PT; kk += 8) {
      const mma::FragA a =
          mma::load_a_tf32(ys + (16 * rs + gr) * LDT + kk + tq, LDT);
      mma::FragB bf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        bf[n] = mma::load_b_tf32(xs + (32 * cs + 8 * n + gr) * LDT + kk + tq);
      ssd32::mma_tf32x3_rn(r, a, bf);
    }
  }

  // Q = G w R on the lower triangle: its rows' sums with dt[k] and its
  // columns' sums, by lane then by shuffles in a fixed order; R's diagonal
  {
    float rp[2] = {0.f, 0.f}, cq[4][2] = {};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 16 * rs + gr + 8 * j, k = 32 * cs + 8 * n + 2 * tq;
        const float2 gg = *reinterpret_cast<const float2*>(Gg + t * CL + k);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rv = r[n][2 * j + e];
          float q = 0.f;
          if (k + e <= t)
            q = (e ? gg.y : gg.x) * expf(cum[t] - cum[k + e]) * rv;
          rp[j] += dts[k + e] * q;
          cq[n][e] += q;
          if (k + e == t) vec[V_RD * CL + t] = rv;
        }
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rp[j] += __shfl_xor_sync(0xffffffffu, rp[j], 1);
      rp[j] += __shfl_xor_sync(0xffffffffu, rp[j], 2);
      if (tq == 0) vec[(V_ROW0 + cs) * CL + 16 * rs + gr + 8 * j] = rp[j];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cq[n][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0) vec[(V_COL0 + rs) * CL + 32 * cs + 8 * n + 2 * tq + e] = v;
      }
  }

  const float dh = D[h];
  for (int s = 0; s < nps; ++s) {
    // E[k][p] = B[k] . dS[p] and Z[t][p] = C[t] . S_c[p] over ds, 64
    // columns at a time; <dS, S_c> by thread
    float E[4][4] = {}, Z[4][4] = {}, dot = 0.f;
    for (int dc = 0; dc < ndc; ++dc) {
      if (!(early && dc == 0)) {
        __syncthreads();  // the previous tiles' readers are done
        if (nps > 1 && dc == 0) load_rows(s);
        load_cols(s, dc);
        mma::cp_async_commit();
      }
      mma::cp_async_wait<0>();
      __syncthreads();
      rows_dot_rn(E, bsd + (16 * rs + gr) * LDT + tq,
                  dls + (32 * cs + gr) * LDT + tq);
      rows_dot_rn(Z, csd + (16 * rs + gr) * LDT + tq,
                  ssd + (32 * cs + gr) * LDT + tq);
      for (int i = tid; i < PT * 64; i += NT) {
        const int p = i >> 6, d = i & 63;
        dot += dls[p * LDT + d] * ssd[p * LDT + d];
      }
    }

    // G into bsd for M's fragments
    __syncthreads();
    mma::load_tile_f32<CL, NT>(bsd, LDT, Gg, CL, CL, CL, CL, true, tid);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();

    // M^T . dy over t >= k: A = M^T (rows k, k permuted over t), built from
    // G and split in registers
    float mx[4][4] = {};
    for (int kk = 16 * rs; kk < CL; kk += 8) {
      mma::FragA m;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * rs + gr + (i & 1) * 8, t = kk + 2 * tq + (i >> 1);
        const float v =
            t >= k ? bsd[t * LDT + k] * expf(cum[t] - cum[k]) * dts[k] : 0.f;
        mma::split_tf32(v, m.hi[i], m.lo[i]);
      }
      mma::FragB bf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        bf[n] = mma::load_bk_tf32(ys + (kk + 2 * tq) * LDT + 32 * cs + 8 * n + gr,
                                  LDT);
      ssd32::mma_tf32x3_rn(mx, m, bf);
    }

    // dy . Z by row, this lane's part (Z is not read after)
    float vsum[2] = {0.f, 0.f}, wsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = 16 * rs + gr + 8 * j;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wsum[j] += ys[t * LDT + 32 * cs + 8 * n + 2 * tq + e] * Z[n][2 * j + e];
    }

    // dx = M^T.dy + e dt E + D dy; x . E by row, this lane's part
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 16 * rs + gr + 8 * j, t = t0 + k;
      float* dxrow = dx + ((size_t(b) * S + t) * nh + h) * hd + s * PT;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int p = 32 * cs + 8 * n + 2 * tq;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ev = E[n][2 * j + e];
          o[e] = mx[n][2 * j + e] + wk[k] * ev + dh * ys[k * LDT + p + e];
          vsum[j] += xs[k * LDT + p + e] * ev;
        }
        if (t >= S) continue;
        const int pa = s * PT + p;
        if (pa + 1 < hd && hd % 2 == 0) {
          *reinterpret_cast<float2*>(dxrow + p) = make_float2(o[0], o[1]);
        } else {
          if (pa < hd) dxrow[p] = o[0];
          if (pa + 1 < hd) dxrow[p + 1] = o[1];
        }
      }
    }

    // this piece's row sums by column half and <dS, S_c> by warp, added to
    // the pieces before in order
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        vsum[j] += __shfl_xor_sync(0xffffffffu, vsum[j], o);
        wsum[j] += __shfl_xor_sync(0xffffffffu, wsum[j], o);
      }
      if (tq == 0) {
        float* v = vec + (V_V0 + cs) * CL + 16 * rs + gr + 8 * j;
        float* wv = vec + (V_W0 + cs) * CL + 16 * rs + gr + 8 * j;
        *v = s == 0 ? vsum[j] : *v + vsum[j];
        *wv = s == 0 ? wsum[j] : *wv + wsum[j];
      }
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) red[warp] = s == 0 ? dot : red[warp] + dot;
  }

  __syncthreads();
  if (tid < CL) {
    vec[V_ROWP * CL + tid] = vec[V_ROW0 * CL + tid] + vec[V_ROW1 * CL + tid];
    vec[V_COLQ * CL + tid] =
        ((vec[V_COL0 * CL + tid] + vec[V_COL1 * CL + tid]) +
         vec[V_COL2 * CL + tid]) + vec[V_COL3 * CL + tid];
    vec[V_V * CL + tid] = vec[V_V0 * CL + tid] + vec[V_V1 * CL + tid];
    vec[V_W * CL + tid] = vec[V_W0 * CL + tid] + vec[V_W1 * CL + tid];
  }
  __syncthreads();

  // one thread: dcum, its reverse running sum, ddt, dA and dD in order
  if (tid == 0) {
    const float* rowP = vec + V_ROWP * CL;
    const float* colQ = vec + V_COLQ * CL;
    const float* V = vec + V_V * CL;
    const float* W = vec + V_W * CL;
    const float* Rd = vec + V_RD * CL;
    float dsc = 0.f;
    for (int i = 0; i < NT / 32; ++i) dsc += red[i];
    float sumU = 0.f;
    for (int t = 0; t < CL; ++t) sumU += wk[t] * V[t];
    const float a = A[h];
    float rc = 0.f, dA_acc = 0.f, dD_acc = 0.f;
    for (int t = CL - 1; t >= 0; --t) {
      float dcum = rowP[t] - dts[t] * colQ[t] + ec[t] * W[t] - wk[t] * V[t];
      if (t == CL - 1) dcum += expf(last) * dsc + sumU;
      rc += dcum;
      dA_acc += dts[t] * rc;
      if (t0 + t < S)
        ddt[(size_t(b) * S + t0 + t) * nh + h] = colQ[t] + dec[t] * V[t] + a * rc;
    }
    for (int t = 0; t < CL; ++t) dD_acc += Rd[t];
    pA[bch] = dA_acc;
    pD[bch] = dD_acc;
  }
}

// ssd_dbc_kernel's tiles of one head: x, dy, S_c and dS (a 64-row piece
// of hd; S_c and dS at the block's 64 columns) and its vectors
constexpr int BUF = 2 * CL * LDT + 2 * PT * LDT + 4 * CL;
enum { B_CUM, B_DT, B_WK, B_EC };

size_t smem_dbc() { return sizeof(float) * (2 * size_t(CL) * LDT + size_t(BUF)); }

// item it's tiles (head h0 + it / nps, piece it % nps of hd) into buf, by
// cp.async; the caller commits
__device__ __forceinline__ void ssd_dbc_issue(
    float* buf, int it, int nps, const float* x, const float* dy,
    const ssd32::Scratch& w, const float* dso, const ssd32::ChunkVecs& vecs,
    int b, int c, int h0, int dc, int S, int nh, int hd, int ds, int nc,
    int vec_x, int vec_st, int tid) {
  const int h = h0 + it / nps, s = it % nps, t0 = c * CL;
  const size_t bch = (size_t(b) * nc + c) * nh + h;
  const size_t x_off = ((size_t(b) * S + t0) * nh + h) * hd + s * PT;
  float* xs = buf;
  float* ys = xs + CL * LDT;
  float* ssd = ys + CL * LDT;
  float* dls = ssd + PT * LDT;
  float* vb = dls + PT * LDT;
  mma::load_tile_f32<CL, NT>(xs, LDT, x + x_off, size_t(nh) * hd, S - t0,
                             hd - s * PT, PT, vec_x, tid);
  mma::load_tile_f32<CL, NT>(ys, LDT, dy + x_off, size_t(nh) * hd, S - t0,
                             hd - s * PT, PT, vec_x, tid);
  const size_t so = bch * hd * ds + size_t(s) * PT * ds + dc * 64;
  mma::load_tile_f32<PT, NT>(ssd, LDT, w.st + so, size_t(ds), hd - s * PT,
                             ds - dc * 64, 64, vec_st, tid);
  mma::load_tile_f32<PT, NT>(dls, LDT, dso + so, size_t(ds), hd - s * PT,
                             ds - dc * 64, 64, vec_st, tid);
  if (tid < 4 * CL / 4) {  // four CL vectors, 16 bytes a thread
    const int v = tid / (CL / 4), q = tid % (CL / 4);
    const float* src = v == B_CUM ? w.cum : v == B_DT ? vecs.dt
                       : v == B_WK ? vecs.wk : vecs.ec;
    mma::cp_async16(vb + v * CL + 4 * q, src + bch * CL + 4 * q, 16);
  }
}

// (d) Per (chunk, 64 columns of ds, run of heads, batch row) of one group:
// the run's share of dB and dC at those columns, its heads added in order.
// Warps 0-3 own dB's rows k = 16 warp, warps 4-7 dC's rows t = 16 (warp -
// 4); all eight share R's 64 x 64 as ssd_grads_kernel does. One head's
// tiles at a time (two blocks an SM overlap one's loads with the other's
// products); dG goes over x once x is used.
__global__ void __launch_bounds__(NT, 2)
    ssd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   const float* __restrict__ work,
                   const float* __restrict__ dso, ssd32::ChunkVecs vecs,
                   float* __restrict__ pB, float* __restrict__ pC, int S,
                   int nh, int hd, int ng, int ds, int nc, int ndc, int runs,
                   int hr, int vec_x, int vec_bc, int vec_st) {
  extern __shared__ __align__(16) float smem[];
  float* bsd = smem;            // CL x LDT: B[k][d] at the block's columns
  float* csd = bsd + CL * LDT;  // CL x LDT: C[t][d]
  float* xs = csd + CL * LDT;   // CL x LDT: x[k][p]; then dG[t][k]
  float* ys = xs + CL * LDT;    // CL x LDT: dy[t][p]
  float* ssd = ys + CL * LDT;   // PT x LDT: S_c[p][d]
  float* dls = ssd + PT * LDT;  // PT x LDT: dS[p][d]
  const float* vb = dls + PT * LDT;
  const float* cum = vb + B_CUM * CL;
  const float* dts = vb + B_DT * CL;
  float* dGs = xs;

  const int run = blockIdx.x % runs, dc = blockIdx.x / runs % ndc;
  const int c = blockIdx.x / (runs * ndc);
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / ng, h0 = g * rep + run * hr;
  const int nhr = min(hr, rep - run * hr);
  const int nps = (hd + PT - 1) / PT, items = nhr * nps;
  const int t0 = c * CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4, rs = warp & 3, cs = warp >> 2;
  const bool isB = warp < 4;
  const int m0 = 16 * (warp & 3);
  const ssd32::Scratch w =
      ssd32::carve(const_cast<float*>(work), gridDim.z, nc, nh, ng);

  const size_t bc_off = ((size_t(b) * S + t0) * ng + g) * ds + dc * 64;
  mma::load_tile_f32<CL, NT>(bsd, LDT, Bm + bc_off, size_t(ng) * ds, S - t0,
                             ds - dc * 64, 64, vec_bc, tid);
  mma::load_tile_f32<CL, NT>(csd, LDT, Cm + bc_off, size_t(ng) * ds, S - t0,
                             ds - dc * 64, 64, vec_bc, tid);

  float acc[8][4] = {};  // dB (warps 0-3) or dC (warps 4-7), rows m0
  float r[4][4] = {};
  for (int it = 0; it < items; ++it) {
    if (it > 0) __syncthreads();  // the last head's tiles are used
    ssd_dbc_issue(xs, it, nps, x, dy, w, dso, vecs, b, c, h0, dc, S, nh, hd,
                  ds, nc, vec_x, vec_st, tid);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    const int s = it % nps;

    if (s == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n) r[n][0] = r[n][1] = r[n][2] = r[n][3] = 0.f;
    }
    // R += dy . x^T over this piece of hd
#pragma unroll 1
    for (int kk = 0; kk < PT; kk += 8) {
      const mma::FragA a =
          mma::load_a_tf32(ys + (16 * rs + gr) * LDT + kk + tq, LDT);
      mma::FragB bf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        bf[n] = mma::load_b_tf32(xs + (32 * cs + 8 * n + gr) * LDT + kk + tq);
      ssd32::mma_tf32x3_rn(r, a, bf);
    }
    // dB += (wk x) . dS, dC += (exp(cum) dy) . S_c over this piece of hd
    {
      const float* as = isB ? xs : ys;
      const float* sc = vb + (isB ? B_WK : B_EC) * CL;
      const float* bt = isB ? dls : ssd;
      const float s0 = sc[m0 + gr], s1 = sc[m0 + gr + 8];
#pragma unroll 1
      for (int kk = 0; kk < PT; kk += 8) {
        const mma::FragA a = ssd32::load_a_perm_tf32(
            as + (m0 + gr) * LDT + kk + 2 * tq, LDT, s0, s1);
        mma_cols64(acc, a, bt + (kk + 2 * tq) * LDT + gr);
      }
    }
    if (s == nps - 1) {  // the head's last piece: dG over x, then its terms
      __syncthreads();    // every read of x is done
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = 16 * rs + gr + 8 * j, k = 32 * cs + 8 * n + 2 * tq;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = k + e <= t
                       ? expf(cum[t] - cum[k + e]) * dts[k + e] * r[n][2 * j + e]
                       : 0.f;
          *reinterpret_cast<float2*>(dGs + t * LDT + k) = make_float2(v[0], v[1]);
        }
      __syncthreads();
      if (isB) {  // dB[k] += sum_{t >= k} dG[t][k] C[t]
        for (int kk = m0; kk < CL; kk += 8) {
          const mma::FragA a =
              mma::load_at_tf32(dGs + (kk + 2 * tq) * LDT + m0 + gr, LDT);
          mma_cols64(acc, a, csd + (kk + 2 * tq) * LDT + gr);
        }
      } else {  // dC[t] += sum_{k <= t} dG[t][k] B[k]
        for (int kk = 0; kk < m0 + 16; kk += 8) {
          const mma::FragA a = ssd32::load_a_perm_tf32(
              dGs + (m0 + gr) * LDT + kk + 2 * tq, LDT, 1.f, 1.f);
          mma_cols64(acc, a, bsd + (kk + 2 * tq) * LDT + gr);
        }
      }
    }
  }

  float* part = (isB ? pB : pC) +
                ((size_t(b) * ng + g) * runs + run) * size_t(S) * ds +
                size_t(t0) * ds + dc * 64;
  ssd32::store_c(acc, part, size_t(ds), m0, 0, S - t0, ds - dc * 64, lane);
}

// (e) dB and dC: the runs in order; dA and dD: the chunks' partials in
// (batch row, chunk) order
__global__ void ssd_reduce_kernel(const float* __restrict__ pB,
                                  const float* __restrict__ pC,
                                  const float* __restrict__ pA,
                                  const float* __restrict__ pD,
                                  float* __restrict__ dB, float* __restrict__ dC,
                                  float* __restrict__ dA, float* __restrict__ dD,
                                  int B, int S, int nh, int ng, int ds, int nc,
                                  int runs) {
  const long long n_bc = (long long)B * S * ng * ds;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_bc) {
    const int d = int(i % ds);
    const long long rr = i / ds;
    const int g = int(rr % ng);
    const long long bt = rr / ng;
    const int t = int(bt % S), b = int(bt / S);
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < runs; ++r) {
      const size_t o = (((size_t(b) * ng + g) * runs + r) * S + t) * size_t(ds) + d;
      sb += pB[o];
      sc += pC[o];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < n_bc + nh) {
    const int h = int(i - n_bc);
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < nc; ++c) {
        const size_t o = (size_t(b) * nc + c) * nh + h;
        sa += pA[o];
        sd += pD[o];
      }
    dA[h] = sa;
    dD[h] = sd;
  }
}

// Heads an ssd_dbc_kernel block adds before it writes: of the run counts
// that give distinct run lengths, the one with the fewest (waves x heads a
// block), waves of WAVE blocks, the fewest runs on a tie. A function of
// the shapes alone, so the order of dB's and dC's sums is too.
int head_runs(int B, int nc, int ng, int nh, int ds) {
  const int rep = nh / ng, ndc = ssd32::padded_ds(ds) / 64;
  const long long blocks = (long long)B * nc * ng * ndc;
  int best = 1;
  long long best_cost = -1;
  for (int runs = 1; runs <= rep; ++runs) {
    const int hr = (rep + runs - 1) / runs;
    if ((rep + hr - 1) / hr != runs) continue;
    const long long cost = (blocks * runs + WAVE - 1) / WAVE * hr;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = runs;
    }
  }
  return best;
}

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

struct Work {
  float* fw;              // the forward's scratch (ssd32::Scratch)
  float* dso;             // (B, nc, nh, hd, ds): own dS, then dS
  ssd32::ChunkVecs vecs;  // (B, nc, nh, CL) each
  float *pB, *pC;         // (B, ng, runs, S, ds) each
  float *pA, *pD;         // (B, nc, nh) each
};

// scratch in floats, laid out as carve reads it
struct WorkSizes {
  size_t fw, dso, vec, p, s;
  size_t total() const { return fw + dso + 3 * vec + 2 * p + 2 * s; }
};

WorkSizes work_sizes(int B, int S, int nh, int hd, int ng, int ds) {
  const int nc = (S + CL - 1) / CL, runs = head_runs(B, nc, ng, nh, ds);
  return {round4(ssd32::scratch_floats(B, nc, nh, hd, ng, ds)),
          round4(size_t(B) * nc * nh * hd * ds), size_t(B) * nc * nh * CL,
          round4(size_t(B) * ng * runs * S * ds), round4(size_t(B) * nc * nh)};
}

Work carve(float* base, const WorkSizes& n) {
  Work w;
  w.fw = base;
  w.dso = w.fw + n.fw;
  w.vecs.dt = w.dso + n.dso;
  w.vecs.wk = w.vecs.dt + n.vec;
  w.vecs.ec = w.vecs.wk + n.vec;
  w.pB = w.vecs.ec + n.vec;
  w.pC = w.pB + n.p;
  w.pA = w.pC + n.p;
  w.pD = w.pA + n.s;
  return w;
}

}  // namespace

// Floats of float32 scratch a call needs (see the header).
long long ssd_scan_bwd_work_floats(int B, int S, int nh, int hd, int ng,
                                   int ds) {
  if (ng < 1 || nh % ng || S < 1) return 0;
  return (long long)work_sizes(B, S, nh, hd, ng, ds).total();
}

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). The caller has checked shapes, types and layout
// (all float32, nh % ng == 0, 1 <= ds <= 128, S >= 1) and passes ``work``,
// float32 scratch of ssd_scan_bwd_work_floats elements; ``dstate`` may be
// null (a zero gradient of the final state).
int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D,
                        const void* dy, const void* dstate, void* dx,
                        void* ddt, void* dA, void* dB, void* dC, void* dD,
                        void* work, int B, int S, int nh, int hd, int ng,
                        int ds, void* stream) {
  if (ds < 1 || ds > MAX_DS || ng < 1 || nh % ng || S < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (B == 0 || nh == 0 || hd == 0) {  // nothing reaches a gradient
    const size_t n_bc = sizeof(float) * B * S * ng * ds;
    if ((err = cudaMemsetAsync(dB, 0, n_bc, s)) != cudaSuccess ||
        (err = cudaMemsetAsync(dC, 0, n_bc, s)) != cudaSuccess ||
        (err = cudaMemsetAsync(ddt, 0, sizeof(float) * B * S * nh, s)) != cudaSuccess ||
        (err = cudaMemsetAsync(dA, 0, sizeof(float) * nh, s)) != cudaSuccess)
      return err;
    return cudaMemsetAsync(dD, 0, sizeof(float) * nh, s);
  }
  const int nc = (S + CL - 1) / CL, ndc = ssd32::padded_ds(ds) / 64;
  const int runs = head_runs(B, nc, ng, nh, ds);
  const int hr = (nh / ng + runs - 1) / runs;
  const WorkSizes sizes = work_sizes(B, S, nh, hd, ng, ds);
  const Work w = carve(static_cast<float*>(work), sizes);
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const int vec_x = hd % 4 == 0 && ssd32::aligned16(x) && ssd32::aligned16(dy);
  const int vec_bc = ds % 4 == 0 && ssd32::aligned16(Bm) && ssd32::aligned16(Cm);
  const int vec_st = ds % 4 == 0;  // the scratch is 16-byte aligned

  if ((err = ssd32::launch_chunk_states(
           xf, static_cast<const float*>(dt), static_cast<const float*>(A), Bf,
           Cf, dyf, w.fw, w.dso, w.vecs, B, S, nh, hd, ng, ds, vec_x, vec_bc,
           s)) != cudaSuccess)
    return err;
  if ((err = ssd32::launch_state_pass(w.fw, nullptr, w.dso,
                                      static_cast<const float*>(dstate), B, S,
                                      nh, hd, ng, ds, s)) != cudaSuccess)
    return err;

  const size_t sm_g = smem_grads(), sm_d = smem_dbc();
  if ((err = cudaFuncSetAttribute(ssd_grads_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(sm_g))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_dbc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(sm_d))) != cudaSuccess)
    return err;
  ssd_grads_kernel<<<dim3(nc, nh, B), NT, sm_g, s>>>(
      xf, static_cast<const float*>(A), Bf, Cf, static_cast<const float*>(D),
      dyf, w.fw, w.dso, w.vecs, static_cast<float*>(dx),
      static_cast<float*>(ddt), w.pA, w.pD, S, nh, hd, ng, ds, nc, vec_x,
      vec_bc, vec_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dbc_kernel<<<dim3(nc * ndc * runs, ng, B), NT, sm_d, s>>>(
      xf, Bf, Cf, dyf, w.fw, w.dso, w.vecs, w.pB, w.pC, S, nh, hd, ng, ds, nc,
      ndc, runs, hr, vec_x, vec_bc, vec_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)B * S * ng * ds + nh;
  ssd_reduce_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(
      w.pB, w.pC, w.pA, w.pD, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), static_cast<float*>(dD), B, S, nh, ng, ds, nc,
      runs);
  return cudaGetLastError();
}
