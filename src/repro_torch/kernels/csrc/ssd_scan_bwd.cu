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
// Two CUDA kernels a call, on the caller's stream:
//  (a) ssd_scan_bwd_kernel, the forward's float32 shape: one block per
//      (TP = 32 rows of hd, head h, batch row b), 16 x 16 threads, tiles of
//      TL = 64 positions, every product on the f32 CUDA cores. Walk 1 runs
//      the forward's state recurrence and writes S_c for every chunk to
//      float32 scratch (B, nc, nh, hd, ds). Walk 2 goes back over the
//      chunks with dS in shared memory: per chunk it forms G, R and from
//      them M, dG and Q on the lower triangle, then dx (the block's rows
//      are its own), the block's partial dB and dC rows (its 32 rows of
//      hd), and one thread the chunk's dcum, its reverse running sum, the
//      partial ddt and the running dA and dD, all in a fixed order. Every
//      gradient but dx sums over the head dim, so a block's partials go to
//      scratch.
//  (b) ssd_scan_bwd_reduce_kernel, one thread per output element: dB and
//      dC add the partials of the group's heads in order, each over its
//      row tiles in order; ddt its row tiles; dA and dD every batch row's
//      row tiles. No atomics anywhere, so a call's bits do not move from
//      run to run.
//
// Shared memory: B, C (TL x ds), S_c and dS (TP x ds), x and dy (TL x TP),
// M, dG and Q (TL x TL), row partials and a few TL vectors: 178.7 KB at
// ds = 128 (the wrapper refuses ds > 128; every SSM config of the registry
// has ds <= 128).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TL = 64;       // sequence positions per tile
constexpr int TP = 32;       // rows of the head dim per block
constexpr int NT = 256;      // 16 x 16 threads
constexpr int MAX_DS = 128;  // state width the shared memory holds
constexpr int LANES = 16;    // threads along a row of a product
constexpr int NVEC = 10;     // TL-long vectors in shared memory

size_t smem_floats(int ds) {
  const size_t ldn = ds + 1;
  return (2 * TL + 2 * TP) * ldn + 2 * size_t(TL) * (TP + 1) +
         3 * size_t(TL) * (TL + 1) + 2 * size_t(TL) * (LANES + 1) + NT +
         NVEC * TL;
}

__global__ void __launch_bounds__(NT)
    ssd_scan_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D,
                        const float* __restrict__ dy,
                        const float* __restrict__ dstate,
                        float* __restrict__ dx, float* __restrict__ states,
                        float* __restrict__ pB, float* __restrict__ pC,
                        float* __restrict__ pdt, float* __restrict__ pA,
                        float* __restrict__ pD, int S, int nh, int hd,
                        int ng, int ds) {
  extern __shared__ float smem[];
  const int pt = blockIdx.x, p0 = pt * TP, h = blockIdx.y, b = blockIdx.z;
  const int npt = gridDim.x;
  const int g = h / (nh / ng);
  const int nc = (S + TL - 1) / TL;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ldn = ds + 1, ldx = TP + 1, ldm = TL + 1, ldr = LANES + 1;
  float* Bs = smem;              // TL x ldn: B rows of the tile
  float* Cs = Bs + TL * ldn;     // TL x ldn: C rows
  float* st = Cs + TL * ldn;     // TP x ldn: S_c (walk 1: the carried state)
  float* dS = st + TP * ldn;     // TP x ldn: the gradient of the state
  float* xs = dS + TP * ldn;     // TL x ldx: x rows, this block's p
  float* dys = xs + TL * ldx;    // TL x ldx: dy rows, this block's p
  float* Ms = dys + TL * ldx;    // TL x ldm: G w dt[k], k <= t
  float* dGs = Ms + TL * ldm;    // TL x ldm: w dt[k] R
  float* Qs = dGs + TL * ldm;    // TL x ldm: G w R
  float* redV = Qs + TL * ldm;   // TL x ldr: x[k].(dS.B[k]) by lane
  float* redH = redV + TL * ldr; // TL x ldr: dy[t].(S_c C[t]) by lane
  float* redS = redH + TL * ldr; // NT: <dS, S_c> by thread
  float* dts = redS + NT;        // TL: dt
  float* cum = dts + TL;         // TL: running sum of dt * A
  float* ecum = cum + TL;        // TL: exp(cum)
  float* dec = ecum + TL;        // TL: e = exp(cum[last] - cum)
  float* rowP = dec + TL;        // TL: sum_k dt[k] Q[t,k]
  float* colQ = rowP + TL;       // TL: sum_t Q[t,k]
  float* Rd = colQ + TL;         // TL: R[t,t] = dy[t].x[t]
  float* Vv = Rd + TL;           // TL: x[k].(dS.B[k])
  float* off = Vv + TL;          // TL: exp(cum[t]) dy[t].(S_c C[t])
  float* wk = off + TL;          // TL: walk 1's dt * e
  const float a = A[h], dh = D[h];
  const size_t plane = size_t(nh) * hd * ds;  // one chunk's states

  // ---- walk 1: the states entering each chunk, to scratch -------------
  for (int i = tid; i < TP * ldn; i += NT) st[i] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * TL;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TP * ds; i += NT) {
      const int p = i / ds, d = i - p * ds;
      if (p0 + p < hd)
        states[(size_t(b) * nc + c) * plane + (size_t(h) * hd + p0 + p) * ds +
               d] = st[p * ldn + d];
    }
    if (c == nc - 1) break;  // the state leaving the last chunk is not read
    for (int i = tid; i < TL; i += NT) {
      const int t = t0 + i;
      dts[i] = t < S ? dt[(size_t(b) * S + t) * nh + h] : 0.f;
    }
    for (int i = tid; i < TL * ds; i += NT) {
      const int r = i / ds, d = i - r * ds, t = t0 + r;
      Bs[r * ldn + d] =
          t < S ? Bm[((size_t(b) * S + t) * ng + g) * ds + d] : 0.f;
    }
    for (int i = tid; i < TL * TP; i += NT) {
      const int r = i / TP, p = i - r * TP, t = t0 + r;
      xs[r * ldx + p] = (t < S && p0 + p < hd)
                            ? x[((size_t(b) * S + t) * nh + h) * hd + p0 + p]
                            : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < TL; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], a));
        cum[i] = s;
      }
    }
    __syncthreads();
    const float last = cum[TL - 1];
    if (tid < TL) wk[tid] = dts[tid] * expf(last - cum[tid]);
    __syncthreads();
    const float chunk_decay = expf(last);
    for (int d0 = 0; d0 < ds; d0 += LANES * 8) {
      float acc[2][8] = {};
      for (int k = 0; k < TL; ++k) {
        const float w = wk[k];
        float xv[2], bv[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) xv[i] = xs[k * ldx + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d0 + tx + 16 * j;
          bv[j] = d < ds ? Bs[k * ldn + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = ty + 16 * i, d = d0 + tx + 16 * j;
          if (d < ds)
            st[p * ldn + d] = st[p * ldn + d] * chunk_decay + acc[i][j];
        }
    }
  }
  __syncthreads();

  // ---- walk 2: back over the chunks, carrying dS -----------------------
  for (int i = tid; i < TP * ds; i += NT) {
    const int p = i / ds, d = i - p * ds;
    dS[p * ldn + d] =
        (dstate != nullptr && p0 + p < hd)
            ? dstate[((size_t(b) * nh + h) * hd + p0 + p) * ds + d]
            : 0.f;
  }
  float dA_acc = 0.f, dD_acc = 0.f;  // thread 0's, in chunk order
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * TL;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < TL; i += NT) {
      const int t = t0 + i;
      dts[i] = t < S ? dt[(size_t(b) * S + t) * nh + h] : 0.f;
    }
    for (int i = tid; i < TL * ds; i += NT) {
      const int r = i / ds, d = i - r * ds, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < S) {
        const size_t o = ((size_t(b) * S + t) * ng + g) * ds + d;
        bv = Bm[o];
        cv = Cm[o];
      }
      Bs[r * ldn + d] = bv;
      Cs[r * ldn + d] = cv;
    }
    for (int i = tid; i < TL * TP; i += NT) {
      const int r = i / TP, p = i - r * TP, t = t0 + r;
      float xv = 0.f, gv = 0.f;
      if (t < S && p0 + p < hd) {
        const size_t o = ((size_t(b) * S + t) * nh + h) * hd + p0 + p;
        xv = x[o];
        gv = dy[o];
      }
      xs[r * ldx + p] = xv;
      dys[r * ldx + p] = gv;
    }
    for (int i = tid; i < TP * ds; i += NT) {
      const int p = i / ds, d = i - p * ds;
      st[p * ldn + d] =
          p0 + p < hd
              ? states[(size_t(b) * nc + c) * plane +
                       (size_t(h) * hd + p0 + p) * ds + d]
              : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < TL; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], a));
        cum[i] = s;
      }
    }
    __syncthreads();
    const float last = cum[TL - 1];
    if (tid < TL) {
      ecum[tid] = expf(cum[tid]);
      dec[tid] = expf(last - cum[tid]);
    }

    // G = C.B^T and R = dy.x^T on this block's rows; M, dG, Q from them
    {
      float gacc[4][4] = {}, racc[4][4] = {};
      for (int d = 0; d < ds; ++d) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ldn + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] += cv[i] * bv[j];
      }
      for (int p = 0; p < TP; ++p) {
        float gv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = dys[(ty + 16 * i) * ldx + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[(tx + 16 * j) * ldx + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) racc[i][j] += gv[i] * xv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, k = tx + 16 * j;
          float m = 0.f, dg = 0.f, q = 0.f;
          if (k <= t) {
            const float w = expf(cum[t] - cum[k]);
            m = gacc[i][j] * w * dts[k];
            dg = w * dts[k] * racc[i][j];
            q = gacc[i][j] * w * racc[i][j];
          }
          if (k == t) Rd[t] = racc[i][j];
          Ms[t * ldm + k] = m;
          dGs[t * ldm + k] = dg;
          Qs[t * ldm + k] = q;
        }
    }
    __syncthreads();

    // row sums of dt[k] Q[t,k] and column sums of Q, in order
    if (tid < TL) {
      float s = 0.f;
      for (int k = 0; k <= tid; ++k) s += dts[k] * Qs[tid * ldm + k];
      rowP[tid] = s;
    } else if (tid < 2 * TL) {
      const int k = tid - TL;
      float s = 0.f;
      for (int t = k; t < TL; ++t) s += Qs[t * ldm + k];
      colQ[k] = s;
    }

    // dx[k] = sum_t M[t,k] dy[t] + e[k] dt[k] (dS.B[k]) + D dy[k]
    {
      float acc[4][2] = {}, E[4][2] = {};
      for (int t = ty; t < TL; ++t) {  // M[t,k] = 0 for t < k
        float m[4], gv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = Ms[t * ldm + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 2; ++j) gv[j] = dys[t * ldx + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] += m[i] * gv[j];
      }
      for (int d = 0; d < ds; ++d) {
        float bv[4], sv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bs[(ty + 16 * i) * ldn + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) sv[j] = dS[(tx + 16 * j) * ldn + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) E[i][j] += bv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = ty + 16 * i, t = t0 + k;
        const float ek = dec[k] * dts[k];
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = tx + 16 * j;
          v += xs[k * ldx + p] * E[i][j];
          if (t < S && p0 + p < hd)
            dx[((size_t(b) * S + t) * nh + h) * hd + p0 + p] =
                acc[i][j] + ek * E[i][j] + dh * dys[k * ldx + p];
        }
        redV[k * ldr + tx] = v;
      }
    }

    // the block's partial dB and dC rows; dy[t].(S_c C[t]) by lane
    {
      float* pb = pB + ((size_t(b) * nh + h) * npt + pt) * size_t(S) * ds;
      float* pc = pC + ((size_t(b) * nh + h) * npt + pt) * size_t(S) * ds;
      float hsum[4] = {};
      for (int d0 = 0; d0 < ds; d0 += LANES * 8) {
        // dB[k] = sum_t dG[t,k] C[t] + e[k] dt[k] (x[k]^T.dS)
        {
          float acc[4][8] = {}, F[4][8] = {};
          for (int t = ty; t < TL; ++t) {  // dG[t,k] = 0 for t < k
            float gv[4], cv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i] = dGs[t * ldm + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              cv[j] = d < ds ? Cs[t * ldn + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] += gv[i] * cv[j];
          }
          for (int p = 0; p < TP; ++p) {
            float xv[4], sv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 16 * i) * ldx + p];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              sv[j] = d < ds ? dS[p * ldn + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) F[i][j] += xv[i] * sv[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = ty + 16 * i, t = t0 + k;
            const float ek = dec[k] * dts[k];
            if (t >= S) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              if (d < ds) pb[size_t(t) * ds + d] = acc[i][j] + ek * F[i][j];
            }
          }
        }
        // dC[t] = sum_k dG[t,k] B[k] + exp(cum[t]) (dy[t]^T.S_c)
        {
          float acc[4][8] = {}, H[4][8] = {};
          const int kend = ty + 16 * 3 + 1;  // dG is 0 past this thread's rows
          for (int k = 0; k < kend; ++k) {
            float gv[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i] = dGs[(ty + 16 * i) * ldm + k];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              bv[j] = d < ds ? Bs[k * ldn + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] += gv[i] * bv[j];
          }
          for (int p = 0; p < TP; ++p) {
            float gv[4], sv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i] = dys[(ty + 16 * i) * ldx + p];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              sv[j] = d < ds ? st[p * ldn + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) H[i][j] += gv[i] * sv[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = ty + 16 * i, t = t0 + q;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int d = d0 + tx + 16 * j;
              if (d >= ds) continue;
              hsum[i] += H[i][j] * Cs[q * ldn + d];
              if (t < S)
                pc[size_t(t) * ds + d] = acc[i][j] + ecum[q] * H[i][j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) redH[(ty + 16 * i) * ldr + tx] = hsum[i];
    }

    // <dS, S_c> by thread
    {
      float s = 0.f;
      for (int i = tid; i < TP * ds; i += NT) {
        const int p = i / ds, d = i - p * ds;
        s += dS[p * ldn + d] * st[p * ldn + d];
      }
      redS[tid] = s;
    }
    __syncthreads();
    if (tid < TL) {
      float v = 0.f, hv = 0.f;
      for (int l = 0; l < LANES; ++l) {
        v += redV[tid * ldr + l];
        hv += redH[tid * ldr + l];
      }
      Vv[tid] = v;
      off[tid] = ecum[tid] * hv;
    }
    __syncthreads();

    // one thread: dcum, its reverse running sum, ddt, dA and dD in order
    if (tid == 0) {
      float dot = 0.f;
      for (int i = 0; i < NT; ++i) dot += redS[i];
      float sumU = 0.f;
      for (int t = 0; t < TL; ++t) sumU += dec[t] * dts[t] * Vv[t];
      float rc = 0.f;
      float* pd = pdt + ((size_t(b) * nh + h) * npt + pt) * size_t(S);
      for (int t = TL - 1; t >= 0; --t) {
        float dcum = rowP[t] - dts[t] * colQ[t] + off[t] -
                     dec[t] * dts[t] * Vv[t];
        if (t == TL - 1) dcum += expf(last) * dot + sumU;
        rc += dcum;
        dA_acc += dts[t] * rc;
        if (t0 + t < S) pd[t0 + t] = colQ[t] + dec[t] * Vv[t] + a * rc;
      }
      for (int t = 0; t < TL; ++t) dD_acc += Rd[t];
    }

    // dS <- exp(cum[last]) dS + sum_t exp(cum[t]) dy[t] (x) C[t]; every
    // read of dS this chunk is behind the barriers above
    {
      const float chunk_decay = expf(last);
      for (int d0 = 0; d0 < ds; d0 += LANES * 8) {
        float acc[2][8] = {};
        for (int t = 0; t < TL; ++t) {
          const float e = ecum[t];
          float gv[2], cv[8];
#pragma unroll
          for (int i = 0; i < 2; ++i) gv[i] = dys[t * ldx + ty + 16 * i] * e;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int d = d0 + tx + 16 * j;
            cv[j] = d < ds ? Cs[t * ldn + d] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += gv[i] * cv[j];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = ty + 16 * i, d = d0 + tx + 16 * j;
            if (d < ds)
              dS[p * ldn + d] = dS[p * ldn + d] * chunk_decay + acc[i][j];
          }
      }
    }
  }
  if (tid == 0) {
    const size_t o = (size_t(b) * nh + h) * npt + pt;
    pA[o] = dA_acc;
    pD[o] = dD_acc;
  }
}

// dB and dC: the group's heads in order, each over its row tiles in order;
// ddt: the row tiles; dA and dD: the batch rows', each over its row tiles
__global__ void ssd_scan_bwd_reduce_kernel(
    const float* __restrict__ pB, const float* __restrict__ pC,
    const float* __restrict__ pdt, const float* __restrict__ pA,
    const float* __restrict__ pD, float* __restrict__ dB,
    float* __restrict__ dC, float* __restrict__ ddt, float* __restrict__ dA,
    float* __restrict__ dD, int B, int S, int nh, int ng, int ds, int npt) {
  const long long n_bc = (long long)B * S * ng * ds;
  const long long n_dt = (long long)B * S * nh;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int rep = nh / ng;
  if (i < n_bc) {
    const int d = int(i % ds);
    const long long r = i / ds;
    const int g = int(r % ng);
    const long long bt = r / ng;
    const int t = int(bt % S), b = int(bt / S);
    float sb = 0.f, sc = 0.f;
    for (int h = g * rep; h < (g + 1) * rep; ++h)
      for (int p = 0; p < npt; ++p) {
        const size_t o =
            (((size_t(b) * nh + h) * npt + p) * S + t) * size_t(ds) + d;
        sb += pB[o];
        sc += pC[o];
      }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < n_bc + n_dt) {
    const long long j = i - n_bc;
    const int h = int(j % nh);
    const long long bt = j / nh;
    const int t = int(bt % S), b = int(bt / S);
    float s = 0.f;
    for (int p = 0; p < npt; ++p)
      s += pdt[((size_t(b) * nh + h) * npt + p) * S + t];
    ddt[j] = s;
  } else if (i < n_bc + n_dt + nh) {
    const int h = int(i - n_bc - n_dt);
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b)
      for (int p = 0; p < npt; ++p) {
        const size_t o = (size_t(b) * nh + h) * npt + p;
        sa += pA[o];
        sd += pD[o];
      }
    dA[h] = sa;
    dD[h] = sd;
  }
}

struct Work {
  float *states, *pB, *pC, *pdt, *pA, *pD;
};

// scratch sizes in floats: the chunk states, the dB / dC partials, the
// ddt partials, the dA / dD partials
struct WorkSizes {
  size_t states, p, dt, s;
  size_t total() const { return states + 2 * p + dt + 2 * s; }
};

WorkSizes work_sizes(int B, int S, int nh, int hd, int ds) {
  const size_t nc = (S + TL - 1) / TL, npt = (hd + TP - 1) / TP;
  return {size_t(B) * nc * nh * hd * ds, size_t(B) * nh * npt * S * ds,
          size_t(B) * nh * npt * S, size_t(B) * nh * npt};
}

Work carve(float* base, const WorkSizes& n) {
  Work w;
  w.states = base;
  w.pB = w.states + n.states;
  w.pC = w.pB + n.p;
  w.pdt = w.pC + n.p;
  w.pA = w.pdt + n.dt;
  w.pD = w.pA + n.s;
  return w;
}

}  // namespace

// Floats of float32 scratch a call needs: the chunk states and the
// blocks' partial gradients.
long long ssd_scan_bwd_work_floats(int B, int S, int nh, int hd, int ng,
                                   int ds) {
  (void)ng;
  return (long long)work_sizes(B, S, nh, hd, ds).total();
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
  const Work w =
      carve(static_cast<float*>(work), work_sizes(B, S, nh, hd, ds));
  const int npt = (hd + TP - 1) / TP;
  cudaError_t err;
  if (B > 0 && nh > 0 && npt > 0) {
    const size_t smem = smem_floats(ds) * sizeof(float);
    err = cudaFuncSetAttribute(ssd_scan_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
    ssd_scan_bwd_kernel<<<dim3(npt, nh, B), NT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(D),
        static_cast<const float*>(dy), static_cast<const float*>(dstate),
        static_cast<float*>(dx), w.states, w.pB, w.pC, w.pdt, w.pA, w.pD, S,
        nh, hd, ng, ds);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n = (long long)B * S * ng * ds + (long long)B * S * nh + nh;
  if (n > 0) {
    ssd_scan_bwd_reduce_kernel<<<unsigned((n + 255) / 256), 256, 0, s>>>(
        w.pB, w.pC, w.pdt, w.pA, w.pD, static_cast<float*>(dB),
        static_cast<float*>(dC), static_cast<float*>(ddt),
        static_cast<float*>(dA), static_cast<float*>(dD), B, S, nh, ng, ds,
        npt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
