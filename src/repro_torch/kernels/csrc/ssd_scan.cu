// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). For each batch row b and head h (group g = h / (nh / ng)),
// the sequence cut into 64-position chunks:
//
//   cum[t]  = inclusive running sum of dt[t] * A[h] within a chunk
//   y[t]    = sum_{k <= t in the chunk} (C[t].B[k]) exp(cum[t] - cum[k])
//             dt[k] x[k]  +  exp(cum[t]) (C[t] . state)  +  D[h] x[t]
//   state  <- exp(cum[last]) state + sum_k exp(cum[last] - cum[k]) dt[k]
//             x[k] (x) B[k]                 (after each chunk)
//
// Layout: x (B, S, nh, hd), dt (B, S, nh), B/C (B, S, ng, ds) in T
// (float32 or bfloat16); A, D (nh,) float32; y (B, S, nh, hd) and the
// final state (B, nh, hd, ds) in T. Decay math and the carried state are
// float32. The result does not depend on where the sequence is cut, up to
// rounding, so the kernel cuts at 64 positions whatever the caller's chunk
// (the wrapper still refuses an S that chunk does not divide, as JAX
// asserts); a ragged last chunk is padded with dt = x = B = C = 0, which
// adds nothing to y or to the state.
//
// Bound. At the main path's prefill (B = 1, S = 512, nh = 80, hd = 64,
// ng = 1, ds = 128, bf16) the function moves ~12.1 MB (x and y ~5.2 MB
// each, the state ~1.3 MB, dt, B and C ~0.35 MB): ~3.6 us at 3.35 TB/s;
// its ~2.7 GFLOP take ~2.7 us at the bf16 tensor-core peak. So it is bound
// by bytes.
//
// bfloat16 body (tc::): Mamba2's own GPU decomposition (arXiv:2405.21060
// section 6), three launches on the caller's stream:
//  (a) ssd_chunk_state_kernel, one block per (chunk, head, 64 rows of hd,
//      batch row), all chunks in parallel: the chunk's running sum of
//      dt * A (one thread, in order, no fused multiply-add, as the plain
//      version's cumsum) and its own state contribution
//      (wk x)^T . B on the tensor cores; the first block of each group
//      also computes G = C.B^T, once per (batch, chunk, group), shared by
//      the group's heads;
//  (b) ssd_state_pass_kernel, one thread per state element: the short
//      sequential pass over the chunks, state_c = exp(cum[last]) *
//      state_{c-1} + own_c, in float32, leaving the state entering each
//      chunk and writing the final state;
//  (c) ssd_chunk_out_kernel, one block per (chunk, head, rows, batch):
//      y = exp(cum) * (C . state_in) + (G o L o dt) . x + D x, both
//      products on the tensor cores, the lower triangle only.
// Products are mma.sync m16n8k16, bf16 operands, f32 accumulation; x, B
// and C are bf16 already. The operands the kernel computes in float32 (the
// decay-weighted M = G o L o dt, wk x, and the carried state) go in as two
// bf16 halves, hi = bf16(v) and lo = bf16(v - hi), two products each: one
// bf16 rounding of M (8 bits) would leave ~2e-3 of a row's largest terms,
// more than the 2e-2 element-wise gate allows where terms cancel; hi + lo
// keeps ~16 bits, and TF32 (10 bits) would have needed the same split.
// Tiles are staged by cp.async with 16-byte rows of padding (ldmatrix
// free of bank conflicts). Scratch, float32, from the wrapper: G (64 x 64
// per chunk and group), per chunk and head one decay, the 64 running sums
// (the output kernel reads them, so they are summed once) and one (hd,
// ds) state (~2.6 MB a chunk at the main shape).
//
// float32 body (unchanged since the first port). ONE block owns the
// carried state of its slice and a loop inside it walks the sequence: a
// block is (TP = 32 rows of hd, head h, batch row b), the state's rows p
// being independent (y[:, p] and state[p, :] read only x[:, p]). The block
// keeps its TP x ds f32 state in shared memory and walks the sequence in
// tiles of TL = 64 positions; per tile it loads B, C and x rows as f32,
// forms the running sum of dt * A, M = (C.B^T) * exp(cum[q] - cum[k]) *
// dt[k] on the lower triangle (16 x 16 threads, 4 x 4 entries each), y =
// M.x + exp(cum) * (C.state) + D x, then the state update. All its
// products run on the f32 CUDA cores, on purpose: TF32 tensor cores keep
// 10 mantissa bits and would miss the 5e-5 float32 gate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int TL = 64;       // sequence positions per tile
constexpr int TP = 32;       // rows of the head dim per block
constexpr int NT = 256;      // 16 x 16 threads
constexpr int MAX_DS = 256;  // state width the shared memory holds

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

size_t smem_bytes(int ds) {
  const size_t ldn = ds + 1;
  return sizeof(float) * ((2 * TL + TP) * ldn + size_t(TL) * (TP + 1) +
                          size_t(TL) * (TL + 1) + 3 * TL);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ D,
                    T* __restrict__ y, T* __restrict__ state_out, int S,
                    int nh, int hd, int ng, int ds) {
  extern __shared__ float smem[];
  const int p0 = blockIdx.x * TP, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / ng);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ldn = ds + 1, ldx = TP + 1, ldm = TL + 1;
  float* Bs = smem;             // TL x ldn: B rows of the tile
  float* Cs = Bs + TL * ldn;    // TL x ldn: C rows
  float* st = Cs + TL * ldn;    // TP x ldn: the carried state
  float* xs = st + TP * ldn;    // TL x ldx: x rows, this block's p
  float* Ms = xs + TL * ldx;    // TL x ldm: (C.B^T) * decay * dt, k <= q
  float* cum = Ms + TL * ldm;   // TL: running sum of dt * A
  float* dts = cum + TL;        // TL: dt
  float* wk = dts + TL;         // TL: dt * exp(cum[last] - cum)
  const float a = A[h], dh = D[h];
  for (int i = tid; i < TP * ldn; i += NT) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TL) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TL; i += NT) {
      const int t = t0 + i;
      dts[i] = t < S ? to_float(dt[(size_t(b) * S + t) * nh + h]) : 0.f;
    }
    for (int i = tid; i < TL * ds; i += NT) {
      const int r = i / ds, d = i - r * ds, t = t0 + r;
      float bv = 0.f, cv = 0.f;
      if (t < S) {
        const size_t off = ((size_t(b) * S + t) * ng + g) * ds + d;
        bv = to_float(Bm[off]);
        cv = to_float(Cm[off]);
      }
      Bs[r * ldn + d] = bv;
      Cs[r * ldn + d] = cv;
    }
    for (int i = tid; i < TL * TP; i += NT) {
      const int r = i / TP, p = i - r * TP, t = t0 + r;
      xs[r * ldx + p] =
          (t < S && p0 + p < hd)
              ? to_float(x[((size_t(b) * S + t) * nh + h) * hd + p0 + p])
              : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int i = 0; i < TL; ++i) {
        c = __fadd_rn(c, __fmul_rn(dts[i], a));
        cum[i] = c;
      }
    }
    __syncthreads();
    const float last = cum[TL - 1];
    if (tid < TL) wk[tid] = dts[tid] * expf(last - cum[tid]);

    // M = (C.B^T) * exp(cum[q] - cum[k]) * dt[k] for k <= q, else 0
    {
      float acc[4][4] = {};
      for (int d = 0; d < ds; ++d) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ldn + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = ty + 16 * i, k = tx + 16 * j;
          Ms[q * ldm + k] =
              k <= q ? acc[i][j] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
        }
    }
    __syncthreads();

    // y = M.x + exp(cum) * (C.state) + D x, with the state entering the tile
    {
      float acc[4][2] = {}, off[4][2] = {};
      const int kend = ty + 16 * 3 + 1;  // M is 0 past this thread's rows
      for (int k = 0; k < kend; ++k) {
        float m[4], xv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = Ms[(ty + 16 * i) * ldm + k];
#pragma unroll
        for (int j = 0; j < 2; ++j) xv[j] = xs[k * ldx + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] += m[i] * xv[j];
      }
      for (int d = 0; d < ds; ++d) {
        float cv[4], sv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * ldn + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) sv[j] = st[(tx + 16 * j) * ldn + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) off[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i, t = t0 + q;
        if (t >= S) continue;
        const float decay = expf(cum[q]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = tx + 16 * j;
          if (p0 + p >= hd) continue;
          y[((size_t(b) * S + t) * nh + h) * hd + p0 + p] = from_float<T>(
              acc[i][j] + off[i][j] * decay + xs[q * ldx + p] * dh);
        }
      }
    }
    __syncthreads();  // every read of the entering state is done

    // state = exp(cum[last]) * state + sum_k wk[k] x[k] (x) B[k]
    {
      const float chunk_decay = expf(last);
      for (int d0 = 0; d0 < ds; d0 += 128) {
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
  }
  __syncthreads();
  for (int i = tid; i < TP * ds; i += NT) {
    const int p = i / ds, d = i - p * ds;
    if (p0 + p < hd)
      state_out[((size_t(b) * nh + h) * hd + p0 + p) * ds + d] =
          from_float<T>(st[p * ldn + d]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D, void* y,
                   void* state, int B, int S, int nh, int hd, int ng, int ds,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((hd + TP - 1) / TP, nh, B);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<T*>(state), S, nh, hd, ng, ds);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 body: the chunked SSD in parallel over chunks, on tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int CL = 64;   // positions per chunk (the kernel's cut)
constexpr int PT = 64;   // rows of the head dim per block
constexpr int NT = 128;  // four warps, 16 rows of the block's 64 each
constexpr int PAD = 8;   // bf16 of padding a shared row (ldmatrix banks)
constexpr int LDX = PT + PAD;

using bf16 = __nv_bfloat16;

// ds rounded up to a multiple of 64 (zero columns add nothing)
__host__ __device__ inline int padded_ds(int ds) { return (ds + 63) / 64 * 64; }

// the chunk's dt (0 past S) and the inclusive running sum of dt * A, on one
// thread, in order, no fused multiply-add, as the plain version's cumsum;
// computed once per chunk and head (the chunk-state kernel), which leaves it
// in the scratch for the output kernel
__device__ __forceinline__ void chunk_decays(const bf16* __restrict__ dt,
                                             size_t b, int t0, int S, int nh,
                                             int h, float a, float* dts,
                                             float* cum, int tid) {
  for (int i = tid; i < CL; i += NT) {
    const int t = t0 + i;
    dts[i] = t < S ? __bfloat162float(dt[(b * S + t) * nh + h]) : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    float c = 0.f;
    for (int i = 0; i < CL; ++i) {
      c = __fadd_rn(c, __fmul_rn(dts[i], a));
      cum[i] = c;
    }
  }
  __syncthreads();
}

struct Scratch {  // float32 work the wrapper allocates
  float* G;       // (B, nc, ng, CL, CL): C.B^T of each chunk and group
  float* decay;   // (B, nc, nh): exp(sum of the chunk's dt * A)
  float* cum;     // (B, nc, nh, CL): the chunk's running sums of dt * A
  float* st;      // (B, nc, nh, hd, ds): a chunk's own state, then (after
                  // the state pass) the state entering it
};

__host__ __device__ inline Scratch carve(float* work, int B, int nc, int nh,
                                         int ng) {
  Scratch w;
  w.G = work;
  w.decay = w.G + size_t(B) * nc * ng * CL * CL;
  w.cum = w.decay + (size_t(B) * nc * nh + 3) / 4 * 4;  // 16-byte aligned
  w.st = w.cum + size_t(B) * nc * nh * CL;
  return w;
}

size_t smem_state(int ds) {
  return sizeof(bf16) * (size_t(CL) * LDX + 2 * size_t(CL) * (padded_ds(ds) + PAD)) +
         sizeof(float) * 3 * CL;
}
size_t smem_out(int ds) {
  return sizeof(bf16) * (size_t(CL) * LDX + 3 * size_t(CL) * (padded_ds(ds) + PAD)) +
         sizeof(float) * 3 * CL;
}

// (a) Per (chunk, head, 64-row slice of hd, batch row): the chunk's own
// state contribution st[p][d] = sum_k dt[k] exp(cum[last] - cum[k]) x[k][p]
// B[k][d], and exp(cum[last]); the first slice of a group's first head also
// computes G = C.B^T for the group, once per (batch, chunk, group).
__global__ void __launch_bounds__(NT)
    ssd_chunk_state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                           const float* __restrict__ A, const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm, float* __restrict__ work,
                           int S, int nh, int hd, int ng, int ds, int nc,
                           int npt, int vec_x, int vec_bc) {
  const int DSP = padded_ds(ds), LDN = DSP + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // CL x LDX: x[k][p]
  bf16* bs = xs + CL * LDX;                        // CL x LDN: B[k][d]
  bf16* cs = bs + CL * LDN;                        // CL x LDN: C[q][d]
  float* dts = reinterpret_cast<float*>(cs + CL * LDN);
  float* cum = dts + CL;
  float* wk = cum + CL;

  const int c = blockIdx.x / npt, p0 = (blockIdx.x % npt) * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rep = nh / ng, g = h / rep;
  const int t0 = c * CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const bool do_g = h % rep == 0 && p0 == 0;
  const Scratch w = carve(work, gridDim.z, nc, nh, ng);

  const size_t bc_off = ((size_t(b) * S + t0) * ng + g) * ds;
  mma::load_tile<CL, NT>(xs, LDX, x + ((size_t(b) * S + t0) * nh + h) * hd + p0,
                         size_t(nh) * hd, S - t0, hd - p0, PT, vec_x, tid);
  mma::load_tile<CL, NT>(bs, LDN, Bm + bc_off, size_t(ng) * ds, S - t0, ds,
                         DSP, vec_bc, tid);
  if (do_g)
    mma::load_tile<CL, NT>(cs, LDN, Cm + bc_off, size_t(ng) * ds, S - t0, ds,
                           DSP, vec_bc, tid);
  mma::cp_async_commit();
  chunk_decays(dt, b, t0, S, nh, h, A[h], dts, cum, tid);
  const float last = cum[CL - 1];
  if (tid < CL) wk[tid] = dts[tid] * expf(last - cum[tid]);
  if (p0 == 0) {
    const size_t bch = (size_t(b) * nc + c) * nh + h;
    if (tid < CL) w.cum[bch * CL + tid] = cum[tid];
    if (tid == 0) w.decay[bch] = expf(last);
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // A = (wk x)^T, rows p (this warp's 16), cols k: transposed ldmatrix of
  // x, each pair scaled by its wk and split into bf16 hi + lo
  uint32_t ahi[CL / 16][4], alo[CL / 16][4];
#pragma unroll
  for (int kk = 0; kk < CL / 16; ++kk) {
    uint32_t r[4];
    mma::ldsm_x4_t(r, xs + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * LDX +
                          warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kk * 16 + 2 * tq + (i >> 1) * 8;
      const float2 f = mma::unpack_bf16(r[i]);
      mma::split_bf16(f.x * wk[k], f.y * wk[k + 1], ahi[kk][i], alo[kk][i]);
    }
  }
  float* st = w.st + ((size_t(b) * nc + c) * nh + h) * size_t(hd) * ds;
  for (int d0 = 0; d0 < DSP; d0 += 64) {
    float acc[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < CL / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LDN + d0 + np * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * np], ahi[kk], r[0], r[1]);
        mma::mma_bf16(acc[2 * np], alo[kk], r[0], r[1]);
        mma::mma_bf16(acc[2 * np + 1], ahi[kk], r[2], r[3]);
        mma::mma_bf16(acc[2 * np + 1], alo[kk], r[2], r[3]);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + warp * 16 + gr + r * 8;
        const int d = d0 + n * 8 + 2 * tq;
        if (p >= hd || d >= ds) continue;
        float* at = st + size_t(p) * ds + d;
        if (d + 1 < ds && ds % 2 == 0)
          *reinterpret_cast<float2*>(at) = make_float2(acc[n][2 * r],
                                                       acc[n][2 * r + 1]);
        else
          for (int e = 0; e < 2 && d + e < ds; ++e) at[e] = acc[n][2 * r + e];
      }
  }

  if (do_g) {  // G[q][k] = C[q] . B[k], exact bf16 operands
    float acc[8][4] = {};
    for (int kk = 0; kk < DSP / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        mma::ldsm_x4(r, bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(acc[2 * np], a, r[0], r[1]);
        mma::mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
      }
    }
    float* G = w.G + ((size_t(b) * nc + c) * ng + g) * CL * CL;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            G + (warp * 16 + gr + r * 8) * CL + n * 8 + 2 * tq) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// (b) Per element of the (B, nh, hd, ds) state, in float32: walk the chunks
// in order, leave in st the state entering each chunk, carry
// state = exp(cum[last]) * state + the chunk's own, and write the final
// state in the input dtype.
__global__ void ssd_state_pass_kernel(float* __restrict__ work,
                                      bf16* __restrict__ state_out, int B,
                                      int nh, int hd, int ng, int ds, int nc) {
  const size_t per_head = size_t(hd) * ds;
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size_t(B) * nh * per_head) return;
  const int b = int(i / (nh * per_head));
  const int h = int(i / per_head % nh);
  const size_t e = i % per_head;
  const Scratch w = carve(work, B, nc, nh, ng);
  float* slot = w.st + (size_t(b) * nc * nh + h) * per_head + e;
  const float* dec = w.decay + size_t(b) * nc * nh + h;
  const size_t step = size_t(nh) * per_head;  // one chunk further
  float run = 0.f;
  // CB chunks' loads issued together before their stores, so a thread
  // keeps CB loads in flight rather than one
  constexpr int CB = 8;
  for (int c0 = 0; c0 < nc; c0 += CB) {
    float own[CB], d[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (c0 + j < nc) {
        own[j] = slot[(c0 + j) * step];
        d[j] = dec[(c0 + j) * nh];
      }
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (c0 + j < nc) {
        slot[(c0 + j) * step] = run;
        run = __fadd_rn(__fmul_rn(run, d[j]), own[j]);
      }
  }
  state_out[i] = __float2bfloat16(run);
}

// (c) Per (chunk, head, 64-row slice of hd, batch row): y = exp(cum) *
// (C.state_in) + (G o L o dt).x + D x, with L[q][k] = exp(cum[q] - cum[k])
// for k <= q, else 0.
__global__ void __launch_bounds__(NT)
    ssd_chunk_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                         const bf16* __restrict__ Cm,
                         const float* __restrict__ D, const float* __restrict__ work,
                         bf16* __restrict__ y, int S, int nh, int hd, int ng,
                         int ds, int nc, int npt, int vec_x, int vec_bc) {
  const int DSP = padded_ds(ds), LDN = DSP + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // CL x LDX: x[k][p]
  bf16* cs = xs + CL * LDX;                        // CL x LDN: C[q][d]
  bf16* sh = cs + CL * LDN;                        // PT x LDN: state_in hi
  bf16* sl = sh + PT * LDN;                        // PT x LDN: state_in lo
  float* dts = reinterpret_cast<float*>(sl + PT * LDN);
  float* cum = dts + CL;
  float* ec = cum + CL;

  const int c = blockIdx.x / npt, p0 = (blockIdx.x % npt) * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (nh / ng);
  const int t0 = c * CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const Scratch w = carve(const_cast<float*>(work), gridDim.z, nc, nh, ng);

  mma::load_tile<CL, NT>(xs, LDX, x + ((size_t(b) * S + t0) * nh + h) * hd + p0,
                         size_t(nh) * hd, S - t0, hd - p0, PT, vec_x, tid);
  if (c > 0)
    mma::load_tile<CL, NT>(cs, LDN, Cm + ((size_t(b) * S + t0) * ng + g) * ds,
                           size_t(ng) * ds, S - t0, ds, DSP, vec_bc, tid);
  mma::cp_async_commit();
  // this thread's entries of G on and below the warp's diagonal block, in
  // flight with the loads below: M's A fragments need no load later
  const float* G = w.G + ((size_t(b) * nc + c) * ng + g) * CL * CL;
  float2 gv[CL / 16][4];
#pragma unroll
  for (int kk = 0; kk < CL / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = warp * 16 + gr + (i & 1) * 8;
      const int k = kk * 16 + 2 * tq + (i >> 1) * 8;
      gv[kk][i] = kk <= warp ? *reinterpret_cast<const float2*>(G + q * CL + k)
                             : make_float2(0.f, 0.f);
    }
  if (tid < CL) {  // dt and the running sums the chunk-state kernel left
    const int t = t0 + tid;
    dts[tid] = t < S ? __bfloat162float(dt[(size_t(b) * S + t) * nh + h]) : 0.f;
    cum[tid] = w.cum[((size_t(b) * nc + c) * nh + h) * CL + tid];
    ec[tid] = expf(cum[tid]);
  }
  if (c > 0) {  // the state entering the chunk, split into bf16 hi + lo
    const float* st = w.st + ((size_t(b) * nc + c) * nh + h) * size_t(hd) * ds;
    // pairs of columns, LB of them a thread loaded before any is stored,
    // so LB loads are in flight at once
    constexpr int LB = 16;
    const int pairs = PT * (DSP / 2);
    for (int i0 = 0; i0 < pairs; i0 += LB * NT) {
      float2 v[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int i = i0 + j * NT + tid;
        const int p = i / (DSP / 2), d = (i % (DSP / 2)) * 2;
        const float* at = st + size_t(p0 + p) * ds + d;
        v[j] = make_float2(0.f, 0.f);
        if (i >= pairs || p0 + p >= hd) continue;
        if (d + 1 < ds && ds % 2 == 0) {
          v[j] = *reinterpret_cast<const float2*>(at);
        } else {
          v[j].x = d < ds ? at[0] : 0.f;
          v[j].y = d + 1 < ds ? at[1] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int i = i0 + j * NT + tid;
        if (i >= pairs) continue;
        const int p = i / (DSP / 2), d = (i % (DSP / 2)) * 2;
        uint32_t hi, lo;
        mma::split_bf16(v[j].x, v[j].y, hi, lo);
        *reinterpret_cast<uint32_t*>(sh + p * LDN + d) = hi;
        *reinterpret_cast<uint32_t*>(sl + p * LDN + d) = lo;
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();

  // rows q = warp * 16 + gr (+ 8) of the chunk, cols p of the slice
  float acc[8][4] = {};
  if (c > 0) {
    for (int kk = 0; kk < DSP / 16; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4(a, cs + (warp * 16 + (lane & 15)) * LDN + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int at = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN + kk * 16 +
                       ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        mma::ldsm_x4(r, sh + at);
        mma::mma_bf16(acc[2 * np], a, r[0], r[1]);
        mma::mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
        mma::ldsm_x4(r, sl + at);
        mma::mma_bf16(acc[2 * np], a, r[0], r[1]);
        mma::mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
      }
    }
    const float e0 = ec[warp * 16 + gr], e1 = ec[warp * 16 + gr + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }

  // + (G o L o dt).x over the key blocks at or below this warp's rows; M's
  // A fragments are built in registers from G and split hi + lo
#pragma unroll
  for (int kk = 0; kk < CL / 16; ++kk) {
    if (kk > warp) break;
    uint32_t mhi[4], mlo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = warp * 16 + gr + (i & 1) * 8;
      const int k = kk * 16 + 2 * tq + (i >> 1) * 8;
      const float m0 = k <= q ? gv[kk][i].x * expf(cum[q] - cum[k]) * dts[k] : 0.f;
      const float m1 =
          k + 1 <= q ? gv[kk][i].y * expf(cum[q] - cum[k + 1]) * dts[k + 1] : 0.f;
      mma::split_bf16(m0, m1, mhi[i], mlo[i]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      mma::ldsm_x4_t(r, xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX +
                            np * 16 + (lane >> 4) * 8);
      mma::mma_bf16(acc[2 * np], mhi, r[0], r[1]);
      mma::mma_bf16(acc[2 * np], mlo, r[0], r[1]);
      mma::mma_bf16(acc[2 * np + 1], mhi, r[2], r[3]);
      mma::mma_bf16(acc[2 * np + 1], mlo, r[2], r[3]);
    }
  }

  const float dh = D[h];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = warp * 16 + gr + r * 8, t = t0 + q;
    if (t >= S) continue;
    bf16* yrow = y + ((size_t(b) * S + t) * nh + h) * hd;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = n * 8 + 2 * tq;
      const float2 xv = mma::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xs + q * LDX + p));
      const float y0 = acc[n][2 * r] + xv.x * dh;
      const float y1 = acc[n][2 * r + 1] + xv.y * dh;
      if (p0 + p + 1 < hd && hd % 2 == 0) {
        *reinterpret_cast<uint32_t*>(yrow + p0 + p) = mma::pack_bf16(y0, y1);
      } else {
        if (p0 + p < hd) yrow[p0 + p] = __float2bfloat16(y0);
        if (p0 + p + 1 < hd) yrow[p0 + p + 1] = __float2bfloat16(y1);
      }
    }
  }
}

cudaError_t launch_bf16(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* D, void* y,
                        void* state, void* work, int B, int S, int nh, int hd,
                        int ng, int ds, cudaStream_t stream) {
  const int nc = (S + CL - 1) / CL, npt = (hd + PT - 1) / PT;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = hd % 8 == 0 && aligned(x);
  const int vec_bc = ds % 8 == 0 && aligned(Bm) && aligned(Cm);
  const size_t sm_state = smem_state(ds), sm_out = smem_out(ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sm_state));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(sm_out));
  if (err != cudaSuccess) return err;
  const dim3 grid(nc * npt, nh, B);
  float* wk = static_cast<float*>(work);
  ssd_chunk_state_kernel<<<grid, NT, sm_state, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), wk, S, nh, hd, ng, ds, nc, npt, vec_x,
      vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n = size_t(B) * nh * hd * ds;
  ssd_state_pass_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      wk, static_cast<bf16*>(state), B, nh, hd, ng, ds, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_out_kernel<<<grid, NT, sm_out, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const bf16*>(Cm),
      static_cast<const float*>(D), wk, static_cast<bf16*>(y), S, nh, hd, ng,
      ds, nc, npt, vec_x, vec_bc);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout
// (nh % ng == 0, 1 <= ds <= 256); for bfloat16 it passes ``work``, float32
// scratch of ssd_scan_work_floats(B, S, nh, hd, ng, ds) elements.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* state, void* work, int B, int S, int nh, int hd,
                    int ng, int ds, int is_bf16, void* stream) {
  if (ds < 1 || ds > MAX_DS || ng < 1 || nh % ng) return cudaErrorInvalidValue;
  if (B == 0 || nh == 0 || hd == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tc::launch_bf16(x, dt, A, Bm, Cm, D, y, state, work, B, S, nh, hd,
                           ng, ds, s);
  return launch<float>(x, dt, A, Bm, Cm, D, y, state, B, S, nh, hd, ng, ds,
                       s);
}

// Floats of scratch the bfloat16 body needs (0 for float32).
long long ssd_scan_work_floats(int B, int S, int nh, int hd, int ng, int ds,
                               int is_bf16) {
  if (!is_bf16) return 0;
  const long long nc = (S + tc::CL - 1) / tc::CL;
  return nc * B * (ng * tc::CL * tc::CL + (long long)nh * tc::CL +
                   (long long)nh * hd * ds) +
         (nc * B * nh + 3) / 4 * 4;
}
