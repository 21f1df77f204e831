// The float32 Mamba2 SSD chunked scan on the tensor cores (sm_90a), split
// TF32: the pieces ssd_scan.cu's float32 body and ssd_scan_bwd.cu share.
// Both files compile this header, so the backward's chunk states come from
// the same instructions as the forward's, with the same bits.
//
// The decomposition is Mamba2's own (arXiv:2405.21060 section 6), the one
// ssd_scan.cu's bfloat16 body runs, over 64-position chunks (a ragged last
// chunk padded with dt = x = B = C = 0, which adds nothing):
//  (a) chunk_state_kernel, one block per (chunk, head, 64 rows of hd, batch
//      row), all chunks in parallel: the chunk's running sum of dt * A (one
//      thread, in order, __fadd_rn / __fmul_rn, as the plain version's
//      cumsum), the chunk's own state contribution (wk x)^T . B with wk =
//      dt exp(cum[last] - cum), and, in the first block of each group,
//      G = C . B^T once per (batch, chunk, group). Given dy (the backward)
//      it also forms the chunk's own part of the state's gradient,
//      (exp(cum) dy)^T . C, and keeps dt, wk and exp(cum) per (batch,
//      chunk, head);
//  (b) state_pass_kernel, one thread per state element: the short float32
//      pass over the chunks, state_c = exp(cum[last]) state_{c-1} + own_c,
//      leaving the state entering each chunk (and the final state); for the
//      backward, the same pass in reverse over the gradient, from dstate.
// Every product is split TF32 (mma.cuh: hi = tf32(v), lo = tf32(v - hi),
// three m16n8k8 a product, ~22 significant bits): x, B and C are float32,
// so both operands are split. One TF32 product (11 bits) misses the 5e-5
// float32 gate (tests/test_torch_ssd_tf32.py shows it). Each k8 step's
// three terms are summed apart and added into the float32 accumulator by
// one rounded addition (mma_tf32x3_rn). Blocks of 8 warps; the pass moves
// float4 where it can.
//
// Tiles are float32 in shared memory with row strides of 4 mod 8 words
// (64 + 4, ds rounded up to 64, + 4): mma.cuh's fragment loaders then read
// one word a bank. Loaded by cp.async in 16-byte pieces where the widths
// and addresses allow it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {
namespace ssd32 {

constexpr int CL = 64;       // positions per chunk (the kernels' cut)
constexpr int PT = 64;       // rows of the head dim per block
constexpr int NT = 256;      // eight warps: (16 rows, a column half) each
constexpr int LDT = CL + 4;  // row stride of a 64-wide float32 tile

// ds rounded up to a multiple of 64 (zero columns add nothing)
__host__ __device__ inline int padded_ds(int ds) { return (ds + 63) / 64 * 64; }

struct Scratch {  // float32 work the wrappers allocate
  float* G;       // (B, nc, ng, CL, CL): C.B^T of each chunk and group
  float* decay;   // (B, nc, nh): exp(sum of the chunk's dt * A)
  float* cum;     // (B, nc, nh, CL): the chunk's running sums of dt * A
  float* st;      // (B, nc, nh, hd, ds): a chunk's own state, then (after
                  // the state pass) the state entering it
};

__host__ __device__ inline size_t scratch_floats(int B, int nc, int nh,
                                                 int hd, int ng, int ds) {
  return size_t(B) * nc * (size_t(ng) * CL * CL + size_t(nh) * CL +
                           size_t(nh) * hd * ds) +
         (size_t(B) * nc * nh + 3) / 4 * 4;
}

__host__ __device__ inline Scratch carve(float* work, int B, int nc, int nh,
                                         int ng) {
  Scratch w;
  w.G = work;
  w.decay = w.G + size_t(B) * nc * ng * CL * CL;
  w.cum = w.decay + (size_t(B) * nc * nh + 3) / 4 * 4;  // 16-byte aligned
  w.st = w.cum + size_t(B) * nc * nh * CL;
  return w;
}

// A from a row-major float32 tile with k permuted as load_bk_tf32's B
// (k = tq holds column 2tq, k = tq + 4 column 2tq + 1), row gr scaled by s0
// and row gr + 8 by s1 before the split: p = &tile[(m0 + gr) * ld + k0 +
// 2 tq]. Two 8-byte loads a lane.
__device__ __forceinline__ mma::FragA load_a_perm_tf32(const float* p, int ld,
                                                       float s0, float s1) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
  mma::FragA f;
  mma::split_tf32(u.x * s0, f.hi[0], f.lo[0]);
  mma::split_tf32(v.x * s1, f.hi[1], f.lo[1]);
  mma::split_tf32(u.y * s0, f.hi[2], f.lo[2]);
  mma::split_tf32(v.y * s1, f.hi[3], f.lo[3]);
  return f;
}

// d = a . b on the tensor cores with C = 0 (tf32 operands, f32 result)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// acc[n] += a . b[n] in split TF32 for NN n8 tiles, one k8 step: the three
// products (lo.hi, hi.lo, then hi.hi, as mma.cuh's mma_tf32x3) go into a
// zeroed accumulator and that step's sum into acc by one float32 addition,
// rounded to nearest. The tensor cores align a product's terms to the
// largest and drop the bits below (they truncate): over a long depth the
// accumulator's own truncations, each up to an ulp of the running sum and
// all toward zero, would add up to ~1e-4 of y at mamba2's widths (and grow
// with the heads dB and dC add); a step's sum carries them only at its own,
// smaller, scale.
template <int NN>
__device__ __forceinline__ void mma_tf32x3_rn(float (&acc)[NN][4],
                                              const mma::FragA& a,
                                              const mma::FragB (&b)[NN]) {
  float t[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) mma_tf32_zero(t[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma::mma_tf32(t[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n) mma::mma_tf32(t[n], a.hi, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += t[n][i];
}

// a C fragment's rows r = 0, 1 (gr, gr + 8) and columns 2tq, 2tq + 1 of
// n8 tile n into dst (row stride ld): rows past `rows` and columns past
// `cols` are not written
template <int NN>
__device__ __forceinline__ void store_c(const float (&acc)[NN][4], float* dst,
                                        size_t ld, int row0, int col0,
                                        int rows, int cols, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + gr + 8 * r, j = col0 + n * 8 + 2 * tq;
      if (i >= rows || j >= cols) continue;
      float* at = dst + i * ld + j;
      if (j + 1 < cols && (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0)
        *reinterpret_cast<float2*>(at) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      else
        for (int e = 0; e < 2 && j + e < cols; ++e) at[e] = acc[n][2 * r + e];
    }
}

// The chunk's dt (0 past S) and the inclusive running sum of dt * A, on one
// thread, in order, no fused multiply-add, as the plain version's cumsum.
__device__ __forceinline__ void chunk_decays(const float* __restrict__ dt,
                                             size_t b, int t0, int S, int nh,
                                             int h, float a, float* dts,
                                             float* cum, int tid) {
  for (int i = tid; i < CL; i += blockDim.x) {
    const int t = t0 + i;
    dts[i] = t < S ? dt[(b * S + t) * nh + h] : 0.f;
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

// dst[p][d] = sum_k us[k][p] vs[k][d] for this warp's 16 of the block's 64
// rows p (warp & 3) and its pieces of NN n8 tiles, d0 = NN 8 (warp >> 2) +
// NN 16 i < ds (dst's row stride ds; rows past `rows` are not written): A =
// us^T (k permuted, from load_at_tf32), B = vs.
template <int NN>
__device__ __forceinline__ void outer_store(const float* us, const float* vs,
                                            int ldv, int dsp, float* dst,
                                            int rows, int ds, int warp,
                                            int lane) {
  const int gr = lane >> 2, tq = lane & 3, r0 = 16 * (warp & 3);
  for (int d0 = NN * 8 * (warp >> 2); d0 < dsp; d0 += NN * 16) {
    float acc[NN][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < CL; kk += 8) {
      const mma::FragA a =
          mma::load_at_tf32(us + (kk + 2 * tq) * LDT + r0 + gr, LDT);
      mma::FragB b[NN];
#pragma unroll
      for (int n = 0; n < NN; ++n)
        b[n] = mma::load_bk_tf32(vs + (kk + 2 * tq) * ldv + d0 + n * 8 + gr, ldv);
      mma_tf32x3_rn(acc, a, b);
    }
    store_c(acc, dst, size_t(ds), r0, d0, rows, ds, lane);
  }
}

// outer_store in pieces of 64 columns where the two warp halves get as
// many, else (an odd count of 64, as ds = 64) of 32
__device__ __forceinline__ void outer_store(const float* us, const float* vs,
                                            int ldv, int dsp, float* dst,
                                            int rows, int ds, int warp,
                                            int lane) {
  if (dsp % 128 == 0)
    outer_store<8>(us, vs, ldv, dsp, dst, rows, ds, warp, lane);
  else
    outer_store<4>(us, vs, ldv, dsp, dst, rows, ds, warp, lane);
}

// G[q][k] = C[q] . B[k] for this warp's 16 rows q (warp & 3) and 32
// columns k (warp >> 2)
__device__ __forceinline__ void gram_store(const float* cs, const float* bs,
                                           int ld, int dsp, float* G, int warp,
                                           int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  float acc[4][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < dsp; kk += 8) {
    const mma::FragA a = mma::load_a_tf32(cs + (r0 + gr) * ld + kk + tq, ld);
    mma::FragB b[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      b[n] = mma::load_b_tf32(bs + (c0 + n * 8 + gr) * ld + kk + tq);
    mma_tf32x3_rn(acc, a, b);
  }
  store_c(acc, G, CL, r0, c0, CL, CL, lane);
}

// (B, nc, nh, CL) vectors the backward keeps beside the scratch: dt,
// wk = dt exp(cum[last] - cum) and exp(cum) of each chunk and head
struct ChunkVecs {
  float *dt, *wk, *ec;
};

// shared memory of chunk_state_kernel: x, B, C, three vectors (and dy)
inline size_t smem_state(int ds, bool with_dy) {
  return sizeof(float) * (size_t(CL) * LDT * (with_dy ? 2 : 1) +
                          2 * size_t(CL) * (padded_ds(ds) + 4) + 4 * CL);
}

// (a) Per (chunk, head, 64-row slice of hd, batch row): the chunk's own
// state st[p][d] = sum_k wk[k] x[k][p] B[k][d], its running sums and
// decay, and (first slice of a group's first head) G = C.B^T. With dy:
// also dso[p][d] = sum_t exp(cum[t]) dy[t][p] C[t][d] and, in the first
// slice, the head's ChunkVecs.
__global__ void __launch_bounds__(NT)
    chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ Bm,
                       const float* __restrict__ Cm, const float* __restrict__ dy,
                       float* __restrict__ work, float* __restrict__ dso,
                       ChunkVecs vecs, int S, int nh, int hd, int ng, int ds,
                       int nc, int npt, int vec_x, int vec_bc) {
  const int DSP = padded_ds(ds), LDN = DSP + 4;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // CL x LDT: x[k][p], then wk[k] x[k][p]
  float* bs = xs + CL * LDT;    // CL x LDN: B[k][d]
  float* cs = bs + CL * LDN;    // CL x LDN: C[q][d]
  float* dts = cs + CL * LDN;   // CL: dt
  float* cum = dts + CL;        // CL: running sum of dt * A
  float* wk = cum + CL;         // CL: dt exp(cum[last] - cum)
  float* ec = wk + CL;          // CL: exp(cum)
  float* ys = ec + CL;          // CL x LDT: dy[t][p], then exp(cum[t]) dy

  const int c = blockIdx.x / npt, p0 = (blockIdx.x % npt) * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rep = nh / ng, g = h / rep;
  const int t0 = c * CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool do_g = h % rep == 0 && p0 == 0;
  const bool grad = dy != nullptr;
  const Scratch w = carve(work, gridDim.z, nc, nh, ng);

  const size_t bc_off = ((size_t(b) * S + t0) * ng + g) * ds;
  const size_t x_off = ((size_t(b) * S + t0) * nh + h) * hd + p0;
  mma::load_tile_f32<CL, NT>(xs, LDT, x + x_off, size_t(nh) * hd, S - t0,
                             hd - p0, PT, vec_x, tid);
  mma::load_tile_f32<CL, NT>(bs, LDN, Bm + bc_off, size_t(ng) * ds, S - t0,
                             ds, DSP, vec_bc, tid);
  if (do_g || grad)
    mma::load_tile_f32<CL, NT>(cs, LDN, Cm + bc_off, size_t(ng) * ds, S - t0,
                               ds, DSP, vec_bc, tid);
  if (grad)
    mma::load_tile_f32<CL, NT>(ys, LDT, dy + x_off, size_t(nh) * hd, S - t0,
                               hd - p0, PT, vec_x, tid);
  mma::cp_async_commit();
  chunk_decays(dt, b, t0, S, nh, h, A[h], dts, cum, tid);
  const float last = cum[CL - 1];
  if (tid < CL) {
    wk[tid] = dts[tid] * expf(last - cum[tid]);
    ec[tid] = expf(cum[tid]);
  }
  if (p0 == 0) {
    const size_t bch = (size_t(b) * nc + c) * nh + h;
    if (tid < CL) w.cum[bch * CL + tid] = cum[tid];
    if (tid == 0) w.decay[bch] = expf(last);
    if (grad && tid < CL) {
      vecs.dt[bch * CL + tid] = dts[tid];
      vecs.wk[bch * CL + tid] = wk[tid];
      vecs.ec[bch * CL + tid] = ec[tid];
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < CL * PT; i += NT) {
    const int k = i / PT, p = i % PT;
    xs[k * LDT + p] *= wk[k];
    if (grad) ys[k * LDT + p] *= ec[k];
  }
  __syncthreads();

  const size_t slab = ((size_t(b) * nc + c) * nh + h) * size_t(hd) * ds +
                      size_t(p0) * ds;
  outer_store(xs, bs, LDN, DSP, w.st + slab, hd - p0, ds, warp, lane);
  if (grad) outer_store(ys, cs, LDN, DSP, dso + slab, hd - p0, ds, warp, lane);
  if (do_g)
    gram_store(cs, bs, LDN, DSP, w.G + ((size_t(b) * nc + c) * ng + g) * CL * CL,
               warp, lane);
}

__device__ __forceinline__ float pass_step(float run, float d, float own) {
  return __fadd_rn(__fmul_rn(run, d), own);
}
__device__ __forceinline__ float4 pass_step(float4 run, float d, float4 own) {
  return make_float4(pass_step(run.x, d, own.x), pass_step(run.y, d, own.y),
                     pass_step(run.z, d, own.z), pass_step(run.w, d, own.w));
}

// one thread's walk over the chunks of its V = 1 or 4 elements (V floats of
// one head's state, T float or float4): forward from run (each chunk's slot
// left holding what entered it), or in reverse; returns what leaves
template <typename T>
__device__ __forceinline__ T walk(T* slot, const float* dec, size_t step,
                                  int nh, int nc, T run, bool rev) {
  // CB chunks' loads issued together before their stores, so a thread
  // keeps CB loads in flight rather than one
  constexpr int CB = 8;
  for (int c0 = 0; c0 < nc; c0 += CB) {
    T own[CB];
    float d[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (c0 + j < nc) {
        const int c = rev ? nc - 1 - (c0 + j) : c0 + j;
        own[j] = slot[c * step];
        d[j] = dec[c * nh];
      }
#pragma unroll
    for (int j = 0; j < CB; ++j)
      if (c0 + j < nc) {
        const int c = rev ? nc - 1 - (c0 + j) : c0 + j;
        slot[c * step] = run;
        run = pass_step(run, d[j], own[j]);
      }
  }
  return run;
}

// (b) Per V = 4 elements (V = 1 where hd * ds is not a multiple of 4) of
// the (B, nh, hd, ds) state, in float32: walk the chunks in order, leave in
// st the state entering each chunk, carry state = exp(cum[last]) * state +
// the chunk's own, and write the final state where state_out is given. With
// dso (the backward), a second set of threads walks dso's chunks in reverse
// from dstate (0 where null): each chunk's slot is left holding the
// gradient of the state leaving it, and g <- exp(cum[last]) * g + the
// chunk's own.
__global__ void state_pass_kernel(float* __restrict__ work,
                                  float* __restrict__ state_out,
                                  float* __restrict__ dso,
                                  const float* __restrict__ dstate, int B,
                                  int nh, int hd, int ng, int ds, int nc,
                                  int V) {
  const size_t per_head = size_t(hd) * ds, n = size_t(B) * nh * per_head;
  const size_t nv = n / V;
  size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool rev = dso != nullptr && i >= nv;
  if (rev) i -= nv;
  if (i >= nv) return;
  i *= V;
  const int b = int(i / (nh * per_head));
  const int h = int(i / per_head % nh);
  const size_t e = i % per_head;
  const Scratch w = carve(work, B, nc, nh, ng);
  const float* dec = w.decay + size_t(b) * nc * nh + h;
  const size_t at = (size_t(b) * nc * nh + h) * per_head + e;
  const size_t step = size_t(nh) * per_head;  // one chunk further
  float* base = (rev ? dso : w.st) + at;
  if (V == 4) {
    float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rev && dstate != nullptr)
      run = *reinterpret_cast<const float4*>(dstate + i);
    run = walk(reinterpret_cast<float4*>(base), dec, step / 4, nh, nc, run,
               rev);
    if (!rev && state_out != nullptr)
      *reinterpret_cast<float4*>(state_out + i) = run;
  } else {
    float run = rev && dstate != nullptr ? dstate[i] : 0.f;
    run = walk(base, dec, step, nh, nc, run, rev);
    if (!rev && state_out != nullptr) state_out[i] = run;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// (a) on the caller's stream; the backward passes dy, dso and vecs
inline cudaError_t launch_chunk_states(const float* x, const float* dt,
                                       const float* A, const float* Bm,
                                       const float* Cm, const float* dy,
                                       float* work, float* dso, ChunkVecs vecs,
                                       int B, int S, int nh, int hd, int ng,
                                       int ds, int vec_x, int vec_bc,
                                       cudaStream_t stream) {
  const int nc = (S + CL - 1) / CL, npt = (hd + PT - 1) / PT;
  const size_t smem = smem_state(ds, dy != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  chunk_state_kernel<<<dim3(nc * npt, nh, B), NT, smem, stream>>>(
      x, dt, A, Bm, Cm, dy, work, dso, vecs, S, nh, hd, ng, ds, nc, npt,
      vec_x, vec_bc);
  return cudaGetLastError();
}

// (b) on the caller's stream: the forward pass (state_out may be null),
// and with dso the reverse pass as well
inline cudaError_t launch_state_pass(float* work, float* state_out, float* dso,
                                     const float* dstate, int B, int S,
                                     int nh, int hd, int ng, int ds,
                                     cudaStream_t stream) {
  const int nc = (S + CL - 1) / CL;
  // float4 where a head's state is whole 16-byte pieces and the final
  // state and dstate are 16-byte aligned (the scratch is)
  const int V = (size_t(hd) * ds) % 4 == 0 && aligned16(state_out) &&
                        aligned16(dstate)
                    ? 4
                    : 1;
  const size_t n = size_t(B) * nh * hd * ds / V * (dso != nullptr ? 2 : 1);
  state_pass_kernel<<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      work, state_out, dso, dstate, B, nh, hd, ng, ds, nc, V);
  return cudaGetLastError();
}

}  // namespace ssd32
}  // namespace
