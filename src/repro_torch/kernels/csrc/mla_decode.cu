// Absorbed-MLA decode attention in the latent space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mla_decode.py
// ::mla_decode_ctx (_mla_kernel): one query token per sequence attends to
// the LATENT cache of DeepSeek's multi-head latent attention. Head h
// scores position j as scale * (q_lat[h]·ckv[j] + q_rope[h]·k_rope[j]),
// the scores are masked by `valid` and soft-maxed over the positions, and
// the context is the weighted sum of the same latent rows, ctx[h] =
// sum_j w[h, j] * ckv[j] (the caller applies W_uv and W_o).
//
// Layout: q_lat (B, H, r), q_rope (B, H, dr), ckv (B, S, r),
// k_rope (B, S, dr), valid (B, S) bool, out (B, H, r), all contiguous,
// ckv 16-byte aligned; q, cache and out float32 or bfloat16 (one type);
// arithmetic in float32.
//
// Design. Two passes. The partial pass runs one block per (split of
// `chunk` positions, batch row), one warp per head (H <= 16): the TPU
// kernel's sequential grid axis over cache tiles becomes a parallel split
// over positions, and within a split a loop over tiles of TS = 32. Each
// tile's valid flags come first (a tile with no live position is skipped
// whole), then its live latent and rope rows (the latents in 16-byte
// loads, a thread's loads all in flight at once), converted to float32
// into shared memory once and used by every head, for both the scores and
// the context: each latent tile is read from device memory once, which is
// the point of the Pallas design. For the scores, lane p of each warp
// takes position p of the tile against the head's query, held in shared
// memory and read as broadcasts (rows padded by four words, so 16-byte
// reads of 32 rows hit distinct banks); the warp then updates its online
// softmax (max, normaliser) once per tile and adds each live position's
// weighted row into the r / 32 float32 context elements each lane keeps
// in registers. The split leaves its unnormalised context and softmax
// state in a float32 workspace; the merge pass (one block per row, a warp
// per head) rescales the splits to their common max and sums them in
// split order, so a row's bits depend on S and the split width only. A
// dead position is never loaded and never added, so it contributes
// exactly 0.0 whatever the cache holds there, and a row with no live
// position writes 0.
//
// Bound. The kernel reads each live latent and rope row once and does
// 2 * H * (2r + dr) operations per live position: at the decode shapes
// (H = 16, r = 512, dr = 64, a handful of rows) it sits on device-memory
// bytes, (live positions) * (r + dr) * itemsize. Each block runs H warps
// of float32 FMAs over its live positions, bound by its SM's CUDA cores
// and shared-memory reads (every warp reads each staged row for its head),
// and the workspace adds (live splits) * H * r * 4 bytes each way; mma /
// wgmma products over bfloat16 tiles fed by TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int TS = 32;      // positions per tile (one per lane)
constexpr int MAX_H = 16;   // warps per block
constexpr int PAD = 4;      // shared row padding, in floats
constexpr int U = 4;        // staging loads a thread has in flight

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

// the 16 / sizeof(T) elements of one 16-byte load, as float32, into four
// or eight consecutive (16-byte aligned) shared-memory words
template <typename T>
__device__ __forceinline__ void store_floats(const uint4& v, float* dst);
template <>
__device__ __forceinline__ void store_floats<float>(const uint4& v,
                                                    float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
      __uint_as_float(v.w));
}
template <>
__device__ __forceinline__ void store_floats<__nv_bfloat16>(const uint4& v,
                                                            float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int H, int r, int dr) {
  return sizeof(float) * (size_t(TS) * (r + PAD) + size_t(TS) * (dr + PAD) +
                          size_t(H) * r + size_t(H) * dr) +
         sizeof(int) * TS;
}

// Block (split s, row b) walks positions [s * chunk, (s + 1) * chunk) and
// leaves each head's unnormalised context and its (max, normaliser) in
// the float32 workspace: part[b, s, h, :r] (B * nsplit * H * r floats),
// then ml[b, s, h, 0:2] behind them. A split with no live position
// writes max = -inf and no context, which the merge skips.
template <typename T, int RPL>  // RPL = r / 32 context elements per lane
__global__ void __launch_bounds__(MAX_H * 32)
    mla_partial_kernel(const T* __restrict__ q_lat,
                       const T* __restrict__ q_rope,
                       const T* __restrict__ ckv,
                       const T* __restrict__ k_rope,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ part, int S, int H, int dr,
                       float scale, int chunk) {
  constexpr int r = RPL * 32;
  constexpr int lr = r + PAD;
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int NV = TS * r / VE;      // 16-byte loads per latent tile
  const int ldr = dr + PAD;
  extern __shared__ float smem[];
  float* ckv_s = smem;                    // TS x lr
  float* kr_s = ckv_s + TS * lr;          // TS x ldr
  float* ql_s = kr_s + TS * ldr;          // H x r
  float* qr_s = ql_s + H * r;             // H x dr
  int* live_s = reinterpret_cast<int*>(qr_s + H * dr);  // TS

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int b = blockIdx.y;
  const int j_lo = split * chunk, j_hi = min(S, j_lo + chunk);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int h = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < H * r; i += nt)
    ql_s[i] = to_float(q_lat[size_t(b) * H * r + i]);
  for (int i = tid; i < H * dr; i += nt)
    qr_s[i] = to_float(q_rope[size_t(b) * H * dr + i]);

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
    // of a thread's loads are issued before any is converted and stored,
    // so they are in flight together
    const size_t base = size_t(b) * S + j0;
    const uint4* src = reinterpret_cast<const uint4*>(ckv + base * r);
    for (int v0 = 0; v0 < NV; v0 += nt * U) {
      uint4 buf[U];
      bool okv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * nt + tid;
        okv[u] = v < NV && live_s[v * VE / r];
        if (okv[u]) buf[u] = src[v];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!okv[u]) continue;
        const int e = (v0 + u * nt + tid) * VE;
        store_floats<T>(buf[u], ckv_s + (e / r) * lr + e % r);
      }
    }
    for (int i0 = 0; i0 < TS * dr; i0 += nt * U) {
      T buf[U];
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
        if (okr[u]) kr_s[(i / dr) * ldr + i % dr] = to_float(buf[u]);
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
      const float wp = __shfl_sync(0xffffffffu, w, p);
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

// One block per row, one warp per head: the splits' contexts rescaled to
// their common max and summed in split order, then normalised; a row with
// no live position (every split's max -inf) writes 0.
template <typename T, int RPL>
__global__ void __launch_bounds__(MAX_H * 32)
    mla_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int H, int nsplit) {
  constexpr int r = RPL * 32;
  const int b = blockIdx.x;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t at = size_t(b) * nsplit * H + h;   // split 0 of (b, h)
  const float* ml = part + size_t(gridDim.x) * nsplit * H * r;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[(at + s * H) * 2]);
  float num[RPL], den = 0.f;
#pragma unroll
  for (int e = 0; e < RPL; ++e) num[e] = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      const float ms = ml[(at + s * H) * 2];
      if (ms == -INFINITY) continue;  // a split with no live position
      const float c = expf(ms - mx);
      den = fmaf(ml[(at + s * H) * 2 + 1], c, den);
      const float* src = part + (at + s * H) * r;
#pragma unroll
      for (int e = 0; e < RPL; ++e)
        num[e] = fmaf(src[lane + 32 * e], c, num[e]);
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  T* o = out + (size_t(b) * H + h) * r;
#pragma unroll
  for (int e = 0; e < RPL; ++e) o[lane + 32 * e] = from_float<T>(num[e] * inv);
}

template <typename T, int RPL>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv,
                   const void* k_rope, const void* valid, void* out,
                   void* work, int B, int S, int H, int dr, float scale,
                   int chunk, cudaStream_t stream) {
  const int nsplit = (S + chunk - 1) / chunk;
  if (nsplit > 0) {
    const size_t smem = smem_bytes(H, RPL * 32, dr);
    cudaError_t err = cudaFuncSetAttribute(
        mla_partial_kernel<T, RPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    mla_partial_kernel<T, RPL><<<dim3(nsplit, B), H * 32, smem, stream>>>(
        static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
        static_cast<const T*>(ckv), static_cast<const T*>(k_rope),
        static_cast<const unsigned char*>(valid), static_cast<float*>(work),
        S, H, dr, scale, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  mla_merge_kernel<T, RPL><<<B, H * 32, 0, stream>>>(
      static_cast<const float*>(work), static_cast<T*>(out), H, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_r(int r, const void* q_lat, const void* q_rope,
                     const void* ckv, const void* k_rope, const void* valid,
                     void* out, void* work, int B, int S, int H, int dr,
                     float scale, int chunk, cudaStream_t stream) {
  switch (r) {
    case 32: return launch<T, 1>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, chunk, stream);
    case 64: return launch<T, 2>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, chunk, stream);
    case 128: return launch<T, 4>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, chunk, stream);
    case 256: return launch<T, 8>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, chunk, stream);
    case 512: return launch<T, 16>(q_lat, q_rope, ckv, k_rope, valid, out, work, B, S, H, dr, scale, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). The caller has checked shapes, types and
// layout: r in {32, 64, 128, 256, 512}, dr a multiple of 4 up to 256,
// 1 <= H <= 16, chunk >= 1, and `work` holds B * ceil(S / chunk) * H *
// (r + 2) floats; S = 0 writes zeros.
int mla_decode_launch(const void* q_lat, const void* q_rope, const void* ckv,
                      const void* k_rope, const void* valid, void* out,
                      void* work, int B, int S, int H, int r, int dr,
                      float scale, int chunk, int is_bf16, void* stream) {
  if (B == 0) return cudaSuccess;
  if (H < 1 || H > MAX_H || dr < 0 || dr % 4 || dr > 256 || chunk < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_r<__nv_bfloat16>(r, q_lat, q_rope, ckv, k_rope, valid, out,
                                   work, B, S, H, dr, scale, chunk, s);
  return launch_r<float>(r, q_lat, q_rope, ckv, k_rope, valid, out, work, B,
                         S, H, dr, scale, chunk, s);
}
