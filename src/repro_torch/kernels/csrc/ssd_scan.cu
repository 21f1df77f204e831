// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). For each batch row b and head h (group g = h / (nh / ng)):
//
//   cum[t]  = inclusive running sum of dt[t] * A[h] within a tile
//   y[t]    = sum_{k <= t in the tile} (C[t].B[k]) exp(cum[t] - cum[k])
//             dt[k] x[k]  +  exp(cum[t]) (C[t] . state)  +  D[h] x[t]
//   state  <- exp(cum[last]) state + sum_k exp(cum[last] - cum[k]) dt[k]
//             x[k] (x) B[k]                 (after each tile)
//
// Layout: x (B, S, nh, hd), dt (B, S, nh), B/C (B, S, ng, ds) in T
// (float32 or bfloat16); A, D (nh,) float32; y (B, S, nh, hd) and the
// final state (B, nh, hd, ds) in T. Decay math, the quadratic form and
// the carried state are float32.
//
// Design. The TPU kernel walked the chunk axis as a sequential grid
// dimension and carried the (nh, hd, ds) state in VMEM; blocks on Hopper
// run in no order, so here ONE block owns the carried state of its slice
// and a loop inside it walks the sequence. A block is (TP = 32 rows of hd,
// head h, batch row b): the state's rows p are independent (y[:, p] and
// state[p, :] read only x[:, p]), so a head splits over blocks without any
// exchange. At the main path's shape (B = 1, nh = 80, hd = 64) that is 160
// blocks for 132 SMs, two resident per SM. The block keeps its TP x ds f32
// state in shared memory and walks the sequence in tiles of TL = 64
// positions: a whole 256 x 256 f32 decay tile (256 KB) would not fit in
// the 227 KB a block may use, and the scan's result does not depend on
// where the sequence is cut, up to rounding (the wrapper still refuses
// an S that the caller's chunk does not divide, as JAX asserts). A ragged
// last tile is padded with dt = x = B = C = 0, which adds nothing to y or
// to the state. Per tile: load B, C and x rows as f32, the running sum of
// dt * A (one thread, in order, no fused multiply-add, as the plain
// version's cumsum), M = (C.B^T) * exp(cum[q] - cum[k]) * dt[k] on the
// lower triangle (16 x 16 threads, 4 x 4 entries each), y = M.x +
// exp(cum) * (C.state) + D x, then the state update. All products run on
// the f32 CUDA cores.
//
// Bound. At the main path's prefill (B = 1, S = 512, nh = 80, hd = 64,
// ng = 1, ds = 128, bf16) the function moves ~12.1 MB (x and y ~5.2 MB
// each, the state ~1.3 MB, dt, B and C ~0.35 MB): ~3.6 us at 3.35 TB/s;
// its ~2.7 GFLOP take ~2.7 us at the bf16 tensor-core peak. So it is
// bound by bytes. This first version reads every input once from device
// memory (B and C once per block, from L2 after the first), but it
// recomputes C.B^T in every block of a group and runs ~5 GFLOP of f32
// FMAs on the CUDA cores, so it sits far above that bound; sharing C.B^T
// across heads, mma/wgmma products and TMA-fed tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout
// (nh % ng == 0, 1 <= ds <= 256).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* state, int B, int S, int nh, int hd, int ng, int ds,
                    int is_bf16, void* stream) {
  if (ds < 1 || ds > MAX_DS || ng < 1 || nh % ng) return cudaErrorInvalidValue;
  if (B == 0 || nh == 0 || hd == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, state, B, S, nh, hd,
                                 ng, ds, s);
  return launch<float>(x, dt, A, Bm, Cm, D, y, state, B, S, nh, hd, ng, ds,
                       s);
}
