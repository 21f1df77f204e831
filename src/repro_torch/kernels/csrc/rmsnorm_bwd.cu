// The gradient of RMSNorm for Hopper (sm_90a), float32.
//
// Replaces no Pallas kernel: JAX differentiates its plain
// src/repro/models/layers.py::rmsnorm_fwd, and the port's forward kernel
// (rmsnorm.cu, which replaces src/repro/kernels/rmsnorm.py::rmsnorm) has
// no gradient of its own. For every row x of width D with the output's
// gradient g, r = rsqrt(mean(x^2) + eps) and gs = g * scale:
//
//   dx     = r * gs - x * r^3 * mean(x * gs)
//   dscale = sum over rows of g * x * r
//
// x rows are float32 with a row stride of `row_stride` elements and unit
// column stride (the MLA latent dkv[..., :r] is read in place, as the
// forward reads it); g, dx (rows, D) contiguous; scale and dscale (D,).
// One launch may take two such tensors of one D (a layer's q and k norms,
// which the forward normalises in one launch): every kernel's grid covers
// both.
//
// Three kernels: (1) one warp a row (eight rows a block) reads x, g and
// scale, reduces sum(x^2) and sum(x * gs) over its lanes (each lane its
// columns lane, lane + 32, ... in order, then a xor-shuffle tree), writes
// dx from a second read of the row, and keeps r for the row; (2) the first
// stage of dscale: blocks of 32 columns x 8 row lanes, one per chunk of
// rows, each lane summing g * x * r over its rows of the chunk in order,
// the 8 lanes then added in order through shared memory into the chunk's
// partial row; (3) one thread a column adds the chunks' partials in chunk
// order. No atomics: the bits repeat from run to run.
//
// Bound. The function reads x, g and scale once and writes dx and dscale
// once, ~6 operations an element: bound by bytes. At qwen3-0.6b's block
// norm over a training batch (4096 rows, D 1024) that is 50.3 MB, 0.015 ms
// at 3.35 TB/s. This design reads x and g twice (kernel 1's two passes,
// then kernel 2), so it moves about twice the bound's bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads a block
constexpr int ROWS_A_BLOCK = NT / 32;
constexpr int COLS = 32;       // columns a block of the dscale stages
constexpr int LANES = NT / COLS;

struct Seg {
  const float* x;
  const float* scale;
  const float* g;
  float* dx;
  long long rows;
  long long row_stride;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (1) dx and r, one warp a row of either segment
__global__ void __launch_bounds__(NT)
    rows_kernel(Seg s0, Seg s1, int D, float eps, float* __restrict__ rstd) {
  const long long all = s0.rows + s1.rows;
  const int lane = threadIdx.x % 32;
  for (long long r = (long long)blockIdx.x * ROWS_A_BLOCK + threadIdx.x / 32;
       r < all; r += (long long)gridDim.x * ROWS_A_BLOCK) {
    const bool first = r < s0.rows;
    const Seg& s = first ? s0 : s1;
    const long long i = first ? r : r - s0.rows;
    const float* x = s.x + i * s.row_stride;
    const float* g = s.g + i * D;
    float ss = 0.f, sg = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xv = x[c], gs = g[c] * s.scale[c];
      ss = fmaf(xv, xv, ss);
      sg = fmaf(xv, gs, sg);
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    const float rr = rsqrtf(ss / D + eps);
    const float coef = rr * rr * rr * (sg / D);
    float* dx = s.dx + i * D;
    for (int c = lane; c < D; c += 32)
      dx[c] = rr * (g[c] * s.scale[c]) - x[c] * coef;
    if (lane == 0) rstd[r] = rr;
  }
}

// (2) partial[seg][chunk][col] = sum over the chunk's rows of g * x * r
__global__ void __launch_bounds__(NT)
    partial_kernel(Seg s0, Seg s1, int D, int chunks,
                   const float* __restrict__ rstd, float* __restrict__ partial) {
  __shared__ float acc[LANES][COLS];
  const int seg = blockIdx.z, chunk = blockIdx.y;
  const Seg& s = seg == 0 ? s0 : s1;
  const float* r_of = rstd + (seg == 0 ? 0 : s0.rows);
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const int col = blockIdx.x * COLS + tx;
  const long long per = (s.rows + chunks - 1) / chunks;
  const long long r0 = chunk * per, r1 = min(s.rows, r0 + per);
  float a = 0.f;
  if (col < D)
    for (long long i = r0 + ty; i < r1; i += LANES)
      a = fmaf(s.g[i * D + col] * s.x[i * s.row_stride + col], r_of[i], a);
  acc[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < D) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) t += acc[l][tx];
    partial[((size_t)seg * chunks + chunk) * D + col] = t;
  }
}

// (3) dscale[seg][col] = the chunks' partials added in order
__global__ void __launch_bounds__(NT)
    reduce_kernel(int D, int chunks, const float* __restrict__ partial,
                  float* __restrict__ dscale) {
  const int seg = blockIdx.y;
  const int col = blockIdx.x * NT + threadIdx.x;
  if (col >= D) return;
  const float* p = partial + (size_t)seg * chunks * D + col;
  float t = 0.f;
  for (int c = 0; c < chunks; ++c) t += p[(size_t)c * D];
  dscale[(size_t)seg * D + col] = t;
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). rows1 = 0 means one tensor. The caller has
// checked shapes, types and layout, and allocated dx, the workspaces rstd
// (rows0 + rows1) and partial (segments, chunks, D), and dscale
// (segments, D).
int rmsnorm_bwd_launch(const void* x0, const void* scale0, const void* g0,
                       void* dx0, long long rows0, long long row_stride0,
                       const void* x1, const void* scale1, const void* g1,
                       void* dx1, long long rows1, long long row_stride1,
                       int D, float eps, void* rstd, void* partial,
                       void* dscale, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s0{static_cast<const float*>(x0), static_cast<const float*>(scale0),
               static_cast<const float*>(g0), static_cast<float*>(dx0), rows0,
               row_stride0};
  const Seg s1{static_cast<const float*>(x1), static_cast<const float*>(scale1),
               static_cast<const float*>(g1), static_cast<float*>(dx1), rows1,
               row_stride1};
  const int segs = rows1 > 0 ? 2 : 1;
  const long long all = rows0 + rows1;
  if (all == 0 || D == 0) return cudaSuccess;
  long long blocks = (all + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
  if (blocks > 65535) blocks = 65535;
  rows_kernel<<<unsigned(blocks), NT, 0, st>>>(s0, s1, D, eps,
                                               static_cast<float*>(rstd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 pgrid((D + COLS - 1) / COLS, chunks, segs);
  partial_kernel<<<pgrid, NT, 0, st>>>(s0, s1, D, chunks,
                                       static_cast<const float*>(rstd),
                                       static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((D + NT - 1) / NT, segs);
  reduce_kernel<<<rgrid, NT, 0, st>>>(D, chunks,
                                      static_cast<const float*>(partial),
                                      static_cast<float*>(dscale));
  return cudaGetLastError();
}
