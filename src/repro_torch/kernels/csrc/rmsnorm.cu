// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): for every row x of width D,
//
//   y = x * rsqrt(mean(x^2) + eps) * scale        (float32 arithmetic)
//
// written in x's type. x rows are T (float32 or bfloat16) with a row
// stride of `row_stride` elements and unit column stride, so a slice such
// as the MLA latent dkv[..., :r] is read in place; scale (D,) is S
// (float32 or bfloat16); out (rows, D) is T and contiguous.
//
// Design. The TPU kernel stages 256-row tiles in VMEM and reduces each
// row across its lanes; Hopper has no sequential grid and far less fast
// memory a block, so here a row is owned by one warp (D <= 512: the
// qwen3 q/k norms at D = 128 have B*S*H rows, the deepseek latent norm
// D = 512) or by one 256-thread block (the block norms at D = 1024 to
// 5120, where a decode step has only as many rows as slots, so a warp a
// row would leave the row's loads in one long dependent chain). Threads
// stride over the row (neighbouring lanes on neighbouring addresses),
// accumulate x^2 in float32, reduce with warp shuffles (and, for a block,
// one float32 partial per warp in shared memory), then read the row again
// (from L1/L2) to write the scaled result. The sum is taken in another
// order than the plain version's, so results agree to rounding, not bit
// for bit.
//
// Bound. The function reads x and scale once and writes y once: at the
// block norm of a 512-token qwen3 prefill (rows = 512, D = 1024, bf16)
// that is 2,099,200 bytes, ~0.63 us at 3.35 TB/s; its ~3 flops an element
// are negligible, so it is bound by bytes. The second read of the row
// comes from cache, not device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int WARPS = NT / 32;
constexpr int MAX_WARP_D = 512;         // widths a warp owns a row of

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp a row: block b, warp w owns row b * WARPS + w.
template <typename T, typename S>
__global__ void __launch_bounds__(NT)
rmsnorm_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ out, long long rows, int D,
                    long long row_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * row_stride;
  float ss = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float v = to_float(xr[j]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * static_cast<long long>(D);
  for (int j = lane; j < D; j += 32)
    store(orow + j, to_float(xr[j]) * inv * to_float(scale[j]));
}

// One block a row.
template <typename T, typename S>
__global__ void __launch_bounds__(NT)
rmsnorm_block_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                     T* __restrict__ out, int D, long long row_stride,
                     float eps) {
  __shared__ float part[WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * row_stride;
  float ss = 0.f;
  for (int j = threadIdx.x; j < D; j += NT) {
    const float v = to_float(xr[j]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < WARPS; ++w) total += part[w];   // same order everywhere
  const float inv = rsqrtf(total / static_cast<float>(D) + eps);
  T* orow = out + row * static_cast<long long>(D);
  for (int j = threadIdx.x; j < D; j += NT)
    store(orow + j, to_float(xr[j]) * inv * to_float(scale[j]));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows,
           int D, long long row_stride, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (D <= MAX_WARP_D) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    rmsnorm_warp_kernel<T, S><<<static_cast<unsigned>(blocks), NT, 0,
                                stream>>>(xp, sp, op, rows, D, row_stride,
                                          eps);
  } else {
    rmsnorm_block_kernel<T, S><<<static_cast<unsigned>(rows), NT, 0,
                                 stream>>>(xp, sp, op, D, row_stride, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout
// (rows >= 1, 1 <= D, row_stride >= D, grid within range).
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int D, long long row_stride, float eps,
                   int x_bf16, int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D,
                                                      row_stride, eps, s)
               : launch<__nv_bfloat16, float>(x, scale, out, rows, D,
                                              row_stride, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, rows, D,
                                                   row_stride, eps, s)
                    : launch<float, float>(x, scale, out, rows, D, row_stride,
                                           eps, s);
}
