// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): for every row x of width D,
//
//   y = x * rsqrt(mean(x^2) + eps) * scale        (float32 arithmetic)
//
// written in x's type. x rows are T (float32 or bfloat16) with a row
// stride of `row_stride` elements and unit column stride, so a slice such
// as the MLA latent dkv[..., :r] is read in place; scale (D,) is S
// (float32 or bfloat16); out (rows, D) is T and contiguous. One launch
// may normalise two such tensors of one D and one type (a layer's q and k
// norms): the grid covers the rows of both.
//
// Bound. The function reads x and scale once and writes y once: at the
// block norm of a 512-token qwen3 prefill (rows = 512, D = 1024, bf16)
// that is 2,099,200 bytes, ~0.63 us at 3.35 TB/s; its ~4 flops an element
// are negligible, so it is bound by bytes. At a decode step (4 rows) the
// bytes take nanoseconds: there the time is the launch and one chain of
// dependent steps (load, reduce, store), so the design keeps that chain
// short.
//
// Design. The TPU kernel stages 256-row tiles in VMEM and reduces each
// row across its lanes. Here a row is owned by a group of W warps and
// held in registers: every lane loads up to N 16-byte vectors of x (V = 8
// bf16 or 4 f32 elements each) and the matching vectors of scale, all
// issued before any is used, so the loads are in flight together; the
// output is computed from those registers, so x is read from memory once.
// Vector j of a row belongs to thread j % (32 W) of its group, in slot
// j / (32 W): neighbouring lanes read neighbouring 16 bytes. (W, N) are
// chosen by the wrapper from D and the type alone (kernels/rmsnorm.py,
// `layout`): one vector a lane on 1, 2 or 4 warps, then two on 4 warps,
// then 8 warps with up to 8 vectors a lane, N rounded up to a power of
// two. Few vectors a lane keep each warp's chain of instructions short,
// which at a decode step's 4 rows is most of the time after the launch
// (a first layout of up to 8 vectors a lane on fewer warps was slower at
// every shape the port's norms see; PERF.md has the readings).
// A block is 4 warps (4 rows at W = 1, 2 at W = 2, 1 at W = 4) or one
// 8-warp row, and the grid follows the row count, capped, with a
// grid-stride loop beyond the cap.
//
// Bits. A lane adds the squares of its elements in slot order, element
// order within a slot (fmaf); a xor-shuffle tree adds the lanes of a
// warp; for W > 1 the warps' partials are added in warp order through
// shared memory after one barrier. Nothing of that depends on the number
// of rows, the row's index, the grid, the block, the pair or the
// alignment, so a row's bits depend on D, its type, its values, scale and
// eps alone. Inputs the 16-byte path cannot take (a base or row stride
// off 16 bytes, a scale off 16 bytes, D not a multiple of V, or a row
// wider than 8 vectors a lane of 8 warps) run on the VEC = false
// instantiation of the same kernel: the same element-to-lane assignment
// and summation order, one element at a time, reading x a second time to
// write; its bits equal the vector path's wherever both can run. The sum
// is taken in another order than the plain version's, so the two agree
// to rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC_BYTES = 16;
constexpr int MAX_SLOTS = 8;      // 16-byte vectors a lane holds
constexpr int GRID_CAP = 4096;    // blocks; more rows loop over the grid

// rows a block: blocks of 4 warps up to W = 4, one 8-warp row above
__host__ __device__ constexpr int rows_a_block(int W) {
  return W >= 4 ? 1 : 4 / W;
}

// One tensor to normalise: `rows` rows of x `row_stride` elements apart,
// its scale (D,) and its contiguous output (rows, D).
struct Rows {
  const void* x;
  const void* scale;
  void* out;
  long long rows;
  long long row_stride;
};

// float32 / bfloat16 values, alone in memory or packed in 32-bit words
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  static __device__ __forceinline__ void put(uint32_t* w, int e, float v) {
    w[e] = __float_as_uint(v);
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  // element e of the packed words: the low half of word e / 2 for even e
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    const uint32_t u = w[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  // in element order: an even e starts its word, the odd one completes it
  static __device__ __forceinline__ void put(uint32_t* w, int e, float v) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(v));
    w[e >> 1] = (e & 1) ? ((w[e >> 1] & 0xffffu) | (b << 16)) : b;
  }
};

// BYTES (8, 16 or 32) bytes at p, aligned to min(BYTES, 16), into words
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  static_assert(BYTES == 8 || BYTES == 16 || BYTES == 32, "vector bytes");
  if constexpr (BYTES == 8) {
    const uint2 u = __ldg(static_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 u = __ldg(static_cast<const uint4*>(p) + i);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // the same bits in every lane: each step adds a commuted pair
}

// Rows a then b, R = rows_a_block(W) rows a block, W warps a row; VEC:
// N 16-byte vectors a lane held in registers, else one element at a time.
// (The exact block size and one block an SM as launch bounds: without the
// second, ptxas spilled a few bytes of four float32 layouts at 64-80
// registers.)
template <typename T, typename S, int W, int N, bool VEC>
__global__ void __launch_bounds__(32 * W * rows_a_block(W), 1)
rmsnorm_kernel(Rows a, Rows b, int D, float eps) {
  constexpr int V = VEC_BYTES / static_cast<int>(sizeof(T));
  constexpr int R = rows_a_block(W);
  constexpr int LANES = 32 * W;
  constexpr int SB = V * static_cast<int>(sizeof(S));   // scale bytes a vector
  __shared__ float part[2][R][W];
  const int g = threadIdx.x / LANES;
  const int t = threadIdx.x % LANES;
  const long long rows = a.rows + b.rows;
  int buf = 0;
  // block-uniform trip count, so every thread reaches the barrier
  for (long long base = static_cast<long long>(blockIdx.x) * R; base < rows;
       base += static_cast<long long>(gridDim.x) * R, buf ^= 1) {
    const long long row = base + g;
    const bool live = row < rows;
    const bool in_a = row < a.rows;
    const long long r = in_a ? row : row - a.rows;
    const T* x = static_cast<const T*>(in_a ? a.x : b.x) +
                 r * (in_a ? a.row_stride : b.row_stride);
    const S* scale = static_cast<const S*>(in_a ? a.scale : b.scale);
    T* out = static_cast<T*>(in_a ? a.out : b.out) + r * D;

    float ss = 0.f;
    uint32_t xw[VEC ? N : 1][4];
    uint32_t sw[VEC ? N : 1][SB / 4];
    if constexpr (VEC) {
      const int nvec = D / V;
#pragma unroll
      for (int n = 0; n < N; ++n) {           // every load issued first
        const int j = n * LANES + t;
        if (live && j < nvec) {
          load_words<16>(x + static_cast<long long>(j) * V, xw[n]);
          load_words<SB>(scale + static_cast<long long>(j) * V, sw[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int j = n * LANES + t;
        if (live && j < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float v = Elt<T>::get(xw[n], e);
            ss = fmaf(v, v, ss);
          }
        }
      }
    } else {
      const long long slots =
          (static_cast<long long>(D) + V * LANES - 1) / (V * LANES);
      for (long long n = 0; n < slots; ++n) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const long long i = (n * LANES + t) * V + e;
          if (live && i < D) {
            const float v = Elt<T>::load(x + i);
            ss = fmaf(v, v, ss);
          }
        }
      }
    }

    float total = warp_sum(ss);
    if constexpr (W > 1) {
      if ((t & 31) == 0) part[buf][g][t >> 5] = total;
      __syncthreads();   // part[buf] is rewritten two iterations on, after
                         // the next barrier: every read of it is done
      total = part[buf][g][0];
#pragma unroll
      for (int w = 1; w < W; ++w) total += part[buf][g][w];
    }
    const float inv = rsqrtf(total / static_cast<float>(D) + eps);

    if constexpr (VEC) {
      const int nvec = D / V;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int j = n * LANES + t;
        if (live && j < nvec) {
          uint32_t yw[4];
#pragma unroll
          for (int e = 0; e < V; ++e)
            Elt<T>::put(yw, e,
                        (Elt<T>::get(xw[n], e) * inv) * Elt<S>::get(sw[n], e));
          *reinterpret_cast<uint4*>(out + static_cast<long long>(j) * V) =
              make_uint4(yw[0], yw[1], yw[2], yw[3]);
        }
      }
    } else {
      const long long slots =
          (static_cast<long long>(D) + V * LANES - 1) / (V * LANES);
      for (long long n = 0; n < slots; ++n) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const long long i = (n * LANES + t) * V + e;
          if (live && i < D)
            Elt<T>::store(out + i,
                          (Elt<T>::load(x + i) * inv) * Elt<S>::load(scale + i));
        }
      }
    }
  }
}

template <typename T, typename S, int W, int N, bool VEC>
int launch(const Rows& a, const Rows& b, int D, float eps,
           cudaStream_t stream) {
  constexpr int R = rows_a_block(W);
  const long long groups = (a.rows + b.rows + R - 1) / R;
  const unsigned blocks =
      static_cast<unsigned>(groups < GRID_CAP ? groups : GRID_CAP);
  rmsnorm_kernel<T, S, W, N, VEC><<<blocks, 32 * W * R, 0, stream>>>(a, b, D,
                                                                     eps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations `layout` can ask for: one element at a time at any W;
// 16-byte vectors at (W, N) = (1, 1), (2, 1), (4, 1), (4, 2), (8, 2),
// (8, 4) and (8, 8).
template <typename T, typename S>
int dispatch(const Rows& a, const Rows& b, int D, float eps, int warps,
             int slots, int vec, cudaStream_t s) {
  if (!vec) {
    switch (warps) {
      case 1: return launch<T, S, 1, 1, false>(a, b, D, eps, s);
      case 2: return launch<T, S, 2, 1, false>(a, b, D, eps, s);
      case 4: return launch<T, S, 4, 1, false>(a, b, D, eps, s);
      case 8: return launch<T, S, 8, 1, false>(a, b, D, eps, s);
    }
  } else if (warps == 1 && slots == 1) {
    return launch<T, S, 1, 1, true>(a, b, D, eps, s);
  } else if (warps == 2 && slots == 1) {
    return launch<T, S, 2, 1, true>(a, b, D, eps, s);
  } else if (warps == 4) {
    switch (slots) {
      case 1: return launch<T, S, 4, 1, true>(a, b, D, eps, s);
      case 2: return launch<T, S, 4, 2, true>(a, b, D, eps, s);
    }
  } else if (warps == 8) {
    switch (slots) {
      case 2: return launch<T, S, 8, 2, true>(a, b, D, eps, s);
      case 4: return launch<T, S, 8, 4, true>(a, b, D, eps, s);
      case 8: return launch<T, S, 8, MAX_SLOTS, true>(a, b, D, eps, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for a layout with no
// instantiation). The caller has checked shapes, types and layout (rows0
// + rows1 >= 1, D >= 1, row strides >= D, both tensors of one type and
// one scale type) and chosen (warps, slots) from D and the type, and vec
// only where every base, row stride and scale lies on 16 bytes and V
// divides D. rows1 = 0 normalises one tensor.
int rmsnorm_launch(const void* x0, const void* scale0, void* out0,
                   long long rows0, long long row_stride0, const void* x1,
                   const void* scale1, void* out1, long long rows1,
                   long long row_stride1, int D, float eps, int x_bf16,
                   int scale_bf16, int warps, int slots, int vec,
                   void* stream) {
  const Rows a{x0, scale0, out0, rows0, row_stride0};
  const Rows b{x1, scale1, out1, rows1, row_stride1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? dispatch<__nv_bfloat16, __nv_bfloat16>(a, b, D, eps, warps,
                                                        slots, vec, s)
               : dispatch<__nv_bfloat16, float>(a, b, D, eps, warps, slots,
                                                vec, s);
  }
  return scale_bf16 ? dispatch<float, __nv_bfloat16>(a, b, D, eps, warps,
                                                     slots, vec, s)
                    : dispatch<float, float>(a, b, D, eps, warps, slots, vec,
                                             s);
}
