// The gradient of RMSNorm for Hopper (sm_90a), float32 and bfloat16.
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
// x rows are T (float32 or bfloat16) with a row stride of `row_stride`
// elements and unit column stride (the MLA latent dkv[..., :r] is read in
// place, as the forward reads it); g, dx (rows, D) contiguous, T; scale
// (D,) S (float32 or bfloat16), dscale (segments, D) S, one row a tensor:
// every dtype pair the forward takes. Every sum is float32; dx and dscale
// are each rounded to their type once, as JAX's autodiff of its float32
// rmsnorm_fwd gives them. One launch may take two such tensors
// of one D (a layer's q and k norms, which the forward normalises in one
// launch): both kernels' grids cover both.
//
// Bound. The function reads x, g and scale once and writes dx and dscale
// once, ~6 operations an element: bound by bytes. At qwen3-0.6b's block
// norm over a training batch (4096 rows, D 1024) that is 50.3 MB, 0.015 ms
// at 3.35 TB/s (bf16: 25.2 MB, 0.0075 ms); at its q/k pair (65536 + 32768
// rows of 128) 151 MB, 0.045 ms (bf16: half).
//
// Design: x and g are read once. (1) The rows pass holds a row in
// registers as the forward does (rmsnorm.cu): a group of W warps owns a
// row, and 16-byte vector j (V = 4 float32 or 8 bfloat16 elements) belongs
// to thread j % (32 W) of the group in slot j / (32 W), (W, N) from D and
// T alone (kernels/rmsnorm.py `layout`).
// A lane issues every 16-byte load of x and g of U rows before it uses
// any (U = 4 / N rows at N <= 2, else 1: at D = 128 a warp's row is one
// vector a lane, so four rows keep the bytes in flight), reduces sum(x^2)
// and sum(x * gs) from those registers, and writes dx from them. scale
// and the lane's sums of g * x * r for its columns stay in registers over
// every row its group walks: a lane's columns never change. A block is 8
// warps, R = 8 / W groups; at the end the groups' sums are added in group
// order through shared memory and the block writes one partial row of
// dscale. (2) The dscale pass adds a segment's block partials: 8 runs of
// consecutive blocks, each in block order, then the runs in order. Two
// launches, no atomics and no workspace but the partial rows.
//
// Bits. A row's lane sums run in slot order, element order within a
// slot (fmaf); a xor-shuffle tree adds the lanes of a warp; for W > 1 the
// warps' sums are added in warp order through shared memory. So a row's
// dx depends on its values, scale, eps, D and types alone. The rows of a
// segment are split into blocks by the wrapper (`bwd_partition`) from the
// segment's row count and D alone: block b owns rows [b per, (b + 1) per),
// walked R U rows at a time, group q taking rows base + q U + u (per is a
// multiple of the float32 layout's R U; a bfloat16 block's last step may
// be partial). So a
// segment's dscale depends on its rows and D alone: never on the SM count
// or on the other segment of a pair, and a pair's rows get the bits of
// their solo launches. Inputs the 16-byte path cannot take (a base or row
// stride off 16 bytes, D not a multiple of V) run on the VEC = false
// instantiation: the same lanes, slots, rows and order, one element at a
// time, with the same bits. Rows wider than 8 vectors a lane of 8 warps
// (D > 8192 float32, 16384 bfloat16) run on `wide_kernel`: the same lane assignment looped over
// the slots, reading x and g a second time to write dx and keeping the
// block's dscale sums in its partial row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int VEC_BYTES = 16;     // bytes of a vector
constexpr int MAX_SLOTS = 8;      // 16-byte vectors a lane holds
constexpr int BLOCK_WARPS = 8;    // warps a block of the rows pass
constexpr int NT = 32 * BLOCK_WARPS;
constexpr int RUNS = 8;           // runs of block partials, dscale pass
constexpr int COLS = 32;          // columns a block of the dscale pass

__host__ __device__ constexpr int groups_a_block(int W) {
  return BLOCK_WARPS / W;
}
// rows a group holds in flight at once
__host__ __device__ constexpr int rows_in_flight(int N) {
  return N <= 2 ? 4 / N : 1;
}
// blocks an SM should hold (launch bounds): the register need grows with N,
// and is larger for the bf16 words' conversions and the one-element path
// (held to three blocks, 80 registers, those spilled 4 to 284 bytes)
__host__ __device__ constexpr int min_blocks(int N, bool f32_vec) {
  return f32_vec ? (N <= 2 ? 3 : (N == 4 ? 2 : 1)) : (N <= 2 ? 2 : 1);
}

// One tensor of the backward and its partition: block b of the segment
// owns rows [b per, min(rows, (b + 1) per)). x, g and dx are T, scale S.
struct Seg {
  const void* x;
  const void* scale;
  const void* g;
  void* dx;
  long long rows;
  long long row_stride;
  long long per;
  int blocks;
};

// float32 / bfloat16 values, alone in memory or packed in 32-bit words
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
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
    return __bfloat162float(__ldg(p));
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

// elements a 16-byte vector of T, and 32-bit words of a vector of S
template <typename T>
constexpr int vec_elems() {
  return VEC_BYTES / static_cast<int>(sizeof(T));
}
template <typename T, typename S>
constexpr int scale_words() {
  return vec_elems<T>() * static_cast<int>(sizeof(S)) / 4;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // the same bits in every lane: each step adds a commuted pair
}

// the V elements of a slot of U (element i of a row at p[i]) into words:
// VEC_LOAD, WORDS words by 16-byte loads; else element by element, those
// at or past D left 0
template <typename U, int V, int WORDS, bool VEC_LOAD>
__device__ __forceinline__ void load_vec(const U* p, int i, int D,
                                         uint32_t* w) {
  if constexpr (VEC_LOAD) {
#pragma unroll
    for (int c = 0; c < WORDS / 4; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + i) + c);
      w[4 * c] = u.x;
      w[4 * c + 1] = u.y;
      w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
    if constexpr (WORDS % 4) {   // a bfloat16 scale under bfloat16 rows
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + i));
      w[0] = u.x;
      w[1] = u.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      Elt<U>::put(w, e, i + e < D ? Elt<U>::load(p + i + e) : 0.f);
  }
}

template <typename T, bool VEC_LOAD>
__device__ __forceinline__ void store_vec(T* p, int i, int D,
                                          const float* v) {
  constexpr int V = vec_elems<T>();
  if constexpr (VEC_LOAD) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < V; ++e) Elt<T>::put(w, e, v[e]);
    *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (i + e < D) Elt<T>::store(p + i + e, v[e]);
  }
}

// V floats of a partial row (16-byte stores where VEC_LOAD)
template <int V, bool VEC_LOAD>
__device__ __forceinline__ void store_partial(float* p, int i, int D,
                                              const float* v) {
  if constexpr (VEC_LOAD) {
#pragma unroll
    for (int c = 0; c < V / 4; ++c)
      *reinterpret_cast<float4*>(p + i + 4 * c) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (i + e < D) p[i + e] = v[e];
  }
}

// (1) rows pass: dx of every row, and one partial row of dscale a block.
// W warps a row, N vectors a lane; VEC_LOAD: 16-byte loads and stores.
// x, g and scale are kept as their loaded words and read as float32.
template <typename T, typename S, int W, int N, bool VEC_LOAD>
__global__ void __launch_bounds__(
    NT, min_blocks(N, VEC_LOAD && sizeof(T) == sizeof(float)))
rows_kernel(Seg s0, Seg s1, int D, float eps, float* __restrict__ partial) {
  constexpr int V = vec_elems<T>();
  constexpr int SW = scale_words<T, S>();
  constexpr int R = groups_a_block(W);
  constexpr int U = rows_in_flight(N);
  constexpr int LANES = 32 * W;
  __shared__ float part[2][R][U][W][2];
  // groups 1..R-1's dscale sums for group 0 to add (one float at R = 1)
  __shared__ float merge[R > 1 ? R - 1 : 1][R > 1 ? N : 1][R > 1 ? V : 1]
                        [R > 1 ? LANES : 1];
  const int grp = threadIdx.x / LANES;
  const int t = threadIdx.x % LANES;
  const bool in0 = static_cast<int>(blockIdx.x) < s0.blocks;
  const Seg s = in0 ? s0 : s1;
  const T* xs = static_cast<const T*>(s.x);
  const T* gs = static_cast<const T*>(s.g);
  T* dxs = static_cast<T*>(s.dx);
  const long long b = in0 ? blockIdx.x : blockIdx.x - s0.blocks;
  const long long r0 = b * s.per;
  const long long r1 = min(s.rows, r0 + s.per);
  // vectors a row; the one-element path's last vector may be partial
  const int nvec = VEC_LOAD ? D / V : (D + V - 1) / V;

  uint32_t sw[N][SW];
  float acc[N][V];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = n * LANES + t;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int w = 0; w < SW; ++w) sw[n][w] = 0u;
    if (j < nvec)
      load_vec<S, V, SW, VEC_LOAD>(static_cast<const S*>(s.scale), j * V, D,
                                   sw[n]);
  }

  int buf = 0;
  // block-uniform trip count, so every thread reaches the barrier
  for (long long base = r0; base < r1; base += R * U, buf ^= 1) {
    uint32_t xw[U][N][4], gw[U][N][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {             // every load issued first
      const long long row = base + grp * U + u;
      const T* x = xs + row * s.row_stride;
      const T* g = gs + row * D;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int j = n * LANES + t;
        if (row < r1 && j < nvec) {
          load_vec<T, V, 4, VEC_LOAD>(x, j * V, D, xw[u][n]);
          load_vec<T, V, 4, VEC_LOAD>(g, j * V, D, gw[u][n]);
        }
      }
    }
    float ss[U], sg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + grp * U + u;
      ss[u] = sg[u] = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int j = n * LANES + t;
        if (row < r1 && j < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if (VEC_LOAD || j * V + e < D) {
              const float x = Elt<T>::get(xw[u][n], e);
              ss[u] = fmaf(x, x, ss[u]);
              sg[u] = fmaf(x, Elt<T>::get(gw[u][n], e) *
                                  Elt<S>::get(sw[n], e), sg[u]);
            }
          }
        }
      }
      ss[u] = warp_sum(ss[u]);
      sg[u] = warp_sum(sg[u]);
    }
    if constexpr (W > 1) {
      if ((t & 31) == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          part[buf][grp][u][t >> 5][0] = ss[u];
          part[buf][grp][u][t >> 5][1] = sg[u];
        }
      }
      __syncthreads();   // part[buf] is rewritten two iterations on, after
                         // the next barrier: every read of it is done
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ss[u] = part[buf][grp][u][0][0];
        sg[u] = part[buf][grp][u][0][1];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          ss[u] += part[buf][grp][u][w][0];
          sg[u] += part[buf][grp][u][w][1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + grp * U + u;
      if (row >= r1) continue;
      const float r = rsqrtf(ss[u] / static_cast<float>(D) + eps);
      const float coef = r * r * r * (sg[u] / static_cast<float>(D));
      T* dx = dxs + row * D;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int j = n * LANES + t;
        if (j < nvec) {
          float d[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = Elt<T>::get(xw[u][n], e);
            const float g = Elt<T>::get(gw[u][n], e);
            d[e] = fmaf(-x, coef, r * (g * Elt<S>::get(sw[n], e)));
            acc[n][e] = fmaf(g * x, r, acc[n][e]);
          }
          store_vec<T, VEC_LOAD>(dx, j * V, D, d);
        }
      }
    }
  }

  // the groups' sums in group order, then the block's partial row
  if constexpr (R > 1) {
    if (grp > 0) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < V; ++e) merge[grp - 1][n][e][t] = acc[n][e];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int q = 0; q < R - 1; ++q) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[n][e] += merge[q][n][e][t];
    }
  }
  float* prow = partial + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = n * LANES + t;
    if (j < nvec) store_partial<V, VEC_LOAD>(prow, j * V, D, acc[n]);
  }
}

// (1') rows pass for rows wider than MAX_SLOTS vectors a lane of 8 warps:
// one row at a time, the slots looped, element by element; x and g read a
// second time to write dx; each lane's dscale sums kept in the block's
// partial row, which only that lane touches
template <typename T, typename S>
__global__ void __launch_bounds__(NT)
wide_kernel(Seg s0, Seg s1, int D, float eps, float* __restrict__ partial) {
  constexpr int V = vec_elems<T>();
  __shared__ float part[2][BLOCK_WARPS][2];
  const int t = threadIdx.x;
  const bool in0 = static_cast<int>(blockIdx.x) < s0.blocks;
  const Seg s = in0 ? s0 : s1;
  const S* scale = static_cast<const S*>(s.scale);
  const long long b = in0 ? blockIdx.x : blockIdx.x - s0.blocks;
  const long long r0 = b * s.per;
  const long long r1 = min(s.rows, r0 + s.per);
  const int slots = (D + V * NT - 1) / (V * NT);
  float* prow = partial + static_cast<long long>(blockIdx.x) * D;
  for (int n = 0; n < slots; ++n)
    for (int e = 0; e < V; ++e) {
      const int i = (n * NT + t) * V + e;
      if (i < D) prow[i] = 0.f;
    }
  int buf = 0;
  for (long long row = r0; row < r1; ++row, buf ^= 1) {
    const T* x = static_cast<const T*>(s.x) + row * s.row_stride;
    const T* g = static_cast<const T*>(s.g) + row * D;
    float ss = 0.f, sg = 0.f;
    for (int n = 0; n < slots; ++n)
      for (int e = 0; e < V; ++e) {
        const int i = (n * NT + t) * V + e;
        if (i < D) {
          const float xv = Elt<T>::load(x + i);
          ss = fmaf(xv, xv, ss);
          sg = fmaf(xv, Elt<T>::load(g + i) * Elt<S>::load(scale + i), sg);
        }
      }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if ((t & 31) == 0) {
      part[buf][t >> 5][0] = ss;
      part[buf][t >> 5][1] = sg;
    }
    __syncthreads();
    ss = part[buf][0][0];
    sg = part[buf][0][1];
    for (int w = 1; w < BLOCK_WARPS; ++w) {
      ss += part[buf][w][0];
      sg += part[buf][w][1];
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float coef = r * r * r * (sg / static_cast<float>(D));
    T* dx = static_cast<T*>(s.dx) + row * D;
    for (int n = 0; n < slots; ++n)
      for (int e = 0; e < V; ++e) {
        const int i = (n * NT + t) * V + e;
        if (i < D) {
          const float xv = Elt<T>::load(x + i), gv = Elt<T>::load(g + i);
          Elt<T>::store(dx + i,
                        fmaf(-xv, coef, r * (gv * Elt<S>::load(scale + i))));
          prow[i] = fmaf(gv * xv, r, prow[i]);
        }
      }
  }
}

// (2) dscale[seg][col] in S: the segment's block partials in RUNS runs of
// consecutive blocks, each run in block order, then the runs in order
template <typename S>
__global__ void __launch_bounds__(COLS * RUNS)
dscale_kernel(int blocks0, int blocks1, int D,
              const float* __restrict__ partial, S* __restrict__ dscale) {
  __shared__ float run[RUNS][COLS];
  const int seg = blockIdx.y;
  const int nb = seg == 0 ? blocks0 : blocks1;
  const float* p = partial + static_cast<long long>(seg == 0 ? 0 : blocks0) * D;
  const int tx = threadIdx.x % COLS, ty = threadIdx.x / COLS;
  const int col = blockIdx.x * COLS + tx;
  const int len = (nb + RUNS - 1) / RUNS;
  const int b1 = min(nb, (ty + 1) * len);
  float a = 0.f;
  if (col < D) {
#pragma unroll 8
    for (int b = ty * len; b < b1; ++b)
      a += p[static_cast<long long>(b) * D + col];
  }
  run[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < D) {
    float total = run[0][tx];
#pragma unroll
    for (int l = 1; l < RUNS; ++l) total += run[l][tx];
    Elt<S>::store(dscale + static_cast<long long>(seg) * D + col, total);
  }
}

// The rows pass `layout` asks for: (W, N) = (1, 1), (2, 1), (4, 1), (4, 2),
// (8, 2), (8, 4), (8, 8) with 16-byte loads or one element at a time, and
// wide_kernel past 8 vectors a lane; then the dscale pass.
template <typename T, typename S, bool VEC_LOAD>
int dispatch(const Seg& s0, const Seg& s1, int D, float eps, int warps,
             int slots, float* partial, cudaStream_t st) {
  const auto go = [&](auto kernel) {
    kernel<<<s0.blocks + s1.blocks, NT, 0, st>>>(s0, s1, D, eps, partial);
    return static_cast<int>(cudaGetLastError());
  };
  switch (warps * 16 + slots) {
    case 1 * 16 + 1: return go(rows_kernel<T, S, 1, 1, VEC_LOAD>);
    case 2 * 16 + 1: return go(rows_kernel<T, S, 2, 1, VEC_LOAD>);
    case 4 * 16 + 1: return go(rows_kernel<T, S, 4, 1, VEC_LOAD>);
    case 4 * 16 + 2: return go(rows_kernel<T, S, 4, 2, VEC_LOAD>);
    case 8 * 16 + 2: return go(rows_kernel<T, S, 8, 2, VEC_LOAD>);
    case 8 * 16 + 4: return go(rows_kernel<T, S, 8, 4, VEC_LOAD>);
    case 8 * 16 + 8: return go(rows_kernel<T, S, 8, MAX_SLOTS, VEC_LOAD>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename S>
int launch(const Seg& s0, const Seg& s1, int D, float eps, int warps,
           int slots, int vec, float* partial, void* dscale, int segments,
           cudaStream_t st) {
  if (s0.blocks + s1.blocks > 0) {
    int err;
    if (slots > MAX_SLOTS) {
      wide_kernel<T, S><<<s0.blocks + s1.blocks, NT, 0, st>>>(s0, s1, D, eps,
                                                             partial);
      err = static_cast<int>(cudaGetLastError());
    } else {
      err = vec ? dispatch<T, S, true>(s0, s1, D, eps, warps, slots, partial,
                                       st)
                : dispatch<T, S, false>(s0, s1, D, eps, warps, slots,
                                        partial, st);
    }
    if (err != 0) return err;
  }
  const dim3 grid((D + COLS - 1) / COLS, segments);
  dscale_kernel<S><<<grid, COLS * RUNS, 0, st>>>(s0.blocks, s1.blocks, D,
                                                 partial,
                                                 static_cast<S*>(dscale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success; cudaErrorInvalidValue for a layout with no
// instantiation). rows1 = 0 and blocks1 = 0 mean one tensor. The caller
// has checked shapes, types and layout (both tensors of one D, one type
// and one scale type), chosen (warps, slots) from D and the type and each
// segment's (per, blocks) from its rows and D, vec only where every base
// and row stride lies on 16 bytes and V divides D, and allocated dx, the
// float32 partial rows (blocks0 + blocks1, D) and dscale (segments, D) in
// the scale's type, which the second launch writes whole (0 for a segment
// without rows).
int rmsnorm_bwd_launch(const void* x0, const void* scale0, const void* g0,
                       void* dx0, long long rows0, long long row_stride0,
                       long long per0, int blocks0, const void* x1,
                       const void* scale1, const void* g1, void* dx1,
                       long long rows1, long long row_stride1,
                       long long per1, int blocks1, int D, float eps,
                       int warps, int slots, int vec, void* partial,
                       void* dscale, int segments, int x_bf16, int scale_bf16,
                       void* stream) {
  using bf16 = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seg s0{x0, scale0, g0, dx0, rows0, row_stride0, per0, blocks0};
  const Seg s1{x1, scale1, g1, dx1, rows1, row_stride1, per1, blocks1};
  float* part = static_cast<float*>(partial);
  if (x_bf16)
    return scale_bf16
               ? launch<bf16, bf16>(s0, s1, D, eps, warps, slots, vec, part,
                                    dscale, segments, st)
               : launch<bf16, float>(s0, s1, D, eps, warps, slots, vec, part,
                                     dscale, segments, st);
  return scale_bf16 ? launch<float, bf16>(s0, s1, D, eps, warps, slots, vec,
                                          part, dscale, segments, st)
                    : launch<float, float>(s0, s1, D, eps, warps, slots, vec,
                                           part, dscale, segments, st);
}
