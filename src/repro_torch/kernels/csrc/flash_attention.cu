// Prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// ::flash_attention (_attn_kernel): causal / sliding-window / softcapped
// attention with an online softmax and GQA (query head h reads kv head
// h / (H / Hkv)), queries right-aligned against the keys (offset Skv - Sq).
//
// Layout: q (B, Sq, H, K), k (B, Skv, Hkv, K), v (B, Skv, Hkv, Kv),
// out (B, Sq, H, Kv), all contiguous, float32 or bfloat16; scores,
// softmax statistics and the output accumulator are float32.
//
// Design. One block per (query tile of BQ rows, query head, batch row).
// The TPU kernel carried its softmax state across a sequential grid axis
// of KV tiles; here a loop inside the block walks the KV tiles instead,
// and causal / window bounds skip the tiles no row of this block can see.
// Q, K and V tiles are staged in shared memory as float32 (row strides
// padded by one word, so column reads hit distinct banks); each of the
// 16 x 16 threads owns 4 query rows x 4 key columns of the score tile and
// 4 rows x Kv/16 columns of the output. Rows and keys past the ends are
// masked, so no length has to divide the tile. A masked score gets an
// exact 0.0 weight, and a row that sees no key at all writes 0.
//
// Bound. Causal prefill does 2*2*B*H*Sq*Skv*K/2 operations over
// (2*B*Sq*H*K + 2*B*Skv*Hkv*K)*itemsize bytes: at the main path's widths
// it is bound by operations. This first version runs its products on the
// float32 CUDA cores (exact float32 for float32 inputs); moving them onto
// wgmma with TMA-fed tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // 16 x 16 threads

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

// sum / max over the 16 lanes that share a row group (lane bits 0..3)
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int K, int Kv) {
  return sizeof(float) *
         (size_t(BQ) * (K + 1) + size_t(BK) * (K + 1) + size_t(BK) * Kv +
          size_t(BQ) * (BK + 1));
}

template <typename T, int NC>  // NC = Kv / 16 output columns per thread
__global__ void __launch_bounds__(NT)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Skv, int H, int Hkv, int K, int causal,
                           int window, float scale, float softcap) {
  constexpr int Kv = NC * 16;
  extern __shared__ float smem[];
  const int ldq = K + 1;
  const int ldp = BK + 1;
  float* qs = smem;              // BQ x ldq
  float* ks = qs + BQ * ldq;     // BK x ldq
  float* vs = ks + BK * ldq;     // BK x Kv
  float* ps = vs + BK * Kv;      // BQ x ldp

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int off = Skv - Sq;  // right-aligned queries

  for (int i = tid; i < BQ * K; i += NT) {
    const int r = i / K, d = i % K, qp = q0 + r;
    qs[r * ldq + d] =
        qp < Sq ? to_float(q[((size_t(b) * Sq + qp) * H + h) * K + d]) : 0.f;
  }

  // keys this tile can see: causal stops at the last row's position, a
  // window starts at the oldest key the first row still sees
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * K; i += NT) {
      const int r = i / K, d = i % K, kp = k0 + r;
      ks[r * ldq + d] =
          kp < Skv ? to_float(k[((size_t(b) * Skv + kp) * Hkv + hk) * K + d])
                   : 0.f;
    }
    for (int i = tid; i < BK * Kv; i += NT) {
      const int r = i / Kv, d = i % Kv, kp = k0 + r;
      vs[r * Kv + d] =
          kp < Skv ? to_float(v[((size_t(b) * Skv + kp) * Hkv + hk) * Kv + d])
                   : 0.f;
    }
    __syncthreads();

    // scores for rows ty*4+i and key columns tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < K; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = row + off;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(rmax));
      // nothing visible yet: keep the (zero) state as it is
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * ldp + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * alpha + group16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[j * Kv + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * ldp + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t(b) * Sq + row) * H + h) * Kv;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int K, int causal,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(K, NC * 16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, Hkv, K,
      causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kv(int Kv, const void* q, const void* k, const void* v,
                      void* out, int B, int Sq, int Skv, int H, int Hkv, int K,
                      int causal, int window, float scale, float softcap,
                      cudaStream_t stream) {
  switch (Kv) {
    case 16: return launch<T, 1>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 32: return launch<T, 2>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 64: return launch<T, 4>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 128: return launch<T, 8>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    case 256: return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, Hkv, K, causal, window, scale, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launch (0 on success). The caller has checked shapes, types and layout.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int H, int Hkv,
                           int K, int Kv, int causal, int window, float scale,
                           float softcap, int is_bf16, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_kv<__nv_bfloat16>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K,
                                    causal, window, scale, softcap, s);
  return launch_kv<float>(Kv, q, k, v, out, B, Sq, Skv, H, Hkv, K, causal,
                          window, scale, softcap, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
