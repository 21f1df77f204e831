// The gradient of prefill attention for Hopper (sm_90a), float32.
//
// Replaces no Pallas kernel: JAX trains through the custom VJP of its jnp
// flash path, src/repro/kernels/flash_ref.py::_bwd_impl, and the port's
// forward kernels (flash_attention.cu) have no gradient of their own. It
// computes what _bwd_impl computes, with the forward's masks (causal,
// window, softcap, queries right-aligned against the keys at offset
// Skv - Sq, ragged tails, GQA with query head h reading kv head
// h / (H / Hkv), K != Kv):
//
//   p     = exp(s - lse)               s the (capped) scaled score, 0 masked
//   delta = sum_c dO * O               a row
//   ds    = p * (dO . V^T - delta)     (* (1 - t^2) under a softcap t)
//   dQ    = scale * ds . K
//   dK    = scale * ds^T . Q           summed over the G heads of a kv head
//   dV    = p^T . dO                   summed likewise
//
// with lse the forward's per-row log-sum-exp (B, H, Sq), which the float32
// forward body writes when asked (flash_attention.cu).
//
// Layout: q (B, Sq, H, K), k (B, Skv, Hkv, K), v (B, Skv, Hkv, Kv), out and
// dout (B, Sq, H, Kv), lse and the delta workspace (B, H, Sq), dq, dk, dv
// as q, k, v; all float32, contiguous.
//
// Three kernels a call, as the TPU reference's two passes plus its row
// pass: delta (one warp a row); dq (one block per 64-row query tile, query
// head and batch row, a loop inside the block over the KV tiles the rows
// can see, as the forward walks them); dk and dv (one block per 64-key
// tile, kv head and batch row, a loop over the G query heads of that kv
// head and, within each, over the query tiles that can see the keys). So
// every output element has one owner and is written once: no atomics,
// and the sums run in one fixed order, so the bits repeat from run to
// run. Both passes recompute the score tile the forward computed, with
// the forward's thread layout and summation order (16 x 16 threads, each 4
// query rows x 4 keys; K, then Kv, in order), so p matches the forward's.
// Tiles are staged in shared memory as float32 rows padded by one word; K
// is zero-padded to a multiple of 16 columns (exact zeros add nothing).
//
// Bound. The function reads q, k, v, out, dout and lse once and writes dq,
// dk and dv once, and does 2 * pairs * (3K + 2Kv) operations over the
// visible (query, key) pairs of every head (the score, dO.V^T, dq, dk and
// dv; the dq pass recomputes the first two on top). At qwen3-0.6b's
// training shape (B 8, S 512, H 16, Hkv 8, K = Kv = 128, causal) that is
// 21.5 GFLOP against 201 MB: bound by operations on the f32 CUDA cores
// (67 TFLOP/s, 0.32 ms). This first design stays on the CUDA cores (TF32
// would miss the float32 parity contract) and holds one block an SM (up to
// 226 KB of shared memory); making it fast is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // 16 x 16 threads

// sum over the 32 lanes of a warp
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta[b, h, i] = sum_c dout[b, i, h, c] * out[b, i, h, c]: one warp a row
__global__ void __launch_bounds__(NT)
    delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int Sq, int H,
                 int Kv) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* o = out + r * Kv;
  const float* d = dout + r * Kv;
  float acc = 0.f;
  for (int c = lane; c < Kv; c += 32) acc = fmaf(o[c], d[c], acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    // r = (b * Sq + i) * H + h
    const long long h = r % H, bi = r / H, i = bi % Sq, b = bi / Sq;
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// Stage rows [r0, r0 + n) of a (.., rows, heads, width) tensor's head `hh`
// into shared memory, `ld` floats a row, zero past the tensor's rows and
// past `width` up to `cols`.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int r0, int n, int rows, int heads,
                                      int hh, int width, int cols,
                                      size_t batch_off, int tid) {
  for (int i = tid; i < n * cols; i += NT) {
    const int r = i / cols, d = i % cols, rr = r0 + r;
    dst[r * ld + d] = (rr < rows && d < width)
                          ? src[batch_off + (size_t(rr) * heads + hh) * width + d]
                          : 0.f;
  }
}

// The score tile of rows q0 + ty*4 + i against keys k0 + tx + 16*j, as the
// forward computes it (fmaf over d in order, then scale, then the cap);
// p = exp(s - lse) where visible and 0 elsewhere, and ds = p * (dp - delta)
// (* (1 - t^2) with a cap), dp the dO.V^T tile. Both passes call this.
__device__ __forceinline__ void p_and_ds(
    const float* qs, int ldq, const float* ks, const float* dos, int ldo,
    const float* vs, int ldv, const float* lse_s, const float* delta_s,
    int q0, int k0, int Sq, int Skv, int off, int K, int Kv, int causal,
    int window, float scale, float softcap, int ty, int tx, float p[4][4],
    float ds[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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
  for (int d = 0; d < Kv; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = dos[(ty * 4 + i) * ldo + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = vs[(tx + 16 * j) * ldv + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const int qpos = row + off;
    const float l = lse_s[ty * 4 + i], dl = delta_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool ok = row < Sq && kp < Skv && (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      float x = s[i][j] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        dcap = 1.f - t * t;
      }
      const float pij = ok ? expf(x - l) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - dl) * dcap;
    }
  }
}

// Q, K, dO and V tiles, the ds and p tiles, lse and delta of the rows
size_t smem_floats(int KP, int Kv) {
  return size_t(BQ + BK) * (KP + 1 + Kv + 1) + 2 * size_t(BQ) * (BK + 1) +
         2 * BQ;
}

// dq: NK = KP / 16 output columns a thread (KP = K padded to 16)
template <int NK>
__global__ void __launch_bounds__(NT)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Skv, int H, int Hkv, int K,
              int Kv, int causal, int window, float scale, float softcap) {
  constexpr int KP = NK * 16;
  extern __shared__ float smem[];
  const int ldq = KP + 1, ldo = Kv + 1, ldp = BK + 1;
  float* qs = smem;                 // BQ x ldq
  float* ks = qs + BQ * ldq;        // BK x ldq
  float* dos = ks + BK * ldq;       // BQ x ldo
  float* vs = dos + BQ * ldo;       // BK x ldo
  float* dss = vs + BK * ldo;       // BQ x ldp
  float* lse_s = dss + BQ * ldp;    // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = Skv - Sq;

  stage(qs, ldq, q, q0, BQ, Sq, H, h, K, KP, size_t(b) * Sq * H * K, tid);
  stage(dos, ldo, dout, q0, BQ, Sq, H, h, Kv, Kv, size_t(b) * Sq * H * Kv,
        tid);
  for (int i = tid; i < BQ; i += NT) {
    const int row = q0 + i;
    const size_t at = (size_t(b) * H + h) * Sq + row;
    lse_s[i] = row < Sq ? lse[at] : 0.f;
    delta_s[i] = row < Sq ? delta[at] : 0.f;
  }

  // the forward's KV tiles for this query tile
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, last_row + off + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q0 + off - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  float acc[4][NK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NK; ++c) acc[i][c] = 0.f;

  const size_t kv_off = size_t(b) * Skv * Hkv;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    stage(ks, ldq, k, k0, BK, Skv, Hkv, hk, K, KP, kv_off * K, tid);
    stage(vs, ldo, v, k0, BK, Skv, Hkv, hk, Kv, Kv, kv_off * Kv, tid);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds(qs, ldq, ks, dos, ldo, vs, ldo, lse_s, delta_s, q0, k0, Sq, Skv,
             off, K, Kv, causal, window, scale, softcap, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * ldp + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float kk[NK];
#pragma unroll
      for (int c = 0; c < NK; ++c) kk[c] = ks[j * ldq + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dss[(ty * 4 + i) * ldp + j];
#pragma unroll
        for (int c = 0; c < NK; ++c) acc[i][c] = fmaf(d, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* o = dq + ((size_t(b) * Sq + row) * H + h) * K;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int col = tx + 16 * c;
      if (col < K) o[col] = acc[i][c] * scale;
    }
  }
}

// dk and dv: NK = KP / 16 key columns, NC = Kv / 16 value columns a thread
template <int NK, int NC>
__global__ void __launch_bounds__(NT)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int H, int Hkv, int K,
                int causal, int window, float scale, float softcap) {
  constexpr int KP = NK * 16, Kv = NC * 16;
  extern __shared__ float smem[];
  const int ldq = KP + 1, ldo = Kv + 1, ldp = BK + 1;
  float* qs = smem;                 // BQ x ldq
  float* ks = qs + BQ * ldq;        // BK x ldq
  float* dos = ks + BK * ldq;       // BQ x ldo
  float* vs = dos + BQ * ldo;       // BK x ldo
  float* dss = vs + BK * ldo;       // BQ x ldp
  float* ps = dss + BQ * ldp;       // BQ x ldp
  float* lse_s = ps + BQ * ldp;     // BQ
  float* delta_s = lse_s + BQ;      // BQ

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = Skv - Sq;

  const size_t kv_off = size_t(b) * Skv * Hkv;
  stage(ks, ldq, k, k0, BK, Skv, Hkv, hk, K, KP, kv_off * K, tid);
  stage(vs, ldo, v, k0, BK, Skv, Hkv, hk, Kv, Kv, kv_off * Kv, tid);

  // the query tiles whose rows can see some key of this tile
  const int k_last = min(k0 + BK, Skv) - 1;
  int q_begin = causal ? max(0, k0 - off) : 0;
  q_begin = (q_begin / BQ) * BQ;
  const int q_end = window > 0 ? min(Sq, k_last + window - off) : Sq;

  float dka[4][NK], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NK; ++c) dka[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) dva[i][c] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage(qs, ldq, q, q0, BQ, Sq, H, h, K, KP, size_t(b) * Sq * H * K, tid);
      stage(dos, ldo, dout, q0, BQ, Sq, H, h, Kv, Kv,
            size_t(b) * Sq * H * Kv, tid);
      for (int i = tid; i < BQ; i += NT) {
        const int row = q0 + i;
        const size_t at = (size_t(b) * H + h) * Sq + row;
        lse_s[i] = row < Sq ? lse[at] : 0.f;
        delta_s[i] = row < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds(qs, ldq, ks, dos, ldo, vs, ldo, lse_s, delta_s, q0, k0, Sq,
               Skv, off, K, Kv, causal, window, scale, softcap, ty, tx, p,
               ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty * 4 + i) * ldp + tx + 16 * j] = p[i][j];
          dss[(ty * 4 + i) * ldp + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // this thread's keys ty*4 + r against every row of the tile
      for (int i = 0; i < BQ; ++i) {
        float qq[NK], dd[NC];
#pragma unroll
        for (int c = 0; c < NK; ++c) qq[c] = qs[i * ldq + tx + 16 * c];
#pragma unroll
        for (int c = 0; c < NC; ++c) dd[c] = dos[i * ldo + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pv = ps[i * ldp + ty * 4 + r];
          const float dsv = dss[i * ldp + ty * 4 + r];
#pragma unroll
          for (int c = 0; c < NK; ++c) dka[r][c] = fmaf(dsv, qq[c], dka[r][c]);
#pragma unroll
          for (int c = 0; c < NC; ++c) dva[r][c] = fmaf(pv, dd[c], dva[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= Skv) continue;
    const size_t at = (size_t(b) * Skv + kp) * Hkv + hk;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const int col = tx + 16 * c;
      if (col < K) dk[at * K + col] = dka[r][c] * scale;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) dv[at * Kv + tx + 16 * c] = dva[r][c];
  }
}

struct Args {
  const float *q, *k, *v, *out, *lse, *dout;
  float *dq, *dk, *dv, *delta;
  int B, Sq, Skv, H, Hkv, K, Kv, causal, window;
  float scale, softcap;
  cudaStream_t stream;
};

template <int NK>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats(NK * 16, a.Kv);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<NK><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.Sq, a.Skv, a.H, a.Hkv,
      a.K, a.Kv, a.causal, a.window, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int NK, int NC>
cudaError_t launch_dkdv(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats(NK * 16, NC * 16);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NK, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.Hkv, a.B);
  dkdv_kernel<NK, NC><<<grid, NT, smem, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.Sq, a.Skv, a.H,
      a.Hkv, a.K, a.causal, a.window, a.scale, a.softcap);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_kv(const Args& a) {
  if (a.Sq > 0) {
    const cudaError_t err = launch_dq<NK>(a);
    if (err != cudaSuccess) return err;
  }
  if (a.Skv == 0) return cudaSuccess;
  switch (a.Kv) {
    case 16: return launch_dkdv<NK, 1>(a);
    case 32: return launch_dkdv<NK, 2>(a);
    case 64: return launch_dkdv<NK, 4>(a);
    case 112: return launch_dkdv<NK, 7>(a);
    case 128: return launch_dkdv<NK, 8>(a);
    case 256: return launch_dkdv<NK, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C++ entry point for the binding; returns the cudaError_t of the
// launches (0 on success). The caller has checked shapes, types, layout and
// that the tiles fit in shared memory, and allocated the outputs and the
// delta workspace (B, H, Sq).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, int B, int Sq, int Skv, int H,
                               int Hkv, int K, int Kv, int causal, int window,
                               float scale, float softcap, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(out),
               static_cast<const float*>(lse),
               static_cast<const float*>(dout), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta), B, Sq, Skv, H, Hkv, K, Kv, causal,
               window, scale, softcap, static_cast<cudaStream_t>(stream)};
  if (B == 0 || H == 0) return cudaSuccess;
  if (Sq > 0) {
    const long long rows = (long long)B * Sq * H;
    const int per = NT / 32;
    delta_kernel<<<unsigned((rows + per - 1) / per), NT, 0, a.stream>>>(
        a.out, a.dout, a.delta, rows, Sq, H, Kv);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // with no query row dq is empty, and dk / dv come out 0 (no tile runs)
  const int nk = (K + 15) / 16;
  if (nk <= 1) return launch_kv<1>(a);
  if (nk <= 2) return launch_kv<2>(a);
  if (nk <= 4) return launch_kv<4>(a);
  if (nk <= 8) return launch_kv<8>(a);
  if (nk <= 12) return launch_kv<12>(a);
  if (nk <= 16) return launch_kv<16>(a);
  return cudaErrorInvalidValue;
}
