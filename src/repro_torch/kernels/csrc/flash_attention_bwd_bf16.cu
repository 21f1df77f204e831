// The gradient of prefill attention for Hopper (sm_90a), bfloat16: the
// body flash_attention_bwd.cu's entry point takes for bfloat16 q, k, v,
// out and dout (float32 lse from the bf16 forward, flash_attention.cu),
// writing bfloat16 dq, dk and dv. It replaces the first bf16 body (three
// mma.sync passes: delta, dq over key tiles, dk / dv over query tiles),
// which had no Pallas counterpart either: JAX differentiates
// src/repro/kernels/flash_ref.py::_bwd_impl.
//
// It computes what _bwd_impl computes for bfloat16 inputs (what
// flash_attention_bwd.cu's header sets out, with the same masks: causal,
// window, softcap, 0 for a row that sees no key): every sum in float32,
// delta = sum dO * O from out and dout read as float32, P and dS entering
// their products as bfloat16, each output rounded to bfloat16 once.
//
// Bound. At qwen3-0.6b's training shape (B 8, S 512, H 16, Hkv 8, K = Kv =
// 128, causal) the function reads q, k, v, out, dout (bf16) and lse and
// writes dq, dk, dv (bf16): 100.8 MB, 0.030 ms at 3.35 TB/s, against
// 2 * pairs * (3K + 2Kv) = 21.5 GFLOP, 0.022 ms at 989 TFLOP/s: bound by
// bytes.
//
// Three kernels a call: the delta row pass (flash_bwd.cuh), a walk over
// key tiles for dK and dV, and a pass over query tiles for dQ. What the
// design does about what held the first body back:
// - mma.sync from ldmatrix fragments: every product is wgmma (m64nNk16,
//   bf16 in, float32 accumulate, wgmma.cuh), issued by two consumer warp
//   groups straight from the tiles in shared memory, in the 128-byte
//   swizzle TMA writes, or (dQ's dS) from the accumulator's registers.
// - Copies by cp.async, 16 bytes a thread, one tile ahead: TMA copies every
//   tile (4-d tensor maps over (batch, row, head, column), rows and columns
//   past the tensor zero-filled) and the rows' lse and delta into a ring of
//   stages completing on mbarriers; one producer warp keeps the loads in
//   flight and setmaxnreg gives its registers to the consumers. Rows that
//   do not start on 16 bytes (K not a multiple of 8, a base off 16 bytes)
//   cannot be read by TMA: there the producer warp writes the same swizzled
//   tiles element by element, and every bit comes out the same.
// - The dk/dv pass waiting on itself (one Q / dO buffer, five barriers an
//   item, P and dS through one tile): the walk runs persistent blocks, one
//   an SM, taking items (a 64-key tile of a kv head and batch row) from an
//   atomic counter, heaviest first under a causal mask; each walks the
//   query tiles (64 rows) of the G heads that see it, head by head,
//   ascending, with Q, dO, lse and delta arriving three stages ahead and the
//   next item's first stage loaded before its K and V. The two consumer
//   groups split every product evenly: S^T = K.Q^T and dP^T = V.dO^T by
//   query halves (32 columns each), P^T and dS^T through a pair of shared
//   tiles (two pairs, used in turn, so a step costs one barrier), dV +=
//   P^T.dO and dK += dS^T.Q by column halves. At K = Kv = 128 a thread
//   holds 32 + 32 accumulators of dK and dV and 16 + 16 of S^T and dP^T;
//   with dK and dV of 64 keys each a warp group (FlashAttention-3's split,
//   128 of them) the walk spilled under 232 registers.
// - Seven products, K / V and Q / dO read again by each pass: the walk runs
//   four (S, dP, dV, dK) and reads K and V once an item. dQ is summed in a
//   fixed order, so the bits repeat from run to run: the dq pass (a block a
//   pair of 64-row query tiles of a head, one a warp group) walks the key
//   tiles the rows see in ascending order, recomputing S and dP, adds dQ +=
//   dS.K with dS from its accumulators, every sum in registers, and writes
//   dq = bf16(scale * sum) once. Adding each key tile's part into a float32
//   accumulator in key tile order instead (a counter a query tile, a writer
//   warp adding 64 x K float32 tiles at L2 by TMA) measured slower at
//   qwen3's batch, bound by those adds: 151 MB of them (PERF.md).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;                 // query rows a tile
constexpr int BN = 64;                 // keys a tile
constexpr int NCW = 2;                 // consumer warp groups
// and a producer warp group, of which one warp works: setmaxnreg moves
// registers between warp groups of the block's pool, 65536 / 384 = 168 a
// thread at launch, so 2 x 128 x 216 + 128 x 64 = 64512 of it (the
// producer's element path spills under 56)
constexpr int NTHREADS = (NCW + 1) * GT;
constexpr int PRODUCER_REGS = 64;
constexpr int CONSUMER_REGS = 216;
constexpr int ROW = 128;               // bytes of a swizzled tile row
constexpr int ATOM = 64;               // bf16 columns of a row
constexpr int ROWS = 2 * BM * 4;       // a tile's lse and delta, float32

struct Args {
  const bf16 *q, *k, *v, *dout;   // read here only off the TMA path
  const float *lse, *delta;
  int* items;                     // the walk's item counter, zeroed
  bf16 *dq, *dk, *dv;
  int B, Sq, Skv, H, Hkv, K, Kv, causal, window;
  float scale, softcap;
  // scale / softcap and softcap * log2(e), from the host: a division in
  // the loop would call a subroutine, and every register live across the
  // call would spill
  float cap_in, cap_out;
  int tma, rows_tma, n_items;
};

// ---- barriers, copies and fences ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// A wait that could not end (a fault in the protocol) traps after about
// ten seconds, so the launch fails instead of holding the card
constexpr long long STUCK_CYCLES = 1ll << 34;
__device__ __forceinline__ void check_stuck(long long t0) {
  if (clock64() - t0 > STUCK_CYCLES) __trap();
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    check_stuck(t0);
  }
}
// a box of the 4-d tensor map at (column, head, row, batch) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int h, int r,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(h), "r"(r), "r"(b),
      "r"(bar)
      : "memory");
}
// a tile of `atoms` 64-column boxes of `rows` rows
__device__ __forceinline__ void tma_tiles(uint32_t dst, int atoms, int rows,
                                          const CUtensorMap* map,
                                          uint32_t bar, int h, int r, int b) {
  for (int c = 0; c < atoms; ++c)
    tma_load(dst + c * rows * ROW, map, bar, c * ATOM, h, r, b);
}
// 64 float32 of row bh of a 2-d tensor map (the rows' lse or delta) from
// column q0, past the tensor zero
__device__ __forceinline__ void tma_load_row(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int q0, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(q0), "r"(bh), "r"(bar)
      : "memory");
}
// generic-proxy stores to shared memory, before wgmma or TMA reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x, as the hardware's ex2 computes it (flush to zero below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// shared memory by 32-bit address (a generic pointer takes two registers)
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ int lds_int(uint32_t a) {
  int v;
  asm volatile("ld.volatile.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(a)
               : "memory");
  return v;
}
// a value the compiler must take as new here: the shared memory bases of
// the tiles, so that it builds each product's descriptors where they are
// used instead of keeping all of them live across the loop
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void store_pair(bf16* p, int col, int width,
                                           float x0, float x1, bool pairs) {
  if (pairs && col + 1 < width) {
    *reinterpret_cast<uint32_t*>(p + col) = mma::pack_bf16(x0, x1);
  } else {
    if (col < width) p[col] = __float2bfloat16(x0);
    if (col + 1 < width) p[col + 1] = __float2bfloat16(x1);
  }
}

// The element path: `rows` rows of `width` bf16 (row_stride apart, the
// first `have` present) into the swizzled tile TMA would write (16-byte
// chunk c of row r at chunk c ^ (r % 8) of its 64-column atom), zeros past
// the tensor, by the 32 lanes of the producer warp
template <int W>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const bf16* src, size_t stride,
                                           int have, int width, int rows,
                                           int lane) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  for (int ch = lane; ch < rows * (W / 8); ch += 32) {
    const int r = ch / (W / 8), c = (ch % (W / 8)) * 8;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = c + 2 * i;
      const uint32_t lo =
          r < have && c0 < width ? s[size_t(r) * stride + c0] : 0u;
      const uint32_t hi =
          r < have && c0 + 1 < width ? s[size_t(r) * stride + c0 + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + (c / ATOM) * rows * ROW + r * ROW +
                              ((((c % ATOM) >> 3) ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A B operand of columns from `col` of a swizzled tile of `rows` rows, the
// k16 step at depth row 16 * kk (MN-major)
__device__ __forceinline__ uint64_t cols_desc(uint32_t tile, int rows,
                                              int col, int kk) {
  return wg::desc(tile + (col / ATOM) * rows * ROW + (col % ATOM) * 2 +
                      kk * 16 * ROW,
                  rows * ROW, 1024);
}
// an A or B operand of rows from `row` of a swizzled tile of `rows` rows,
// the k16 step kk along the columns (K-major)
__device__ __forceinline__ uint64_t rows_desc(uint32_t tile, int rows,
                                              int row, int kk) {
  return wg::desc(tile + (kk / 4) * rows * ROW + row * ROW + (kk % 4) * 32,
                  16, 1024);
}

// p = exp2(x - lse2) where visible (0 elsewhere), x the scaled (capped)
// score in log2 units; ds = p (dp - delta) (* (1 - t^2) under a cap t)
template <bool CAP>
__device__ __forceinline__ void p_ds(float s, float dp, float lse2,
                                     float delta, bool ok, const Args& a,
                                     float scale2, float& p, float& ds) {
  float x, dcap = 1.f;
  if constexpr (CAP) {
    const float t = tanhf(s * a.cap_in);
    x = t * a.cap_out;
    dcap = 1.f - t * t;
  } else {
    x = s * scale2;
  }
  p = ok ? ex2(x - lse2) : 0.f;
  ds = p * (dp - delta) * dcap;
}

// ============================================================================
// The walk over key tiles: dK and dV
// ============================================================================

// Its tiles in dynamic shared memory, 1024-byte aligned (the swizzle's
// atom): K and V of the item; a ring of STAGES stages of a Q and a dO tile
// and their rows' lse and delta; PBUF pairs of P^T and dS^T tiles (64 keys x
// 64 queries); then the barriers and the item slot. The first of 3 stages
// and 2 pairs, 2 and 2, 2 and 1 that fits.
template <int KP, int KVP>
struct Walk {
  static constexpr int NA = KP / ATOM, NVA = KVP / ATOM;
  static constexpr int K_TILE = BN * KP * 2, V_TILE = BN * KVP * 2;
  static constexpr int Q_TILE = BM * KP * 2, DO_TILE = BM * KVP * 2;
  static constexpr int PS_TILE = BN * BM * 2;
  static constexpr int PER_STAGE = Q_TILE + DO_TILE + ROWS;
  static constexpr int TAIL = 1024 + 128;   // base alignment, barriers
  static constexpr int bytes(int stages, int pbuf) {
    return K_TILE + V_TILE + stages * PER_STAGE + pbuf * 2 * PS_TILE + TAIL;
  }
  static constexpr int STAGES = bytes(3, 2) <= MAX_SMEM ? 3 : 2;
  static constexpr int PBUF = bytes(STAGES, 2) <= MAX_SMEM ? 2 : 1;
  static constexpr int SMEM = bytes(STAGES, PBUF);
  static_assert(SMEM <= MAX_SMEM, "bf16 walk tiles exceed shared memory");
  static constexpr int OFF_K = 0, OFF_V = K_TILE;
  static constexpr int OFF_Q = OFF_V + V_TILE;
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_TILE;
  static constexpr int OFF_PS = OFF_DO + STAGES * DO_TILE;
  static constexpr int OFF_ROWS = OFF_PS + PBUF * 2 * PS_TILE;
  // barriers: K / V full and empty, the ring's full and empty; the item
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * ROWS;
  static constexpr int OFF_SLOT = OFF_BAR + 16 + 16 * STAGES;
  // each consumer group's columns of dK: KP / 2 from column DK0 * group;
  // for KP = 192 a whole atom (0 or 2) and half of atom 1 (columns 64 + 32
  // * group), as an operand may not cross the atom it starts inside
  static constexpr int DK_N0 = KP == 192 ? 64 : KP / 2;
  static constexpr int DK_N1 = KP == 192 ? 32 : 0;
  static constexpr int DK0 = KP == 192 ? 128 : KP / 2;
  static constexpr int DV_N = KVP / 2;
};

struct Item {
  int b, hk, k0, q_begin, n_q;
};
// item = t * (B * Hkv) + b * Hkv + hk: key tile ascending outermost. The
// query tiles whose rows can see a key of [k0, k0 + BN): [q_begin,
// q_begin + n_q * BM), for each of the G heads of kv head hk
__device__ __forceinline__ Item decode(int item, const Args& a) {
  Item it;
  const int bh = item % (a.B * a.Hkv);
  it.b = bh / a.Hkv;
  it.hk = bh % a.Hkv;
  it.k0 = item / (a.B * a.Hkv) * BN;
  const int off = a.Skv - a.Sq;
  const int k_last = min(it.k0 + BN, a.Skv) - 1;
  int qb = a.causal ? max(0, it.k0 - off) : 0;
  qb = (qb / BM) * BM;
  const int qe = a.window > 0 ? min(a.Sq, k_last + a.window - off) : a.Sq;
  it.q_begin = qb;
  it.n_q = qe > qb ? (qe - qb + BM - 1) / BM : 0;
  return it;
}

// The walk's producer warp: K and V of each item it takes, then the item's
// query tiles into the ring
template <int KP, int KVP>
__device__ __forceinline__ void walk_produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const CUtensorMap* tm_lse,
    const CUtensorMap* tm_delta, const Args& a, unsigned char* sm,
    uint32_t s0) {
  using C = Walk<KP, KVP>;
  const int lane = threadIdx.x % 32, G = a.H / a.Hkv;
  const uint32_t kv_full = s0 + C::OFF_BAR, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_full + 16, empty0 = full0 + 8 * C::STAGES;
  int stage = 0;
  uint32_t ph = 0, kv_ph = 0;

  // query tile j of the item into the ring's current stage
  auto load_step = [&](const Item& it, int j) {
    const int h = it.hk * G + j / it.n_q;
    const int q0 = it.q_begin + (j % it.n_q) * BM;
    mbar_wait(empty0 + 8 * stage, ph ^ 1);
    const uint32_t full = full0 + 8 * stage;
    const uint32_t qs = s0 + C::OFF_Q + stage * C::Q_TILE;
    const uint32_t dos = s0 + C::OFF_DO + stage * C::DO_TILE;
    const uint32_t rows = s0 + C::OFF_ROWS + stage * ROWS;
    // the rows' lse and delta: by TMA where their rows start on 16 bytes
    if (!a.rows_tma) {
      float* r_ = reinterpret_cast<float*>(sm + C::OFF_ROWS + stage * ROWS);
      for (int r = lane; r < BM; r += 32) {
        const bool in = q0 + r < a.Sq;
        const size_t at = (size_t(it.b) * a.H + h) * a.Sq + q0 + r;
        r_[r] = in ? a.lse[at] : 0.f;
        r_[BM + r] = in ? a.delta[at] : 0.f;
      }
    }
    if (a.tma) {
      if (lane == 0) {
        mbar_arrive_tx(full, C::Q_TILE + C::DO_TILE + (a.rows_tma ? ROWS : 0));
        if (a.rows_tma) {
          tma_load_row(rows, tm_lse, full, q0, it.b * a.H + h);
          tma_load_row(rows + BM * 4, tm_delta, full, q0, it.b * a.H + h);
        }
        tma_tiles(qs, C::NA, BM, tm_q, full, h, q0, it.b);
        tma_tiles(dos, C::NVA, BM, tm_do, full, h, q0, it.b);
      } else {
        mbar_arrive(full);
      }
    } else {
      const size_t row0 = size_t(it.b) * a.Sq + q0;
      stage_rows<KP>(sm + C::OFF_Q + stage * C::Q_TILE,
                     a.q + (row0 * a.H + h) * a.K, size_t(a.H) * a.K,
                     a.Sq - q0, a.K, BM, lane);
      stage_rows<KVP>(sm + C::OFF_DO + stage * C::DO_TILE,
                      a.dout + (row0 * a.H + h) * a.Kv, size_t(a.H) * a.Kv,
                      a.Sq - q0, a.Kv, BM, lane);
      fence_async_smem();
      mbar_arrive(full);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      ph ^= 1;
    }
  };

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(a.items, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    const bool live = item < a.n_items;
    const Item it = decode(live ? item : 0, a);
    const int steps = live ? G * it.n_q : 0;
    // the first query tile goes in before K and V: its stage is freed by
    // the consumers on data already in the ring
    if (steps > 0) load_step(it, 0);
    mbar_wait(kv_empty, kv_ph ^ 1);
    kv_ph ^= 1;
    if (lane == 0) sts(s0 + C::OFF_SLOT, live ? item : -1);
    if (!live) {
      mbar_arrive(kv_full);
      break;
    }
    if (a.tma) {
      if (lane == 0) {
        mbar_arrive_tx(kv_full, C::K_TILE + C::V_TILE);
        tma_tiles(s0 + C::OFF_K, C::NA, BN, tm_k, kv_full, it.hk, it.k0,
                  it.b);
        tma_tiles(s0 + C::OFF_V, C::NVA, BN, tm_v, kv_full, it.hk, it.k0,
                  it.b);
      } else {
        mbar_arrive(kv_full);
      }
    } else {
      const size_t row0 = size_t(it.b) * a.Skv + it.k0;
      stage_rows<KP>(sm + C::OFF_K, a.k + (row0 * a.Hkv + it.hk) * a.K,
                     size_t(a.Hkv) * a.K, a.Skv - it.k0, a.K, BN, lane);
      stage_rows<KVP>(sm + C::OFF_V, a.v + (row0 * a.Hkv + it.hk) * a.Kv,
                      size_t(a.Hkv) * a.Kv, a.Skv - it.k0, a.Kv, BN, lane);
      fence_async_smem();
      mbar_arrive(kv_full);
    }
    for (int j = 1; j < steps; ++j) load_step(it, j);
  }
}

// The walk's consumer warp groups: group g takes query columns [32 g,
// 32 g + 32) of S^T and dP^T and its columns of dK and dV
template <int KP, int KVP, bool CAP>
__device__ __forceinline__ void walk_consume(const Args& a, uint32_t s0) {
  using C = Walk<KP, KVP>;
  const int tid = threadIdx.x, wg = tid / GT, wtid = tid % GT;
  const int wi = wtid / 32, lane = tid % 32, gr = lane / 4, tq = lane % 4;
  const int G = a.H / a.Hkv, off = a.Skv - a.Sq;
  const uint32_t kv_full = s0 + C::OFF_BAR, kv_empty = kv_full + 8;
  const uint32_t full0 = kv_full + 16, empty0 = full0 + 8 * C::STAGES;
  const float scale2 = a.scale * LOG2E;
  const bool pairs = (a.K & 1) == 0;
  int stage = 0, pstep = 0;  // the ring's stage, this step's P / dS pair
  uint32_t ph = 0, kv_ph = 0;
  float dk0[C::DK_N0 / 2], dk1[C::DK_N1 ? C::DK_N1 / 2 : 1], dv[C::DV_N / 2];
  const int ck0 = C::DK0 * wg, ck1 = 64 + 32 * wg, cv = C::DV_N * wg;

  for (;;) {
    mbar_wait(kv_full, kv_ph);
    kv_ph ^= 1;
    const int item = lds_int(s0 + C::OFF_SLOT);
    if (item < 0) break;
    const Item it = decode(item, a);
#pragma unroll
    for (int i = 0; i < C::DK_N0 / 2; ++i) dk0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (C::DK_N1 ? C::DK_N1 / 2 : 1); ++i) dk1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::DV_N / 2; ++i) dv[i] = 0.f;
    const int steps = G * it.n_q;
    for (int j = 0; j < steps; ++j) {
      const int q0 = it.q_begin + (j % it.n_q) * BM;
      const uint32_t qs = s0 + C::OFF_Q + stage * C::Q_TILE;
      const uint32_t dos = s0 + C::OFF_DO + stage * C::DO_TILE;
      const uint32_t rows = s0 + C::OFF_ROWS + stage * ROWS;
      const uint32_t pt = fresh(s0 + C::OFF_PS + pstep * 2 * C::PS_TILE);
      const uint32_t dst = pt + C::PS_TILE;
      const uint32_t ks = fresh(s0 + C::OFF_K), vs = fresh(s0 + C::OFF_V);
      // key row kp sees query column c of the tile where c < Sq - q0, kp <
      // Skv, kp <= c + q0 + off (causal) and kp > c + q0 + off - window
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = it.k0 + wi * 16 + gr + r * 8;
        const int rel = kp - q0 - off;
        lo[r] = a.causal ? rel : 0;
        hi[r] = kp < a.Skv ? min(a.Sq - q0, a.window > 0 ? rel + a.window
                                                       : BM)
                           : lo[r];
      }
      mbar_wait(full0 + 8 * stage, ph);

      // S^T = K.Q^T and dP^T = V.dO^T over this group's 32 query columns
      float s[16], dp[16];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        wg::mma_ss<32, 0, 0>(s, rows_desc(ks, BN, 0, kk),
                             rows_desc(qs, BM, 32 * wg, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KVP / 16; ++kk)
        wg::mma_ss<32, 0, 0>(dp, rows_desc(vs, BN, 0, kk),
                             rows_desc(dos, BM, 32 * wg, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<16>(s);
      wg::fence_regs<16>(dp);

      // P^T and dS^T as bf16 into this step's pair of tiles: d[4n + e] is
      // key row wi * 16 + gr + 8 (e >> 1), query column 32 * group + 8n +
      // 2tq + (e & 1); the key row sees columns [lo, hi)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int qc = wg * 32 + n * 8 + 2 * tq;
        const float2 l2 = lds2(rows + 4 * qc);
        const float2 dl = lds2(rows + 4 * (BM + qc));
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc + (e & 1);
          p_ds<CAP>(s[4 * n + e], dp[4 * n + e],
                    ((e & 1) ? l2.y : l2.x) * LOG2E, (e & 1) ? dl.y : dl.x,
                    c >= lo[e >> 1] && c < hi[e >> 1], a, scale2, p[e], d[e]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kr = wi * 16 + gr + r * 8;
          const uint32_t at = kr * ROW + (((qc >> 3) ^ (kr & 7)) << 4) + 4 * tq;
          sts(pt + at, mma::pack_bf16(p[2 * r], p[2 * r + 1]));
          sts(dst + at, mma::pack_bf16(d[2 * r], d[2 * r + 1]));
        }
      }
      fence_async_smem();
      bar_sync(1, NCW * GT);  // both groups' halves of P^T and dS^T stored

      // dV += P^T.dO and dK += dS^T.Q over the 64 query rows, this group's
      // columns
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::mma_ss<C::DV_N, 0, 1>(dv, rows_desc(pt, BN, 0, kk),
                                  cols_desc(dos, BM, cv, kk), 1);
        wg::mma_ss<C::DK_N0, 0, 1>(dk0, rows_desc(dst, BN, 0, kk),
                                   cols_desc(qs, BM, ck0, kk), 1);
        if constexpr (C::DK_N1 > 0)
          wg::mma_ss<C::DK_N1, 0, 1>(dk1, rows_desc(dst, BN, 0, kk),
                                     cols_desc(qs, BM, ck1, kk), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<C::DV_N / 2>(dv);
      wg::fence_regs<C::DK_N0 / 2>(dk0);
      if constexpr (C::DK_N1 > 0) wg::fence_regs<C::DK_N1 / 2>(dk1);
      // Q, dO and the rows of this stage are read
      if (wtid == 0) mbar_arrive(empty0 + 8 * stage);
      // with one pair, both groups' products are done before the next
      // step writes it again
      if constexpr (C::PBUF == 1) bar_sync(2, NCW * GT);
      pstep = C::PBUF == 1 ? 0 : pstep ^ 1;
      if (++stage == C::STAGES) {
        stage = 0;
        ph ^= 1;
      }
    }
    if (wtid == 0) mbar_arrive(kv_empty);  // K and V are read

    // dK = scale * sum dS^T.Q, dV = sum P^T.dO, rounded once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = it.k0 + wi * 16 + gr + r * 8;
      if (kp >= a.Skv) continue;
      const size_t at = (size_t(it.b) * a.Skv + kp) * a.Hkv + it.hk;
#pragma unroll
      for (int n = 0; n < C::DK_N0 / 8; ++n)
        store_pair(a.dk + at * a.K, ck0 + n * 8 + 2 * tq, a.K,
                   dk0[4 * n + 2 * r] * a.scale,
                   dk0[4 * n + 2 * r + 1] * a.scale, pairs);
      if constexpr (C::DK_N1 > 0) {
#pragma unroll
        for (int n = 0; n < C::DK_N1 / 8; ++n)
          store_pair(a.dk + at * a.K, ck1 + n * 8 + 2 * tq, a.K,
                     dk1[4 * n + 2 * r] * a.scale,
                     dk1[4 * n + 2 * r + 1] * a.scale, pairs);
      }
#pragma unroll
      for (int n = 0; n < C::DV_N / 8; ++n)
        store_pair(a.dv + at * a.Kv, cv + n * 8 + 2 * tq, a.Kv,
                   dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1], true);
    }
  }
}

template <int KP, int KVP, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    bwd_bf16_walk_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_lse,
                         const __grid_constant__ CUtensorMap tm_delta,
                         const __grid_constant__ Args a) {
  using C = Walk<KP, KVP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = mma::smem_u32(sm);
  if (threadIdx.x == 0) {
    const uint32_t bar = s0 + C::OFF_BAR;
    mbar_init(bar, 32);       // K and V landed: the producer's lanes
    mbar_init(bar + 8, NCW);  // K and V read: one thread a consumer group
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 16 + 8 * s, 32);
      mbar_init(bar + 16 + 8 * (C::STAGES + s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NCW * GT) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < NCW * GT + 32)
      walk_produce<KP, KVP>(&tm_q, &tm_k, &tm_v, &tm_do, &tm_lse, &tm_delta,
                            a, sm, s0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    walk_consume<KP, KVP, CAP>(a, s0);
  }
}

// ============================================================================
// The pass over query tiles: dQ
// ============================================================================

// A block takes QW 64-row query tiles of one head and batch row (QW = 2, one
// a consumer group; 1 where two tiles do not fit, and for K = 192, whose 96
// accumulator columns a thread spill: there the two groups take half of
// dQ's columns each) and walks the key tiles they see, K and V arriving in
// a ring of STAGES.
// Shared memory: the Q and dO tiles and the rows' lse and delta, the ring,
// the barriers.
template <int KP, int KVP>
struct DqPass {
  static constexpr int NA = KP / ATOM, NVA = KVP / ATOM;
  static constexpr int Q_TILE = BM * KP * 2, DO_TILE = BM * KVP * 2;
  static constexpr int K_TILE = BN * KP * 2, V_TILE = BN * KVP * 2;
  static constexpr int TAIL = 1024 + 128;
  static constexpr int bytes(int qw, int stages) {
    return qw * (Q_TILE + DO_TILE + ROWS) + stages * (K_TILE + V_TILE) + TAIL;
  }
  static constexpr int QW = KP != 192 && bytes(2, 2) <= MAX_SMEM ? 2 : 1;
  static constexpr int STAGES = bytes(QW, 4) <= MAX_SMEM   ? 4
                                : bytes(QW, 3) <= MAX_SMEM ? 3
                                                           : 2;
  static constexpr int SMEM = bytes(QW, STAGES);
  static_assert(SMEM <= MAX_SMEM, "bf16 dq pass tiles exceed shared memory");
  static constexpr int OFF_Q = 0, OFF_DO = QW * Q_TILE;
  static constexpr int OFF_ROWS = OFF_DO + QW * DO_TILE;
  static constexpr int OFF_K = OFF_ROWS + QW * ROWS;
  static constexpr int OFF_V = OFF_K + STAGES * K_TILE;
  // barriers: Q / dO full, the ring's full and empty
  static constexpr int OFF_BAR = OFF_V + STAGES * V_TILE;
  // a group's columns of dQ in two pieces: with a tile each, all of them
  // (from 0 and, past 128, from 128); with half each, KP / 2 from KP / 2 *
  // group, or for K = 192 a whole atom (0 or 2) and half of atom 1 (64 + 32
  // * group), as an operand may not cross the atom it starts inside
  static constexpr int DQ_N0 = QW == 2 ? (KP > 128 ? 128 : KP)
                                       : (KP == 192 ? 64 : KP / 2);
  static constexpr int DQ_N1 = QW == 2 ? KP - DQ_N0 : (KP == 192 ? 32 : 0);
  static constexpr int DQ_C0 = QW == 2 ? 0 : (KP == 192 ? 128 : KP / 2);
};

// the key tiles [t_begin, t_end) rows [r0, r1) of a query block see
struct KeyTiles {
  int t_begin, t_end;
};
__device__ __forceinline__ KeyTiles key_tiles(int r0, int r1, const Args& a) {
  const int off = a.Skv - a.Sq;
  const int kv_end = a.causal ? min(a.Skv, r1 - 1 + off + 1) : a.Skv;
  const int kv_begin = a.window > 0 ? max(0, r0 + off - a.window + 1) : 0;
  const int tb = kv_begin / BN, te = (kv_end + BN - 1) / BN;
  return {tb, kv_end > kv_begin ? max(tb, te) : tb};
}

template <int KP, int KVP>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const CUtensorMap* tm_lse,
    const CUtensorMap* tm_delta, const Args& a, unsigned char* sm,
    uint32_t s0, int b, int h, int r0) {
  using C = DqPass<KP, KVP>;
  const int lane = threadIdx.x % 32, hk = h / (a.H / a.Hkv);
  const uint32_t q_full = s0 + C::OFF_BAR;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::STAGES;
  // the block's query tiles, their rows' lse and delta
  if (!a.rows_tma) {
    float* r_ = reinterpret_cast<float*>(sm + C::OFF_ROWS);
    for (int r = lane; r < C::QW * BM; r += 32) {
      const bool in = r0 + r < a.Sq;
      const size_t at = (size_t(b) * a.H + h) * a.Sq + r0 + r;
      r_[(r / BM) * (2 * BM) + r % BM] = in ? a.lse[at] : 0.f;
      r_[(r / BM) * (2 * BM) + BM + r % BM] = in ? a.delta[at] : 0.f;
    }
  }
  if (a.tma) {
    if (lane == 0) {
      mbar_arrive_tx(q_full, C::QW * (C::Q_TILE + C::DO_TILE +
                                      (a.rows_tma ? ROWS : 0)));
      for (int w = 0; w < C::QW; ++w) {
        const uint32_t rows = s0 + C::OFF_ROWS + w * ROWS;
        if (a.rows_tma) {
          tma_load_row(rows, tm_lse, q_full, r0 + w * BM, b * a.H + h);
          tma_load_row(rows + BM * 4, tm_delta, q_full, r0 + w * BM,
                       b * a.H + h);
        }
        tma_tiles(s0 + C::OFF_Q + w * C::Q_TILE, C::NA, BM, tm_q, q_full, h,
                  r0 + w * BM, b);
        tma_tiles(s0 + C::OFF_DO + w * C::DO_TILE, C::NVA, BM, tm_do, q_full,
                  h, r0 + w * BM, b);
      }
    } else {
      mbar_arrive(q_full);
    }
  } else {
    for (int w = 0; w < C::QW; ++w) {
      const int q0 = r0 + w * BM;
      const size_t row0 = size_t(b) * a.Sq + q0;
      stage_rows<KP>(sm + C::OFF_Q + w * C::Q_TILE,
                     a.q + (row0 * a.H + h) * a.K, size_t(a.H) * a.K,
                     a.Sq - q0, a.K, BM, lane);
      stage_rows<KVP>(sm + C::OFF_DO + w * C::DO_TILE,
                      a.dout + (row0 * a.H + h) * a.Kv, size_t(a.H) * a.Kv,
                      a.Sq - q0, a.Kv, BM, lane);
    }
    fence_async_smem();
    mbar_arrive(q_full);
  }
  // the key tiles, ascending
  const KeyTiles kt = key_tiles(r0, min(a.Sq, r0 + C::QW * BM), a);
  int stage = 0;
  uint32_t ph = 0;
  for (int t = kt.t_begin; t < kt.t_end; ++t) {
    mbar_wait(empty0 + 8 * stage, ph ^ 1);
    const uint32_t full = full0 + 8 * stage;
    if (a.tma) {
      if (lane == 0) {
        mbar_arrive_tx(full, C::K_TILE + C::V_TILE);
        tma_tiles(s0 + C::OFF_K + stage * C::K_TILE, C::NA, BN, tm_k, full,
                  hk, t * BN, b);
        tma_tiles(s0 + C::OFF_V + stage * C::V_TILE, C::NVA, BN, tm_v, full,
                  hk, t * BN, b);
      } else {
        mbar_arrive(full);
      }
    } else {
      const size_t row0 = size_t(b) * a.Skv + t * BN;
      stage_rows<KP>(sm + C::OFF_K + stage * C::K_TILE,
                     a.k + (row0 * a.Hkv + hk) * a.K, size_t(a.Hkv) * a.K,
                     a.Skv - t * BN, a.K, BN, lane);
      stage_rows<KVP>(sm + C::OFF_V + stage * C::V_TILE,
                      a.v + (row0 * a.Hkv + hk) * a.Kv, size_t(a.Hkv) * a.Kv,
                      a.Skv - t * BN, a.Kv, BN, lane);
      fence_async_smem();
      mbar_arrive(full);
    }
    if (++stage == C::STAGES) {
      stage = 0;
      ph ^= 1;
    }
  }
}

// consumer group w: query tile r0 + 64 w (r0 and its half of dQ's columns
// where QW = 1); S = Q.K^T and dP = dO.V^T (keys as columns, in halves
// where wide), dQ += dS.K from dS's registers
template <int KP, int KVP, bool CAP>
__device__ __forceinline__ void dq_consume(const Args& a, uint32_t s0, int b,
                                           int h, int r0) {
  using C = DqPass<KP, KVP>;
  // S and dP in two key halves where dQ's accumulators are wide, or the
  // softcap's tanh needs the registers (they spill at K = 128 with it)
  constexpr int HALVES = KP > 128 || (KP == 128 && CAP) ? 2 : 1;
  constexpr int NK = BN / HALVES;   // keys a half
  const int tid = threadIdx.x, wg = tid / GT;
  const int wi = (tid % GT) / 32, lane = tid % 32, gr = lane / 4, tq = lane % 4;
  const int off = a.Skv - a.Sq;
  const uint32_t q_full = s0 + C::OFF_BAR;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::STAGES;
  const float scale2 = a.scale * LOG2E;
  const int tile = C::QW == 2 ? wg : 0;
  const int c0 = C::DQ_C0 * wg;
  const int c1 = C::QW == 2 ? C::DQ_N0 : 64 + 32 * wg;
  const int q0 = r0 + tile * BM;
  const uint32_t qs0 = s0 + C::OFF_Q + tile * C::Q_TILE;
  const uint32_t dos0 = s0 + C::OFF_DO + tile * C::DO_TILE;
  const uint32_t rows = s0 + C::OFF_ROWS + tile * ROWS;
  const KeyTiles kt = key_tiles(r0, min(a.Sq, r0 + C::QW * BM), a);
  mbar_wait(q_full, 0);
  // this thread's two query rows: lse (log2 units), delta, visible keys
  float lse2[2], dl[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wi * 16 + gr + r * 8, qpos = q0 + row + off;
    const float2 x = lds2(rows + 4 * (row & ~1));
    const float2 y = lds2(rows + 4 * (BM + (row & ~1)));
    lse2[r] = ((row & 1) ? x.y : x.x) * LOG2E;
    dl[r] = (row & 1) ? y.y : y.x;
    lo[r] = a.window > 0 ? qpos - a.window + 1 : 0;
    hi[r] = q0 + row < a.Sq ? (a.causal ? min(a.Skv, qpos + 1) : a.Skv) : 0;
  }
  float dq0[C::DQ_N0 / 2], dq1[C::DQ_N1 ? C::DQ_N1 / 2 : 1];
#pragma unroll
  for (int i = 0; i < C::DQ_N0 / 2; ++i) dq0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::DQ_N1 ? C::DQ_N1 / 2 : 1); ++i) dq1[i] = 0.f;
  int stage = 0;
  uint32_t ph = 0;
  for (int t = kt.t_begin; t < kt.t_end; ++t) {
    mbar_wait(full0 + 8 * stage, ph);
#pragma unroll
    for (int hf = 0; hf < HALVES; ++hf) {
      // the tiles' bases anew each half: the compiler builds each
      // product's descriptors where it issues it
      const uint32_t qs = fresh(qs0), dos = fresh(dos0);
      const uint32_t ks = fresh(s0 + C::OFF_K + stage * C::K_TILE);
      const uint32_t vs = fresh(s0 + C::OFF_V + stage * C::V_TILE);
      float s[NK / 2], dp[NK / 2];
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk)
        wg::mma_ss<NK, 0, 0>(s, rows_desc(qs, BM, 0, kk),
                             rows_desc(ks, BN, hf * NK, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KVP / 16; ++kk)
        wg::mma_ss<NK, 0, 0>(dp, rows_desc(dos, BM, 0, kk),
                             rows_desc(vs, BN, hf * NK, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<NK / 2>(s);
      wg::fence_regs<NK / 2>(dp);
      // dS as bf16 A fragments: d[4n + e] is query row wi * 16 + gr + 8
      // (e >> 1), key t * 64 + hf * NK + 8n + 2tq + (e & 1)
      uint32_t df[NK / 16][4];
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t * BN + hf * NK + n * 8 + 2 * tq + (e & 1);
          const int r = e >> 1;
          float p;
          p_ds<CAP>(s[4 * n + e], dp[4 * n + e], lse2[r], dl[r],
                    kp >= lo[r] && kp < hi[r], a, scale2, p, d[e]);
        }
        df[n / 2][(n & 1) * 2] = mma::pack_bf16(d[0], d[1]);
        df[n / 2][(n & 1) * 2 + 1] = mma::pack_bf16(d[2], d[3]);
      }
      // dQ += dS.K over this half's keys
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        wg::mma_rs<C::DQ_N0>(dq0, df[kk],
                             cols_desc(ks, BN, c0, hf * (NK / 16) + kk), 1);
        if constexpr (C::DQ_N1 > 0)
          wg::mma_rs<C::DQ_N1>(dq1, df[kk],
                               cols_desc(ks, BN, c1, hf * (NK / 16) + kk), 1);
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_regs<C::DQ_N0 / 2>(dq0);
      if constexpr (C::DQ_N1 > 0) wg::fence_regs<C::DQ_N1 / 2>(dq1);
    }
    if (tid % GT == 0) mbar_arrive(empty0 + 8 * stage);  // K and V read
    if (++stage == C::STAGES) {
      stage = 0;
      ph ^= 1;
    }
  }
  // dq = scale * sum dS.K, rounded once
  const bool pairs = (a.K & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wi * 16 + gr + r * 8;
    if (row >= a.Sq) continue;
    bf16* o = a.dq + ((size_t(b) * a.Sq + row) * a.H + h) * a.K;
#pragma unroll
    for (int n = 0; n < C::DQ_N0 / 8; ++n)
      store_pair(o, c0 + n * 8 + 2 * tq, a.K, dq0[4 * n + 2 * r] * a.scale,
                 dq0[4 * n + 2 * r + 1] * a.scale, pairs);
    if constexpr (C::DQ_N1 > 0) {
#pragma unroll
      for (int n = 0; n < C::DQ_N1 / 8; ++n)
        store_pair(o, c1 + n * 8 + 2 * tq, a.K,
                   dq1[4 * n + 2 * r] * a.scale,
                   dq1[4 * n + 2 * r + 1] * a.scale, pairs);
    }
  }
}

// A block a pair of query tiles (one for the widest heads) of a head and
// batch row, the last pairs first (the heaviest under a causal mask)
template <int KP, int KVP, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    bwd_bf16_dq_pass_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_lse,
                       const __grid_constant__ CUtensorMap tm_delta,
                       const __grid_constant__ Args a) {
  using C = DqPass<KP, KVP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = mma::smem_u32(sm);
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::QW * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  if (threadIdx.x == 0) {
    const uint32_t bar = s0 + C::OFF_BAR;
    mbar_init(bar, 32);  // Q, dO and the rows landed: the producer's lanes
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar + 8 + 8 * s, 32);
      mbar_init(bar + 8 + 8 * (C::STAGES + s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= NCW * GT) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < NCW * GT + 32)
      dq_produce<KP, KVP>(&tm_q, &tm_k, &tm_v, &tm_do, &tm_lse, &tm_delta, a,
                          sm, s0, b, h, r0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    dq_consume<KP, KVP, CAP>(a, s0, b, h, r0);
  }
}

// ============================================================================
// The host side
// ============================================================================

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &got);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &got);
#endif
    if (got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a (batch, row, head, column) bf16 tensor, read in boxes of 64 columns x
// `rows` rows of one head into the 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int Hx,
                int W, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {cuuint64_t(W), cuuint64_t(Hx), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(W) * 2, cuuint64_t(Hx) * W * 2,
                                 cuuint64_t(S) * Hx * W * 2};
  const cuuint32_t box[4] = {cuuint32_t(ATOM), 1, cuuint32_t(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the rows' lse or delta, (B * H, Sq) float32, read 64 a box
bool rows_map(CUtensorMap* map, const float* t, int BH, int Sq) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cuuint64_t(Sq), cuuint64_t(BH)};
  const cuuint64_t strides[1] = {cuuint64_t(Sq) * 4};
  const cuuint32_t box[2] = {cuuint32_t(BM), 1};
  const cuuint32_t one[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(t),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the six maps of a call (zero where the call stages element by element);
// the K and V maps read 64-key boxes, the others 64-row boxes
struct Maps {
  CUtensorMap q, k, v, dout, lse, delta;
};
bool make_maps(Maps& m, const void* q, const void* k, const void* v,
               const void* dout, const Args& a) {
  m = Maps{};
  if (a.tma &&
      !(tensor_map(&m.q, q, a.B, a.Sq, a.H, a.K, BM) &&
        tensor_map(&m.k, k, a.B, a.Skv, a.Hkv, a.K, BN) &&
        tensor_map(&m.v, v, a.B, a.Skv, a.Hkv, a.Kv, BN) &&
        tensor_map(&m.dout, dout, a.B, a.Sq, a.H, a.Kv, BM)))
    return false;
  return !a.rows_tma || (rows_map(&m.lse, a.lse, a.B * a.H, a.Sq) &&
                         rows_map(&m.delta, a.delta, a.B * a.H, a.Sq));
}

template <int KP, int KVP>
cudaError_t launch_kernels(const Maps& m, Args a, cudaStream_t stream) {
  using W = Walk<KP, KVP>;
  using D = DqPass<KP, KVP>;
  // the softcap's tanh only where there is one
  const bool cap = a.softcap > 0.f;
  const auto walk = cap ? bwd_bf16_walk_kernel<KP, KVP, true>
                        : bwd_bf16_walk_kernel<KP, KVP, false>;
  const auto dq = cap ? bwd_bf16_dq_pass_kernel<KP, KVP, true>
                      : bwd_bf16_dq_pass_kernel<KP, KVP, false>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               D::SMEM);
  if (err != cudaSuccess) return err;
  a.n_items = ((a.Skv + BN - 1) / BN) * a.B * a.Hkv;
  walk<<<a.n_items < sms ? a.n_items : sms, NTHREADS, W::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, m.lse, m.delta, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + D::QW * BM - 1) / (D::QW * BM), a.H, a.B);
  dq<<<grid, NTHREADS, D::SMEM, stream>>>(m.q, m.k, m.v, m.dout, m.lse,
                                          m.delta, a);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const Maps& m, const Args& a, cudaStream_t stream) {
  if (a.Kv <= 64) return launch_kernels<KP, 64>(m, a, stream);
  if (a.Kv <= 128) return launch_kernels<KP, 128>(m, a, stream);
  return launch_kernels<KP, 256>(m, a, stream);
}

}  // namespace

// Called by flash_attention_bwd_launch for bfloat16 (B, H > 0): the delta
// pass, the walk over key tiles (dk, dv) and the pass over query tiles (dq).
// items is one int32, zeroed by the caller for this call: the walk's count
// of work items taken.
int flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const float* lse, const void* dout,
                                    void* dq, void* dk, void* dv,
                                    float* delta, int* items, int B, int Sq,
                                    int Skv, int H, int Hkv, int K, int Kv,
                                    int causal, int window, float scale,
                                    float softcap, cudaStream_t stream) {
  if (Sq == 0) {  // no query row: dk and dv are 0
    cudaError_t err = cudaMemsetAsync(dk, 0, size_t(B) * Skv * Hkv * K * 2,
                                      stream);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dv, 0, size_t(B) * Skv * Hkv * Kv * 2, stream);
    return err;
  }
  if (Skv == 0)  // no key: dq is 0
    return cudaMemsetAsync(dq, 0, size_t(B) * Sq * H * K * 2, stream);
  cudaError_t err = launch_delta<bf16>(out, dout, delta, B, Sq, H, Kv, stream);
  if (err != cudaSuccess) return err;
  // TMA where every row starts on 16 bytes (Kv is a multiple of 16), and
  // for the rows' lse and delta where Sq is a multiple of 4
  const int tma =
      K % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               lse, delta, items, static_cast<bf16*>(dq),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H,
               Hkv, K, Kv, causal, window, scale, softcap,
               softcap > 0.f ? scale / softcap : 0.f, softcap * LOG2E, tma,
               tma && Sq % 4 == 0, 0};
  Maps m;
  if (!make_maps(m, q, k, v, dout, a)) return cudaErrorInvalidValue;
  if (K <= 64) return launch_kp<64>(m, a, stream);
  if (K <= 128) return launch_kp<128>(m, a, stream);
  if (K <= 192) return launch_kp<192>(m, a, stream);
  if (K <= 256) return launch_kp<256>(m, a, stream);
  return cudaErrorInvalidValue;
}
