// Flash-attention backward for Hopper, sm_90a: K2 (dQ) and K3 (dK, dV).
//
// Replaces the Pallas TPU kernels ray_tpu/ops/attention.py:_bwd_dq_kernel
// (K2) and ray_tpu/ops/attention.py:_bwd_dkv_kernel (K3), launched by
// _flash_bwd.  Same function, JAX's formula in fp32: s = q.k^T * scale with
// the causal mask at global row q_tile * BQ + q_offset (the finite
// NEG_INF = -1e30), p = exp(s - lse), dp = dO.v^T, ds = p * (dp - delta) *
// scale; dQ = sum_k ds.k, dV = sum_q p^T.dO, dK = sum_q ds^T.q.  lse and
// delta = rowsum(dO * O) come from the caller (fp32 [B, H, Sq]; ring
// attention passes global values), so nothing of the forward is recomputed
// beyond s.  Outputs in the inputs' dtype.
//
// Pair set: a (q row, key) pair contributes only if K1 (flash_fwd.cu)
// visited it, so the gradient is the gradient of K1's function.  The q
// tile at q0 visits key tiles [0, hi), hi = clip(trunc((q0 + q_offset +
// BQ + BK - 1) / BK), 0, n_kb) when causal and n_kb >= 2, every key tile
// otherwise.  K2 loops exactly those key tiles.  K3 visits, for its key
// tile, every q tile whose hi lies past it; the Pallas K3 starts instead
// at trunc((k0 - q_offset) / block_q) under another condition (n_qb >= 2),
// which differs from K1's visits only on rows that see no key.  Ragged
// Sq/Sk are masked: key columns past Sk and q rows past Sq contribute
// p = 0, and rows past the end are never written.
//
// What bounds it on the H100: per causal (q, key) pair and head, K2 does
// 6 * D flops (q.k^T, dO.v^T, ds.k) and K3 8 * D (q.k^T, dO.v^T, p^T.dO,
// ds^T.q), against O((Sq + Sk) * D) bytes per head, so both are bound by
// tensor-core operations (at B=1, H=32, Hkv=8, S=2048, D=128: 51.6 and
// 68.8 GFLOP, 52 and 70 us at 989 TFLOP/s, against about 59 and 50 MB of
// traffic, 18 and 15 us at 3.35 TB/s).  Both keep every Sq x Sk matrix
// (s, p, dp, ds) out of device memory.  Which kernel runs:
//
// | dtype | head_dim   | K2                      | K3                     |
// | bf16  | 64, 128    | `dq::` (wgmma, TMA)     | `dkv::` (wgmma, TMA)   |
// | bf16  | 32         | `f32::` (CUDA cores)    | `f32::` (CUDA cores)   |
// | fp32  | 32, 64, 128| `f32::` (CUDA cores)    | `f32::` (CUDA cores)   |
//
// - K2 in bf16 (the main path; `dq::` below) is built as K1 is.  One
//   block per (128-row q block, q head, batch) of two consumer warpgroups
//   and one producer warp.  Each consumer warpgroup owns 64 q rows, one
//   visiting tile, so its own cut, and keeps its rows' lse and delta in
//   registers for the whole loop.  The producer loads the block's Q and dO
//   once and streams 64-key K and V tiles, up to the larger cut, by TMA
//   into a 2-stage ring with full/empty mbarriers, in the 128-byte swizzle
//   TMA and wgmma both read.  Per key tile a warpgroup issues S = Q.K^T
//   and dP = dO.V^T together (wgmma m64n64k16, both operands K-major in
//   shared memory, one commit and one wait), turns S into p and dP into
//   ds in place in registers, packs ds to bf16 as the register A operand
//   of dQ += dS.K (wgmma with K MN-major through the descriptor's
//   transpose, as V in K1's P.V) and releases the stage once that product
//   has retired.  S, dP and dQ at D = 128 are 128 fp32 registers a
//   thread, as K1's S and O: the block stays within the 168 registers
//   ptxas gives every thread of a block of more than two warpgroups.  dQ
//   (scale already in ds) is written once, through the warpgroup's Q tile
//   as 16-byte stores; no atomics, so the result is deterministic.  The
//   grid puts q heads on its fast axis (a kv head's group-mates share K/V
//   in L2) and walks q blocks from the last: the heaviest causal blocks
//   start first.
// - K3 in bf16 (the main path; `dkv::` below).  One block per (64-key
//   tile, kv head, batch) of two consumer warpgroups and one producer
//   warp.  The producer loads the block's K and V once by TMA and streams
//   the (q head, q tile) iterations that visit the key tile (the kv head's
//   `group` q heads, so the GQA sum needs no atomics): Q and dO 64-row
//   tiles by TMA and the tile's 64 lse and delta values by cp.async, into
//   a 2-stage ring.  The score products are computed transposed, S^T =
//   K.Q^T and dP^T = V.dO^T, so their fp32 accumulators, turned into p^T
//   and ds^T and packed to bf16, are exactly the register A operand of dV
//   += P^T.dO and dK += dS^T.Q (wgmma with dO and Q MN-major through the
//   descriptor's transpose); a q row is a column of the accumulator, and
//   each thread reads the lse and delta of its 16 columns from the ring.
//   The two warpgroups split the products, not the iterations: warpgroup
//   1 runs S^T -> p^T -> dV, hands p^T in fp32 to warpgroup 0 through the
//   stage (named barriers), and warpgroup 0 runs dP^T -> ds^T -> dK.  So
//   each thread holds one 64 x D fp32 accumulator (D / 2 registers) for
//   the whole loop and 160 registers suffice at D = 128; a split of the
//   iterations, which needs dK and dV (and S^T and dP^T) in every thread,
//   spilled 2.6 KB there and ran 3x slower (NVIDIA H100 80GB HBM3, 700 W).
//   dK and dV are written once, through shared memory as 16-byte stores.
//   The grid puts kv heads (and batches) on its fast axis and key tiles
//   on the slow one: the low key tiles, which the most q tiles visit,
//   start first.
// - Both wgmma kernels take p the same way.  Tiles that need no mask (not
//   on the causal edge, not ragged) take p = 2^(s scale log2 e - lse log2
//   e) in one FMA and one ex2.approx; masked tiles subtract first, p =
//   2^((s - lse) log2 e), so a row that sees no key inside a visited tile
//   (s = lse = NEG_INF) gets exactly p = 1, as the formula gives.
// - fp32 at head_dim 32, 64 and 128, and bf16 at head_dim 32 (`f32::`
//   below): one block of 4 warps per (64-row q tile, head, batch) for K2
//   and per (64-row key tile, kv head, batch) for K3, everything through
//   shared memory, exact fp32 products on the CUDA cores.  bf16 inputs are
//   converted to fp32 as a tile lands and the outputs rounded to bf16
//   once.  A bf16 row of 32 values is 64 bytes, which the wgmma kernels'
//   128-byte swizzle does not fit; the tiny model (head_dim 32) runs
//   these, no call on the main path does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr float NEG_INF = -1e30f;

// K1's visiting rule: the q tile at q0 visits key tiles [0, key_tiles).
__device__ __forceinline__ int key_tiles(int q0, int q_offset, int n_kb,
                                         int causal) {
  if (!causal || n_kb < 2) return n_kb;
  // C division truncates toward zero, as jax.lax.div does.
  const int t = (q0 + q_offset + BQ + BK - 1) / BK;
  return max(0, min(t, n_kb));
}

// Element strides (batch, head, seq) of q, k, v and dO, in that order.
struct Strides {
  int64_t s[12];
};

// ---------------------- wgmma building blocks of the bf16 K2 and K3 kernels

constexpr int SUB = 64 * 128;  // bytes of a [64 rows x 64] bf16 sub-tile

// acc = A . B^T over D (unscaled): A [64 x D] and B [64 x D] K-major in
// shared memory, D / 16 wgmma m64n64k16 steps.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * SUB + (kk % 4) * 32;
    rt::wgmma_m64n64k16_ss(acc, rt::wgmma_desc_sw128(a + off, 16, 1024),
                           rt::wgmma_desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc += A . B: A the register fragments of a 64 x 64 tile (4 k16 steps
// over the 64 rows of B), B [64 rows x D] MN-major through the transpose
// bit, 16 rows (2048 bytes) a step, D / 64 sub-tiles apart.  The rows of
// B are q rows in K3 (dO, Q) and keys in K2 (K).
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = rt::wgmma_desc_sw128(b + kk * 2048, SUB, 1024);
    if constexpr (D == 128)
      rt::wgmma_m64n128k16_rs_tb(acc, a[kk], desc, 1);
    else
      rt::wgmma_m64n64k16_rs_tb(acc, a[kk], desc, 1);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) rt::fence_operand(x[i]);
}
__device__ __forceinline__ void fence_all(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) rt::fence_operand(x[i][e]);
}

// A 64 x 64 accumulator in bf16: the A fragments of its 4 k16 steps.
__device__ __forceinline__ void pack(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = rt::pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// The warp's 16 rows of a [64 x D] fp32 accumulator to bf16 rows of
// `out` (row stride D): through the tile at `tile` (same swizzle) as
// 16-byte stores; rows at or past k_rows are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, unsigned char* tile,
                                           const float (&acc)[D / 2],
                                           int warp, int lane, int k_rows) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<uint32_t*>(tile + (jd / 8) * SUB +
                                   16 * rt::swizzle<8>(row, jd % 8) +
                                   4 * t) =
          rt::pack_bf16(acc[4 * jd + 2 * r], acc[4 * jd + 2 * r + 1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 16 * CH / 32; ++it) {
    const int i = it * 32 + lane;
    const int row = 16 * warp + i / CH, c = i % CH;
    if (row < k_rows)
      *reinterpret_cast<uint4*>(out + (int64_t)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (c / 8) * SUB +
                                          16 * rt::swizzle<8>(row, c % 8));
  }
}

namespace dkv {

constexpr int ST = 2;                 // ring stages
constexpr int PTILE = 32 * 128 * 4;   // fp32 p^T of a 64 x 64 tile
constexpr int NTHREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer
// Named barriers: 1 before the epilogue, then per stage s "p^T written"
// (PREADY + s) and "p^T read" (PFREE + s).
constexpr int PREADY = 2, PFREE = 2 + ST;

// Shared memory (1024-byte aligned): K, V, then per ring stage a Q and a
// dO tile, each [64 rows x D] as D / 64 sub-tiles of [64 x 64] bf16 in
// TMA's 128-byte swizzle, and the stage's p^T in fp32; then per stage the
// 64 lse and 64 delta values; then the barriers.
template <int D>
struct Layout {
  static constexpr int TILE = D / 64 * SUB;
  static constexpr int K = 0;
  static constexpr int V = TILE;
  static constexpr int RING = 2 * TILE;
  static constexpr int STAGE = 2 * TILE + PTILE;  // Q, dO, p^T
  static constexpr int STATS = RING + ST * STAGE;  // 512 bytes a stage
  static constexpr int BARS = STATS + ST * 512;
  static constexpr int BYTES = BARS + 8 * (2 * ST + 1) + 1024;
};

// The tile's position and rules, shared by the steps below.  Accumulator
// layout (m64nN): x[4 j + e] is key row 16 warp + g + 8 (e / 2) and
// column 8 j + 2 t + e % 2 (a q row of S^T and dP^T).
struct Tile {
  int key;  // the thread's first key row (the second is key + 8)
  int q0, t, Sq, Sk, causal, q_offset;
  float scale;
  // Ragged (keys past Sk, q rows past Sq) or across the causal edge (the
  // first q row, q0 + q_offset, lies before the last key): per element.
  __device__ bool masked(int k0) const {
    return k0 + BK > Sk || q0 + BQ > Sq ||
           (causal && q0 + q_offset < k0 + BK - 1);
  }
};

// s^T -> p^T = exp(s scale - lse) in place, with the causal NEG_INF and
// p = 0 past Sk and Sq.  Unmasked: one FMA and one ex2.approx; masked:
// s - lse first, so equal values (a row that sees no key inside a visited
// tile, s = lse = NEG_INF) give exactly p = 1.
__device__ __forceinline__ void probs(float (&x)[32], const float* lse_s,
                                      const Tile& tl, bool masked) {
  constexpr float LOG2E = 1.4426950408889634f;
  const float sl2 = tl.scale * LOG2E;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const float2 lv =
        *reinterpret_cast<const float2*>(lse_s + 8 * jn + 2 * tl.t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jn + e;
      const float lse_c = (e & 1) ? lv.y : lv.x;
      if (!masked) {
        x[i] = rt::ex2(fmaf(x[i], sl2, -lse_c * LOG2E));
      } else {
        const int kr = tl.key + 8 * (e >> 1);
        const int qr = tl.q0 + 8 * jn + 2 * tl.t + (e & 1);
        float sv = x[i] * tl.scale;
        if (tl.causal && qr + tl.q_offset < kr) sv = NEG_INF;
        x[i] = (kr < tl.Sk && qr < tl.Sq) ? rt::ex2((sv - lse_c) * LOG2E)
                                          : 0.f;
      }
    }
  }
}

// dp^T -> ds^T = p (dp - delta) scale in place.
__device__ __forceinline__ void dscores(float (&x)[32], const float (&p)[32],
                                        const float* delta_s,
                                        const Tile& tl) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const float2 dl =
        *reinterpret_cast<const float2*>(delta_s + 8 * jn + 2 * tl.t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * jn + e;
      x[i] = p[i] * (x[i] - ((e & 1) ? dl.y : dl.x)) * tl.scale;
    }
  }
}

// What a consumer warpgroup needs of its block.
struct Block {
  uint32_t base;         // the aligned shared-memory window
  unsigned char* smem;   // the same, generic
  uint32_t full, empty;  // the ring's barriers
  int k0, qt_lo, nq, n_it, k_rows;
};

template <int D>
__device__ __forceinline__ uint32_t stage_addr(const Block& bk, int s) {
  return bk.base + Layout<D>::RING + s * Layout<D>::STAGE;
}
template <int D>
__device__ __forceinline__ const float* stats(const Block& bk, int s) {
  return reinterpret_cast<const float*>(bk.smem + Layout<D>::STATS +
                                        s * 512);
}
// The stage's p^T, fp32 in thread-fragment order: value x of consumer
// thread tid at x * 128 + tid.
template <int D>
__device__ __forceinline__ float* p_tile(const Block& bk, int s) {
  return reinterpret_cast<float*>(bk.smem + Layout<D>::RING +
                                  s * Layout<D>::STAGE + 2 * Layout<D>::TILE);
}

// Warpgroup 1 of two: S^T -> p^T -> dV += P^T.dO; p^T goes to the stage
// in fp32 (thread-fragment order) for warpgroup 0.
template <typename T, int D>
__device__ __forceinline__ void consume_dv(const Block& bk, Tile tl, T* dv,
                                           int tid, int warp, int lane) {
  using L = Layout<D>;
  float dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = 0.f;
  const uint32_t k_addr = bk.base + L::K;
  for (int i = 0; i < bk.n_it; ++i) {
    const int s = i % ST;
    tl.q0 = (bk.qt_lo + i % bk.nq) * BQ;
    const bool masked = tl.masked(bk.k0);
    rt::mbar_wait_spin(bk.full + 8 * s, (i / ST) & 1);
    const uint32_t q_addr = stage_addr<D>(bk, s);
    float* pt = p_tile<D>(bk, s);
    float sc[32];
    uint32_t pa[4][4];
    rt::wgmma_fence();
    issue_scores<D>(sc, k_addr, q_addr);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    fence_all(sc);
    probs(sc, stats<D>(bk, s), tl, masked);
    pack(sc, pa);
    rt::wgmma_fence();
    issue_acc<D>(dva, pa, q_addr + L::TILE);  // dV += P^T.dO
    rt::wgmma_commit();
    // p^T to warpgroup 0, once it has read this stage's previous one.
    if (i >= ST) rt::named_barrier(PFREE + s, 256);
#pragma unroll
    for (int x = 0; x < 32; ++x) pt[x * 128 + tid] = sc[x];
    rt::named_barrier_arrive(PREADY + s, 256);
    rt::wgmma_wait<0>();
    fence_all(dva);
    fence_all(pa);
    rt::mbar_arrive(bk.empty + 8 * s);
  }
  rt::named_barrier(1, 256);  // both warpgroups are done reading K and V
  store_rows<T, D>(dv, bk.smem + L::V, dva, warp, lane, bk.k_rows);
}

// Warpgroup 0 of two: dP^T -> ds^T (p^T from warpgroup 1) -> dK += dS^T.Q.
template <typename T, int D>
__device__ __forceinline__ void consume_dk(const Block& bk, Tile tl, T* dk,
                                           int tid, int warp, int lane) {
  using L = Layout<D>;
  float dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
  const uint32_t v_addr = bk.base + L::V;
  for (int i = 0; i < bk.n_it; ++i) {
    const int s = i % ST;
    rt::mbar_wait_spin(bk.full + 8 * s, (i / ST) & 1);
    const uint32_t q_addr = stage_addr<D>(bk, s);
    const float* pt = p_tile<D>(bk, s);
    float dp[32], p[32];
    uint32_t da[4][4];
    rt::wgmma_fence();
    issue_scores<D>(dp, v_addr, q_addr + L::TILE);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    fence_all(dp);
    rt::named_barrier(PREADY + s, 256);
#pragma unroll
    for (int x = 0; x < 32; ++x) p[x] = pt[x * 128 + tid];
    if (i + ST < bk.n_it) rt::named_barrier_arrive(PFREE + s, 256);
    dscores(dp, p, stats<D>(bk, s) + 64, tl);
    pack(dp, da);
    rt::wgmma_fence();
    issue_acc<D>(dka, da, q_addr);
    rt::wgmma_commit();
    rt::wgmma_wait<0>();
    fence_all(dka);
    fence_all(da);
    rt::mbar_arrive(bk.empty + 8 * s);
  }
  rt::named_barrier(1, 256);
  store_rows<T, D>(dk, bk.smem + L::K, dka, warp, lane, bk.k_rows);
}

// One block per (64-key tile, kv head, batch): warpgroup 1 computes S^T
// -> p^T -> dV (consume_dv), warpgroup 0 dP^T -> ds^T -> dK (consume_dk),
// the last warp produces.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int group,
                         int Sq, int Sk, float scale, int causal,
                         int q_offset) {
  static_assert(std::is_same<T, bf16>::value, "the wgmma kernel is bf16");
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = Layout<D>;
  constexpr int NCONS = 2 * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = rt::smem_u32(smem_raw);
  Block bk;
  bk.base = (raw + 1023) & ~1023u;
  bk.smem = smem_raw + (bk.base - raw);
  bk.full = bk.base + L::BARS;  // full[s]: full + 8 s
  bk.empty = bk.full + 8 * ST;
  const uint32_t kvbar = bk.empty + 8 * ST;

  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int kt = blockIdx.y;  // low key tiles (the heaviest) first
  bk.k0 = kt * BK;
  bk.k_rows = min(BK, Sk - bk.k0);
  const int n_qb = (Sq + BQ - 1) / BQ;
  const int n_kb = (Sk + BK - 1) / BK;
  // The q tiles that visit this key tile: a suffix [qt_lo, n_qb), since
  // the cut grows with the tile's first row.
  int qt_lo = 0;
  while (qt_lo < n_qb && key_tiles(qt_lo * BQ, q_offset, n_kb, causal) <= kt)
    ++qt_lo;
  bk.qt_lo = qt_lo;
  bk.nq = n_qb - qt_lo;
  bk.n_it = group * bk.nq;  // iteration i: q head i / nq, tile i % nq

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // Every producer lane's copies of lse and delta, and lane 0's TMA.
      rt::mbar_init(bk.full + 8 * s, 33);
      rt::mbar_init(bk.empty + 8 * s, NCONS);  // every consumer thread
    }
    rt::mbar_init(kvbar, 1);
    rt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // Producer warp.  Lane 0 issues the TMA copies; every lane copies two
    // of a tile's 64 lse and delta values (zero past Sq) by cp.async.
    const int lane = threadIdx.x - NCONS;
    if (lane == 0 && bk.n_it > 0) {
      rt::mbar_arrive_expect_tx(kvbar, 2 * L::TILE);
      for (int c = 0; c < D / 64; ++c) {
        rt::tma_load_4d(bk.base + L::K + c * SUB, &tk, kvbar, 64 * c, bk.k0,
                        hk, b);
        rt::tma_load_4d(bk.base + L::V + c * SUB, &tv, kvbar, 64 * c, bk.k0,
                        hk, b);
      }
    }
    for (int i = 0; i < bk.n_it; ++i) {
      const int s = i % ST;
      // Wait for the consumers to release the stage's previous tile.
      if (i >= ST) rt::mbar_wait(bk.empty + 8 * s, (i / ST - 1) & 1);
      const int h = hk * group + i / bk.nq;
      const int q0 = (qt_lo + i % bk.nq) * BQ;
      const int64_t row0 = ((int64_t)b * H + h) * Sq + q0;
      const uint32_t st = bk.base + L::STATS + s * 512;
      const uint32_t fb = bk.full + 8 * s;
#pragma unroll
      for (int r = 2 * lane; r < 2 * lane + 2; ++r) {
        const int live = q0 + r < Sq ? 4 : 0;  // bytes read; 0: a zero
        rt::cp_async_4(st + 4 * r, lse + (live ? row0 + r : 0), live);
        rt::cp_async_4(st + 256 + 4 * r, delta + (live ? row0 + r : 0), live);
      }
      rt::cp_async_mbar_arrive(fb);  // once the four values have landed
      if (lane == 0) {
        rt::mbar_arrive_expect_tx(fb, 2 * L::TILE);
        const uint32_t qa = stage_addr<D>(bk, s);
        for (int c = 0; c < D / 64; ++c) {
          rt::tma_load_4d(qa + c * SUB, &tq, fb, 64 * c, q0, h, b);
          rt::tma_load_4d(qa + L::TILE + c * SUB, &tdo, fb, 64 * c, q0, h, b);
        }
      }
    }
  } else {
    // Consumers: warp `warp` of a warpgroup owns keys 16 warp .. 16 warp
    // + 15 of the tile.
    const int w = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    Tile tl;
    tl.key = bk.k0 + 16 * warp + lane / 4;
    tl.q0 = 0;
    tl.t = lane % 4;
    tl.Sq = Sq;
    tl.Sk = Sk;
    tl.causal = causal;
    tl.q_offset = q_offset;
    tl.scale = scale;
    const int64_t row0 = (((int64_t)b * Hkv + hk) * Sk + bk.k0) * D;
    if (bk.n_it > 0) rt::mbar_wait(kvbar, 0);
    if (w == 1)
      consume_dv<T, D>(bk, tl, dv + row0, tid, warp, lane);
    else
      consume_dk<T, D>(bk, tl, dk + row0, tid, warp, lane);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                   const int64_t* st, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!rt::tensor_map_bf16(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ) ||
      !rt::tensor_map_bf16(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BK) ||
      !rt::tensor_map_bf16(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BK) ||
      !rt::tensor_map_bf16(&tdo, dout, B, H, Sq, D, st[9], st[10], st[11],
                           BQ))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<D>::BYTES;
  auto kern = flash_bwd_dkv_kernel<bf16, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(Hkv * B, (Sk + BK - 1) / BK);
  kern<<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, H / Hkv, Sq, Sk, scale, causal,
      q_offset);
  return cudaGetLastError();
}

}  // namespace dkv

// ------------------------------------------- the bf16 K2 on wgmma and TMA

namespace dq {

constexpr int ST = 2;                   // ring stages
constexpr int NCONS = 256;             // two consumer warpgroups,
constexpr int NTHREADS = NCONS + 32;   // then one producer warp

// Shared memory (1024-byte aligned): each consumer warpgroup's Q and dO
// tile, then per ring stage a K and a V tile, each [64 rows x D] as D / 64
// sub-tiles of [64 x 64] bf16 in TMA's 128-byte swizzle; then the
// barriers.
template <int D>
struct Layout {
  static constexpr int TILE = D / 64 * SUB;
  static constexpr int Q = 0;            // warpgroup w: Q + w TILE
  static constexpr int DO = 2 * TILE;    // warpgroup w: DO + w TILE
  static constexpr int RING = 4 * TILE;  // stage s: K at RING + 2 s TILE,
                                         // V one TILE after
  static constexpr int BARS = RING + ST * 2 * TILE;
  static constexpr int BYTES = BARS + 8 * (2 * ST + 1) + 1024;
};

// One block per (128-row q block, q head, batch): warpgroup w computes dQ
// of the block's rows 64 w .. 64 w + 63, the last warp produces.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ out,
                        int H, int group, int Sq, int Sk, float scale,
                        int causal, int q_offset) {
  static_assert(std::is_same<T, bf16>::value, "the wgmma kernel is bf16");
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  using L = Layout<D>;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = rt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BARS;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * ST;
  const uint32_t qbar = empty + 8 * ST;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * BQ;  // heaviest first
  const int n_kb = (Sk + BK - 1) / BK;
  // Warpgroups that hold a row; the last one's cut is the larger, and the
  // producer streams the key tiles up to it.
  const int nw = Sq - q0 > BQ ? 2 : 1;
  const int n_tiles = key_tiles(q0 + (nw - 1) * BQ, q_offset, n_kb, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      rt::mbar_init(full + 8 * s, 1);
      rt::mbar_init(empty + 8 * s, 128 * nw);  // every live consumer thread
    }
    rt::mbar_init(qbar, 1);
    rt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // producer: one thread issues the copies
    if (threadIdx.x == NCONS) {
      rt::mbar_arrive_expect_tx(qbar, 2 * nw * L::TILE);
      for (int w = 0; w < nw; ++w)
        for (int c = 0; c < D / 64; ++c) {
          rt::tma_load_4d(base + L::Q + w * L::TILE + c * SUB, &tq, qbar,
                          64 * c, q0 + BQ * w, h, b);
          rt::tma_load_4d(base + L::DO + w * L::TILE + c * SUB, &tdo, qbar,
                          64 * c, q0 + BQ * w, h, b);
        }
      const int hk = h / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        // Wait for the consumers to release tile j - ST.
        if (j >= ST) rt::mbar_wait(empty + 8 * s, (j / ST - 1) & 1);
        rt::mbar_arrive_expect_tx(full + 8 * s, 2 * L::TILE);
        const uint32_t kd = base + L::RING + s * 2 * L::TILE;
        for (int c = 0; c < D / 64; ++c) {
          rt::tma_load_4d(kd + c * SUB, &tk, full + 8 * s, 64 * c, BK * j, hk,
                          b);
          rt::tma_load_4d(kd + L::TILE + c * SUB, &tv, full + 8 * s, 64 * c,
                          BK * j, hk, b);
        }
      }
    }
  } else if (threadIdx.x / 128 < nw) {
    // Consumers: warpgroup w owns rows r0 .. r0 + 63; warp `warp` of it
    // rows 16 warp + g and 16 warp + g + 8 of those.  Accumulator layout
    // (m64nN): x[4 j + e] is row g + 8 (e / 2), column 8 j + 2 t + e % 2.
    const int w = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r0 = q0 + BQ * w;
    const int hi = key_tiles(r0, q_offset, n_kb, causal);
    const int row = r0 + 16 * warp + lane / 4;  // and row + 8
    const int64_t lrow = ((int64_t)b * H + h) * Sq;
    float lse_r[2], lse_l2[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = row + 8 * r < Sq;
      lse_r[r] = live ? lse[lrow + row + 8 * r] : 0.f;
      delta_r[r] = live ? delta[lrow + row + 8 * r] : 0.f;
      lse_l2[r] = lse_r[r] * LOG2E;
    }
    const float sl2 = scale * LOG2E;
    const uint32_t q_addr = base + L::Q + w * L::TILE;
    const uint32_t do_addr = base + L::DO + w * L::TILE;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    rt::mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      rt::mbar_wait(full + 8 * s, (j / ST) & 1);
      if (j < hi) {
        const uint32_t k_addr = base + L::RING + s * 2 * L::TILE;
        float sc[32], dp[32];
        uint32_t da[4][4];
        rt::wgmma_fence();
        issue_scores<D>(sc, q_addr, k_addr);             // S = Q.K^T
        issue_scores<D>(dp, do_addr, k_addr + L::TILE);  // dP = dO.V^T
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        fence_all(sc);
        fence_all(dp);
        // Ragged (keys past Sk, rows past Sq) or across the causal edge
        // (the first row, r0 + q_offset, lies before the last key).
        const int k0 = BK * j;
        const bool masked = k0 + BK > Sk || r0 + BQ > Sq ||
                            (causal && r0 + q_offset < k0 + BK - 1);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jn + e, r = e >> 1;
            float p;
            if (!masked) {
              p = rt::ex2(fmaf(sc[i], sl2, -lse_l2[r]));
            } else {
              // s - lse first: a row that sees no key inside a visited
              // tile (s = lse = NEG_INF) gets exactly p = 1.
              const int kr = k0 + 8 * jn + 2 * t + (e & 1);
              const int qr = row + 8 * r;
              float sv = sc[i] * scale;
              if (causal && qr + q_offset < kr) sv = NEG_INF;
              p = (kr < Sk && qr < Sq) ? rt::ex2((sv - lse_r[r]) * LOG2E)
                                       : 0.f;
            }
            dp[i] = p * (dp[i] - delta_r[r]) * scale;  // ds
          }
        pack(dp, da);
        rt::wgmma_fence();
        issue_acc<D>(acc, da, k_addr);  // dQ += dS.K
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
        fence_all(acc);
        fence_all(da);
      }
      rt::mbar_arrive(empty + 8 * s);  // this thread is done with stage s
    }
    // dQ to bf16 through the warpgroup's own Q tile (no other warpgroup
    // reads it), 16-byte stores of whole rows; rows past Sq are skipped.
    store_rows<T, D>(out + (lrow + r0) * D, smem + L::Q + w * L::TILE, acc,
                     warp, lane, min(BQ, Sq - r0));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* out, int B, int H, int Hkv, int Sq, int Sk,
                   const int64_t* st, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!rt::tensor_map_bf16(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ) ||
      !rt::tensor_map_bf16(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BK) ||
      !rt::tensor_map_bf16(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BK) ||
      !rt::tensor_map_bf16(&tdo, dout, B, H, Sq, D, st[9], st[10], st[11],
                           BQ))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<D>::BYTES;
  auto kern = flash_bwd_dq_kernel<bf16, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, (Sq + 2 * BQ - 1) / (2 * BQ), B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(out), H, H / Hkv, Sq,
      Sk, scale, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace dq

// --------------------- the CUDA-core kernels: fp32, and bf16 at head_dim 32

namespace f32 {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
// fp32 shared-memory row strides, padded by 16 bytes so the 16 rows a warp
// touches at once do not all fall in one bank.
constexpr int LDS = BK + 4;  // 64 x 64 tiles: s, p, ds
template <int D>
__host__ __device__ constexpr int ld_in() { return D + 4; }  // q, dO, k, v
template <int D>
__host__ __device__ constexpr int ld_acc() { return D + 4; }  // gradients

// A[row] . B[c] over D for tiles [64][ld_in] in shared memory.
template <int D>
__device__ __forceinline__ float row_dot(const float* A, const float* B,
                                         int row, int c) {
  constexpr int LDI = ld_in<D>();
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc += A[row * LDI + d] * B[c * LDI + d];
  return acc;
}

// Acc[row][c] += sum_j M(row, j) * B[j][c] for the even (half 0) or odd
// columns c, with M(row, j) = M[row][j], or M[j][row] when kTrans.  M is
// a [64][LDS] tile, B a [64][ld_in] tile and Acc [64][ld_acc].
template <int D, bool kTrans>
__device__ __forceinline__ void row_acc(float* Acc, const float* M,
                                        const float* B, int row, int half) {
  constexpr int LDI = ld_in<D>();
  float* arow = Acc + row * ld_acc<D>();
  for (int c = half; c < D; c += 2) {
    float s = arow[c];
    for (int j = 0; j < 64; ++j)
      s += (kTrans ? M[j * LDS + row] : M[row * LDS + j]) * B[j * LDI + c];
    arow[c] = s;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * (size_t)64 * ld_in<D>() * sizeof(float)  // q, dO, k, v
         + (size_t)64 * LDS * sizeof(float)           // s, then ds
         + (size_t)64 * ld_acc<D>() * sizeof(float);  // dQ
}

// K2: one block per (64-row q tile, head, batch), looping K1's key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int group, int Sq,
                            int Sk, Strides st, float scale, int causal,
                            int q_offset) {
  constexpr int LDI = ld_in<D>();
  constexpr int LDA = ld_acc<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BQ * LDI;
  float* Ks = dOs + BQ * LDI;
  float* Vs = Ks + BK * LDI;
  float* Ss = Vs + BK * LDI;  // s, then ds
  float* dQs = Ss + BQ * LDS;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int64_t row0 = ((int64_t)b * H + h) * Sq + q0;  // lse/delta/dQ row
  rt::load_tile_f32<T, D, LDI, NTHREADS>(
      Qs, q + b * st.s[0] + h * st.s[1] + (int64_t)q0 * st.s[2], st.s[2],
      q_rows);
  rt::load_tile_f32<T, D, LDI, NTHREADS>(
      dOs, dout + b * st.s[9] + h * st.s[10] + (int64_t)q0 * st.s[11],
      st.s[11], q_rows);
  for (int i = threadIdx.x; i < BQ * LDA; i += NTHREADS) dQs[i] = 0.f;
  const T* kp = k + b * st.s[3] + hk * st.s[4];
  const T* vp = v + b * st.s[6] + hk * st.s[7];

  // Element ownership: lane pair (2r, 2r+1) holds row r of the warp's 16;
  // lane `half` of the pair owns the even or odd key columns of the tile.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const bool live = row < q_rows;
  const int q_pos = q0 + row + q_offset;
  const float lse_r = live ? lse[row0 + row] : 0.f;
  const float delta_r = live ? delta[row0 + row] : 0.f;
  const int hi = key_tiles(q0, q_offset, (Sk + BK - 1) / BK, causal);
  __syncthreads();

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    const int k_rows = min(BK, Sk - k0);
    rt::load_tile_f32<T, D, LDI, NTHREADS>(Ks, kp + (int64_t)k0 * st.s[5],
                                           st.s[5], k_rows);
    rt::load_tile_f32<T, D, LDI, NTHREADS>(Vs, vp + (int64_t)k0 * st.s[8],
                                           st.s[8], k_rows);
    __syncthreads();

    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      Ss[row * LDS + c] = row_dot<D>(Qs, Ks, row, c);
    }
    __syncwarp();

    float* srow = Ss + row * LDS;
#pragma unroll 4
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      const int col = k0 + c;
      const float dp = row_dot<D>(dOs, Vs, row, c);
      float ds = 0.f;
      if (live && col < Sk) {
        float s = srow[c] * scale;
        if (causal && q_pos < col) s = NEG_INF;
        ds = expf(s - lse_r) * (dp - delta_r) * scale;
      }
      srow[c] = ds;
    }
    __syncwarp();

    row_acc<D, false>(dQs, Ss, Ks, row, half);  // dQ[row] += ds . k
    __syncthreads();  // the k/v tiles are overwritten next iteration
  }

  __syncthreads();  // dQ may still be the zeros other threads wrote
  if (live) {
    T* g = dq + (row0 + row) * D;
    const float* arow = dQs + row * LDA;
    for (int c = half; c < D; c += 2) g[c] = rt::from_f32<T>(arow[c]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * (size_t)64 * ld_in<D>() * sizeof(float)  // k, v, q, dO
         + (size_t)64 * LDS * sizeof(float)           // s / p / ds
         + 2 * (size_t)64 * ld_acc<D>() * sizeof(float)  // dK, dV
         + 2 * (size_t)BQ * sizeof(float);                // lse, delta
}

// K3: one block per (64-row key tile, kv head, batch), looping the
// `group` q heads of the kv head and the q tiles that K1 visited with this
// tile.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int group, int Sq, int Sk, Strides st,
                             float scale, int causal, int q_offset) {
  constexpr int LDI = ld_in<D>();
  constexpr int LDA = ld_acc<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LDI;
  float* Qs = Vs + BK * LDI;
  float* dOs = Qs + BQ * LDI;
  float* Ss = dOs + BQ * LDI;  // s, then p, then ds
  float* dKs = Ss + BQ * LDS;
  float* dVs = dKs + BK * LDA;
  float* lse_s = dVs + BK * LDA;
  float* delta_s = lse_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int k0 = kt * BK;
  const int k_rows = min(BK, Sk - k0);
  rt::load_tile_f32<T, D, LDI, NTHREADS>(
      Ks, k + b * st.s[3] + hk * st.s[4] + (int64_t)k0 * st.s[5], st.s[5],
      k_rows);
  rt::load_tile_f32<T, D, LDI, NTHREADS>(
      Vs, v + b * st.s[6] + hk * st.s[7] + (int64_t)k0 * st.s[8], st.s[8],
      k_rows);
  for (int i = threadIdx.x; i < BK * LDA; i += NTHREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  // Element ownership as in K2: lane pair (2r, 2r+1) holds q row r of the
  // warp's 16 and the even or odd key columns; in the products the thread
  // owns key row `row` of dK and dV.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int n_qb = (Sq + BQ - 1) / BQ;
  const int n_kb = (Sk + BK - 1) / BK;
  float dsv[BK / 2];  // ds waits here while p is in use

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qp = q + b * st.s[0] + h * st.s[1];
    const T* dop = dout + b * st.s[9] + h * st.s[10];
    const int64_t lrow = ((int64_t)b * H + h) * Sq;
    for (int qt = 0; qt < n_qb; ++qt) {
      const int q0 = qt * BQ;
      // Block-uniform: skip the pairs of tiles that K1 did not visit.
      if (kt >= key_tiles(q0, q_offset, n_kb, causal)) continue;
      const int q_rows = min(BQ, Sq - q0);
      __syncthreads();  // the previous products are done with q, dO, s
      rt::load_tile_f32<T, D, LDI, NTHREADS>(
          Qs, qp + (int64_t)q0 * st.s[2], st.s[2], q_rows);
      rt::load_tile_f32<T, D, LDI, NTHREADS>(
          dOs, dop + (int64_t)q0 * st.s[11], st.s[11], q_rows);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        lse_s[i] = i < q_rows ? lse[lrow + q0 + i] : 0.f;
        delta_s[i] = i < q_rows ? delta[lrow + q0 + i] : 0.f;
      }
      __syncthreads();

      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        Ss[row * LDS + c] = row_dot<D>(Qs, Ks, row, c);
      }
      __syncwarp();

      const bool live = row < q_rows;
      const int q_pos = q0 + row + q_offset;
      const float lse_r = lse_s[row], delta_r = delta_s[row];
      float* srow = Ss + row * LDS;
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int c = 2 * j + half;
        const int col = k0 + c;
        const float dp = row_dot<D>(dOs, Vs, row, c);
        float p = 0.f, ds = 0.f;
        if (live && col < Sk) {
          float s = srow[c] * scale;
          if (causal && q_pos < col) s = NEG_INF;
          p = expf(s - lse_r);
          ds = p * (dp - delta_r) * scale;
        }
        srow[c] = p;
        dsv[j] = ds;
      }
      __syncthreads();  // each key row of dK/dV needs every warp's q rows

      row_acc<D, true>(dVs, Ss, dOs, row, half);
      __syncthreads();  // p is read; ds takes its place
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) srow[2 * j + half] = dsv[j];
      __syncthreads();
      row_acc<D, true>(dKs, Ss, Qs, row, half);
    }
  }

  __syncthreads();  // dK/dV may still be the zeros other threads wrote
  if (row < k_rows) {
    const int64_t o = (((int64_t)b * Hkv + hk) * Sk + k0 + row) * D;
    const float* krow = dKs + row * LDA;
    const float* vrow = dVs + row * LDA;
    for (int c = half; c < D; c += 2) {
      dk[o + c] = rt::from_f32<T>(krow[c]);
      dv[o + c] = rt::from_f32<T>(vrow[c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk,
                      const Strides& st, float scale, int causal,
                      int q_offset, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_bwd_dq_fma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, H / Hkv, Sq, Sk, st, scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int Sq,
                       int Sk, const Strides& st, float scale, int causal,
                       int q_offset, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_bwd_dkv_fma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, Sq, Sk, st,
      scale, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace f32

Strides to_strides(const int64_t* strides) {
  Strides st;
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  return st;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v and dO in that order; the last dim is contiguous.
// lse and delta are contiguous fp32 [B, H, Sq]; dq is contiguous
// [B, H, Sq, D], dk and dv contiguous [B, Hkv, Sk, D].  Each returns the
// CUDA error code of its launch (0 on success).
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq_out, int dtype, int B, int H, int Hkv, int Sq,
                    int Sk, int D, const int64_t* strides, float scale,
                    int causal, int q_offset, void* stream) {
  using f32::launch_dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return dq::launch<128>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv, Sq,
                           Sk, strides, scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return dq::launch<64>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv, Sq,
                          Sk, strides, scale, causal, q_offset, s);
  const Strides st = to_strides(strides);
  if (dtype == 1 && D == 32)
    return launch_dq<bf16, 32>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv,
                               Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv,
                                 Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv,
                                Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 32)
    return launch_dq<float, 32>(q, k, v, dout, lse, delta, dq_out, B, H, Hkv,
                                Sq, Sk, st, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int dtype, int B, int H, int Hkv,
                     int Sq, int Sk, int D, const int64_t* strides,
                     float scale, int causal, int q_offset, void* stream) {
  using f32::launch_dkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return dkv::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq,
                            Sk, strides, scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return dkv::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq,
                           Sk, strides, scale, causal, q_offset, s);
  const Strides st = to_strides(strides);
  if (dtype == 1 && D == 32)
    return launch_dkv<bf16, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Hkv, Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                 Hkv, Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 32)
    return launch_dkv<float, 32>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                 Hkv, Sq, Sk, st, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
