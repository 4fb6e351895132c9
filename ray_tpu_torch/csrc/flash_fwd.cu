// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/attention.py:_fwd_kernel
// (launched by _flash_fwd).  Same function: online-softmax attention over
// q [B, H, Sq, D] and k/v [B, Hkv, Sk, D] (GQA: kv head = h / (H / Hkv),
// read through strides, never repeated), a causal mask at global row
// row + q_offset (runtime int, any sign), the finite NEG_INF = -1e30 mask
// value (a row fully masked inside a visited tile gets exp(NEG_INF -
// NEG_INF) = 1) and l clamped to 1e-30 (a row whose tiles are all skipped
// ends with O = 0 and lse = NEG_INF + log(1e-30)).  Which key tiles a row
// visits is part of the function: the rule of the JAX kernel and of
// ops/attention.py:_visited, on 64-row q tiles and 64-key tiles, cut at
// hi = clip(trunc((tile_row0 + q_offset + 127) / 64), 0, n_kb) when
// causal and n_kb >= 2.  Outputs: out [B, H, Sq, D] in q's dtype and lse
// [B, H, Sq] in fp32.  Ragged Sq/Sk tails are masked here: rows past Sq
// are never written and keys past Sk contribute p = 0.
//
// What bounds it on the H100: at the forward and training shape ([1, 32,
// 2048, 128], Hkv 8, causal) the two products are 4 * D FLOP per causal
// (row, key) pair, 34.4 GFLOP, against 42 MB of q/k/v/out/lse traffic:
// 34.8 us at the 989 TFLOP/s bf16 peak against 12.6 us at 3.35 TB/s, so
// the kernel is bound by tensor-core operations, and only wgmma reaches
// the tensor cores' full rate.  The design feeds wgmma and keeps
// everything quadratic, and the running output, out of memory:
//
// - bf16 (the main path): one block per (128-row q tile, q head, batch)
//   of two consumer warpgroups and one producer warp.  One producer
//   thread issues TMA copies (tensor maps built per call from the
//   strides) of Q once and of 128-key K and V tiles into a 2-stage ring
//   with full and empty mbarriers, in the 128-byte swizzle that both TMA
//   and the wgmma descriptors read.  Each consumer warpgroup owns 64 q
//   rows, exactly one visiting tile, and so its own cut.  S = Q.K^T is
//   wgmma m64n128k16 with both operands in shared memory, fp32 in
//   registers.  The online softmax runs in registers (row max and sum
//   across the 4 lanes of a group with shuffles); l sums the fp32 p.  P,
//   rounded to bf16 in registers, is the register A operand of P.V (wgmma
//   with V [keys x D] MN-major through the descriptor's transpose).  O
//   stays in fp32 registers for the whole loop and is written once,
//   O / max(l, 1e-30), through shared memory as 16-byte stores.  The
//   grid puts q heads on its fast axis and walks q tiles from the last:
//   the heaviest causal tiles start first and do not set the tail.
//   Per element the softmax takes more issue slots than the products, so
//   a tile that needs no mask (all but the diagonal, a tile half past the
//   cut and the ragged tail) takes the max over the raw scores and
//   p = 2^(s * scale * log2 e - m * log2 e) as one FMA and one ex2.approx;
//   a masked tile keeps m in natural units and p = 2^((s - m) log2 e),
//   so a fully masked row's p is exactly 1 and its lse NEG_INF bit for
//   bit.  ptxas allocates 168 registers to every thread of a block of two
//   warpgroups and more (setmaxnreg did not raise the consumers' share,
//   and a producer warpgroup cut to 40 registers spilled), so the
//   producer is one warp and nothing is rebalanced.
// - fp32 inputs at head_dim 32, 64 and 128, and bf16 at head_dim 32: a
//   CUDA-core kernel (64x64 tiles, everything through shared memory).  It
//   converts bf16 to fp32 as a tile lands, computes in fp32 (exact fp32
//   products) and rounds the output to the input's type once.  The tiny
//   model (head_dim 32, either dtype) runs it; no call on the main path
//   does.  A bf16 row of 32 values is 64 bytes, which the wgmma kernel's
//   128-byte swizzle does not fit.
//
// Not done yet: overlapping one tile's softmax with the next tile's
// products inside a warpgroup (it needs P of two tiles live: beyond 168
// registers it spills), and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr int VIS = 64;  // the visiting rule's tile, rows and keys

// The visiting cut of the 64-row q tile whose first row is row0: key
// tiles [0, hi) are visited.  C division truncates toward zero, as
// jax.lax.div does.
__device__ __forceinline__ int visited_tiles(int row0, int q_offset,
                                             int causal, int n_kb) {
  if (!(causal && n_kb >= 2)) return n_kb;
  const int t = (row0 + q_offset + VIS + VIS - 1) / VIS;
  return max(0, min(t, n_kb));
}

// ------------------------------------------------------ the bf16 kernel

constexpr int BQ = 128;   // q rows per block: one 64-row visiting tile per
                          // consumer warpgroup
constexpr int BKV = 128;  // keys per streamed tile: two visiting tiles
constexpr int STAGES = 2;
constexpr int NCONSUMERS = 256;  // warpgroups 0 and 1 compute,
constexpr int NTHREADS = NCONSUMERS + 32;  // then one producer warp
constexpr int HALF = 128 * 128;  // bytes of a [128 rows x 64] swizzled half

// Shared memory: Q, then STAGES x (K, V), each [128 rows x D] as D / 64
// column halves of [128 x 64] bf16 in TMA's 128-byte swizzle (1024-byte
// aligned), then the barriers.
template <int D>
struct Layout {
  static constexpr int TILE = D / 64 * HALF;
  static constexpr int Q = 0;
  static constexpr int KV = TILE;  // stage s: K at KV + 2 s TILE, V after
  static constexpr int BARS = KV + STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + 64 + 1024;  // + alignment slack
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128)
    rt::wgmma_m64n128k16_rs_tb(o, a, desc_v, 1);
  else
    rt::wgmma_m64n64k16_rs_tb(o, a, desc_v, 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int group, int Sq, int Sk, float scale, int causal,
                     int q_offset) {
  static_assert(std::is_same<T, bf16>::value, "the wgmma kernel is bf16");
  using L = Layout<D>;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = rt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BARS;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int n_kb = (Sk + VIS - 1) / VIS;  // in 64-key visiting tiles
  // The second half's cut is the larger; a block whose second half holds
  // no row stops at the first half's.
  const int hi_blk =
      visited_tiles(q_rows > VIS ? q0 + VIS : q0, q_offset, causal, n_kb);
  const int n_tiles = (hi_blk + 1) / 2;  // 128-key tiles the block streams

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rt::mbar_init(full + 8 * s, 1);
      rt::mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    rt::mbar_init(qbar, 1);
    rt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMERS) {  // producer: one thread issues the copies
    if (threadIdx.x == NCONSUMERS) {
      rt::mbar_arrive_expect_tx(qbar, L::TILE);
      for (int c = 0; c < D / 64; ++c)
        rt::tma_load_4d(base + L::Q + c * HALF, &tq, qbar, 64 * c, q0, h, b);
      const int hk = h / group;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // Wait for both consumer warpgroups to release tile j - STAGES.
        if (j >= STAGES) rt::mbar_wait(empty + 8 * s, (j / STAGES - 1) & 1);
        rt::mbar_arrive_expect_tx(full + 8 * s, 2 * L::TILE);
        const uint32_t kd = base + L::KV + s * 2 * L::TILE;
        for (int c = 0; c < D / 64; ++c) {
          rt::tma_load_4d(kd + c * HALF, &tk, full + 8 * s, 64 * c, BKV * j,
                          hk, b);
          rt::tma_load_4d(kd + L::TILE + c * HALF, &tv, full + 8 * s, 64 * c,
                          BKV * j, hk, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup w owns block rows 64 w .. 64 w + 63, one visiting
    // tile with its own cut; warp ww of it rows 16 ww .. 16 ww + 15.
    const int w = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + VIS * w;
    const int hi_w = visited_tiles(r0, q_offset, causal, n_kb);
    const int pos = r0 + 16 * warp + g + q_offset;  // row g; row g + 8: +8

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = base + L::Q + w * VIS * 128;

    rt::mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      rt::mbar_wait(full + 8 * s, (j / STAGES) & 1);
      if (2 * j < hi_w) {
        const uint32_t k_addr = base + L::KV + s * 2 * L::TILE;
        const uint32_t v_addr = k_addr + L::TILE;

        // S = Q . K^T (unscaled): D / 16 wgmma steps, operands in shared
        // memory, fp32 sums in registers.
        float sc[64];
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * HALF + (kk % 4) * 32;
          rt::wgmma_m64n128k16_ss(sc,
                                  rt::wgmma_desc_sw128(q_addr + off, 16, 1024),
                                  rt::wgmma_desc_sw128(k_addr + off, 16, 1024),
                                  kk > 0);
        }
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) rt::fence_operand(sc[i]);

        // Online softmax in registers: sc[4n + e] is row g + 8 (e / 2), key
        // 128 j + 8 n + 2 t + e % 2.  Keys past Sk and keys of a 64-key tile
        // past this warpgroup's cut get -inf (p = 0); keys the causal mask
        // hides inside a visited tile get the finite NEG_INF.
        const int k0 = BKV * j;
        const bool masked = k0 + BKV > Sk || 2 * j + 1 >= hi_w ||
                            (causal && k0 + BKV - 1 > r0 + q_offset);
        if (!masked) {
          // No mask: max over the raw scores (scale > 0 commutes with max
          // and with rounding), p = 2^(s scale log2e - m log2e) in one FMA.
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < 64; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
          float ml[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], rt::quad_max(mx[r]) * scale);
            const float alpha = rt::ex2((m[r] - m_new) * LOG2E);
            m[r] = m_new;
            ml[r] = m_new * LOG2E;
            l[r] *= alpha;
#pragma unroll
            for (int jd = 0; jd < D / 8; ++jd) {
              o[4 * jd + 2 * r] *= alpha;
              o[4 * jd + 2 * r + 1] *= alpha;
            }
          }
          const float sl2 = scale * LOG2E;
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const float p = rt::ex2(fmaf(sc[i], sl2, -ml[(i >> 1) & 1]));
            sc[i] = p;
            l[(i >> 1) & 1] += p;
          }
        } else {
          const int k_end = min(Sk, hi_w * VIS);
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            float x = sc[i] * scale;
            if (masked) {
              const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
              if (col >= k_end)
                x = -INFINITY;
              else if (causal && pos + 8 * ((i >> 1) & 1) < col)
                x = NEG_INF;
            }
            sc[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], rt::quad_max(mx[r]));
            const float alpha = rt::ex2((m[r] - m_new) * LOG2E);
            m[r] = m_new;
            l[r] *= alpha;
#pragma unroll
            for (int jd = 0; jd < D / 8; ++jd) {
              o[4 * jd + 2 * r] *= alpha;
              o[4 * jd + 2 * r + 1] *= alpha;
            }
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            // s - m first: equal values give exactly 0, so a fully masked
            // row's p is exactly 1.
            const float p = rt::ex2((sc[i] - m[(i >> 1) & 1]) * LOG2E);
            sc[i] = p;
            l[(i >> 1) & 1] += p;
          }
        }
        uint32_t pa[8][4];  // P in bf16: the A fragments of 8 k16 steps
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[kk][e] =
                rt::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

        // O += P . V: P from registers, V [keys x D] MN-major through the
        // descriptor's transpose; 8 k16 steps over the tile's keys.
        rt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_pv<D>(o, pa[kk],
                      rt::wgmma_desc_sw128(v_addr + kk * 16 * 128, HALF, 1024));
        rt::wgmma_commit();
        rt::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < D / 2; ++i) rt::fence_operand(o[i]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) rt::fence_operand(pa[kk][e]);
      }
      rt::mbar_arrive(empty + 8 * s);  // this thread is done with stage s
    }

    // Epilogue: O / max(l, 1e-30) to bf16 into the warpgroup's own Q rows
    // (same swizzle), then 16-byte stores of whole rows; lse.
    const int64_t row_base = ((int64_t)b * H + h) * Sq + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_safe = fmaxf(rt::quad_sum(l[r]), 1e-30f);
      const int row = VIS * w + 16 * warp + g + 8 * r;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
        *reinterpret_cast<uint32_t*>(smem + L::Q + (jd / 8) * HALF +
                                     16 * rt::swizzle<8>(row, jd % 8) +
                                     4 * t) =
            rt::pack_bf16(o[4 * jd + 2 * r] / l_safe,
                          o[4 * jd + 2 * r + 1] / l_safe);
      if (t == 0 && row < q_rows) lse[row_base + row] = m[r] + logf(l_safe);
    }
    __syncwarp();
    constexpr int CH = D / 8;
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int i = it * 32 + lane;
      const int row = VIS * w + 16 * warp + i / CH, c = i % CH;
      if (row < q_rows)
        *reinterpret_cast<uint4*>(out + (row_base + row) * D + c * 8) =
            *reinterpret_cast<const uint4*>(smem + L::Q + (c / 8) * HALF +
                                            16 * rt::swizzle<8>(row, c % 8));
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Hkv, int Sq,
                        int Sk, const int64_t* st, float scale, int causal,
                        int q_offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!rt::tensor_map_bf16(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ) ||
      !rt::tensor_map_bf16(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BKV) ||
      !rt::tensor_map_bf16(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BKV))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<D>::BYTES;
  auto kern = flash_fwd_kernel<bf16, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, (Sq + BQ - 1) / BQ, B);
  kern<<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(out),
                                         lse, H, H / Hkv, Sq, Sk, scale,
                                         causal, q_offset);
  return cudaGetLastError();
}

// ------------------------------------------- the CUDA-core (fp32) kernel

namespace f32 {

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // key rows per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
// Shared-memory row strides, padded by 16 bytes so the 16 rows a warp
// touches at once do not all fall in one bank.
constexpr int LDS = BK + 4;  // scores / p
template <int D>
__host__ __device__ constexpr int ld_in() { return D + 4; }  // q, k, v
template <int D>
__host__ __device__ constexpr int ld_out() { return D + 4; }  // output

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * BK) * ld_in<D>() * sizeof(float) +
         (size_t)(BQ * LDS + BQ * ld_out<D>()) * sizeof(float);
}

// Inputs of type T (fp32, or bf16 at head_dim 32) are converted to fp32
// as they land in shared memory; every product and the softmax run in
// fp32, and the output is rounded to T once.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int H, int group, int Sq,
                         int Sk, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                         int64_t k_sb, int64_t k_sh, int64_t k_ss,
                         int64_t v_sb, int64_t v_sh, int64_t v_ss,
                         float scale, int causal, int q_offset) {
  constexpr int LDI = ld_in<D>();
  constexpr int LDO = ld_out<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDI;
  float* Vs = Ks + BK * LDI;
  float* Ss = Vs + BK * LDI;  // scores, then p
  float* Os = Ss + BQ * LDS;  // running output

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;

  rt::load_tile_f32<T, D, LDI, NTHREADS>(
      Qs, q + b * q_sb + h * q_sh + (int64_t)q0 * q_ss, q_ss, q_rows);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Softmax ownership: lane pair (2r, 2r+1) holds row r of the warp's 16;
  // lane `half` of the pair owns the even or odd key columns of the tile
  // and the even or odd output columns.
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int q_pos = q0 + row + q_offset;
  float m = NEG_INF, l = 0.f;

  const int n_kb = (Sk + BK - 1) / BK;
  const int hi = visited_tiles(q0, q_offset, causal, n_kb);
  __syncthreads();

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    const int k_rows = min(BK, Sk - k0);
    rt::load_tile_f32<T, D, LDI, NTHREADS>(Ks, kp + (int64_t)k0 * k_ss, k_ss,
                                           k_rows);
    rt::load_tile_f32<T, D, LDI, NTHREADS>(Vs, vp + (int64_t)k0 * v_ss, v_ss,
                                           k_rows);
    __syncthreads();

    // Scores for this warp's 16 rows: Ss[row][0:BK] = q . k^T (unscaled).
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += Qs[row * LDI + d] * Ks[c * LDI + d];
      Ss[row * LDS + c] = acc;
    }
    __syncwarp();

    // Online softmax update for (row, half).
    float* srow = Ss + row * LDS;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + 2 * j + half;
      float s;
      if (col >= Sk) {
        s = -INFINITY;  // past the ragged tail: contributes p = 0
      } else {
        s = srow[2 * j + half] * scale;
        if (causal && q_pos < col) s = NEG_INF;
      }
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
      srow[2 * j + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = Os + row * LDO;
    for (int c = half; c < D; c += 2) orow[c] *= alpha;
    __syncwarp();

    // Os[warp rows] += p . v
    const float* prow = Ss + row * LDS;
    for (int c = half; c < D; c += 2) {
      float acc = orow[c];
      for (int j = 0; j < BK; ++j) acc += prow[j] * Vs[j * LDI + c];
      orow[c] = acc;
    }
    __syncthreads();  // K/V tiles are overwritten next iteration
  }

  if (row < q_rows) {
    const float l_safe = fmaxf(l, 1e-30f);  // fully-masked rows stay finite
    const int64_t o_row = ((int64_t)b * H + h) * Sq + q0 + row;
    T* og = out + o_row * D;
    const float* orow = Os + row * LDO;
    for (int c = half; c < D; c += 2)
      og[c] = rt::from_f32<T>(orow[c] / l_safe);
    if (half == 0) lse[o_row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk,
                   const int64_t* st, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_fma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H,
      H / Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 9 element strides, (batch,
// head, seq) for q, k, v in that order; the last dim is contiguous.  out is
// contiguous [B, H, Sq, D], lse contiguous [B, H, Sq].  Returns the CUDA
// error code of the launch (0 on success).
int rt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                 float* lse, int dtype, int B, int H, int Hkv, int Sq, int Sk,
                 int D, const int64_t* strides, float scale, int causal,
                 int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                            scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                           scale, causal, q_offset, s);
  if (dtype == 1 && D == 32)
    return f32::launch<bf16, 32>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                 strides, scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return f32::launch<float, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                   strides, scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return f32::launch<float, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                  strides, scale, causal, q_offset, s);
  if (dtype == 0 && D == 32)
    return f32::launch<float, 32>(q, k, v, out, lse, B, H, Hkv, Sq, Sk,
                                  strides, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
