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
// traffic, 18 and 15 us at 3.35 TB/s).  The design keeps every Sq x Sk
// matrix (s, p, dp, ds) out of device memory: per 64 x 64 tile they live
// in shared memory, the products run on WMMA bf16 tiles with fp32
// accumulation (p and ds rounded to bf16 before their products, as K1
// rounds p), and the gradients accumulate in fp32 in shared memory and are
// written once.  One block per (64-row q tile, head, batch) for K2 and per
// (64-row key tile, kv head, batch) for K3; K3 loops the `group` q heads
// of its kv head inside the block, so the GQA sum needs no atomics.  fp32
// inputs take the same structure with CUDA-core FMAs (exact fp32
// products).  Shared memory is 98-221 KB a block, so one block runs per
// SM.  Not yet done: register-resident accumulators (mma.sync fragments),
// cp.async/TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows per tile (16 per warp)
constexpr int BK = 64;  // key rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
// Shared-memory row strides, padded by 16 bytes so the 16 rows a warp
// touches at once do not all fall in one bank.
constexpr int LDS = BK + 4;  // fp32 64 x 64 tiles: s, dp (p and ds for fp32)
constexpr int LDP = BK + 8;  // bf16 64 x 64 tiles: p, ds
template <typename T, int D>
__host__ __device__ constexpr int ld_in() {  // q, dO, k, v tiles
  return D + 16 / (int)sizeof(T);
}
template <int D>
__host__ __device__ constexpr int ld_acc() { return D + 4; }  // fp32 grads
template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Element strides (batch, head, seq) of q, k, v and dO, in that order.
struct Strides {
  int64_t s[12];
};

// Copy a 64-row tile of D elements per row (row stride `stride` elements)
// into shared memory [64][ld_in]; rows at or past `rows` are zero-filled so
// the products over them stay finite.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride,
                                          int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld_in<T, D>() + c) = val;
  }
}

// K1's visiting rule: the q tile at q0 visits key tiles [0, key_tiles).
__device__ __forceinline__ int key_tiles(int q0, int q_offset, int n_kb,
                                         int causal) {
  if (!causal || n_kb < 2) return n_kb;
  // C division truncates toward zero, as jax.lax.div does.
  const int t = (q0 + q_offset + BQ + BK - 1) / BK;
  return max(0, min(t, n_kb));
}

// A[row] . B[c] over D for fp32 tiles [64][ld_in] in shared memory.
template <typename T, int D>
__device__ __forceinline__ float row_dot(const T* A, const T* B, int row,
                                         int c) {
  constexpr int LDI = ld_in<T, D>();
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc += A[row * LDI + d] * B[c * LDI + d];
  return acc;
}

// C[r][c] = sum_d A[r][d] * B[c][d] for the warp's 16 rows r of the 64-row
// tile A and all 64 rows c of B (both [64][ld_in] in shared memory); C is
// fp32 [64][LDS].  bf16: WMMA.  fp32: the thread (row, half) computes the
// even (half 0) or odd columns of its row.
template <typename T, int D>
__device__ __forceinline__ void warp_abt(float* C, const T* A, const T* B,
                                         int warp, int row, int half) {
  constexpr int LDI = ld_in<T, D>();
  if constexpr (is_bf16<T>()) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(a, A + warp * 16 * LDI + kk * 16, LDI);
        wmma::load_matrix_sync(bt, B + n * 16 * LDI + kk * 16, LDI);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(C + warp * 16 * LDS + n * 16, acc, LDS,
                              wmma::mem_row_major);
    }
  } else {
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      C[row * LDS + c] = row_dot<T, D>(A, B, row, c);
    }
  }
}

// Acc[r][c] += sum_j M(r, j) * B[j][c] for the warp's 16 rows r and all D
// columns c, with M(r, j) = M[r][j], or M[j][r] when kTrans.  M is a
// 64 x 64 tile: bf16 [64][LDP] for bf16 inputs, fp32 [64][LDS] for fp32;
// B is a [64][ld_in] tile and Acc fp32 [64][ld_acc].
template <typename T, int D, bool kTrans>
__device__ __forceinline__ void warp_acc(float* Acc, const void* M,
                                         const T* B, int warp, int row,
                                         int half) {
  constexpr int LDI = ld_in<T, D>();
  constexpr int LDA = ld_acc<D>();
  if constexpr (is_bf16<T>()) {
    using namespace nvcuda;
    using ALayout = typename std::conditional<kTrans, wmma::col_major,
                                              wmma::row_major>::type;
    const bf16* Mb = static_cast<const bf16*>(M);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    for (int n = 0; n < D / 16; ++n) {
      wmma::load_matrix_sync(acc, Acc + warp * 16 * LDA + n * 16, LDA,
                             wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        // The A tile (rows warp*16.., columns kk*16..): M[r][j] sits at
        // r * LDP + j (row-major), M[j][r] at j * LDP + r (column-major).
        const bf16* ap = kTrans ? Mb + kk * 16 * LDP + warp * 16
                                : Mb + warp * 16 * LDP + kk * 16;
        wmma::load_matrix_sync(a, ap, LDP);
        wmma::load_matrix_sync(b, B + kk * 16 * LDI + n * 16, LDI);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Acc + warp * 16 * LDA + n * 16, acc, LDA,
                              wmma::mem_row_major);
    }
  } else {
    const float* Mf = static_cast<const float*>(M);
    float* arow = Acc + row * LDA;
    for (int c = half; c < D; c += 2) {
      float s = arow[c];
      for (int j = 0; j < 64; ++j)
        s += (kTrans ? Mf[j * LDS + row] : Mf[row * LDS + j]) * B[j * LDI + c];
      arow[c] = s;
    }
  }
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return 4 * (size_t)64 * ld_in<T, D>() * sizeof(T)  // q, dO, k, v
         + (is_bf16<T>() ? 2 : 1) * (size_t)64 * LDS * sizeof(float)  // s, dp
         + (size_t)64 * ld_acc<D>() * sizeof(float)                  // dQ
         + (is_bf16<T>() ? (size_t)64 * LDP * sizeof(bf16) : 0);     // ds
}

// K2: one block per (64-row q tile, head, batch), looping K1's key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int group, int Sq, int Sk, Strides st,
                        float scale, int causal, int q_offset) {
  constexpr int LDI = ld_in<T, D>();
  constexpr int LDA = ld_acc<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * LDI;
  T* Ks = dOs + BQ * LDI;
  T* Vs = Ks + BK * LDI;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDI);  // s, then fp32 ds
  float* DPs = Ss + BQ * LDS;                           // dp (bf16 only)
  float* dQs = DPs + (is_bf16<T>() ? BQ * LDS : 0);
  bf16* dSb = reinterpret_cast<bf16*>(dQs + BQ * LDA);  // bf16 ds

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int64_t row0 = ((int64_t)b * H + h) * Sq + q0;  // lse/delta/dQ row
  load_tile<T, D>(Qs, q + b * st.s[0] + h * st.s[1] + (int64_t)q0 * st.s[2],
                  st.s[2], q_rows);
  load_tile<T, D>(dOs,
                  dout + b * st.s[9] + h * st.s[10] + (int64_t)q0 * st.s[11],
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
    load_tile<T, D>(Ks, kp + (int64_t)k0 * st.s[5], st.s[5], k_rows);
    load_tile<T, D>(Vs, vp + (int64_t)k0 * st.s[8], st.s[8], k_rows);
    __syncthreads();

    warp_abt<T, D>(Ss, Qs, Ks, warp, row, half);
    if constexpr (is_bf16<T>()) warp_abt<T, D>(DPs, dOs, Vs, warp, row, half);
    __syncwarp();

    float* srow = Ss + row * LDS;
#pragma unroll 4
    for (int j = 0; j < BK / 2; ++j) {
      const int c = 2 * j + half;
      const int col = k0 + c;
      float dp;
      if constexpr (is_bf16<T>()) {
        dp = DPs[row * LDS + c];
      } else {
        dp = row_dot<T, D>(dOs, Vs, row, c);
      }
      float ds = 0.f;
      if (live && col < Sk) {
        float s = srow[c] * scale;
        if (causal && q_pos < col) s = NEG_INF;
        ds = expf(s - lse_r) * (dp - delta_r) * scale;
      }
      if constexpr (is_bf16<T>()) {
        dSb[row * LDP + c] = __float2bfloat16(ds);
      } else {
        srow[c] = ds;
      }
    }
    __syncwarp();

    // dQ[warp rows] += ds . k
    if constexpr (is_bf16<T>()) {
      warp_acc<T, D, false>(dQs, dSb, Ks, warp, row, half);
    } else {
      warp_acc<T, D, false>(dQs, Ss, Ks, warp, row, half);
    }
    __syncthreads();  // the k/v tiles are overwritten next iteration
  }

  __syncthreads();  // dQ may still be the zeros other threads wrote
  if (live) {
    T* g = dq + (row0 + row) * D;
    const float* arow = dQs + row * LDA;
    for (int c = half; c < D; c += 2) g[c] = from_f<T>(arow[c]);
  }
}

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * (size_t)64 * ld_in<T, D>() * sizeof(T)  // k, v, q, dO
         + (is_bf16<T>() ? 2 : 1) * (size_t)64 * LDS * sizeof(float)  // s, dp
         + 2 * (size_t)64 * ld_acc<D>() * sizeof(float)              // dK, dV
         + 2 * (size_t)BQ * sizeof(float)                            // lse, delta
         + (is_bf16<T>() ? 2 * (size_t)64 * LDP * sizeof(bf16) : 0); // p, ds
}

// K3: one block per (64-row key tile, kv head, batch), looping the `group`
// q heads of the kv head and the q tiles that K1 visited with this tile.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int group, int Sq, int Sk,
                         Strides st, float scale, int causal, int q_offset) {
  constexpr int LDI = ld_in<T, D>();
  constexpr int LDA = ld_acc<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * LDI;
  T* Qs = Vs + BK * LDI;
  T* dOs = Qs + BQ * LDI;
  float* Ss = reinterpret_cast<float*>(dOs + BQ * LDI);  // s, then fp32 p/ds
  float* DPs = Ss + BQ * LDS;                            // dp (bf16 only)
  float* dKs = DPs + (is_bf16<T>() ? BQ * LDS : 0);
  float* dVs = dKs + BK * LDA;
  float* lse_s = dVs + BK * LDA;
  float* delta_s = lse_s + BQ;
  bf16* Pb = reinterpret_cast<bf16*>(delta_s + BQ);  // bf16 p
  bf16* dSb = Pb + BQ * LDP;                         // bf16 ds

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = gridDim.y;
  const int k0 = kt * BK;
  const int k_rows = min(BK, Sk - k0);
  load_tile<T, D>(Ks, k + b * st.s[3] + hk * st.s[4] + (int64_t)k0 * st.s[5],
                  st.s[5], k_rows);
  load_tile<T, D>(Vs, v + b * st.s[6] + hk * st.s[7] + (int64_t)k0 * st.s[8],
                  st.s[8], k_rows);
  for (int i = threadIdx.x; i < BK * LDA; i += NTHREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  // Element ownership as in K2: lane pair (2r, 2r+1) holds q row r of the
  // warp's 16 and the even or odd key columns; in the products the warp
  // owns key rows warp*16.. of dK and dV.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int n_qb = (Sq + BQ - 1) / BQ;
  const int n_kb = (Sk + BK - 1) / BK;
  float dsv[BK / 2];  // fp32 inputs: ds waits here while p is in use

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
      load_tile<T, D>(Qs, qp + (int64_t)q0 * st.s[2], st.s[2], q_rows);
      load_tile<T, D>(dOs, dop + (int64_t)q0 * st.s[11], st.s[11], q_rows);
      for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
        lse_s[i] = i < q_rows ? lse[lrow + q0 + i] : 0.f;
        delta_s[i] = i < q_rows ? delta[lrow + q0 + i] : 0.f;
      }
      __syncthreads();

      warp_abt<T, D>(Ss, Qs, Ks, warp, row, half);
      if constexpr (is_bf16<T>()) {
        warp_abt<T, D>(DPs, dOs, Vs, warp, row, half);
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
        float dp;
        if constexpr (is_bf16<T>()) {
          dp = DPs[row * LDS + c];
        } else {
          dp = row_dot<T, D>(dOs, Vs, row, c);
        }
        float p = 0.f, ds = 0.f;
        if (live && col < Sk) {
          float s = srow[c] * scale;
          if (causal && q_pos < col) s = NEG_INF;
          p = expf(s - lse_r);
          ds = p * (dp - delta_r) * scale;
        }
        if constexpr (is_bf16<T>()) {
          Pb[row * LDP + c] = __float2bfloat16(p);
          dSb[row * LDP + c] = __float2bfloat16(ds);
        } else {
          srow[c] = p;
          dsv[j] = ds;
        }
      }
      __syncthreads();  // each key row of dK/dV needs every warp's q rows

      if constexpr (is_bf16<T>()) {
        warp_acc<T, D, true>(dVs, Pb, dOs, warp, row, half);
        warp_acc<T, D, true>(dKs, dSb, Qs, warp, row, half);
      } else {
        warp_acc<T, D, true>(dVs, Ss, dOs, warp, row, half);
        __syncthreads();  // p is read; ds takes its place
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) srow[2 * j + half] = dsv[j];
        __syncthreads();
        warp_acc<T, D, true>(dKs, Ss, Qs, warp, row, half);
      }
    }
  }

  __syncthreads();  // dK/dV may still be the zeros other threads wrote
  if (row < k_rows) {
    const int64_t o = (((int64_t)b * Hkv + hk) * Sk + k0 + row) * D;
    const float* krow = dKs + row * LDA;
    const float* vrow = dVs + row * LDA;
    for (int c = half; c < D; c += 2) {
      dk[o + c] = from_f<T>(krow[c]);
      dv[o + c] = from_f<T>(vrow[c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int Hkv, int Sq, int Sk,
                      const Strides& st, float scale, int causal,
                      int q_offset, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  auto kern = flash_bwd_dq_kernel<T, D>;
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
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  auto kern = flash_bwd_dkv_kernel<T, D>;
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
                    void* dq, int dtype, int B, int H, int Hkv, int Sq,
                    int Sk, int D, const int64_t* strides, float scale,
                    int causal, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = to_strides(strides);
  if (dtype == 1 && D == 128)
    return launch_dq<bf16, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                                Sk, st, scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch_dq<bf16, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                               Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                 Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                                Sk, st, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int dtype, int B, int H, int Hkv,
                     int Sq, int Sk, int D, const int64_t* strides,
                     float scale, int causal, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = to_strides(strides);
  if (dtype == 1 && D == 128)
    return launch_dkv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                 Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<bf16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                  Hkv, Sq, Sk, st, scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                 Sq, Sk, st, scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
