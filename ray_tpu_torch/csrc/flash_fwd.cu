// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/attention.py:_fwd_kernel
// (launched by _flash_fwd).  Same function: online-softmax attention over
// q [B, H, Sq, D] and k/v [B, Hkv, Sk, D] (GQA: kv head = h / (H / Hkv)),
// a causal mask at global row q_tile * BQ + q_offset (runtime int), K tiles
// past the diagonal skipped with the same truncating cut clipped to
// [0, n_kb] and applied only when n_kb >= 2, the finite NEG_INF = -1e30
// mask value (a row fully masked inside a visited tile gets
// exp(NEG_INF - NEG_INF) = 1), and l clamped to 1e-30 so a row whose tiles
// are all skipped ends with O = 0 and lse ~ NEG_INF.  Outputs: out in q's
// dtype and lse [B, H, Sq] in fp32 (no 128-lane pad).
//
// What bounds it on the H100: at the serving and forward shapes (head_dim
// 128, thousands of keys) the two products q.k^T and p.v are
// 4 * Sq * Sk * D flops per head against 2 * (Sq + Sk) * D elements of
// traffic, so the kernel is bound by tensor-core operations, not bytes.
// The design therefore keeps the Sq x Sk score matrix out of device memory
// (scores, probabilities and the running output live in shared memory and
// registers) and feeds the tensor cores through WMMA (mma.sync) on bf16
// tiles.  The Pallas kernel kept a whole head's K/V resident in VMEM; that
// does not fit 227 KB of shared memory, so K/V stream through shared memory
// in BK-row tiles inside the block.  One block per (q tile, h, b): blocks
// run in any order, so nothing carries between them.  fp32 inputs take the
// same structure with CUDA-core FMAs (exact fp32 products).  Not yet done:
// wgmma, TMA, double-buffered K/V, a register-resident output.
//
// Ragged Sq/Sk tails are masked here: rows past Sq are never written and
// key columns past Sk contribute p = 0, so any length launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block (16 per warp)
constexpr int BK = 64;  // key rows per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
// Shared-memory row strides, padded by 16 bytes so the 16 rows a warp
// touches at once do not all fall in one bank.
constexpr int LDS = BK + 4;  // fp32 scores / p
constexpr int LDP = BK + 8;  // bf16 p
template <typename T, int D>
__host__ __device__ constexpr int ld_in() {  // q, k, v tiles
  return D + 16 / (int)sizeof(T);
}
template <int D>
__host__ __device__ constexpr int ld_out() { return D + 4; }  // fp32 output

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * BK) * ld_in<T, D>() * sizeof(T) +
         (size_t)(BQ * LDS + BQ * ld_out<D>()) * sizeof(float) +
         (std::is_same<T, bf16>::value ? (size_t)BQ * LDP * sizeof(bf16) : 0);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int group, int Sq, int Sk,
                     int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                     int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                     int64_t v_ss, float scale, int causal, int q_offset) {
  constexpr int LDI = ld_in<T, D>();
  constexpr int LDO = ld_out<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LDI;
  T* Vs = Ks + BK * LDI;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDI);  // scores, then fp32 p
  float* Os = Ss + BQ * LDS;                             // running output
  bf16* Ps = reinterpret_cast<bf16*>(Os + BQ * LDO);     // bf16 p (bf16 only)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;

  load_tile<T, D>(Qs, q + b * q_sb + h * q_sh + (int64_t)q0 * q_ss, q_ss,
                  q_rows);
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
  int hi = n_kb;
  if (causal && n_kb >= 2) {
    // C division truncates toward zero, as jax.lax.div does.
    const int t = (q0 + q_offset + BQ + BK - 1) / BK;
    hi = max(0, min(t, n_kb));
  }
  __syncthreads();

  for (int kb = 0; kb < hi; ++kb) {
    const int k0 = kb * BK;
    const int k_rows = min(BK, Sk - k0);
    load_tile<T, D>(Ks, kp + (int64_t)k0 * k_ss, k_ss, k_rows);
    load_tile<T, D>(Vs, vp + (int64_t)k0 * v_ss, v_ss, k_rows);
    __syncthreads();

    // Scores for this warp's 16 rows: Ss[row][0:BK] = q . k^T (unscaled).
    if constexpr (std::is_same<T, bf16>::value) {
      using namespace nvcuda;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(a, Qs + warp * 16 * LDI + kk * 16, LDI);
          wmma::load_matrix_sync(kt, Ks + n * 16 * LDI + kk * 16, LDI);
          wmma::mma_sync(acc, a, kt, acc);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc, LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc += Qs[row * LDI + d] * Ks[c * LDI + d];
        Ss[row * LDS + c] = acc;
      }
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
      if constexpr (std::is_same<T, bf16>::value) {
        Ps[row * LDP + 2 * j + half] = __float2bfloat16(p);
      } else {
        srow[2 * j + half] = p;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = Os + row * LDO;
    for (int c = half; c < D; c += 2) orow[c] *= alpha;
    __syncwarp();

    // Os[warp rows] += p . v
    if constexpr (std::is_same<T, bf16>::value) {
      using namespace nvcuda;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      for (int n = 0; n < D / 16; ++n) {
        wmma::load_matrix_sync(o, Os + warp * 16 * LDO + n * 16, LDO,
                               wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(pa, Ps + warp * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(vb, Vs + kk * 16 * LDI + n * 16, LDI);
          wmma::mma_sync(o, pa, vb, o);
        }
        wmma::store_matrix_sync(Os + warp * 16 * LDO + n * 16, o, LDO,
                                wmma::mem_row_major);
      }
    } else {
      const float* prow = Ss + row * LDS;
      for (int c = half; c < D; c += 2) {
        float acc = orow[c];
        for (int j = 0; j < BK; ++j) acc += prow[j] * Vs[j * LDI + c];
        orow[c] = acc;
      }
    }
    __syncthreads();  // K/V tiles are overwritten next iteration
  }

  if (row < q_rows) {
    const float l_safe = fmaxf(l, 1e-30f);  // fully-masked rows stay finite
    const int64_t o_row = ((int64_t)b * H + h) * Sq + q0 + row;
    T* og = out + o_row * D;
    const float* orow = Os + row * LDO;
    for (int c = half; c < D; c += 2) og[c] = from_f<T>(orow[c] / l_safe);
    if (half == 0) lse[o_row] = m + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk,
                   const int64_t* strides, float scale, int causal,
                   int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, H / Hkv, Sq, Sk,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale, causal, q_offset);
  return cudaGetLastError();
}

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
    return launch<bf16, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                             scale, causal, q_offset, s);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                            scale, causal, q_offset, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                              scale, causal, q_offset, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, strides,
                             scale, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
