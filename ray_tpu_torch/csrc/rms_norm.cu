// RMSNorm forward (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/norms.py:_rms_kernel (launched
// by rms_norm_pallas).  Same function: out = x * rsqrt(mean(x^2) + eps) * w
// over the last dim, fp32 math, cast back to x's dtype.  Any row count
// launches; there is no block-divisibility fallback.
//
// What bounds it on the H100: one read of x and one write of out (w is
// d elements and stays in L1/L2), about one flop per byte, so device-memory
// bandwidth bounds large row counts and launch latency bounds decode (a few
// rows).  The design is one warp per row: a 16-byte vectorised pass sums
// x^2 in fp32 with a warp-shuffle reduction, and a second pass re-reads the
// row (an L1/L2 hit) to scale and store, so each row costs one trip to
// device memory and no shared memory or block barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// VEC: elements per 16-byte load (1 = scalar path for unaligned rows).
template <typename T, int VEC>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (int64_t)row * d;
  T* orow = out + (int64_t)row * d;

  float ss = 0.f;
  for (int i = lane * VEC; i < d; i += 32 * VEC) {
    alignas(16) T e[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + i);
    } else {
      e[0] = xr[i];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rstd = rsqrtf(ss / (float)d + eps);

  for (int i = lane * VEC; i < d; i += 32 * VEC) {
    alignas(16) T e[VEC];
    alignas(16) T g[VEC];
    alignas(16) T r[VEC];
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(xr + i);
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(w + i);
    } else {
      e[0] = xr[i];
      g[0] = w[i];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) r[j] = from_f<T>(to_f(e[j]) * rstd * to_f(g[j]));
    if constexpr (VEC > 1) {
      *reinterpret_cast<uint4*>(orow + i) = *reinterpret_cast<uint4*>(r);
    } else {
      orow[i] = r[0];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = d % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const dim3 block(ROWS_PER_BLOCK * 32);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (aligned)
    rms_norm_kernel<T, VEC><<<grid, block, 0, stream>>>(xt, wt, ot, rows, d, eps);
  else
    rms_norm_kernel<T, 1><<<grid, block, 0, stream>>>(xt, wt, ot, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x and out are contiguous [rows, d],
// w is [d] of the same dtype.  Returns the CUDA error code of the launch.
int rt_rms_norm(const void* x, const void* w, void* out, int dtype, int rows,
                int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(x, w, out, rows, d, eps, s);
  if (dtype == 0) return launch<float>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
