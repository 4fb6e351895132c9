// RMSNorm forward and backward (K4) for Hopper, sm_90a.
//
// The forward replaces the Pallas TPU kernel ray_tpu/ops/norms.py:
// _rms_kernel (launched by rms_norm_pallas): out = x * rsqrt(mean(x^2) +
// eps) * w over the last dim, fp32 math, one rounding to x's dtype.  The
// backward replaces what XLA fuses from jax.vjp of ray_tpu/ops/norms.py:
// rms_norm (the JAX package has no Pallas kernel for it).  With
// g = dy * w and r = rsqrt(mean(x^2) + eps), all in fp32:
//   dx = r * g - x * r^3 * mean(g * x)   rounded once to x's dtype,
//   dw = sum over rows of dy * x * r     rounded once to w's dtype.
// Any row count; fp32 and bf16; any d.
//
// What bounds them on the H100: bytes.  The forward reads x and writes
// out (w is d elements and stays in L1/L2), the backward reads x and dy
// and writes dx; about one to five flops a byte.  So device-memory
// bandwidth bounds large row counts, and launch and load latency bound
// decode (8 rows).
//
// The design, for each of those:
// - A row belongs to a group of G threads (G <= 32: a slice of a warp,
//   several rows a block; G > 32: the whole block), and each thread
//   holds VPT 16-byte vectors of it in registers.  d = 4096 and d = 128
//   (the Llama-3-8B and tiny widths) are compiled as such (VPT > 0): a
//   thread issues all its loads before any arithmetic, so a row costs one
//   load latency and x is read from memory once.  Other d loop over the
//   row (VPT = 0) and re-read it from L1/L2 to scale; unaligned rows take
//   the same loop one element at a time (VEC = 1).
// - Sums over a row: xor-shuffles inside the warp, then for G > 32 one
//   shared-memory step; the backward reduces its two sums together.
// - The forward fills the card at every row count: 4 vectors a thread
//   (128 threads a row in bf16) when rows are many, 512 threads a row
//   when rows are few.
// - The backward's dw is a sum over rows, which blocks running in no
//   order cannot share without atomics.  So its grid is at most three
//   blocks per SM, each walking a contiguous run of rows and adding
//   dy * x * r into registers; each row group then writes one fp32
//   partial row, and a second kernel sums the partial rows of a column
//   in a fixed order.  No atomics: dw is bit-identical from run to run.
//   Without dw (w frozen) the partials and the second kernel are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of T: one 16-byte load or store when VEC * sizeof(T) is 16.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// Sum each of v[0..N) over the G threads of a row group (G a power of
// two, groups aligned to G lanes).  G > 32 means the block is one group:
// after the warp's shuffles one shared-memory step adds the warps.  red
// holds 2 * (G / 32) * N floats; `parity` alternates between calls so a
// warp that runs ahead into the next row writes the other half while
// slower warps still read this one.  Every thread of the group gets the
// sums.
template <int G, int N>
__device__ __forceinline__ void group_sum(float (&v)[N], float* red,
                                          int parity) {
  constexpr int W = G < 32 ? G : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
  if constexpr (G > 32) {
    constexpr int WARPS = G / 32;
    float* buf = red + parity * WARPS * N;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int n = 0; n < N; ++n) buf[warp * N + n] = v[n];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += buf[i * N + n];
      v[n] = s;
    }
  }
}

template <int G>
__host__ __device__ constexpr int red_floats(int n) {
  return 2 * (G > 32 ? G / 32 : 1) * n;
}

// ---------------------------------------------------------------- forward

// One row per group of G threads, RPB groups a block.  VPT > 0: d is
// VPT * G * VEC and the row lives in registers; VPT = 0: any d, looped.
template <typename T, int VEC, int VPT, int G, int RPB>
__global__ void __launch_bounds__(G * RPB)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int rows, int d, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[red_floats<G>(1)];
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * RPB + threadIdx.x / G;
  const bool live = row < rows;  // false only in a tail group (G <= 32)
  const T* xr = x + (int64_t)row * d;
  T* orow = out + (int64_t)row * d;
  float ss[1] = {0.f};
  if constexpr (VPT > 0) {
    P xv[VPT], wv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int c = (j * G + t) * VEC;
      if (live) xv[j] = load<T, VEC>(xr + c);
      wv[j] = load<T, VEC>(w + c);
    }
    if (live)
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = to_f(xv[j].e[k]);
          ss[0] += f * f;
        }
    group_sum<G, 1>(ss, red, 0);
    const float r = rsqrtf(ss[0] / (float)d + eps);
    if (!live) return;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.e[k] = from_f<T>(to_f(xv[j].e[k]) * r * to_f(wv[j].e[k]));
      store<T, VEC>(orow + (j * G + t) * VEC, o);
    }
  } else {
    if (live)
      for (int c = t * VEC; c < d; c += G * VEC) {
        const P v = load<T, VEC>(xr + c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = to_f(v.e[k]);
          ss[0] += f * f;
        }
      }
    group_sum<G, 1>(ss, red, 0);
    const float r = rsqrtf(ss[0] / (float)d + eps);
    if (!live) return;
    for (int c = t * VEC; c < d; c += G * VEC) {
      const P v = load<T, VEC>(xr + c), g = load<T, VEC>(w + c);
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.e[k] = from_f<T>(to_f(v.e[k]) * r * to_f(g.e[k]));
      store<T, VEC>(orow + c, o);
    }
  }
}

// Rows at or below which the forward spreads a d = 4096 row over 512
// threads: two rows an SM and fewer.
constexpr int FEW_ROWS = 264;

template <typename T, int VEC, int VPT, int G, int RPB>
cudaError_t fwd(const void* x, const void* w, void* out, int rows, int d,
                float eps, cudaStream_t s) {
  const dim3 grid((rows + RPB - 1) / RPB);
  rms_norm_kernel<T, VEC, VPT, G, RPB><<<grid, G * RPB, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* out, int rows,
                       int d, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  if (d % VEC != 0 || !aligned16({x, w, out}))
    return fwd<T, 1, 0, 256, 1>(x, w, out, rows, d, eps, s);
  if (d == 4096) {
    if (rows <= FEW_ROWS)
      return fwd<T, VEC, 4096 / VEC / 512, 512, 1>(x, w, out, rows, d, eps,
                                                   s);
    return fwd<T, VEC, 4, 4096 / VEC / 4, 1>(x, w, out, rows, d, eps, s);
  }
  if (d == 128)
    return fwd<T, VEC, 1, 128 / VEC, VEC>(x, w, out, rows, d, eps, s);
  return fwd<T, VEC, 0, 256, 1>(x, w, out, rows, d, eps, s);
}

// --------------------------------------------------------------- backward

// dx of one element, given g = dy * w, r and ds = -r^3 sum(g x) / (2 d):
// r g + 2 ds x = r g - x r^3 mean(g x), in the order of the plain
// version (_rms_bwd_ref).
__device__ __forceinline__ float dx_of(float x, float g, float r, float ds) {
  return (g * r + ds * x) + ds * x;
}

// Rows [slot * per_slot, (slot + 1) * per_slot) belong to the row group
// `slot` = blockIdx.x * RPB + group.  dx may be null (x frozen).  DW:
// write the group's fp32 partial dw row part[slot, :].
template <typename T, int VEC, int VPT, int G, int RPB, bool DW>
__global__ void __launch_bounds__(G * RPB)
    rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int d,
                        int per_slot, float eps) {
  using P = Pack<T, VEC>;
  __shared__ float red[red_floats<G>(2)];
  const int t = threadIdx.x % G;
  const int slot = blockIdx.x * RPB + threadIdx.x / G;
  const int row0 = slot * per_slot;
  const int row1 = min(row0 + per_slot, rows);
  if constexpr (VPT > 0) {
    P wv[VPT];
    float acc[VPT][VEC];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      wv[j] = load<T, VEC>(w + (j * G + t) * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;
    }
    // Every group of a block runs per_slot iterations, so the warps that
    // share shuffles (G < 32) or a barrier (G > 32) stay together.
#pragma unroll 1
    for (int i = 0; i < per_slot; ++i) {
      const int row = row0 + i;
      const bool live = row < row1;
      const int64_t off = (int64_t)row * d;
      P xv[VPT], gv[VPT];
      if (live)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int c = (j * G + t) * VEC;
          xv[j] = load<T, VEC>(x + off + c);
          gv[j] = load<T, VEC>(dy + off + c);
        }
      float s[2] = {0.f, 0.f};  // sum x^2, sum (dy w) x
      if (live)
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xf = to_f(xv[j].e[k]);
            s[0] += xf * xf;
            s[1] += to_f(gv[j].e[k]) * to_f(wv[j].e[k]) * xf;
          }
      group_sum<G, 2>(s, red, i & 1);
      if (!live) continue;
      const float r = rsqrtf(s[0] / (float)d + eps);
      const float ds = -0.5f * s[1] * (r * r * r) / (float)d;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        P o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xf = to_f(xv[j].e[k]), dyf = to_f(gv[j].e[k]);
          o.e[k] = from_f<T>(dx_of(xf, dyf * to_f(wv[j].e[k]), r, ds));
          if constexpr (DW) acc[j][k] += dyf * (xf * r);
        }
        if (dx) store<T, VEC>(dx + off + (j * G + t) * VEC, o);
      }
    }
    if constexpr (DW) {
      float* pr = part + (int64_t)slot * d;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        // VEC fp32 = 16 or 32 bytes, 16-byte aligned as d % VEC == 0.
        float* dst = pr + (j * G + t) * VEC;
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
          *reinterpret_cast<float4*>(dst + k) = make_float4(
              acc[j][k], acc[j][k + 1], acc[j][k + 2], acc[j][k + 3]);
      }
    }
  } else {
    // DW: the group's partial row, zeroed and then added to in place by
    // the threads that own its columns.
    float* pr = DW ? part + (int64_t)slot * d : nullptr;
    if constexpr (DW)
      for (int c = t * VEC; c < d; c += G * VEC)
#pragma unroll
        for (int k = 0; k < VEC; ++k) pr[c + k] = 0.f;
#pragma unroll 1
    for (int i = 0; i < per_slot; ++i) {
      const int row = row0 + i;
      const bool live = row < row1;
      const int64_t off = (int64_t)row * d;
      float s[2] = {0.f, 0.f};
      if (live)
        for (int c = t * VEC; c < d; c += G * VEC) {
          const P v = load<T, VEC>(x + off + c),
                  g = load<T, VEC>(dy + off + c), q = load<T, VEC>(w + c);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xf = to_f(v.e[k]);
            s[0] += xf * xf;
            s[1] += to_f(g.e[k]) * to_f(q.e[k]) * xf;
          }
        }
      group_sum<G, 2>(s, red, i & 1);
      if (!live) continue;
      const float r = rsqrtf(s[0] / (float)d + eps);
      const float ds = -0.5f * s[1] * (r * r * r) / (float)d;
      for (int c = t * VEC; c < d; c += G * VEC) {
        const P v = load<T, VEC>(x + off + c),
                g = load<T, VEC>(dy + off + c), q = load<T, VEC>(w + c);
        P o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xf = to_f(v.e[k]), dyf = to_f(g.e[k]);
          o.e[k] = from_f<T>(dx_of(xf, dyf * to_f(q.e[k]), r, ds));
          if constexpr (DW) pr[c + k] += dyf * (xf * r);
        }
        if (dx) store<T, VEC>(dx + off + c, o);
      }
    }
  }
}

// dw[c] = sum over slots of part[slot, c], rounded once to T.  A block
// takes 32 columns; its 32 rows of threads each add every 32nd slot in
// order, then one thread a column adds the 32 sums in order.
constexpr int DW_COLS = 32, DW_LANES = 32;

template <typename T>
__global__ void __launch_bounds__(DW_COLS * DW_LANES)
    rms_norm_dw_kernel(const float* __restrict__ part, T* __restrict__ dw,
                       int slots, int d) {
  __shared__ float sums[DW_LANES][DW_COLS + 1];
  const int c = blockIdx.x * DW_COLS + threadIdx.x;
  float acc = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int s = threadIdx.y; s < slots; s += DW_LANES)
      acc += part[(int64_t)s * d + c];
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < DW_LANES; ++i) tot += sums[i][threadIdx.x];
    dw[c] = from_f<T>(tot);
  }
}

// At most this many backward blocks an SM: more rows in flight, but each
// block's partial dw row is d fp32 more to write and read again.  At
// [2048, 4096] bf16 three (the most that fit) beat two and one
// (scripts/rms_builds.py).
constexpr int BWD_BLOCKS_PER_SM = 3;

struct Plan {
  int blocks, slots, per_slot;
};

// The backward's grid for `rows` rows: at most BWD_BLOCKS_PER_SM blocks
// an SM (fewer if the kernel's occupancy is lower), rows split into
// contiguous runs of equal length, no block without rows.
template <typename Kernel>
Plan plan(Kernel kernel, int threads, int rpb, int rows) {
  int dev = 0, sms = 132, occ = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0);
  const int groups = sms * rpb *
      (occ < BWD_BLOCKS_PER_SM ? (occ > 0 ? occ : 1) : BWD_BLOCKS_PER_SM);
  const int per_slot = (rows + groups - 1) / groups;
  const int used = (rows + per_slot - 1) / per_slot;
  const int blocks = (used + rpb - 1) / rpb;
  return {blocks, blocks * rpb, per_slot};
}

// One backward configuration: its plan and its launch (part, dw null: no
// dw work).
template <typename T, int VEC, int VPT, int G, int RPB>
struct Bwd {
  static Plan make_plan(int rows) {
    return plan(rms_norm_bwd_kernel<T, VEC, VPT, G, RPB, true>, G * RPB,
                RPB, rows);
  }
  static cudaError_t run(const void* x, const void* w, const void* dy,
                         void* dx, void* dw, float* part, int rows, int d,
                         float eps, cudaStream_t s) {
    const Plan p = make_plan(rows);
    const T* xt = static_cast<const T*>(x);
    const T* wt = static_cast<const T*>(w);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (dw) {
      rms_norm_bwd_kernel<T, VEC, VPT, G, RPB, true>
          <<<p.blocks, G * RPB, 0, s>>>(xt, wt, dyt, dxt, part, rows, d,
                                        p.per_slot, eps);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      const dim3 grid((d + DW_COLS - 1) / DW_COLS), block(DW_COLS, DW_LANES);
      rms_norm_dw_kernel<T><<<grid, block, 0, s>>>(part, static_cast<T*>(dw),
                                                   p.slots, d);
    } else {
      rms_norm_bwd_kernel<T, VEC, VPT, G, RPB, false>
          <<<p.blocks, G * RPB, 0, s>>>(xt, wt, dyt, dxt, nullptr, rows, d,
                                        p.per_slot, eps);
    }
    return cudaGetLastError();
  }
};

// Calls f(Bwd<...>{}) with the configuration for this dtype, d and
// alignment.
template <typename T, typename F>
auto with_bwd(int d, bool aligned, F&& f) {
  constexpr int VEC = 16 / sizeof(T);
  if (!aligned || d % VEC != 0) return f(Bwd<T, 1, 0, 256, 1>{});
  if (d == 4096) return f(Bwd<T, VEC, 4096 / VEC / 256, 256, 1>{});
  if (d == 128) return f(Bwd<T, VEC, 1, 128 / VEC, VEC>{});
  return f(Bwd<T, VEC, 0, 256, 1>{});
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x and out are contiguous [rows, d],
// w is [d] of the same dtype.  Returns the CUDA error code of the launch.
int rt_rms_norm(const void* x, const void* w, void* out, int dtype, int rows,
                int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_fwd<bf16>(x, w, out, rows, d, eps, s);
  if (dtype == 0) return launch_fwd<float>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The number of fp32 partial dw rows ([slots, d]) that rt_rms_norm_bwd
// needs as `part` for these arguments (it depends on the card's SM count).
int rt_rms_norm_bwd_slots(int dtype, int rows, int d, int aligned) {
  if (rows <= 0 || d <= 0) return -1;
  auto slots = [&](auto cfg) { return decltype(cfg)::make_plan(rows).slots; };
  if (dtype == 1) return with_bwd<bf16>(d, aligned != 0, slots);
  if (dtype == 0) return with_bwd<float>(d, aligned != 0, slots);
  return -1;
}

// dx = d out / d x (null: not wanted), dw = d out / d w (null: not
// wanted; then part may be null), given x [rows, d], w [d] and
// dy [rows, d], all contiguous, of one dtype.  part is fp32
// [rt_rms_norm_bwd_slots(...), d] scratch.  `aligned` must be the value
// passed to rt_rms_norm_bwd_slots: every pointer 16-byte aligned.
int rt_rms_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                    void* dw, float* part, int dtype, int rows, int d,
                    int aligned, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (aligned && !aligned16({x, w, dy, dx, dw, part}))
    return (int)cudaErrorMisalignedAddress;
  auto run = [&](auto cfg) {
    return decltype(cfg)::run(x, w, dy, dx, dw, part, rows, d, eps, s);
  };
  if (dtype == 1) return (int)with_bwd<bf16>(d, aligned != 0, run);
  if (dtype == 0) return (int)with_bwd<float>(d, aligned != 0, run);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
