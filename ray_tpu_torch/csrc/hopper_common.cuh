// Building blocks for the port's hand-written Hopper (sm_90a) kernels.
//
// Each helper wraps one PTX instruction or one layout rule, so a kernel
// reads as the algorithm and the fragment bookkeeping lives here once.
// Notation of the mma.sync fragment comments: a warp's lane is split into
// g = lane / 4 (the "group", 0..7) and t = lane % 4 (the thread in the
// group, 0..3).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// ------------------------------------------------------------ addresses

// The 32-bit shared-window address of a generic pointer into shared
// memory, as cp.async, ldmatrix and mbarrier instructions take it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Swizzled shared-memory layout of a tile whose rows are CHUNKS 16-byte
// chunks long (CHUNKS = 8 or 16: 64 or 128 bf16 values).  Chunk c of row
// r is stored at chunk (c XOR (r mod 8)) of that row.  ldmatrix reads the
// same logical chunk of 8 consecutive rows at once; unswizzled, a 128- or
// 256-byte row stride puts all 8 in the same 4 banks (an 8-way conflict),
// swizzled they cover all 32 banks.  cp.async writes through the same
// map, and for 128-byte rows from a 1024-byte aligned base it is TMA's
// and wgmma's 128-byte swizzle.  Returns the chunk index within the tile
// (multiply by 16 bytes).
template <int CHUNKS>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  static_assert(CHUNKS % 8 == 0, "rows must be a multiple of 128 bytes");
  return row * CHUNKS + (chunk ^ (row & 7));
}

// ------------------------------------------------------------- cp.async

// Asynchronous 16-byte copy global -> shared (cp.async.cg: cached in L2
// only).  The first `src_bytes` bytes come from `src`, the rest of the 16
// are zero-filled: src_bytes = 0 writes 16 zero bytes and reads nothing,
// which masks rows past a ragged tail (`src` must still be a valid
// address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 4 bytes (cp.async.ca: cached in L1 too); src_bytes 0 or 4.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Arrive at the mbarrier `bar` once every cp.async this thread issued so
// far has landed; the arrival is one of the barrier's expected count.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Close the group of cp.async copies this thread issued since the last
// commit.  An empty group is legal and keeps the group count regular.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
// It orders only this thread's copies: a __syncthreads() must follow
// before other threads read the data.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- CUDA-core fp32 tiles

// An element of the output type T (float or bf16) from fp32.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy a 64-row tile of D elements of T (float or bf16) per row, row
// stride `stride` elements, 16-byte aligned rows, into the fp32 shared
// tile dst [64][LD], converting to fp32; rows at or past `rows` are
// zero-filled so the products over them stay finite.  The NT threads of
// the block share the copy, one 16-byte load each at a time.
template <typename T, int D, int LD, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* src,
                                              int64_t stride, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
    float* d = dst + r * LD + c;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(d) = raw;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(d) = make_float4(f0.x, f0.y, f1.x, f1.y);
      *reinterpret_cast<float4*>(d + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// ------------------------------------------------------------ ldmatrix

// Four 8x8 b16 matrices from shared memory.  Lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i; every lane receives in r[i] the
// two elements (row g, columns 2t and 2t+1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed on the way: r[i] holds (rows 2t and 2t+1, column
// g) of matrix i as addressed.  Gives the B fragment of a product whose
// B is stored K-major rows ([k][n], as V in P.V).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ------------------------------------------------------------- mma.sync

// d += a . b on the tensor cores, m16n8k16, bf16 inputs, fp32 sums.
// Fragments (each uint32_t packs two bf16, the lower column in the low
// half):
//   a[0]: A(g,     2t..2t+1)   a[1]: A(g + 8, 2t..2t+1)
//   a[2]: A(g,     2t+8..+9)   a[3]: A(g + 8, 2t+8..+9)
//   b0:   B(2t..2t+1,   g)     b1:   B(2t+8..+9, g)
//   d[0], d[1]: D(g, 2t..2t+1) d[2], d[3]: D(g + 8, 2t..2t+1)
// The accumulators of two n-adjacent products, packed to bf16 with
// pack_bf16, are exactly the A fragment of the next product over that
// 16-wide dimension: P never leaves registers between S = Q.K^T and P.V.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even) in one register, lo
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (ex2.approx: relative error below
// 2^-22, subnormal results flushed to 0); ex2(0) = 1 and ex2(-inf) = 0
// exactly.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ warp reductions

// Max and sum over the 4 lanes of a group (the lanes that hold one row of
// an mma.sync accumulator).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}


// ------------------------------------------------------------- mbarrier

// A shared-memory barrier that completes a phase when `count` threads
// have arrived and every byte announced with arrive_expect_tx has landed
// (TMA copies count their bytes down on it).  Phases alternate parity
// 0, 1, 0, ...; a waiter names the parity of the phase it waits for.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make initialised barriers visible to the async proxy (TMA) and to the
// other threads; a __syncthreads() must follow.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce `bytes` more bytes for the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity `parity` has completed (try_wait may
// suspend the thread for a while before it answers false).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
      "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A phase that
// never completes is a bug; rather than hang the card, trap after about
// ten seconds (the launch then fails with an error the wrapper raises).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// The same without the guard, for a hot loop whose stall would also stall
// a guarded waiter (K3's consumers: their producer waits on them).  The
// guard in K3's consumer loop cost 10-15 % of K3's time (NVIDIA H100 80GB
// HBM3, 700 W), through how ptxas scheduled the loop around it.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar,
                                               uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A barrier over the first `count` threads of the block that reach it
// with this `id` (1..15; 0 is __syncthreads): lets some warps wait for
// each other while the rest run on.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrive at named barrier `id` without waiting: the threads that bar.sync
// on it go on once `count` threads in all have arrived or synced, and see
// the shared-memory writes made before the arrival.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ TMA

// One TMA copy of a box of a 4-d tensor (coordinates innermost first) into
// shared memory; its bytes are counted on the barrier `bar`.  `tmap` is a
// CUtensorMap passed as a __grid_constant__ kernel parameter.  Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128
// bytes, chunk c of row r at chunk c ^ (r mod 8), in 1024-byte atoms of 8
// rows).  K-major operands (contiguous along the product's depth): sbo =
// 1024, the step between 8-row groups; lbo is unused; a 16-deep slice
// further along the 128-byte row starts 32 bytes later.  MN-major
// operands (contiguous along M or N, as V in P.V): sbo = 1024 steps over
// 8 rows of depth, lbo steps to the next 64 columns of M or N.  `addr` is
// the shared-window address of the slice's first element.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Order register writes before the next wgmma reads its accumulators or
// register A operand.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the group of wgmma operations this warpgroup issued.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie a register to the asynchronous wgmma that reads or writes it: the
// compiler may not move its reads or writes across this point, nor reuse
// it before (call after wgmma_wait).
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// The products.  Accumulator layout of m64nN (per warp w of the
// warpgroup, 16 rows 16w..16w+15): d[4j + e] is the mma.sync m16n8
// accumulator of n8 tile j (rows g and g + 8, columns 2t and 2t + 1).  A
// register A operand is the mma.sync m16n8k16 A fragment of the warp's 16
// rows.  scale_d = 0 overwrites d with the product.

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// -------------------------------------------------------- tensor maps

// cuTensorMapEncodeTiled, looked up through the runtime so a library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, heads, S, D] tensor with element strides (sb,
// sh, ss) and a contiguous last dim, read in boxes of [box_rows x 64]
// into the 128-byte swizzle; rows past S read as zeros.  False if the
// driver refuses it (strides not multiples of 16 bytes, ...).
inline bool tensor_map_bf16(CUtensorMap* map, const void* ptr, int B,
                            int heads, int S, int D, int64_t sb, int64_t sh,
                            int64_t ss, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace rt
