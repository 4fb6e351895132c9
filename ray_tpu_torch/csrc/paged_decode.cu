// Paged-attention decode (K5) for Hopper, sm_90a.
//
// Replaces no Pallas kernel: the JAX package's decode step
// (ray_tpu/models/paged.py: paged_decode_step) gathers each slot's whole
// page table into a linear view, repeats K and V for GQA and attends it
// with plain XLA ops.  On the card those copies (gather, permute, GQA
// repeat, fp32 cast) took most of the serve engine's decode step while
// only the pages below each slot's length are attended.  K5 computes the
// same function from the pools in place:
//   out[b, h] = softmax_j(q[b, h] . k[b, j] * scale) . v[b, j],
//   j = 0..seq_lens[b],
// where position j of slot b is row j % page of page
// page_tables[b, j / page] of the layer's [P+1, Hkv, page, D] pools and
// kv head = h / (H / Hkv).  Scores and the softmax are fp32, computed
// from the working-dtype q and k; P.V sums in fp32; the output is rounded
// once to q's dtype.  fp32 and bf16; head_dim 32, 64 and 128; H / Hkv of
// 1, 2, 4 or 8; any power-of-two page of 1 to 64 positions.
//
// What bounds it on the H100: bytes.  Each K/V row is used by the n_rep
// query heads of its group, about 4 * n_rep / sizeof(T) FLOP a byte, far
// below the card's ridge, so the least time is the live K/V bytes (plus
// q and the output) over 3.35 TB/s.  The design, for that bound:
//
// - Only live rows are read.  A block loads its slice of the slot's page
//   table into shared memory and copies K/V rows of positions 0..seq_len
//   only; rows past seq_len in the last page are never read (their
//   copies zero-fill), nor is any page past it, nor the scratch entries.
// - GQA inside the block: one block serves one (slot, kv head, split)
//   and all n_rep query heads of the group, so each K/V row crosses the
//   memory bus once, with no repeat.
// - Flash-decoding split: each (slot, kv head) is cut into chunks of
//   `chunk` positions, one block each, so 16 slots x 8 kv heads of long
//   sequences still fill 132 SMs.  The grid is (ceil(MAXP * page /
//   chunk), Hkv, B) and chunk follows B x Hkv: CHUNK, or 2 CHUNK where
//   the rows alone are twice the SMs (fewer blocks that exit at once,
//   fewer splits to merge).  Shapes only, so the launch is the same every
//   step and reads no length on the host; a block whose chunk starts past
//   seq_len exits at once.  A slot short enough for one split writes its
//   output straight away; otherwise each split writes its unnormalised
//   fp32 partial (max m, sum l, accumulator) and the last split of the
//   (slot, kv head) to finish, told by an atomic count that it resets,
//   merges them: one launch a layer.
// - Bytes in flight: K and V tiles are copied by cp.async (16-byte
//   copies, whole page rows) into a ring of stages in shared memory, so
//   the next tiles are in flight while one is reduced.  Each warp copies
//   exactly the rows it reduces, so a warp waits on its own copies and
//   the loop has no block barrier.
// - Few instructions a byte.  Every instruction of the loop is paid per
//   byte, and a block left alone at the end of the grid runs at the rate
//   its warps issue.  On CUDA cores the loop took ~780 instructions per 32
//   positions a warp (most of them the 2 x D fp32 multiply-adds a row and
//   head), which held a block alone to ~22 GB/s.  So bf16, the serving
//   dtype, runs on the tensor cores (mma.sync m16n8k16): a warp takes 16
//   positions at a time, with the n_rep query heads of the group as the
//   rows of the 16-row A operand (the rest zero).  S = Q.K^T reads K by
//   ldmatrix from a swizzled tile (exact bf16 products, fp32 sums); the
//   online softmax runs on the fp32 accumulators in log2 units; S's
//   accumulators are P's A fragments for P.V, with V read by transposing
//   ldmatrix.  P enters P.V as two bf16 terms, hi = bf16(p) and lo =
//   bf16(p - hi), so it keeps ~16 bits (the gather rounded P to bf16,
//   8 bits); products are exact, sums fp32.  fp32 inputs (the tiny model)
//   stay on CUDA cores in fp32: a row's D values spread over D / 4 lanes,
//   the n_rep dot products closed by a transposing butterfly, p shared by
//   shuffle.  wgmma would not help: n_rep query rows are far from its 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;  // threads a block: four warps
constexpr int NW = NT / 32;
constexpr int CHUNK = 256;            // positions a split (or 2 CHUNK)
constexpr int MMA_STAGES = 2;         // tensor cores: 64 rows a stage
constexpr int FMA_TILE_BYTES = 8192;  // CUDA cores: of K (and V) a stage
constexpr int FMA_STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// VEC elements of T: one 16-byte load.
template <typename T>
struct alignas(16) Vec {
  T e[16 / sizeof(T)];
};

// Positions of slot b attended: 0..seq_len, at least position 0 and at
// most the table's.
__device__ __forceinline__ int live_positions(const int* lens, int b,
                                              int n_ctx) {
  return min(max(lens[b], 0) + 1, n_ctx);
}

// Floats of a block's end, over its idle ring: acc [SLOTS][NREP][D], then
// l, m and the merge weights [SLOTS][NREP], then M and L [NREP].  SLOTS
// are the block's separate softmaxes.
template <int D, int NREP, int SLOTS>
constexpr int end_floats() {
  return SLOTS * NREP * (D + 3) + 2 * NREP;
}

// The block's split of (slot b, kv head g).
struct Split {
  int b, g, split, p0, p_end, ns, n_tiles;
};

// This block's split, or false if its chunk starts past seq_len.
template <int TP>
__device__ __forceinline__ bool my_split(Split& s, const int* lens,
                                         int n_ctx, int chunk) {
  s.split = blockIdx.x;
  s.g = blockIdx.y;
  s.b = blockIdx.z;
  const int n_pos = live_positions(lens, s.b, n_ctx);
  s.p0 = s.split * chunk;
  if (s.p0 >= n_pos) return false;
  s.p_end = min(s.p0 + chunk, n_pos);
  s.ns = (n_pos + chunk - 1) / chunk;
  s.n_tiles = (s.p_end - s.p0 + TP - 1) / TP;
  return true;
}

// The split's slice of the page table (pages of positions p0..p_end-1)
// into tbl; ends with a block barrier.
__device__ __forceinline__ void load_table(int* tbl, const int* tables,
                                           const Split& s, int maxp,
                                           int ps_shift) {
  const int pg0 = s.p0 >> ps_shift;
  const int n_pg = ((s.p_end - 1) >> ps_shift) - pg0 + 1;
  for (int i = threadIdx.x; i < n_pg; i += NT)
    tbl[i] = tables[(int64_t)s.b * maxp + pg0 + i];
  __syncthreads();
}

// Element offset in the pool of position p's row at column col of its
// kv head (col includes the head's offset).  A row past p_end takes
// position p0's: a valid address, copied as zeros.
__device__ __forceinline__ int64_t row_offset(const int* tbl, int p,
                                              const Split& s, int ps_shift,
                                              int64_t sp, int sr, int col) {
  const int pl = p < s.p_end ? p : s.p0;
  return (int64_t)tbl[(pl >> ps_shift) - (s.p0 >> ps_shift)] * sp +
         ((pl & ((1 << ps_shift) - 1)) * sr + col);
}

// The block's end, once every slot has put its (acc, l, m) in red, lred
// and mred and the block has synchronised: merge the slots; a single
// split writes the output, otherwise the split writes its partial and the
// last split of (slot, kv head) to finish merges every split's.
template <typename T, int D, int NREP, int SLOTS>
__device__ __forceinline__ void finish(float* red, const Split& s, T* out,
                                       float* part, int* counts, int H,
                                       int n_split, int* last) {
  float* lred = red + SLOTS * NREP * D;
  float* mred = lred + SLOTS * NREP;
  float* wred = mred + SLOTS * NREP;
  float* Ms = wred + SLOTS * NREP;
  float* Ls = Ms + NREP;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < NREP) {
    const int n = threadIdx.x;
    float M = -INFINITY, L = 0.f;
    for (int i = 0; i < SLOTS; ++i) M = fmaxf(M, mred[i * NREP + n]);
    for (int i = 0; i < SLOTS; ++i) {
      const float w = exp2f(mred[i * NREP + n] - M);  // 0 for an idle slot
      wred[i * NREP + n] = w;
      L += w * lred[i * NREP + n];
    }
    Ms[n] = M;
    Ls[n] = L;
  }
  __syncthreads();
  const int64_t row0 = (int64_t)s.b * H + s.g * NREP;  // first head's row
  for (int i = threadIdx.x; i < NREP * D; i += NT) {
    const int n = i / D, d = i % D;
    float o = 0.f;
#pragma unroll 4
    for (int k = 0; k < SLOTS; ++k)
      o += wred[k * NREP + n] * red[(k * NREP + n) * D + d];
    if (s.ns == 1)
      out[(row0 + n) * D + d] = rt::from_f32<T>(o / Ls[n]);
    else
      part[((row0 + n) * n_split + s.split) * (D + 2) + d] = o;
  }
  if (s.ns == 1) return;
  if (threadIdx.x < NREP) {
    float* ml =
        part + ((row0 + threadIdx.x) * n_split + s.split) * (D + 2) + D;
    ml[0] = Ms[threadIdx.x];
    ml[1] = Ls[threadIdx.x];
  }

  // The last split of (slot, kv head) to finish merges the partials.
  __threadfence();
  __syncthreads();
  int* count = counts + (int64_t)s.b * gridDim.y + s.g;
  if (threadIdx.x == 0) {
    const bool done = atomicAdd(count, 1) == s.ns - 1;
    if (done) *count = 0;  // every split has counted: ready for the next
    *last = done;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // A warp a head weighs the splits, w = 2^(m - M) / L, into red; then
  // every thread sums its (head, d) over them.
  float* wts = red;  // [NREP][n_split]
  for (int n = threadIdx.x / 32; n < NREP; n += NW) {
    const float* pr = part + (row0 + n) * n_split * (D + 2) + D;
    float M = -INFINITY, L = 0.f;
    for (int k = lane; k < s.ns; k += 32)
      M = fmaxf(M, __ldcg(pr + k * (D + 2)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    for (int k = lane; k < s.ns; k += 32) {
      const float w = exp2f(__ldcg(pr + k * (D + 2)) - M);
      wts[n * n_split + k] = w;
      L += w * __ldcg(pr + k * (D + 2) + 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    for (int k = lane; k < s.ns; k += 32) wts[n * n_split + k] /= L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NREP * D; i += NT) {
    const int n = i / D, d = i % D;
    const float* pr = part + (row0 + n) * n_split * (D + 2) + d;
    float o = 0.f;
#pragma unroll 8
    for (int k = 0; k < s.ns; ++k)
      o += wts[n * n_split + k] * __ldcg(pr + k * (D + 2));
    out[(row0 + n) * D + d] = rt::from_f32<T>(o);
  }
}

// ------------------------------------------------- tensor cores (bf16)

template <int D, int NREP>
struct Mma {
  static constexpr int CH = D / 8;     // 16-byte chunks a row
  static constexpr int TP = 16 * NW;   // rows a stage: 16 a warp
  static constexpr int ROW_BYTES = D * 2;
  static constexpr int TILE_BYTES = TP * ROW_BYTES;  // of K, as many of V
  static constexpr int RING = MMA_STAGES * 2 * TILE_BYTES;
  static constexpr int END = end_floats<D, NREP, NW>() * 4;
  static constexpr int BODY = RING > END ? RING : END;
  static constexpr size_t SMEM = (size_t)BODY + 2 * CHUNK * 4 + 16;
  static constexpr int COPIES = 16 * CH / 32;  // 16-byte copies a lane
  static_assert(NREP <= 8 && CHUNK % TP == 0 && 16 * CH % 32 == 0,
                "a warp's 16 rows in whole copies");
};

// Byte offset of chunk c of row r in a tile of CH-chunk rows, swizzled so
// that ldmatrix's 8 rows of one logical chunk fall in 8 different bank
// groups (CH = 4: 64-byte rows, two to a 128-byte line).
template <int CH>
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
  const int x = CH >= 8 ? (r & 7) : ((r >> 1) & 3);
  return (uint32_t)(r * CH + (c ^ x)) * 16;
}

template <int D, int NREP>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ kp,
                        const bf16* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, bf16* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counts,
                        int H, int maxp, int ps_shift, int chunk,
                        int n_split, int64_t q_sb, int64_t q_sh, int64_t sp,
                        int sh, int sr, float scale) {
  using G = Mma<D, NREP>;
  constexpr int CH = G::CH, TP = G::TP, KS = D / 16;
  Split s;
  if (!my_split<TP>(s, lens, maxp << ps_shift, chunk)) return;

  extern __shared__ __align__(128) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem + G::BODY);
  load_table(tbl, tables, s, maxp, ps_shift);

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;  // the fragments' (g, t)
  const uint32_t ring = rt::smem_u32(smem);
  // This warp's 16 rows of tile t (p0 + t * TP + 16 w ..) into stage
  // t % MMA_STAGES: the lane copies chunks lane + 32 j of the 16 x CH.
  // With pages of 16 rows or more the 16 rows (16-aligned) share a page:
  // one table read for all of them.
  const bool one_page = ps_shift >= 4;
  auto issue = [&](int t) {
    if (t < s.n_tiles) {
      const uint32_t kst = ring + (t % MMA_STAGES) * 2 * G::TILE_BYTES +
                           16 * w * G::ROW_BYTES;
      const int base = s.p0 + t * TP + 16 * w;
      const int64_t o0 =
          one_page ? row_offset(tbl, base, s, ps_shift, sp, sr, s.g * sh)
                   : 0;
#pragma unroll
      for (int j = 0; j < G::COPIES; ++j) {
        const int i = lane + 32 * j, r = i / CH, c = i % CH;
        const int p = base + r;
        const int64_t o =
            one_page ? o0 + (r * sr + c * 8)
                     : row_offset(tbl, p, s, ps_shift, sp, sr,
                                  s.g * sh + c * 8);
        const uint32_t dst = kst + tile_at<CH>(r, c);
        const int n = p < s.p_end ? 16 : 0;
        rt::cp_async_16(dst, kp + o, n);
        rt::cp_async_16(dst + G::TILE_BYTES, vp + o, n);
      }
    }
    rt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < MMA_STAGES - 1; ++t) issue(t);

  // Q's A fragments (rows: the group's heads, the rest zero), k-step kk:
  // qa[kk][0] = Q(g, 16 kk + 2t..), qa[kk][1] = Q(g, 16 kk + 8 + 2t..).
  uint32_t qa[KS][2];
  {
    const bf16* qr =
        q + s.b * q_sb + (int64_t)(s.g * NREP + min(gq, NREP - 1)) * q_sh;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qa[kk][h] = gq < NREP ? *reinterpret_cast<const uint32_t*>(
                                    qr + 16 * kk + 8 * h + 2 * tq)
                              : 0u;
  }
  const float qscale = scale * LOG2E;
  // acc[n]: O(g, 8 n + 2t..) in [0], [1]; rows g + 8 (zero) in [2], [3].
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // head g's; l_run this lane's part
  // ldmatrix rows and chunks of this lane's address: K as is (matrices:
  // rows 0-7 and 8-15 by lane / 16, chunk pair by (lane / 8) % 2), V
  // transposed (rows by (lane / 8) % 2, chunk pair by lane / 16).
  const int kr = 8 * (lane / 16) + lane % 8, kc = (lane / 8) % 2;
  const int vr = 8 * ((lane / 8) % 2) + lane % 8, vc = lane / 16;

  for (int t = 0; t < s.n_tiles; ++t) {
    rt::cp_async_wait<MMA_STAGES - 2>();
    __syncwarp();  // the warp's copies of tile t landed; t - 1 is read
    issue(t + MMA_STAGES - 1);
    const int base = s.p0 + t * TP + 16 * w;
    if (base >= s.p_end) continue;  // none of this warp's rows is live
    const uint32_t kst = ring + (t % MMA_STAGES) * 2 * G::TILE_BYTES +
                         16 * w * G::ROW_BYTES;
    const uint32_t vst = kst + G::TILE_BYTES;

    // S = Q.K^T over the 16 rows: sc0 at positions 2t, 2t+1, sc1 at 8 +
    // 2t, 8 + 2t + 1 (rows g; rows g + 8 are the zero heads).
    float sc0[4] = {0.f, 0.f, 0.f, 0.f}, sc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      rt::ldmatrix_x4(kb, kst + tile_at<CH>(kr, 2 * kk + kc));
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      rt::mma_bf16_16816(sc0, a, kb[0], kb[1]);
      rt::mma_bf16_16816(sc1, a, kb[2], kb[3]);
    }
    float sv[4] = {sc0[0], sc0[1], sc1[0], sc1[1]};
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = base + (e / 2) * 8 + 2 * tq + e % 2;
      sv[e] = p < s.p_end ? sv[e] * qscale : -INFINITY;
      mx = fmaxf(mx, sv[e]);
    }
    mx = rt::quad_max(mx);
    const float m_new = fmaxf(m_run, mx);  // finite: row base is live
    if (__any_sync(0xffffffffu, m_new != m_run)) {
      const float alpha = rt::ex2(m_run - m_new);  // 0 from -inf
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha;
        acc[n][1] *= alpha;
      }
      l_run *= alpha;
      m_run = m_new;
    }
    float pv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pv[e] = rt::ex2(sv[e] - m_run);
      l_run += pv[e];
    }
    // P's A fragments as hi + lo bf16 terms: positions 2t.. and 8 + 2t..
    const uint32_t hi0 = rt::pack_bf16(pv[0], pv[1]);
    const uint32_t hi1 = rt::pack_bf16(pv[2], pv[3]);
    const float2 h0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi0));
    const float2 h1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi1));
    const uint32_t ahi[4] = {hi0, 0u, hi1, 0u};
    const uint32_t alo[4] = {rt::pack_bf16(pv[0] - h0.x, pv[1] - h0.y), 0u,
                             rt::pack_bf16(pv[2] - h1.x, pv[3] - h1.y), 0u};
    // O += P.V, 16 columns of D at a time.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t vb[4];
      rt::ldmatrix_x4_trans(vb, vst + tile_at<CH>(vr, 2 * j + vc));
      rt::mma_bf16_16816(acc[2 * j], ahi, vb[0], vb[1]);
      rt::mma_bf16_16816(acc[2 * j], alo, vb[0], vb[1]);
      rt::mma_bf16_16816(acc[2 * j + 1], ahi, vb[2], vb[3]);
      rt::mma_bf16_16816(acc[2 * j + 1], alo, vb[2], vb[3]);
    }
  }

  // The warps meet over the idle ring.
  rt::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [NW][NREP][D]
  float* lred = red + NW * NREP * D;
  float* mred = lred + NW * NREP;
  const float l = rt::quad_sum(l_run);
  if (gq < NREP) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      red[(w * NREP + gq) * D + 8 * n + 2 * tq] = acc[n][0];
      red[(w * NREP + gq) * D + 8 * n + 2 * tq + 1] = acc[n][1];
    }
    if (tq == 0) {
      lred[w * NREP + gq] = l;
      mred[w * NREP + gq] = m_run;
    }
  }
  __syncthreads();
  finish<bf16, D, NREP, NW>(red, s, out, part, counts, H, n_split,
                            tbl + 2 * CHUNK);
}

// ------------------------------------------------------ CUDA cores (fp32)

template <typename T, int D, int NREP>
struct Fma {
  static constexpr int VEC = 16 / sizeof(T);  // elements a vector
  static constexpr int LR = D / VEC;          // lanes (vectors) a row
  static constexpr int SLOTS = NT / LR;       // rows a block reads at once
  static constexpr int TP = FMA_TILE_BYTES / (D * (int)sizeof(T));
  static constexpr int RPS = TP / SLOTS;      // a thread's rows a tile
  // After the butterfly a lane holds HPL heads' sums; a head's sum sits
  // in SPREAD neighbouring lanes.
  static constexpr int HPL = NREP > LR ? NREP / LR : 1;
  static constexpr int SPREAD = NREP < LR ? LR / NREP : 1;
  static constexpr int RING = FMA_STAGES * 2 * FMA_TILE_BYTES;
  static constexpr int END = end_floats<D, NREP, SLOTS>() * 4;
  static constexpr int BODY = RING > END ? RING : END;
  static constexpr size_t SMEM = (size_t)BODY + 2 * CHUNK * 4 + 16;
  static_assert(LR <= 32 && 32 % LR == 0, "a row within one warp");
  static_assert(TP % SLOTS == 0 && CHUNK % TP == 0, "tiles of whole slots");
};

// Sum v[0..N) over the lanes of a row group by xor offsets O, O/2, .., 1.
// While N > 1 each step keeps half of the sums (the upper half in lanes
// whose bit O is set) and swaps the other half with the partner lane, so
// the lane's first sums are heads head0 + i, head0 = sum of the kept
// halves' offsets.
template <int M, int N, int O>
__device__ __forceinline__ void fold(float (&v)[M], int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int HALF = N / 2;
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = upper ? v[i] : v[i + HALF];
        const float keep = upper ? v[i + HALF] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      fold<M, HALF, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      fold<M, 1, O / 2>(v, lane);
    }
  }
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(NT)
    paged_decode_fma_kernel(const T* __restrict__ q,
                            const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            T* __restrict__ out, float* __restrict__ part,
                            int* __restrict__ counts, int H, int maxp,
                            int ps_shift, int chunk, int n_split,
                            int64_t q_sb, int64_t q_sh, int64_t sp, int sh,
                            int sr, float scale) {
  using G = Fma<T, D, NREP>;
  constexpr int VEC = G::VEC, LR = G::LR, SLOTS = G::SLOTS, TP = G::TP;
  constexpr int RPS = G::RPS, HPL = G::HPL, SPREAD = G::SPREAD;
  constexpr int TILE = FMA_TILE_BYTES / sizeof(T);  // elements a tile
  Split s;
  if (!my_split<TP>(s, lens, maxp << ps_shift, chunk)) return;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // FMA_STAGES x {K tile, V tile}
  int* tbl = reinterpret_cast<int*>(smem + G::BODY);
  load_table(tbl, tables, s, maxp, ps_shift);

  const int lane = threadIdx.x % 32;
  const int slot = threadIdx.x / LR, c = threadIdx.x % LR;
  const int gb = lane & ~(LR - 1);               // the row group's lane 0
  const int head0 = (lane % LR) * HPL / SPREAD;  // this lane's first head
  const uint32_t ring_u32 =
      rt::smem_u32(ring) + (slot * D + c * VEC) * (int)sizeof(T);
  // This thread's rows of tile t (p0 + t * TP + slot + j * SLOTS) and
  // 16-byte column c into stage t % FMA_STAGES: exactly what it reduces.
  auto issue = [&](int t) {
    if (t < s.n_tiles) {
      const uint32_t dst0 =
          ring_u32 + (t % FMA_STAGES) * 2 * FMA_TILE_BYTES;
      const int p = s.p0 + t * TP + slot;
#pragma unroll
      for (int j = 0; j < RPS; ++j) {
        const int pj = p + j * SLOTS;
        const int64_t o =
            row_offset(tbl, pj, s, ps_shift, sp, sr, s.g * sh + c * VEC);
        const uint32_t dst = dst0 + j * SLOTS * D * (int)sizeof(T);
        const int n = pj < s.p_end ? 16 : 0;
        rt::cp_async_16(dst, kp + o, n);
        rt::cp_async_16(dst + FMA_TILE_BYTES, vp + o, n);
      }
    }
    rt::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < FMA_STAGES - 1; ++t) issue(t);

  const int h0 = s.g * NREP;
  const float qscale = scale * LOG2E;
  float qf[NREP][VEC], acc[NREP][VEC], m_run[HPL], l_run[HPL];
#pragma unroll
  for (int n = 0; n < NREP; ++n) {
    const Vec<T> qv = *reinterpret_cast<const Vec<T>*>(
        q + s.b * q_sb + (int64_t)(h0 + n) * q_sh + c * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[n][e] = to_f(qv.e[e]);
      acc[n][e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < HPL; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int t = 0; t < s.n_tiles; ++t) {
    rt::cp_async_wait<FMA_STAGES - 2>();  // this thread's rows landed
    issue(t + FMA_STAGES - 1);
    const T* ks = ring + (t % FMA_STAGES) * 2 * TILE;
    const T* vs = ks + TILE;
    const int base = s.p0 + t * TP;

    // Scores of this thread's rows (log2 units), its heads only; -inf past
    // seq_len.
    float sc[RPS][HPL], mx[HPL];
#pragma unroll
    for (int i = 0; i < HPL; ++i) mx[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < RPS; ++j) {
      const int r = slot + j * SLOTS;
      const Vec<T> kv =
          *reinterpret_cast<const Vec<T>*>(ks + r * D + c * VEC);
      float sum[NREP];
#pragma unroll
      for (int n = 0; n < NREP; ++n) {
        sum[n] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) sum[n] += qf[n][e] * to_f(kv.e[e]);
      }
      fold<NREP, NREP, LR / 2>(sum, lane);
      const bool live = base + r < s.p_end;
#pragma unroll
      for (int i = 0; i < HPL; ++i) {
        sc[j][i] = live ? sum[i] * qscale : -INFINITY;
        mx[i] = fmaxf(mx[i], sc[j][i]);
      }
    }
    // The warp's max over its row groups; rescale only if it grew.
    bool grew = false;
    float alpha[HPL], m_safe[HPL];
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
#pragma unroll
      for (int o = LR; o < 32; o <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
      const float m_new = fmaxf(m_run[i], mx[i]);
      // -inf only while none of the warp's rows has been live.
      m_safe[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m_run[i] - m_safe[i]);
      grew |= m_new != m_run[i];
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int n = 0; n < NREP; ++n) {
        const float a = __shfl_sync(0xffffffffu, alpha[n % HPL],
                                    gb + (n / HPL) * SPREAD);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[n][e] *= a;
      }
    }

    // acc += p . v over this thread's rows; each lane computes its heads'
    // p and the row group shares them.
#pragma unroll
    for (int j = 0; j < RPS; ++j) {
      const int r = slot + j * SLOTS;
      const Vec<T> vv =
          *reinterpret_cast<const Vec<T>*>(vs + r * D + c * VEC);
      float pm[HPL];
#pragma unroll
      for (int i = 0; i < HPL; ++i) {
        pm[i] = exp2f(sc[j][i] - m_safe[i]);
        l_run[i] += pm[i];
      }
#pragma unroll
      for (int n = 0; n < NREP; ++n) {
        const float p = __shfl_sync(0xffffffffu, pm[n % HPL],
                                    gb + (n / HPL) * SPREAD);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[n][e] += p * to_f(vv.e[e]);
      }
    }
  }

  // The row slots meet over the idle ring.
  rt::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [SLOTS][NREP][D]
  float* lred = red + SLOTS * NREP * D;
  float* mred = lred + SLOTS * NREP;
#pragma unroll
  for (int n = 0; n < NREP; ++n)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      red[(slot * NREP + n) * D + c * VEC + e] = acc[n][e];
  if ((lane % LR) % SPREAD == 0)
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      lred[slot * NREP + head0 + i] = l_run[i];
      mred[slot * NREP + head0 + i] = m_run[i];
    }
  __syncthreads();
  finish<T, D, NREP, SLOTS>(red, s, out, part, counts, H, n_split,
                            tbl + 2 * CHUNK);
}

// ------------------------------------------------------------ launching

struct Args {
  const void *q, *k, *v;
  const int *tables, *lens;
  void* out;
  float* part;
  int* counts;
  int B, H, Hkv, maxp, ps_shift, chunk, n_split;
  const int64_t* st;  // q (batch, head), pools (page, head, row)
  float scale;
  cudaStream_t stream;
};

// The kernel of (dtype, D, n_rep) and its shared memory, both set once: the
// dynamic size and all of L1 as shared memory (several blocks an SM).
// f(kernel, smem) gets it; cudaErrorInvalidValue for what K5 does not
// take.
template <typename T, int D, int NREP, typename F>
cudaError_t with(F&& f) {
  constexpr bool tc = sizeof(T) == 2;
  constexpr size_t smem = tc ? Mma<D, NREP>::SMEM : Fma<T, D, NREP>::SMEM;
  auto kern = [] {
    if constexpr (tc)
      return paged_decode_kernel<D, NREP>;
    else
      return paged_decode_fma_kernel<float, D, NREP>;
  }();
  static const cudaError_t ready = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (ready != cudaSuccess) return ready;
  return f(kern, smem);
}

template <typename T, typename F>
cudaError_t dispatch(int D, int n_rep, F&& f) {
#define RT_K5(DD, N) \
  if (D == DD && n_rep == N) return with<T, DD, N>(f);
  RT_K5(32, 1) RT_K5(32, 2) RT_K5(32, 4) RT_K5(32, 8)
  RT_K5(64, 1) RT_K5(64, 2) RT_K5(64, 4) RT_K5(64, 8)
  RT_K5(128, 1) RT_K5(128, 2) RT_K5(128, 4) RT_K5(128, 8)
#undef RT_K5
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(int D, int n_rep, const Args& a) {
  return dispatch<T>(D, n_rep, [&](auto kern, size_t smem) {
    kern<<<dim3(a.n_split, a.Hkv, a.B), NT, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.tables, a.lens, static_cast<T*>(a.out),
        a.part, a.counts, a.H, a.maxp, a.ps_shift, a.chunk, a.n_split,
        a.st[0], a.st[1], a.st[2], (int)a.st[3], (int)a.st[4], a.scale);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Positions a split covers for B slots of Hkv kv heads on the current
// card: the wrapper sizes the grid and the partials as ceil(MAXP * page /
// chunk) splits.  -1 if the card cannot be read.
int rt_paged_decode_chunk(int B, int Hkv) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return B * Hkv >= 2 * sms ? 2 * CHUNK : CHUNK;
}

// dtype: 0 = float32, 1 = bfloat16.  q [B, H, D] through its (batch,
// head) element strides, the layer's pools k, v [P+1, Hkv, page, D]
// through their common (page, head, row) element strides: strides holds
// those 5; last dims contiguous, rows 16-byte aligned.  tables:
// contiguous int32 [B, maxp]; lens: int32 [B]; page = 1 << ps_shift.
// chunk: rt_paged_decode_chunk(B, Hkv), n_split = ceil(maxp * page /
// chunk).  out: contiguous [B, H, D]; part: fp32 scratch [B, H, n_split,
// D + 2];
// counts: int32 [B, Hkv], zero before the first launch (each launch
// leaves it zero).  Returns the CUDA error code of the launch.
int rt_paged_decode(const void* q, const void* k, const void* v,
                    const int* tables, const int* lens, void* out,
                    float* part, int* counts, int dtype, int B, int H,
                    int Hkv, int D, int maxp, int ps_shift, int chunk,
                    int n_split, const int64_t* strides, float scale,
                    void* stream) {
  // The merge weighs n_rep x n_split splits over the idle ring (at least
  // 16 KB).
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || ps_shift < 0 || ps_shift > 6 ||
      (chunk != CHUNK && chunk != 2 * CHUNK) ||
      n_split != ((maxp << ps_shift) + chunk - 1) / chunk ||
      (H / Hkv) * n_split > 4096 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,        v,       tables, lens,  out,
               part,  counts,   B,       H,      Hkv,   maxp,
               ps_shift, chunk, n_split, strides, scale,
               static_cast<cudaStream_t>(stream)};
  const int n_rep = H / Hkv;
  if (dtype == 1) return (int)launch<bf16>(D, n_rep, a);
  if (dtype == 0) return (int)launch<float>(D, n_rep, a);
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
