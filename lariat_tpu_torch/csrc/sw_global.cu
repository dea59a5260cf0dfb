// K2: batched banded global alignment (bwa's ksw_global2 fill): the end
// score plus the H/E/F direction byte of every in-band cell, stored at
// absolute query columns.
//
// Replaces the Pallas kernel lariat_tpu/ops/sw_global_pallas.py
// `_global_kernel` (via `global_batch_pallas`). The cell is the scalar fill
// of native/ksw.cpp `ksw_global_one`, with the Pallas kernel's handling of
// rows whose band is empty (it never breaks: it writes eh_h[beg] and
// eh_e[end] and goes on), so the score agrees with the reference for every
// input. z is written whole by the kernel: in-band cells their direction
// byte, every other byte 0 (rows from tlen on, columns past the band).
//
// Bound on the H100: integer operations on the in-band cells against the
// bytes of z (tools/kernel_roofline.py). Design: one warp per task
// (common.cuh's wavefront), C query columns a lane in registers (eh_h,
// eh_e and the column's substitution profile; C = 2..6, the fewest that
// cover the task's query, tiles of 6 past 192 columns). Lane l computes row
// s - l at step s and passes to lane l + 1 the row's running h1 (H of the
// last in-band column, or the row's h1_init) and F; columns outside [beg, end)
// leave both untouched, so the band's edges come out as in the scalar loop:
// F starts at bwa's finite NEG at beg and decays by e_ins, the strict tests
// are e > t and f > t, the tie rule M >= e; a row with an empty band resets
// only eh_h[beg] and eh_e[end]. eh_h[qlen], which ends as the score, is
// kept by the last lane. __vibmax_s32 gives each max with its direction
// bit. The rows' direction bytes go to a ring of 33 rows in shared memory;
// each row, once its last lane has written it, is stored whole, task-major
// ((B, Lt, Lq)) with 16-byte stores (zeros past the lanes' columns), so z
// is written once and coalesced.
// What holds it back: the wavefront runs every column of a row, in band or
// not, so a narrow band leaves most lanes of a step predicated off.

#include <cstdint>

#include "common.cuh"

namespace {

using lariat::kFull;
using lariat::NEG;

constexpr int kRing = 33;       // z rows staged a warp (32 in flight + 1)
constexpr int kRingCols = 192;  // the widest tile, 32 lanes x 6 columns

struct GlobalArgs {
  const uint8_t* q;
  int Lq, Lt, qlen, tlen, w, o_del, e_del, o_ins, e_ins, match_sc,
      mismatch_sc, n_sc;
};

// The banded DP of one task, C columns a lane; writes rows 0..tlen-1 of z
// whole and returns eh_h[qlen] (lane 31's).
template <int C>
__device__ __forceinline__ int32_t global_dp(const GlobalArgs& x,
                                             const uint32_t* ts,
                                             uint8_t* ring,
                                             int2* brow, uint8_t* zb,
                                             int lane) {
  constexpr int W = 32 * C;
  const int qlen = x.qlen, tlen = x.tlen, w = x.w, Lq = x.Lq;
  const int gapoe_del = x.o_del + x.e_del, gapoe_ins = x.o_ins + x.e_ins;
  const uint32_t n_word = static_cast<uint32_t>(x.n_sc) & 0xFFu;
  const bool vec = (Lq & 15) == 0;
  // eh_h[qlen]: its initial value
  int32_t eh_q = qlen == 0 ? 0
                 : (qlen <= w ? -(x.o_ins + x.e_ins * qlen) : NEG);
  const int T = qlen > 0 ? (qlen + W - 1) / W : 1;
  for (int k = 0; k < T; ++k) {
    const bool last = k == T - 1;
    const int j0 = k * W + lane * C;
    uint32_t prof[C];
    int32_t eh[C], ee[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      prof[c] = lariat::sub_profile(j < qlen ? x.q[j] : 4, x.match_sc,
                                    x.mismatch_sc, x.n_sc);
      eh[c] = j == 0 ? 0 : (j <= w ? -(x.o_ins + x.e_ins * j) : NEG);
      ee[c] = NEG;
    }
    // z columns this tile stores: its own, and the last tile the rest of
    // the row (zeros past its columns)
    const int lo = k * W, hi = last ? Lq : lo + W;
    int32_t h1_in = 0, f_in = NEG;  // from the left
    int2 nxt = k > 0 && lane == 0 && tlen > 0 ? brow[0] : make_int2(0, 0);
    for (int s = 0; s < tlen + 31; ++s) {
      const int i = s - lane;
      if (k > 0 && lane == 0) {  // the previous tile's boundary of row i
        h1_in = nxt.x; f_in = nxt.y;
        if (s + 1 < tlen) nxt = brow[s + 1];
      }
      int32_t h1 = 0, f = 0;
      if (i >= 0 && i < tlen) {
        const int beg = i > w ? i - w : 0;
        const int end = min(i + w + 1, qlen);
        const int32_t h1_init =
            beg == 0 ? -(x.o_del + x.e_del * (i + 1)) : NEG;
        if (k == 0 && lane == 0) { h1_in = h1_init; f_in = NEG; }
        const uint32_t sel = ts[i];
        h1 = h1_in;
        f = f_in;
        uint32_t d2[(C + 1) / 2];  // the lane's direction bytes, two a word
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          uint32_t d = 0;
          if (j >= beg && j < end) {
            const int32_t M =
                eh[c] + lariat::sub_score(prof[c], n_word, sel);
            const int32_t e = ee[c];
            eh[c] = h1;
            bool p_me, p_hf, p_e, p_f;
            const int32_t hm = __vibmax_s32(M, e, &p_me);   // M >= e
            const int32_t h = __vibmax_s32(hm, f, &p_hf);   // h >= f
            h1 = h;
            ee[c] = __vibmax_s32(M - gapoe_del, e - x.e_del, &p_e);
            f = __vibmax_s32(M - gapoe_ins, f - x.e_ins, &p_f);
            d = (p_hf ? (p_me ? 0u : 1u) : 2u) | (p_e ? 0u : 4u)
                | (p_f ? 0u : 32u);
          }
          if (c & 1) d2[c >> 1] |= d << 8; else d2[c >> 1] = d;
        }
        // the row's edges: eh_h[end] = h1 after a non-empty band, eh_h[beg]
        // = h1_init (== h1 then) after an empty one; eh_e[end] = NEG
        const int jh = beg < end ? end : (beg <= qlen ? beg : -1);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (j0 + c == jh) eh[c] = h1;
          if (j0 + c == end) ee[c] = NEG;
        }
        if (last && lane == 31 && jh == qlen) eh_q = h1;
        if (!last && lane == 31) brow[i] = make_int2(h1, f);
        // C even: 2-byte stores (the lane's bytes start on an even
        // column); C odd: byte stores
        uint8_t* rr = ring + (i % kRing) * kRingCols + lane * C;
        if (C % 2 == 0) {
#pragma unroll
          for (int c = 0; c < C / 2; ++c)
            reinterpret_cast<uint16_t*>(rr)[c] =
                static_cast<uint16_t>(d2[c]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            rr[c] = static_cast<uint8_t>(d2[c >> 1] >> ((c & 1) * 8));
        }
      }
      h1_in = __shfl_up_sync(kFull, h1, 1);
      f_in = __shfl_up_sync(kFull, f, 1);
      __syncwarp();  // the ring row finished this step is complete
      const int r = s - 31;
      if (r >= 0 && r < tlen) {
        const uint8_t* src = ring + (r % kRing) * kRingCols - lo;
        uint8_t* dst = zb + (size_t)r * Lq;
        if (vec) {
          for (int o = lo + lane * 16; o < hi; o += 512)
            *reinterpret_cast<uint4*>(dst + o) =
                o - lo < W ? *reinterpret_cast<const uint4*>(src + o)
                           : make_uint4(0, 0, 0, 0);
        } else {
          for (int o = lo + lane; o < hi; o += 32)
            dst[o] = o - lo < W ? src[o] : 0;
        }
      }
    }
    __syncwarp();  // the boundary rows are read by the next tile's lane 0
  }
  return eh_q;
}

__device__ __forceinline__ int32_t global_dp_any(const GlobalArgs& x,
                                                 const uint32_t* ts,
                                                 uint8_t* ring, int2* brow,
                                                 uint8_t* zb, int lane) {
  // the fewest columns a lane that cover the query (warp-uniform), past
  // 192 columns tiles of 6
  const int need = (x.qlen + 31) / 32;
  if (need <= 2) return global_dp<2>(x, ts, ring, brow, zb, lane);
  if (need == 3) return global_dp<3>(x, ts, ring, brow, zb, lane);
  if (need == 4) return global_dp<4>(x, ts, ring, brow, zb, lane);
  if (need == 5) return global_dp<5>(x, ts, ring, brow, zb, lane);
  return global_dp<6>(x, ts, ring, brow, zb, lane);
}

__global__ void __launch_bounds__(lariat::kWarpsPerBlock * 32)
sw_global_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int32_t* __restrict__ qlen_v,
                 const int32_t* __restrict__ tlen_v,
                 const int32_t* __restrict__ w_v, int B, int Lq, int Lt,
                 int smem_warp, int o_del, int e_del, int o_ins, int e_ins,
                 int match_sc, int mismatch_sc, int n_sc,
                 int2* __restrict__ bnd, int32_t* __restrict__ score,
                 uint8_t* __restrict__ z) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // warp-uniform
  uint8_t* ring = smem + (size_t)warp * smem_warp;      // kRing x 192
  // the target rows' PRMT selectors
  uint32_t* ts = reinterpret_cast<uint32_t*>(ring + kRing * kRingCols);
  const GlobalArgs x{q + (size_t)b * Lq, Lq, Lt, max(min(qlen_v[b], Lq), 0),
                     max(min(tlen_v[b], Lt), 0), w_v[b], o_del, e_del,
                     o_ins, e_ins, match_sc, mismatch_sc, n_sc};
  for (int i = lane; i < x.tlen; i += 32)
    ts[i] = lariat::sub_selector(t[(size_t)b * Lt + i]);
  __syncwarp();
  uint8_t* zb = z + (size_t)b * Lt * Lq;
  int2* brow = bnd + (size_t)b * Lt;
  const int32_t eh_q = global_dp_any(x, ts, ring, brow, zb, lane);
  // the rows from tlen on are all zeros
  lariat::warp_zero(zb + (size_t)x.tlen * Lq, (size_t)(Lt - x.tlen) * Lq,
                    lane);
  if (lane == 31) score[b] = eh_q;
}

}  // namespace

// q (B, Lq) / t (B, Lt) uint8 codes, task-major; qlen/tlen/w (B,) int32;
// bnd (B, Lt) int2 scratch, used only when Lq > 192 (else it may be a single
// element); score (B,) int32; z (B, Lt, Lq) uint8, every byte written.
extern "C" int lariat_sw_global(
    const uint8_t* q, const uint8_t* t, const int32_t* qlen,
    const int32_t* tlen, const int32_t* w, int B, int Lq, int Lt, int o_del,
    int e_del, int o_ins, int e_ins, int match_sc, int mismatch_sc, int n_sc,
    int32_t* bnd, int32_t* score, uint8_t* z, void* stream) {
  if (B <= 0) return 0;
  // a warp's shared memory: the ring of z rows, then the target rows'
  // selectors
  const int smem_warp = kRing * kRingCols + 4 * ((Lt + 3) & ~3);
  const int wpb = lariat::warps_per_block(smem_warp);
  const int smem = smem_warp * wpb;
  const cudaError_t err = lariat::raise_smem_cap(sw_global_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_global_kernel<<<(B + wpb - 1) / wpb, wpb * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, t, qlen, tlen, w, B, Lq, Lt, smem_warp, o_del, e_del, o_ins, e_ins,
      match_sc, mismatch_sc, n_sc, reinterpret_cast<int2*>(bnd), score, z);
  return static_cast<int>(cudaGetLastError());
}
