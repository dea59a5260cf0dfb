// T1: the seed-extension ablation, on K1's warp-per-task wavefront. Timing
// only: every variant except the baseline computes a deliberately wrong
// function.
//
// Replaces the Pallas kernel tools/extend_ablate.py `make_kernel` (via
// `run_variant`). It computes what that kernel computes, for every
// combination of the three switches and any Lt: a banded ksw_extend2 pass
// with w as given (no _adjust_w), no qlen == 0 shortcut and no end bonus,
// whose output rows are alive, max_score, max_i, max_j, max_ie, gscore (raw
// indices, not +1), then two zero rows. `alive` is judged against the true
// tlen, so it stays 1 for a lane that never died when tlen > Lt. The row
// completion takes the gain before the m == 0 stop, and a row whose band
// holds only zeros has its argmax at Lq - 1, as the Pallas kernel's packed
// max(h * 1024 + j) over every query row gives it; that packing is why Lq
// stays below 1024 (the wrapper refuses more).
//
// The point of T1 on the H100 is to find which part of K1
// (csrc/sw_extend.cu) bounds it, so it runs K1's body: `extend_dp` below
// is sw_extend.cu's, line for line -- a warp a task, C columns a lane in
// registers, the (h1, F, m, mj) hand-offs by __shfl_up_sync, the target
// codes in shared memory, DPX cells, column tiles past 256 with their row
// boundaries in device memory -- templated on a policy P that carries
// three switches and T1's row completion (`AblateRows`). The baseline runs
// K1's instruction stream but for that completion. (One header shared
// with K1 cost two of K1's entries 8 SASS instructions each, on the H100,
// so K1 keeps its own copy; a change to either body goes into both, and
// into tests/test_torch_wavefront.py's and tests/test_torch_extend_
// ablate.py's emulations.) Each switch takes one of K1's costs away:
//   CUMMAX=false    F's carried chain (f = max(M - oe_ins, f - e_ins, 0)):
//                   F is max(M - oe_ins, 0) of the previous column, the
//                   hand-off of f across lanes kept;
//   TROW=false      the per-row target code from shared memory: every row
//                   scores against row 0's;
//   WRITEBACK=false the band predicate on the state: a lane updates all
//                   its columns every row with selects (H shifted one
//                   column, 0 outside the band and at its first column; E
//                   decaying as max(E - e_del, 0) outside it). K1 runs
//                   about half its lane-cell slots outside the band, so
//                   this times what the predicate costs there.
// Each task's warp steps are counted as K1's are (`n_steps`).
//
// Bound on the H100: as K1, integer operations on the band cells of the
// rows a task runs; it moves only the codes in and 8 ints a task out.

#include <cstdint>

#include "common.cuh"

namespace {

using lariat::kFull;

constexpr int kMaxC = 8;  // query columns a lane: 256 a tile

// K1's scoring but the end bonus, which T1 has not
struct Scoring {
  int o_del, e_del, o_ins, e_ins, zdrop, match_sc, mismatch_sc, n_sc;
};

// What the last lane keeps across the rows it completes (K1's, without
// max_off, which T1 does not output).
struct RowBest {
  int32_t max_score, max_i, max_j, max_ie, gscore;
};

// T1's rows: make_kernel's completion. qlen is the task's own (the body
// runs min(qlen, Lq) columns); Lq the tile width, the argmax of a row of
// zeros.
template <bool CUMMAX, bool TROW, bool WRITEBACK>
struct AblateRows {
  static constexpr bool kCummax = CUMMAX, kTrow = TROW,
                        kWriteback = WRITEBACK;
  int qlen, Lq;

  __device__ __forceinline__ bool complete(const Scoring& a, int i, int w,
                                           int beg, int, int ncols,
                                           int32_t h1, int32_t m,
                                           int32_t mj,
                                           RowBest& best) const {
    // gscore: H at the band's last column when the band reaches qlen (0
    // when that column lies past the tile; beg == qlen on an empty band)
    const int end = min(i + w + 1, qlen);
    const bool nonempty = beg < end;
    const int32_t h_last = nonempty && end <= ncols ? h1 : 0;
    if ((nonempty ? end == qlen : beg == qlen) && best.gscore < h_last) {
      best.gscore = h_last;
      best.max_ie = i;
    }
    if (m == 0) mj = Lq - 1;
    const bool improved = m > best.max_score;
    const int di = i - best.max_i, dj = mj - best.max_j;
    const bool zcond =
        di > dj ? best.max_score - m - (di - dj) * a.e_del > a.zdrop
                : best.max_score - m - (dj - di) * a.e_ins > a.zdrop;
    if (improved) {
      best.max_score = m;
      best.max_i = i;
      best.max_j = mj;
    }
    return m == 0 || (!improved && zcond);
  }
};

// The (B, Lq) query codes, task-major (what the body reads of a feed).
struct QueryFeed {
  const uint8_t* q;
  int Lq;

  __device__ int qcode(int b, int j) const {
    return q[static_cast<size_t>(b) * Lq + j];
  }
};

// The rows [0, n_rows) of one task (n_rows >= 1), C columns a lane.
// Returns whether the last lane stopped the task (warp-uniform); lane 31's
// `best` holds the outputs, and `steps` gains the warp steps run (every
// tile's). Only `fd.qcode(b, j)` is read of the feed; ts holds the target
// codes of the rows, a byte a row. Line for line sw_extend.cu's
// `extend_dp` but for P's switches and `pol.complete`.
template <int C, class P, class Feed>
__device__ __forceinline__ bool extend_dp(const Feed& fd, const P& pol,
                                          int b, const Scoring& a, int qlen,
                                          int w, int32_t h0, int n_rows,
                                          const uint8_t* ts, int4* brow,
                                          int lane, RowBest& best,
                                          int& steps) {
  constexpr int W = 32 * C;
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const uint32_t n_word = static_cast<uint32_t>(a.n_sc) & 0xFFu;
  const int T = (qlen + W - 1) / W;
  uint32_t sel0 = 0;  // row 0's selector, for every row when !kTrow
  if constexpr (!P::kTrow) sel0 = lariat::sub_selector(ts[0]);
  for (int k = 0; k < T; ++k) {
    const bool last = k == T - 1;
    const int j0 = k * W + lane * C;
    uint32_t prof[C];
    int32_t eh[C], ee[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      prof[c] = lariat::sub_profile(j < qlen ? fd.qcode(b, j) : 4,
                                    a.match_sc, a.mismatch_sc, a.n_sc);
      // the first row: h0 at column 0, then h0 - oe_ins decaying by e_ins
      // while positive
      eh[c] = j == 0 ? h0 : max(h0 - oe_ins - (j - 1) * a.e_ins, 0);
      ee[c] = 0;
    }
    // from the left: the row's running h1, F, and (m, mj)
    int32_t h1_in = 0, f_in = 0, m_in = 0, mj_in = -1;
    int4 nxt = k > 0 && lane == 0 ? brow[0] : make_int4(0, 0, 0, -1);
    for (int s = 0; s < n_rows + 31; ++s) {
      const int i = s - lane;
      if (k > 0 && lane == 0) {  // the previous tile's boundary of row i
        h1_in = nxt.x; f_in = nxt.y; m_in = nxt.z; mj_in = nxt.w;
        if (s + 1 < n_rows) nxt = brow[s + 1];
      }
      int32_t h1 = 0, f = 0, m = 0, mj = -1;
      bool stop = false;
      if (i >= 0 && i < n_rows) {
        const int beg = i > w ? i - w : 0;
        const int end = min(i + w + 1, qlen);
        if (k == 0 && lane == 0) {  // the matrix edge
          h1_in = beg == 0 ? max(h0 - (a.o_del + a.e_del * (i + 1)), 0) : 0;
          f_in = 0; m_in = 0; mj_in = -1;
        }
        const uint32_t sel = P::kTrow ? lariat::sub_selector(ts[i]) : sel0;
        h1 = h1_in; f = f_in; m = m_in; mj = mj_in;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          if constexpr (P::kWriteback) {
            if (j >= beg && j < end) {
              int32_t M = eh[c];
              eh[c] = h1;  // H(i, j - 1): the next row's diagonal
              M = M ? M + lariat::sub_score(prof[c], n_word, sel) : 0;
              const int32_t e = ee[c];
              const int32_t h = __vimax3_s32(M, e, f);
              h1 = h;
              bool later;  // m <= h: the later column wins a tie
              m = __vibmax_s32(h, m, &later);
              mj = later ? j : mj;
              ee[c] = __viaddmax_s32_relu(M, -oe_del, e - a.e_del);
              f = P::kCummax ? __viaddmax_s32_relu(M, -oe_ins, f - a.e_ins)
                             : max(M - oe_ins, 0);
            } else if (j == end) {
              eh[c] = h1;
              ee[c] = 0;
            }
          } else {  // every column, every row: selects, no branch
            const bool in = j >= beg && j < end;
            int32_t M = eh[c];
            eh[c] = j > beg && j <= end ? h1 : 0;
            M = in && M ? M + lariat::sub_score(prof[c], n_word, sel) : 0;
            const int32_t e = ee[c];
            const int32_t h = in ? __vimax3_s32(M, e, f) : 0;
            h1 = in ? h : h1;
            bool later;
            m = __vibmax_s32(h, m, &later);
            mj = later ? j : mj;
            ee[c] = __viaddmax_s32_relu(M, -oe_del, e - a.e_del);
            f = P::kCummax ? __viaddmax_s32_relu(M, -oe_ins, f - a.e_ins)
                           : max(M - oe_ins, 0);
          }
        }
        if (lane == 31) {
          if (!last) {
            brow[i] = make_int4(h1, f, m, mj);
          } else {  // complete row i, as the scalar loop does
            stop = pol.complete(a, i, w, beg, end, qlen, h1, m, mj, best);
          }
        }
      }
      h1_in = __shfl_up_sync(kFull, h1, 1);
      f_in = __shfl_up_sync(kFull, f, 1);
      m_in = __shfl_up_sync(kFull, m, 1);
      mj_in = __shfl_up_sync(kFull, mj, 1);
      if (last && __any_sync(kFull, stop)) {
        steps += s + 1;
        return true;
      }
    }
    steps += n_rows + 31;
    __syncwarp();  // the boundary rows are read by the next tile's lane 0
  }
  return false;
}

template <class P, class Feed>
__device__ __forceinline__ bool extend_dp_any(const Feed& fd, const P& pol,
                                              int b, const Scoring& a,
                                              int qlen, int w, int32_t h0,
                                              int n_rows, const uint8_t* ts,
                                              int4* brow, int lane,
                                              RowBest& best, int& steps) {
  // the fewest columns a lane that cover the query (warp-uniform), past
  // 256 columns tiles of 8
  switch (min((qlen + 31) / 32, kMaxC)) {
    case 1: return extend_dp<1>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 2: return extend_dp<2>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 3: return extend_dp<3>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 4: return extend_dp<4>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 5: return extend_dp<5>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 6: return extend_dp<6>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 7: return extend_dp<7>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    default: return extend_dp<8>(fd, pol, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
  }
}

// one warp (task) a block, K1's launch shape
template <class P>
__global__ void __launch_bounds__(32, 24)
extend_ablate_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ t,
                     const int32_t* __restrict__ params, int B, int Lq,
                     int Lt, Scoring a, int4* __restrict__ bnd,
                     int32_t* __restrict__ out,
                     int32_t* __restrict__ n_steps) {
  extern __shared__ __align__(16) uint8_t ts[];  // target codes, a byte a row
  const int lane = threadIdx.x, b = blockIdx.x;
  const int32_t* p = params + static_cast<size_t>(b) * 8;
  const int qlen = p[0], tlen = p[1], w = p[2];
  const int32_t h0 = p[3];
  int32_t* o = out + b;
  if (qlen <= 0 || tlen <= 0) {  // never alive
    if (lane == 0) {
      o[0] = 0; o[B] = h0; o[2 * B] = -1; o[3 * B] = -1; o[4 * B] = -1;
      o[5 * B] = -1; o[6 * B] = 0; o[7 * B] = 0;
      if (n_steps) n_steps[b] = 0;
    }
    return;
  }
  const int ncols = min(qlen, Lq);
  // the first row whose band holds no column stops the task (m == 0): row
  // ncols + w (row 0 for a negative w); no row past it runs
  const long long r_stop = w < 0 ? 0 : static_cast<long long>(ncols) + w;
  const int n_rows = static_cast<int>(
      min(static_cast<long long>(min(tlen, Lt)), r_stop + 1));
  const uint8_t* tb = t + static_cast<size_t>(b) * Lt;
  for (int i = lane; i < (P::kTrow ? n_rows : 1); i += 32) ts[i] = tb[i];
  __syncwarp();
  RowBest best{h0, -1, -1, -1, -1};
  int steps = 0;
  const bool stopped = extend_dp_any(
      QueryFeed{q, Lq}, P{qlen, Lq}, b, a, ncols, w, h0, n_rows, ts,
      bnd + static_cast<size_t>(b) * Lt, lane, best, steps);
  if (lane != 31) return;
  if (n_steps) n_steps[b] = steps;
  // a task that never stopped ran min(tlen, Lt) rows: alive when Lt cut it
  o[0] = !stopped && n_rows < tlen ? 1 : 0;
  o[B] = best.max_score; o[2 * B] = best.max_i; o[3 * B] = best.max_j;
  o[4 * B] = best.max_ie; o[5 * B] = best.gscore; o[6 * B] = 0;
  o[7 * B] = 0;
}

template <bool C, bool T, bool W>
int launch(const uint8_t* q, const uint8_t* t, const int32_t* params, int B,
           int Lq, int Lt, const Scoring& a, int32_t* bnd, int32_t* out,
           int32_t* n_steps, cudaStream_t s) {
  using P = AblateRows<C, T, W>;
  // the warp's shared memory: its target codes, a byte a row (a target
  // past the card's 227 KB fails with its CUDA error)
  const int smem = (Lt + 15) & ~15;
  const cudaError_t err = lariat::raise_smem_cap(extend_ablate_kernel<P>,
                                                 smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  extend_ablate_kernel<P><<<B, 32, smem, s>>>(
      q, t, params, B, Lq, Lt, a, reinterpret_cast<int4*>(bnd), out,
      n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq) / t (B, Lt) uint8 codes, task-major; params (B, 8) int32 rows
// qlen, tlen, w, h0, ... (1 <= Lq < 1024); bnd (B, Lt) int4 scratch, used
// only when Lq > 256 (else it may be a single element); out (8, B) int32;
// n_steps (B,) int32, or null: each task's warp steps. cummax/trow/
// writeback are 0 or 1 and pick the variant.
extern "C" int lariat_extend_ablate(
    const uint8_t* q, const uint8_t* t, const int32_t* params, int B,
    int Lq, int Lt, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int match_sc, int mismatch_sc, int n_sc, int cummax, int trow,
    int writeback, int32_t* bnd, int32_t* out, int32_t* n_steps,
    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scoring a{o_del, e_del, o_ins, e_ins, zdrop, match_sc, mismatch_sc,
                  n_sc};
#define LARIAT_T1_ARGS q, t, params, B, Lq, Lt, a, bnd, out, n_steps, s
  switch ((cummax ? 4 : 0) | (trow ? 2 : 0) | (writeback ? 1 : 0)) {
    case 0: return launch<false, false, false>(LARIAT_T1_ARGS);
    case 1: return launch<false, false, true>(LARIAT_T1_ARGS);
    case 2: return launch<false, true, false>(LARIAT_T1_ARGS);
    case 3: return launch<false, true, true>(LARIAT_T1_ARGS);
    case 4: return launch<true, false, false>(LARIAT_T1_ARGS);
    case 5: return launch<true, false, true>(LARIAT_T1_ARGS);
    case 6: return launch<true, true, false>(LARIAT_T1_ARGS);
    default: return launch<true, true, true>(LARIAT_T1_ARGS);
  }
#undef LARIAT_T1_ARGS
}
