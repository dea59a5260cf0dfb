// K1: batched banded seed extension (bwa's ksw_extend2), one warp per task.
//
// Replaces the Pallas kernel lariat_tpu/ops/sw_extend_pallas.py
// `_extend_kernel` (via `_extend_batch_pallas_v1`) and its grid variant
// `_extend_kernel_v2` (`extend_batch_pallas_v2`): one kernel is held
// bit-equal against both. The cell is the scalar recurrence of
// native/ksw.cpp `ksw_extend_one`, with the JAX package's z-drop rule (the
// test runs whatever the sign of zdrop, as sw_batch.extend_batch does).
//
// Bound on the H100: integer operations on the band cells of the rows a
// task really runs (11 a cell, tools/kernel_roofline.py OPS_PER_CELL); it
// moves only the codes in and 8 ints a task out. A kernel with one thread
// per task walks its cells in series, keeps its DP row in device memory
// (two loads and two stores a cell) and diverges on mixed lengths and
// z-drop exits.
//
// Design: one warp per task (common.cuh's wavefront), C = 1..8 query
// columns a lane in registers (eh_h, eh_e and the column's substitution
// profile), C the fewest that cover the task's query. Lane l runs target
// row s - l at step s and hands lane l + 1 the row's running h1 (H of the
// last band cell, or the row's h1_init), F, and the row maximum m with its
// last argmax mj; columns outside [beg, end) pass all four on untouched,
// and a lane's own cells continue the scan (`m <= h` takes the later
// column, as in the scalar loop). eh_h[end] <- h1 and eh_e[end] <- 0 fall
// to the lane holding column end. The last lane completes the rows in
// order as the scalar loop does after each row: gscore at end == qlen, the
// strict gain, the m == 0 and z-drop stops. A stop at row r is voted to the
// warp, which leaves after about r + 32 steps; the rows other lanes ran past
// r change no output. The empty-band stop falls at row qlen + w, fixed in
// advance, so no step runs past it. A cell is one PRMT for the
// substitution score and DPX instructions (VIMNMX3 for H, VIADDMNMX relu
// for E and F, VIBMAX for the row maximum with its predicate).
//
// Three entries share the body. One takes (B, Lq) / (B, Lt) code tiles.
// The second takes a wave's (B, 9) descriptor matrix (ops/resident.py
// pack_desc, int32 or int64), the resident reads and the 2-bit pac words,
// and gathers its own inputs: a lane loads its query columns from
// reads[rid, qstart + j * qdir], and the warp decodes its target codes into
// shared memory once, a byte a row (the doubled text: a position >= l_pac
// mirrors to the complement strand) -- the wave's gathers and transposes
// folded into the kernel's loads. The third is the align step's
// (`StepFeed`): each read oriented in place to its hit's strand, against a
// forward-strand window the warp stages from the pac a word a lane -- K8
// (csrc/fetch_window.cu) and the orientation folded into the kernel's
// loads.
//
// Past 256 query columns the tiles run in turn, the row boundary (h1, F,
// m, mj) in device memory. Only the last tile's row completion can stop
// the task, so the earlier tiles run every row up to min(tlen, qlen + w):
// correct, but it pays for rows that a stopped task would skip.

#include <cstdint>
#include <cstdlib>

#include "common.cuh"

namespace {

using lariat::kFull;

constexpr int kMaxC = 8;  // query columns a lane: 256 a tile

struct Scoring {
  int o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc, mismatch_sc,
      n_sc;
};

// The (B, Lq) / (B, Lt) code tiles, task-major.
struct TileFeed {
  const uint8_t* q;
  const uint8_t* t;
  const int32_t* qlen;
  const int32_t* tlen;
  const int32_t* w;
  const int32_t* h0;
  int Lq, Lt;

  __device__ void task(int b, int& ql, int& tl, int& wb, int32_t& h) const {
    ql = min(qlen[b], Lq);
    tl = max(min(tlen[b], Lt), 0);
    wb = w[b];
    h = h0[b];
  }
  __device__ int qcode(int b, int j) const {
    return q[static_cast<size_t>(b) * Lq + j];
  }
  __device__ void targets(int b, uint8_t* ts, int n, int lane) const {
    const uint8_t* tb = t + static_cast<size_t>(b) * Lt;
    for (int i = lane; i < n; i += 32) ts[i] = tb[i];
  }
};

// A wave's descriptor rows [rid, qstart, qdir, qlen, tstart, tdir, tlen,
// h0, w] (D = int32_t or int64_t), the resident reads (n_reads, L) and the
// pac words (16 bases a word, base 0 in the high bits).
template <typename D>
struct DescFeed {
  const D* desc;
  const uint8_t* reads;
  const int32_t* pac;
  long long l_pac;
  int n_reads, L, Lq, Lt;

  __device__ void task(int b, int& ql, int& tl, int& wb, int32_t& h) const {
    const D* d = desc + static_cast<size_t>(b) * 9;
    ql = static_cast<int>(min(static_cast<long long>(d[3]),
                              static_cast<long long>(Lq)));
    tl = static_cast<int>(max(min(static_cast<long long>(d[6]),
                                  static_cast<long long>(Lt)), 0LL));
    h = static_cast<int32_t>(d[7]);
    wb = static_cast<int>(d[8]);
  }
  // reads[rid, qstart + j * qdir]; a position (or read) out of range: N
  __device__ int qcode(int b, int j) const {
    const D* d = desc + static_cast<size_t>(b) * 9;
    const long long rid = d[0];
    const long long pos = static_cast<long long>(d[1])
                          + static_cast<long long>(j) * d[2];
    if (rid < 0 || rid >= n_reads || pos < 0 || pos >= L) return 4;
    return reads[rid * L + pos];
  }
  // the doubled text at tstart + i * tdir: positions >= l_pac mirror
  // through 2 l_pac - 1 - p, complemented; outside [0, 2 l_pac): N
  __device__ void targets(int b, uint8_t* ts, int n, int lane) const {
    const D* d = desc + static_cast<size_t>(b) * 9;
    const long long t0 = d[4], td = d[5];
    for (int i = lane; i < n; i += 32) {
      const long long p = t0 + static_cast<long long>(i) * td;
      int c = 4;
      if (p >= 0 && p < 2 * l_pac) {
        const bool rev = p >= l_pac;
        const long long fwd = rev ? 2 * l_pac - 1 - p : p;
        const uint32_t word = static_cast<uint32_t>(pac[fwd >> 4]);
        c = static_cast<int>((word >> ((15 - (fwd & 15)) * 2)) & 3u);
        if (rev) c = 3 - c;
      }
      ts[i] = static_cast<uint8_t>(c);
    }
  }
};

// The align step's tasks (parallel/align_step.py `_map_and_extend`): task
// b is read b, oriented to the strand of its hit, against the window of
// the forward strand at fwd_start[b] (Lt bases), band w, h0 for every task.
// The reference builds the oriented reads (revcomp and a where over the
// whole batch) and K8's window in device memory; here a lane reads its
// query columns in place, and the warp decodes its window from the pac
// into shared memory, a lane a word.
struct StepFeed {
  const uint8_t* reads;
  const int32_t* lens;
  const int64_t* fwd_start;
  const uint8_t* is_rev;
  const int32_t* pac;
  long long l_pac;
  int L, Lt, w, h0;

  __device__ void task(int b, int& ql, int& tl, int& wb, int32_t& h) const {
    ql = min(lens[b], L);
    tl = Lt;
    wb = w;
    h = h0;
  }
  // reads[b, j], or on a reverse hit the complement of reads[b, clip(len -
  // 1 - j, 0, L - 1)] (N stays N): the reference's revcomp, read in place
  __device__ int qcode(int b, int j) const {
    const uint8_t* r = reads + static_cast<size_t>(b) * L;
    if (!is_rev[b]) return r[j];
    const int len = lens[b];
    if (j >= len) return 4;
    const int c = r[min(max(len - 1 - j, 0), L - 1)];
    return c < 4 ? 3 - c : 4;
  }
  // K8's rule: the forward-strand code at fwd_start + i, 4 outside [0,
  // l_pac) (no mirror onto the reverse strand). Lane k loads the k-th pac
  // word the window touches and writes its codes that fall in [0, n).
  __device__ void targets(int b, uint8_t* ts, int n, int lane) const {
    const long long s = fwd_start[b];
    const long long w0 = s >> 4;  // floor, negative starts too
    const int off = static_cast<int>(s - (w0 << 4));
    const int n_words = (off + n + 15) >> 4;
    for (int k = lane; k < n_words; k += 32) {
      const long long wi = w0 + k;
      const long long p0 = wi << 4;
      const uint32_t word =
          wi >= 0 && p0 < l_pac ? static_cast<uint32_t>(pac[wi]) : 0u;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = 16 * k + e - off;
        if (i >= 0 && i < n) {
          const long long p = p0 + e;
          ts[i] = p >= 0 && p < l_pac
                      ? static_cast<uint8_t>((word >> (2 * (15 - e))) & 3u)
                      : uint8_t{4};
        }
      }
    }
  }
};

// What the last lane keeps across the rows it completes.
struct RowBest {
  int32_t max_score, max_i, max_j, max_ie, gscore, max_off;
};

// The rows [0, n_rows) of one task (n_rows >= 1), C columns a lane.
// Returns whether the last lane stopped the task (warp-uniform); lane 31's
// `best` holds the outputs, and `steps` gains the warp steps run (every
// tile's). T1 (csrc/extend_ablate.cu) runs a line-for-line copy of this
// body: change both.
template <int C, class Feed>
__device__ __forceinline__ bool extend_dp(const Feed& fd, int b,
                                          const Scoring& a, int qlen, int w,
                                          int32_t h0, int n_rows,
                                          const uint8_t* ts, int4* brow,
                                          int lane, RowBest& best,
                                          int& steps) {
  constexpr int W = 32 * C;
  const int oe_del = a.o_del + a.e_del, oe_ins = a.o_ins + a.e_ins;
  const uint32_t n_word = static_cast<uint32_t>(a.n_sc) & 0xFFu;
  const int T = (qlen + W - 1) / W;
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
        const uint32_t sel = lariat::sub_selector(ts[i]);
        h1 = h1_in; f = f_in; m = m_in; mj = mj_in;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
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
            f = __viaddmax_s32_relu(M, -oe_ins, f - a.e_ins);
          } else if (j == end) {
            eh[c] = h1;
            ee[c] = 0;
          }
        }
        if (lane == 31) {
          if (!last) {
            brow[i] = make_int4(h1, f, m, mj);
          } else {  // complete row i, as the scalar loop does
            if (end == qlen && best.gscore < h1) {
              best.max_ie = i;
              best.gscore = h1;
            }
            if (m == 0) {
              stop = true;
            } else if (m > best.max_score) {  // strict: a tie never wins
              best.max_score = m;
              best.max_i = i;
              best.max_j = mj;
              best.max_off = max(best.max_off, abs(mj - i));
            } else {
              const int di = i - best.max_i, dj = mj - best.max_j;
              stop = di > dj
                         ? best.max_score - m - (di - dj) * a.e_del > a.zdrop
                         : best.max_score - m - (dj - di) * a.e_ins > a.zdrop;
            }
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

template <class Feed>
__device__ __forceinline__ bool extend_dp_any(const Feed& fd, int b,
                                              const Scoring& a, int qlen,
                                              int w, int32_t h0, int n_rows,
                                              const uint8_t* ts, int4* brow,
                                              int lane, RowBest& best,
                                              int& steps) {
  // the fewest columns a lane that cover the query (warp-uniform), past
  // 256 columns tiles of 8
  switch (min((qlen + 31) / 32, kMaxC)) {
    case 1: return extend_dp<1>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 2: return extend_dp<2>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 3: return extend_dp<3>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 4: return extend_dp<4>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 5: return extend_dp<5>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 6: return extend_dp<6>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    case 7: return extend_dp<7>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
    default: return extend_dp<8>(fd, b, a, qlen, w, h0, n_rows, ts, brow, lane, best, steps);
  }
}

// one warp (task) a block, 24 blocks an SM: 80 registers a thread. At 64
// the C = 8 path spills (measured on the H100: 84-92 bytes of spill
// stores); at 80 none does, and 24 blocks ran no slower than 16 or 20 (in
// turns on the H100, PERF.md). A block of one warp leaves the SM free to
// start the next task as soon as one leaves.
template <class Feed>
__global__ void __launch_bounds__(32, 24)
sw_extend_kernel(Feed fd, int B, int Lt, Scoring a, int4* __restrict__ bnd,
                 int32_t* __restrict__ out, int32_t* __restrict__ n_steps) {
  extern __shared__ __align__(16) uint8_t ts[];  // target codes, a byte a row
  const int lane = threadIdx.x, b = blockIdx.x;
  int qlen, tlen, w;
  int32_t h0;
  fd.task(b, qlen, tlen, w, h0);
  int32_t* o = out + b;
  if (qlen <= 0) {
    if (lane == 0) {
      o[0] = h0; o[B] = 0; o[2 * B] = 0; o[3 * B] = 0; o[4 * B] = h0;
      o[5 * B] = 0; o[6 * B] = 0; o[7 * B] = 0;
      if (n_steps) n_steps[b] = 0;
    }
    return;
  }
  // _adjust_w: divide in double, truncate toward zero (ksw_extend2)
  int max_ins = static_cast<int>(
      (static_cast<double>(qlen) * a.match_sc + a.end_bonus - a.o_ins)
          / a.e_ins + 1.0);
  int max_del = static_cast<int>(
      (static_cast<double>(qlen) * a.match_sc + a.end_bonus - a.o_del)
          / a.e_del + 1.0);
  w = min(w, min(max(max_ins, 1), max(max_del, 1)));
  // the first row whose band [beg, end) is empty: qlen + w (row 0 for a
  // negative w); the task runs the rows before it
  const int r_empty = w < 0 ? 0 : qlen + w;
  const int n_rows = min(tlen, r_empty);
  fd.targets(b, ts, n_rows, lane);
  __syncwarp();
  RowBest best{h0, -1, -1, -1, -1, 0};
  bool stopped = false;
  int steps = 0;
  if (n_rows > 0)
    stopped = extend_dp_any(fd, b, a, qlen, w, h0, n_rows, ts,
                            bnd + static_cast<size_t>(b) * Lt, lane, best,
                            steps);
  if (lane != 31) return;
  if (n_steps) n_steps[b] = steps;
  if (!stopped && n_rows < tlen) {
    // the empty row: its beg reaches qlen there (the gscore-0 case)
    const int beg = r_empty > w ? r_empty - w : 0;
    if (beg == qlen && best.gscore < 0) {
      best.max_ie = r_empty;
      best.gscore = 0;
    }
  }
  o[0] = best.max_score; o[B] = best.max_j + 1; o[2 * B] = best.max_i + 1;
  o[3 * B] = best.max_ie + 1; o[4 * B] = best.gscore; o[5 * B] = best.max_off;
  o[6 * B] = 0; o[7 * B] = 0;
}

template <class Feed>
int launch_extend(const Feed& fd, int B, int Lt, const Scoring& a,
                  int32_t* bnd, int32_t* out, int32_t* n_steps,
                  void* stream) {
  if (B <= 0) return 0;
  // the warp's shared memory: its target codes, a byte a row (a target
  // past the card's 227 KB fails with its CUDA error)
  const int smem = (Lt + 15) & ~15;
  const cudaError_t err = lariat::raise_smem_cap(sw_extend_kernel<Feed>,
                                                 smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_extend_kernel<Feed><<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      fd, B, Lt, a, reinterpret_cast<int4*>(bnd), out, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Lq) / t (B, Lt) uint8 codes, task-major; qlen/tlen/w/h0 (B,)
// int32; bnd (B, Lt) int4 scratch, used only when Lq > 256 (else it may be
// a single element); out (8, B) int32 rows score, qle, tle, gtle, gscore,
// max_off, 0, 0; n_steps (B,) int32, or null: each task's warp steps, the
// column tiles' summed (the kernel's own count of its schedule).
extern "C" int lariat_sw_extend(
    const uint8_t* q, const uint8_t* t, const int32_t* qlen,
    const int32_t* tlen, const int32_t* w, const int32_t* h0, int B, int Lq,
    int Lt, int o_del, int e_del, int o_ins, int e_ins, int end_bonus,
    int zdrop, int match_sc, int mismatch_sc, int n_sc, int32_t* bnd,
    int32_t* out, int32_t* n_steps, void* stream) {
  const TileFeed fd{q, t, qlen, tlen, w, h0, Lq, Lt};
  const Scoring a{o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc,
                  mismatch_sc, n_sc};
  return launch_extend(fd, B, Lt, a, bnd, out, n_steps, stream);
}

// desc (B, 9) int32 (desc64 = 0) or int64 descriptor rows; reads
// (n_reads, L) uint8; pac int32 words of the l_pac-base forward strand;
// Lq / Lt cap qlen / tlen as the tiles' widths do; bnd, out and n_steps as
// above.
extern "C" int lariat_sw_extend_desc(
    const void* desc, int desc64, const uint8_t* reads, int n_reads, int L,
    const int32_t* pac, long long l_pac, int B, int Lq, int Lt, int o_del,
    int e_del, int o_ins, int e_ins, int end_bonus, int zdrop, int match_sc,
    int mismatch_sc, int n_sc, int32_t* bnd, int32_t* out, int32_t* n_steps,
    void* stream) {
  const Scoring a{o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc,
                  mismatch_sc, n_sc};
  if (desc64) {
    const DescFeed<int64_t> fd{static_cast<const int64_t*>(desc), reads, pac,
                               l_pac, n_reads, L, Lq, Lt};
    return launch_extend(fd, B, Lt, a, bnd, out, n_steps, stream);
  }
  const DescFeed<int32_t> fd{static_cast<const int32_t*>(desc), reads, pac,
                             l_pac, n_reads, L, Lq, Lt};
  return launch_extend(fd, B, Lt, a, bnd, out, n_steps, stream);
}

// The align step: reads (B, L) uint8, lens (B,) int32, fwd_start (B,)
// int64, is_rev (B,) bool bytes; pac int32 words of the l_pac-base forward
// strand; every task's window is Lt bases, its band w and its h0 h0; bnd,
// out and n_steps as above (bnd past 256 query columns, with Lq = L).
extern "C" int lariat_sw_extend_step(
    const uint8_t* reads, const int32_t* lens, const int64_t* fwd_start,
    const uint8_t* is_rev, const int32_t* pac, long long l_pac, int B, int L,
    int Lt, int w, int h0, int o_del, int e_del, int o_ins, int e_ins,
    int end_bonus, int zdrop, int match_sc, int mismatch_sc, int n_sc,
    int32_t* bnd, int32_t* out, int32_t* n_steps, void* stream) {
  const StepFeed fd{reads, lens, fwd_start, is_rev, pac, l_pac, L, Lt, w, h0};
  const Scoring a{o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc,
                  mismatch_sc, n_sc};
  return launch_extend(fd, B, Lt, a, bnd, out, n_steps, stream);
}
