// T1: the seed-extension ablation, one task per thread. Timing only: every
// variant except the baseline computes a deliberately wrong function.
//
// Replaces the Pallas kernel tools/extend_ablate.py `make_kernel` (via
// `run_variant`). It computes what that kernel computes, for every
// combination of the three switches and any Lt: a banded ksw_extend2 pass
// with no _adjust_w, no qlen == 0 shortcut and no end bonus, whose output
// rows are alive, max_score, max_i, max_j, max_ie, gscore (raw indices, not
// +1), then two zero rows. `alive` is judged against the true tlen, so it
// stays 1 for a lane that never died when tlen > Lt. On a row whose band
// holds only zeros the argmax is Lq - 1, as the Pallas kernel's packed
// max over every query row gives it (that packing needs Lq < 1024; this
// kernel does not).
//
// The point of T1 on the H100 is to find which part of K1
// (csrc/sw_extend.cu) bounds it, so its control flow is K1's: one thread per
// task, DP rows in the task-minor scratch [j * B + b], transposed uint8
// codes, a row loop over the band [beg, end) and an early exit once the lane
// is dead (every output is gated by in_row and alive never comes back, so
// the exit is exact). What each switch removes from K1's cost:
//   CUMMAX=false    F's running max along the row (K1's `f -= e_ins; f =
//                   max(f, t)` chain): F becomes max(M[j-1] - oe_ins, 0),
//                   gap opening only, so the cell loses one dependent max;
//   TROW=false      the per-row load of the target code (K1's tT[i * B + b]):
//                   every row scores against the code of row 0;
//   WRITEBACK=false the masked write-back of the DP row: the row is stored
//                   whole, all Lq + 1 columns of eh_h and eh_e every row,
//                   with E decaying as max(E - e_del, 0) out of the band.
//                   With one thread per task that stores more than K1 does,
//                   so this variant may well be slower than the baseline.
//
// Bound on the H100: as K1, a latency-bound integer DP with a data-dependent
// early exit and no tensor-core work.

#include <cstdint>

#include "common.cuh"

namespace {

using lariat::score_sub;

template <bool CUMMAX, bool TROW, bool WRITEBACK>
__global__ void extend_ablate_kernel(
    const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
    const int32_t* __restrict__ params, int B, int Lq, int Lt, int o_del,
    int e_del, int o_ins, int e_ins, int zdrop, int match_sc, int mismatch_sc,
    int n_sc, int32_t* __restrict__ eh_h, int32_t* __restrict__ eh_e,
    int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* p = params + (size_t)b * 8;
  const int qlen = p[0], tlen = p[1], w = p[2];
  const int32_t h0 = p[3];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int32_t e_floor = -oe_del > 0 ? -oe_del : 0;  // max(0 - oe_del, 0)
  int32_t alive = (tlen > 0 && qlen > 0) ? 1 : 0;
  int32_t max_score = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
#define EH(j) eh_h[(size_t)(j) * B + b]
#define EE(j) eh_e[(size_t)(j) * B + b]
  if (alive) {
    // first row: h0 - oe_ins - (j - 1) * e_ins while > 0, h0 at j = 0,
    // zero past qlen; E zero everywhere
    for (int j = 0; j <= Lq; ++j) {
      int32_t v = h0 - oe_ins - (j - 1) * e_ins;
      v = v > 0 ? v : 0;
      if (j == 0) v = h0;
      EH(j) = j <= qlen ? v : 0;
      EE(j) = 0;
    }
  }
  const int rows = tlen < Lt ? tlen : Lt;
  for (int i = 0; alive && i < rows; ++i) {
    const int beg = i > w ? i - w : 0;
    const int end = min(i + w + 1, qlen);
    const int endc = min(end, Lq);  // the band's end inside the scratch
    int32_t h1_init = h0 - (o_del + e_del * (i + 1));
    h1_init = beg == 0 ? (h1_init > 0 ? h1_init : 0) : 0;
    const int tc = TROW ? tT[(size_t)i * B + b] : tT[b];
    int32_t f = 0, m = 0, mj = -1;
    int32_t h1 = WRITEBACK ? h1_init : 0;  // eh_h[beg] after the row
    for (int j = beg; j < endc; ++j) {
      int32_t M = EH(j), e = EE(j);
      EH(j) = h1;
      M = M ? M + score_sub(qT[(size_t)j * B + b], tc, match_sc, mismatch_sc,
                            n_sc)
            : 0;
      int32_t h = M > e ? M : e;
      h = h > f ? h : f;
      h1 = h;
      if (m <= h) { mj = j; m = h; }  // last argmax of the row
      int32_t t = M - oe_del;
      t = t > 0 ? t : 0;
      e -= e_del;
      e = e > t ? e : t;
      EE(j) = e;
      t = M - oe_ins;
      t = t > 0 ? t : 0;
      if (CUMMAX) {
        f -= e_ins;
        f = f > t ? f : t;
      } else {
        f = t;
      }
    }
    if (m == 0) mj = Lq - 1;  // an all-zero row: the packed max's last row
    // gscore: H at the band's last column when the band reaches qlen
    const bool nonempty = beg < end;
    const int32_t h_last = (nonempty && end - 1 < Lq) ? h1 : 0;
    if ((nonempty ? end == qlen : beg == qlen) && gscore < h_last) {
      gscore = h_last;
      max_ie = i;
    }
    const bool improved = m > max_score;
    const int di = i - max_i, dj = mj - max_j;
    const bool zcond =
        di > dj ? max_score - m - (di - dj) * e_del > zdrop
                : max_score - m - (dj - di) * e_ins > zdrop;
    if (improved) {
      max_score = m;
      max_i = i;
      max_j = mj;
    }
    if (m == 0 || (!improved && zcond)) {
      alive = 0;
      break;
    }
    alive = i + 1 < tlen ? 1 : 0;
    if (WRITEBACK) {
      EH(endc) = h1;
      EE(endc) = 0;
    } else {  // the whole row: H shifted by one column, E decayed
      for (int j = 0; j < beg && j < Lq; ++j) {
        EH(j) = 0;
        const int32_t e = EE(j) - e_del;
        EE(j) = e > e_floor ? e : e_floor;
      }
      EH(endc) = h1;
      for (int j = endc + 1; j <= Lq; ++j) EH(j) = 0;
      for (int j = endc; j < Lq; ++j) {
        const int32_t e = EE(j) - e_del;
        EE(j) = e > e_floor ? e : e_floor;
      }
      EE(Lq) = 0;
    }
  }
#undef EH
#undef EE
  int32_t* o = out + b;
  o[0] = alive; o[B] = max_score; o[2 * B] = max_i; o[3 * B] = max_j;
  o[4 * B] = max_ie; o[5 * B] = gscore; o[6 * B] = 0; o[7 * B] = 0;
}

template <bool C, bool T, bool W>
void launch(const uint8_t* qT, const uint8_t* tT, const int32_t* params,
            int B, int Lq, int Lt, int o_del, int e_del, int o_ins, int e_ins,
            int zdrop, int match_sc, int mismatch_sc, int n_sc,
            int32_t* eh_h, int32_t* eh_e, int32_t* out, cudaStream_t s) {
  extend_ablate_kernel<C, T, W><<<lariat::blocks_for(B), lariat::kThreads, 0,
                                  s>>>(
      qT, tT, params, B, Lq, Lt, o_del, e_del, o_ins, e_ins, zdrop, match_sc,
      mismatch_sc, n_sc, eh_h, eh_e, out);
}

}  // namespace

// qT (Lq, B) / tT (Lt, B) uint8 codes; params (B, 8) int32 rows qlen, tlen,
// w, h0, ...; eh_h/eh_e (Lq + 1, B) int32 scratch; out (8, B) int32.
// cummax/trow/writeback are 0 or 1 and pick the variant.
extern "C" int lariat_extend_ablate(
    const uint8_t* qT, const uint8_t* tT, const int32_t* params, int B,
    int Lq, int Lt, int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int match_sc, int mismatch_sc, int n_sc, int cummax, int trow,
    int writeback, int32_t* eh_h, int32_t* eh_e, int32_t* out,
    void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LARIAT_T1_ARGS                                                    \
  qT, tT, params, B, Lq, Lt, o_del, e_del, o_ins, e_ins, zdrop, match_sc, \
      mismatch_sc, n_sc, eh_h, eh_e, out, s
  switch ((cummax ? 4 : 0) | (trow ? 2 : 0) | (writeback ? 1 : 0)) {
    case 0: launch<false, false, false>(LARIAT_T1_ARGS); break;
    case 1: launch<false, false, true>(LARIAT_T1_ARGS); break;
    case 2: launch<false, true, false>(LARIAT_T1_ARGS); break;
    case 3: launch<false, true, true>(LARIAT_T1_ARGS); break;
    case 4: launch<true, false, false>(LARIAT_T1_ARGS); break;
    case 5: launch<true, false, true>(LARIAT_T1_ARGS); break;
    case 6: launch<true, true, false>(LARIAT_T1_ARGS); break;
    default: launch<true, true, true>(LARIAT_T1_ARGS); break;
  }
#undef LARIAT_T1_ARGS
  return static_cast<int>(cudaGetLastError());
}
