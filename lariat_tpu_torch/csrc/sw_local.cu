// K3: batched forward local Smith-Waterman for mate rescue (the forward
// pass of bwa's ksw_align2): best score gmax, its end te (first row reaching
// it) and qe (first argmax in that row), and the second best score2/te2
// from bwa's merged runs of row maxima.
//
// Replaces the Pallas kernel lariat_tpu/ops/sw_local_pallas.py
// `_local_kernel` (via `_run_local`, `local_batch_pallas` and
// `local_two_pass_pallas`). The cell is the scalar recurrence of
// native/ksw.cpp `local_core`; the second-best scan is the Pallas kernel's
// (bwa's stored-index quirk: a run continues only at the stored index + 1,
// and the stored index moves only when the run's maximum rises; the
// exclusion window |ci - te| <= ceil(gmax / max_sc) tested without a
// division). It takes any query length (column tiles past 32 * C).
//
// Bound on the H100: integer operations (9 a cell, tools/kernel_roofline.py
// OPS_PER_CELL); it moves only the codes in and 8 ints a task out. Design:
// one warp per task (common.cuh's wavefront), C query columns a lane in
// registers (H, E and the column's substitution profile; C = 2..6, the
// fewest that cover the task's query, tiles of 6 past 192 columns), so
// nothing of the DP touches device memory. Lane l computes row s - l at
// step s and passes to lane l + 1 its last column's H (the next lane's
// diagonal), the running F and the row's running (max, first argmax); the
// lane holding the last column completes each row in row order, so the
// first argmax and the strict `row max > gmax` test come out as in the
// scalar loop. The row maxima go to shared memory, where the last lane runs
// the second-best scan. A cell is one PRMT for the substitution score and
// DPX instructions: H = max(diag + sub, max(E, F), 0) as a max and an
// __viaddmax_s32_relu, E and F each an __viaddmax_s32_relu after the
// open term, and __vibmax_s32 for the row max with its predicate;
// `cuobjdump -sass` of the sm_90a build shows them as native VIMNMX and
// VIADDMNMX instructions (chip_smoke.py prints the counts).

#include <cstdint>

#include "common.cuh"

namespace {

using lariat::kFull;

struct LocalArgs {
  const uint8_t* q;
  int Lq, qlen, tlen, o_del, e_del, o_ins, e_ins, match_sc, mismatch_sc,
      n_sc;
};

// The forward DP of one task, C columns a lane. Lane 31 ends with the
// task's gmax, te and qe, and the row maxima in cm.
template <int C>
__device__ __forceinline__ void local_dp(const LocalArgs& x,
                                         const uint32_t* ts, int32_t* cm,
                                         int4* brow, int lane, int32_t& gmax,
                                         int32_t& te, int32_t& qe) {
  constexpr int W = 32 * C;
  const int qlen = x.qlen, tlen = x.tlen;
  const int oe_del = x.o_del + x.e_del, oe_ins = x.o_ins + x.e_ins;
  const uint32_t n_word = static_cast<uint32_t>(x.n_sc) & 0xFFu;
  const int T = (qlen + W - 1) / W;
  for (int k = 0; k < T; ++k) {
    const bool last = k == T - 1;
    const int j0 = k * W + lane * C;
    const int nv = max(min(qlen - j0, C), 0);  // valid columns of the lane
    uint32_t prof[C];
    int32_t H[C], E[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      prof[c] = lariat::sub_profile(j < qlen ? x.q[j] : 4, x.match_sc,
                                    x.mismatch_sc, x.n_sc);
      H[c] = 0;
      E[c] = 0;
    }
    // from the left: H(i, j0 - 1), F(i, j0), the row's (max, argmax)
    int32_t hl_in = 0, f_in = 0, m_in = 0, a_in = 0;
    int32_t hl_prev = 0;  // H(i - 1, j0 - 1): this row's first diagonal
    int4 nxt = k > 0 && lane == 0 && tlen > 0 ? brow[0]
                                              : make_int4(0, 0, 0, 0);
    for (int s = 0; s < tlen + 31; ++s) {
      const int i = s - lane;
      if (k > 0 && lane == 0) {  // the previous tile's boundary of row i
        hl_in = nxt.x; f_in = nxt.y; m_in = nxt.z; a_in = nxt.w;
        if (s + 1 < tlen) nxt = brow[s + 1];
      }
      const int32_t diag0 = hl_prev;
      hl_prev = hl_in;
      int32_t ho = 0, fo = 0, mo = 0, ao = 0;
      if (i >= 0 && i < tlen) {
        const uint32_t sel = ts[i];
        int32_t diag = diag0, f = f_in, m = m_in, a = a_in;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          // H = max(diag + sub, E, F, 0): VIMNMX, then VIADDMNMX relu
          const int32_t h = __viaddmax_s32_relu(
              diag, lariat::sub_score(prof[c], n_word, sel), max(E[c], f));
          diag = H[c];
          H[c] = h;
          E[c] = __viaddmax_s32_relu(E[c], -x.e_del, h - oe_del);
          f = __viaddmax_s32_relu(f, -x.e_ins, h - oe_ins);
          if (c < nv) {  // first argmax: keep the old one on a tie
            bool keep;
            m = __vibmax_s32(m, h, &keep);
            a = keep ? a : j0 + c;
          }
        }
        ho = H[C - 1]; fo = f; mo = m; ao = a;
        if (lane == 31) {
          if (last) {
            cm[i] = m;
            if (m > gmax) { gmax = m; te = i; qe = a; }
          } else {
            brow[i] = make_int4(ho, fo, mo, ao);
          }
        }
      }
      hl_in = __shfl_up_sync(kFull, ho, 1);
      f_in = __shfl_up_sync(kFull, fo, 1);
      m_in = __shfl_up_sync(kFull, mo, 1);
      a_in = __shfl_up_sync(kFull, ao, 1);
      if (lane == 0) {  // shfl_up leaves lane 0 its own values: the edge
        hl_in = 0; f_in = 0; m_in = 0; a_in = 0;
      }
    }
    __syncwarp();  // the boundary rows are read by the next tile's lane 0
  }
}

__device__ __forceinline__ void local_dp_any(const LocalArgs& x,
                                             const uint32_t* ts, int32_t* cm,
                                             int4* brow, int lane,
                                             int32_t& gmax, int32_t& te,
                                             int32_t& qe) {
  // the fewest columns a lane that cover the query (warp-uniform), past
  // 192 columns tiles of 6
  switch (min(max((x.qlen + 31) / 32, 2), 6)) {
    case 2: local_dp<2>(x, ts, cm, brow, lane, gmax, te, qe); break;
    case 3: local_dp<3>(x, ts, cm, brow, lane, gmax, te, qe); break;
    case 4: local_dp<4>(x, ts, cm, brow, lane, gmax, te, qe); break;
    case 5: local_dp<5>(x, ts, cm, brow, lane, gmax, te, qe); break;
    default: local_dp<6>(x, ts, cm, brow, lane, gmax, te, qe);
  }
}

// 8 blocks of 4 warps an SM (64 registers a thread): a wave of 4,096
// tasks, 31 an SM on 132 SMs, is resident at once
__global__ void __launch_bounds__(lariat::kWarpsPerBlock * 32, 8)
sw_local_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                const int32_t* __restrict__ qlen_v,
                const int32_t* __restrict__ tlen_v,
                const int32_t* __restrict__ minsc_v, int B, int Lq, int Lt,
                int smem_warp, int o_del, int e_del, int o_ins, int e_ins,
                int match_sc, int mismatch_sc, int n_sc,
                int4* __restrict__ bnd, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // warp-uniform
  // the target rows' PRMT selectors, then the row maxima
  uint32_t* ts = reinterpret_cast<uint32_t*>(smem + (size_t)warp * smem_warp);
  int32_t* cm = reinterpret_cast<int32_t*>(ts + ((Lt + 3) & ~3));
  const LocalArgs x{q + (size_t)b * Lq, Lq, max(min(qlen_v[b], Lq), 0),
                    max(min(tlen_v[b], Lt), 0), o_del, e_del, o_ins, e_ins,
                    match_sc, mismatch_sc, n_sc};
  const int tlen = x.tlen;
  const int max_sc = max(match_sc, 1);
  for (int i = lane; i < tlen; i += 32)
    ts[i] = lariat::sub_selector(t[(size_t)b * Lt + i]);
  __syncwarp();
  int32_t gmax = 0, te = -1, qe = -1;  // lane 31's
  int4* brow = bnd + (size_t)b * Lt;
  if (x.qlen > 0) {
    local_dp_any(x, ts, cm, brow, lane, gmax, te, qe);
  }
  if (lane != 31) return;
  // second best over the merged runs of row maxima >= minsc (a task with
  // qlen 0 has every row maximum 0)
  const int32_t minsc = minsc_v[b];
  const int32_t thr = gmax + max_sc - 1;
  int32_t run_max = -1, run_idx = -2, best2 = -1, te2 = -1;
  for (int i = 0; i < tlen; ++i) {
    const int32_t c = x.qlen > 0 ? cm[i] : 0;
    if (c < minsc) continue;
    if (run_idx + 1 != i) {
      if (run_idx >= 0 && abs(run_idx - te) * max_sc > thr
          && run_max > best2) {
        best2 = run_max;
        te2 = run_idx;
      }
      run_max = c;
      run_idx = i;
    } else if (run_max < c) {
      run_max = c;
      run_idx = i;
    }
  }
  if (run_idx >= 0 && abs(run_idx - te) * max_sc > thr && run_max > best2) {
    best2 = run_max;
    te2 = run_idx;
  }
  int32_t* o = out + b;
  o[0] = te < 0 ? 0 : gmax;
  o[B] = te;
  o[2 * B] = te < 0 ? -1 : qe;
  o[3 * B] = best2;
  o[4 * B] = te2;
  o[5 * B] = 0; o[6 * B] = 0; o[7 * B] = 0;
}

}  // namespace

// q (B, Lq) / t (B, Lt) uint8 codes, task-major; qlen/tlen/minsc (B,)
// int32; bnd (B, Lt) int4 scratch, used only when Lq > 192 (else it may be a
// single element); out (8, B) int32 rows score, te, qe, score2, te2, 0, 0,
// 0.
extern "C" int lariat_sw_local(
    const uint8_t* q, const uint8_t* t, const int32_t* qlen,
    const int32_t* tlen, const int32_t* minsc, int B, int Lq, int Lt,
    int o_del, int e_del, int o_ins, int e_ins, int match_sc, int mismatch_sc,
    int n_sc, int32_t* bnd, int32_t* out, void* stream) {
  if (B <= 0) return 0;
  // a warp's shared memory: the target rows' selectors, then the row
  // maxima
  const int smem_warp = 2 * 4 * ((Lt + 3) & ~3);
  const int wpb = lariat::warps_per_block(smem_warp);
  const int smem = smem_warp * wpb;
  const cudaError_t err = lariat::raise_smem_cap(sw_local_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_local_kernel<<<(B + wpb - 1) / wpb, wpb * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      q, t, qlen, tlen, minsc, B, Lq, Lt, smem_warp, o_del, e_del, o_ins,
      e_ins, match_sc, mismatch_sc, n_sc, reinterpret_cast<int4*>(bnd), out);
  return static_cast<int>(cudaGetLastError());
}
