// K5: one bounded, resumable stretch of the LF walk to a sampled suffix-array
// row, one thread per row: k -> LF(k) (row primary -> 0), counting steps,
// until k % sa_intv == 0 or max_steps steps ran. The (k, steps, done)
// contract lets the host rerun the few unfinished rows at a narrow width.
//
// Replaces lariat_tpu/parallel/align_step.py `sa_walk_chunk` (an XLA
// while_loop over `lf_batch`, whose trip count is the slowest lane's).
//
// Bound on the H100: one dependent fused-row gather per step (fm.cuh `lf`);
// rows finish after about sa_intv steps on average, each thread as soon as
// its own row is sampled.

#include <cstdint>

#include "common.cuh"
#include "fm.cuh"

namespace {

template <typename IDX>
__global__ void sa_walk_kernel(const IDX* __restrict__ k_in,
                               const IDX* __restrict__ steps_in,
                               const bool* __restrict__ done_in,
                               const int32_t* __restrict__ fused,
                               const IDX* __restrict__ L2, long long primary,
                               long long seq_len, long long sa_intv_ll, int n,
                               int max_steps, IDX* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const IDX sa_intv = static_cast<IDX>(sa_intv_ll);
  IDX k = k_in[i], steps = steps_in[i];
  bool done = done_in[i] || k % sa_intv == 0;
  for (int it = 0; it < max_steps && !done; ++it) {
    k = k == f.primary ? IDX(0) : lariat::lf(f, k);
    ++steps;
    done = k % sa_intv == 0;
  }
  out[i] = k;
  out[n + i] = steps;
  out[2 * n + i] = done ? 1 : 0;
}

}  // namespace

// k, steps (n,) IDX; done (n,) bool -> out (3, n) IDX rows k, steps, done.
extern "C" int lariat_sa_walk(const void* k, const void* steps,
                              const bool* done, const int32_t* fused,
                              const void* L2, long long primary,
                              long long seq_len, long long sa_intv, int idx64,
                              int n, int max_steps, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    sa_walk_kernel<int64_t><<<lariat::blocks_for(n), lariat::kThreads, 0,
                              st>>>(
        static_cast<const int64_t*>(k), static_cast<const int64_t*>(steps),
        done, fused, static_cast<const int64_t*>(L2), primary, seq_len,
        sa_intv, n, max_steps, static_cast<int64_t*>(out));
  else
    sa_walk_kernel<int32_t><<<lariat::blocks_for(n), lariat::kThreads, 0,
                              st>>>(
        static_cast<const int32_t*>(k), static_cast<const int32_t*>(steps),
        done, fused, static_cast<const int32_t*>(L2), primary, seq_len,
        sa_intv, n, max_steps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
