// K5: one bounded, resumable stretch of the LF walk to a sampled suffix-array
// row, one thread per row: k -> LF(k) (row primary -> 0), counting steps,
// until k is a multiple of sa_intv or max_steps steps ran. The (k, steps,
// done) contract lets a caller resume unfinished rows; the SA lookup
// (parallel/align_step.py) runs the whole 512-step budget in one launch,
// since each thread leaves as soon as its own row is sampled. A second
// entry, `lariat_sa_lookup`, walks the same way from steps 0 and adds the
// sample on the card: sa_samples[k / sa_intv] + steps (int64), the index
// clamped to the samples as the reference's gather clamps it, also for a
// walk that ends without a sampled row.
//
// Replaces lariat_tpu/parallel/align_step.py `sa_walk_chunk` (an XLA
// while_loop over `lf_batch`, whose trip count is the slowest lane's), with
// its caller `sa_lookup_batch_host`'s two phases, and `sa_lookup_batch`
// (the same loop with the sample add on the device).
//
// Bound on the H100: one dependent fused-row gather per step (fm.cuh `lf`);
// rows finish after about sa_intv steps on average, and a lookup's time is
// its longest walk (about sa_intv x ln(rows) steps) times the latency of one
// step. The step is kept short: `lf` loads the row pieces it needs, and a
// power-of-two sa_intv (the index's 32) is tested with a mask instead of a
// 64-bit remainder.

#include <cstdint>

#include "common.cuh"
#include "fm.cuh"

namespace {

template <typename IDX, bool kPow2>
__global__ void __launch_bounds__(lariat::kThreads) sa_walk_kernel(
    const IDX* __restrict__ k_in, const IDX* __restrict__ steps_in,
    const bool* __restrict__ done_in, const int32_t* __restrict__ fused,
    const IDX* __restrict__ L2, long long primary, long long seq_len,
    long long sa_intv_ll, int n, int max_steps, IDX* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const IDX sa_intv = static_cast<IDX>(sa_intv_ll);
  // rows are >= 0, so the mask and the remainder agree
  const auto sampled = [=](IDX v) {
    return kPow2 ? (v & (sa_intv - 1)) == 0 : v % sa_intv == 0;
  };
  IDX k = k_in[i], steps = steps_in[i];
  bool done = done_in[i] || sampled(k);
  for (int it = 0; it < max_steps && !done; ++it) {
    k = k == f.primary ? IDX(0) : lariat::lf(f, k);
    ++steps;
    done = sampled(k);
  }
  out[i] = k;
  out[n + i] = steps;
  out[2 * n + i] = done ? 1 : 0;
}

// the walk from steps 0, then the sample add (the lookup entry)
template <typename IDX, bool kPow2>
__global__ void __launch_bounds__(lariat::kThreads) sa_lookup_kernel(
    const IDX* __restrict__ k_in, const int32_t* __restrict__ fused,
    const IDX* __restrict__ L2, long long primary, long long seq_len,
    long long sa_intv_ll, const int64_t* __restrict__ samples, long long n_sa,
    int n, int max_steps, int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const IDX sa_intv = static_cast<IDX>(sa_intv_ll);
  const auto sampled = [=](IDX v) {
    return kPow2 ? (v & (sa_intv - 1)) == 0 : v % sa_intv == 0;
  };
  IDX k = k_in[i];
  int steps = 0;
  for (bool done = sampled(k); steps < max_steps && !done;) {
    k = k == f.primary ? IDX(0) : lariat::lf(f, k);
    ++steps;
    done = sampled(k);
  }
  long long si = static_cast<long long>(k / sa_intv);
  si = si < 0 ? 0 : (si >= n_sa ? n_sa - 1 : si);
  out[i] = samples[si] + steps;
}

// a power-of-two sa_intv takes the kernel that masks
template <typename IDX>
int launch(const void* k, const void* steps, const bool* done,
           const int32_t* fused, const void* L2, long long primary,
           long long seq_len, long long sa_intv, int n, int max_steps,
           void* out, cudaStream_t st) {
  const bool pow2 = (sa_intv & (sa_intv - 1)) == 0;
  const auto kernel =
      pow2 ? &sa_walk_kernel<IDX, true> : &sa_walk_kernel<IDX, false>;
  kernel<<<lariat::blocks_for(n), lariat::kThreads, 0, st>>>(
      static_cast<const IDX*>(k), static_cast<const IDX*>(steps), done, fused,
      static_cast<const IDX*>(L2), primary, seq_len, sa_intv, n, max_steps,
      static_cast<IDX*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename IDX>
int launch_lookup(const void* k, const int32_t* fused, const void* L2,
                  long long primary, long long seq_len, long long sa_intv,
                  const int64_t* samples, long long n_sa, int n,
                  int max_steps, int64_t* out, cudaStream_t st) {
  const bool pow2 = (sa_intv & (sa_intv - 1)) == 0;
  const auto kernel =
      pow2 ? &sa_lookup_kernel<IDX, true> : &sa_lookup_kernel<IDX, false>;
  kernel<<<lariat::blocks_for(n), lariat::kThreads, 0, st>>>(
      static_cast<const IDX*>(k), fused, static_cast<const IDX*>(L2), primary,
      seq_len, sa_intv, samples, n_sa, n, max_steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, steps (n,) IDX; done (n,) bool -> out (3, n) IDX rows k, steps, done.
extern "C" int lariat_sa_walk(const void* k, const void* steps,
                              const bool* done, const int32_t* fused,
                              const void* L2, long long primary,
                              long long seq_len, long long sa_intv, int idx64,
                              int n, int max_steps, void* out, void* stream) {
  if (n <= 0) return 0;
  if (sa_intv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch<int64_t>(k, steps, done, fused, L2, primary, seq_len,
                           sa_intv, n, max_steps, out, st);
  return launch<int32_t>(k, steps, done, fused, L2, primary, seq_len,
                         sa_intv, n, max_steps, out, st);
}

// k (n,) IDX rows; samples (n_sa,) int64 -> out (n,) int64 positions.
extern "C" int lariat_sa_lookup(const void* k, const int32_t* fused,
                                const void* L2, long long primary,
                                long long seq_len, long long sa_intv,
                                int idx64, const int64_t* samples,
                                long long n_sa, int n, int max_steps,
                                int64_t* out, void* stream) {
  if (n <= 0) return 0;
  if (sa_intv <= 0 || n_sa <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_lookup<int64_t>(k, fused, L2, primary, seq_len, sa_intv,
                                  samples, n_sa, n, max_steps, out, st);
  return launch_lookup<int32_t>(k, fused, L2, primary, seq_len, sa_intv,
                                samples, n_sa, n, max_steps, out, st);
}
