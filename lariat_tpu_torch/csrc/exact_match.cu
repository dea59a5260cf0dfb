// K7: batched exact-match backward search, one thread a read: from the
// whole index [0, seq_len], each step takes the next base c to the left and
// narrows [k, l] to [L2[c] + occ1(k - 1, c) + 1, L2[c] + occ1(l, c)]
// (fm.cuh `occ1_pair`: one row fetch when both ranks share a block). The
// search runs over the last `span` bases of a read (span = lens, or lens -
// start for the suffix form), at most n_iters steps, and a thread leaves
// once its interval is empty. The two N rules of the reference:
//   skip_n = 0 (fm_batch.py `exact_match_batch`): an N empties the
//       interval (l = k - 1), and it stays empty;
//   skip_n = 1 (align_step.py `exact_match_batch_suffix`): an N is skipped,
//       as if it were deleted, and the search goes on with the next base.
// A second entry, `lariat_occ1`, computes one single-code rank a lane (the
// roofline's fm_rank section times it).
//
// Replaces lariat_tpu/ops/fm_batch.py `exact_match_batch` (an XLA fori loop
// over `backward_ext_batch` and `occ1_batch`, every lane for all L steps)
// and lariat_tpu/parallel/align_step.py `exact_match_batch_suffix`.
//
// Bound on the H100: a chain of dependent fused-row gathers, one (of 48
// bytes at most) a step; a read's time is its steps x the latency of one
// gather, and a batch of 8,192 reads (64 blocks) leaves most of the card
// idle. A simple design that is right; making it fast is later work.

#include <cstdint>

#include "common.cuh"
#include "fm.cuh"

namespace {

template <typename IDX>
__global__ void __launch_bounds__(lariat::kThreads) exact_match_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ start,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ fused,
    const IDX* __restrict__ L2, long long primary, long long seq_len, int B,
    int L, int n_iters, int skip_n, IDX* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const uint8_t* rd = reads + static_cast<long long>(i) * L;
  const int len = lens[i];
  const int n = min(n_iters, start ? len - start[i] : len);
  // the reference reads base clip(len - 1 - t, 0, L - 1) at step t
  const auto base = [&](int t) {
    return static_cast<int>(rd[min(max(len - 1 - t, 0), L - 1)]);
  };
  // a step that empties [k, l] leaves l = k - 1 (occ1(l) == occ1(k - 1)),
  // as an N under the emptying rule does, and nothing changes it after
  IDX k = 0, l = f.seq_len;
  for (int t = 0; t < n; ++t) {
    const int c = base(t);
    if (c >= 4) {
      if (skip_n) continue;
      l = k - 1;
      break;
    }
    IDX ta, tb;
    lariat::occ1_pair(f, k - 1, l, c, ta, tb);
    const IDX l2c = lariat::l2_at(f, c);
    k = l2c + ta + 1;
    l = l2c + tb;
    if (k > l) break;
  }
  out[i] = k;
  out[B + i] = l;
}

template <typename IDX>
__global__ void __launch_bounds__(lariat::kThreads) occ1_kernel(
    const IDX* __restrict__ k, const int32_t* __restrict__ c,
    const int32_t* __restrict__ fused, const IDX* __restrict__ L2,
    long long primary, long long seq_len, int n, IDX* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  out[i] = lariat::occ1(f, k[i], c[i]);
}

}  // namespace

// reads (B, L) uint8; start (B,) int32 or null (the whole read); lens (B,)
// int32 -> out (2, B) IDX rows k, l (empty when k > l).
extern "C" int lariat_exact_match(const uint8_t* reads, const int32_t* start,
                                  const int32_t* lens, const int32_t* fused,
                                  const void* L2, long long primary,
                                  long long seq_len, int idx64, int B, int L,
                                  int n_iters, int skip_n, void* out,
                                  void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = lariat::blocks_for(B);
  if (idx64)
    exact_match_kernel<int64_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, start, lens, fused, static_cast<const int64_t*>(L2), primary,
        seq_len, B, L, n_iters, skip_n, static_cast<int64_t*>(out));
  else
    exact_match_kernel<int32_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, start, lens, fused, static_cast<const int32_t*>(L2), primary,
        seq_len, B, L, n_iters, skip_n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// k (n,) IDX rows in [-1, seq_len]; c (n,) int32 codes 0..3 -> out (n,) IDX.
extern "C" int lariat_occ1(const void* k, const int32_t* c,
                           const int32_t* fused, const void* L2,
                           long long primary, long long seq_len, int idx64,
                           int n, void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = lariat::blocks_for(n);
  if (idx64)
    occ1_kernel<int64_t><<<blocks, lariat::kThreads, 0, st>>>(
        static_cast<const int64_t*>(k), c, fused,
        static_cast<const int64_t*>(L2), primary, seq_len, n,
        static_cast<int64_t*>(out));
  else
    occ1_kernel<int32_t><<<blocks, lariat::kThreads, 0, st>>>(
        static_cast<const int32_t*>(k), c, fused,
        static_cast<const int32_t*>(L2), primary, seq_len, n,
        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
