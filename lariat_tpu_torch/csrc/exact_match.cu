// K7: batched exact-match backward search, a group of kGroup threads a
// read: from the whole index [0, seq_len], each step takes the next base c
// to the left and narrows [k, l] to [L2[c] + occ1(k - 1, c) + 1, L2[c] +
// occ1(l, c)]. The search runs over the last `span` bases of a read (span =
// lens, or lens - start for the suffix form), at most n_iters steps, and a
// group leaves once its interval is empty. Step t reads the base at p =
// clip(len - 1 - t, 0, L - 1); the suffix form applies the reference's
// seed mask there (the base is N unless start <= p < len), so its caller
// passes the reads as they are. The two N rules of the reference:
//   skip_n = 0 (fm_batch.py `exact_match_batch`): an N empties the
//       interval (l = k - 1), and it stays empty;
//   skip_n = 1 (align_step.py `exact_match_batch_suffix`): an N is skipped,
//       as if it were deleted, and the search goes on with the next base.
// A second entry, `lariat_occ1`, computes one single-code rank a thread
// (the roofline's fm_rank section times it).
//
// Replaces lariat_tpu/ops/fm_batch.py `exact_match_batch` (an XLA fori loop
// over `backward_ext_batch` and `occ1_batch`, every lane for all L steps)
// and lariat_tpu/parallel/align_step.py `exact_match_batch_suffix` with the
// seed mask of its `align_step` (:206-213).
//
// Bound on the H100: a chain of dependent steps, each a gather of two
// fused rows (at most 48 bytes each) and a few popcounts; a read's time is
// its steps x the latency of one step. Design: the group rank of fm.cuh
// (`occ1_pair_group`): the group's threads load both rows' pieces in one
// round (one row when the ranks share a block) and sum their popcounts by
// shuffles, so a step costs one round trip to L2, not two in series, and
// 8,192 reads fill 256-512 blocks of 128 threads, every SM of the card.
// The group stages its read's next kChunk bases (masked) in shared memory
// before the chain runs through them. Each read's steps run go to
// `n_steps` when given (the kernel's own count of its chain).

#include <cstdint>

#include "common.cuh"
#include "fm.cuh"

namespace {

constexpr int kGroup = 8;   // threads a read (4 measured too, PERF.md)
constexpr int kChunk = 32;  // bases a group stages at once

template <typename IDX>
__global__ void __launch_bounds__(lariat::kThreads) exact_match_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ start,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ fused,
    const IDX* __restrict__ L2, long long primary, long long seq_len, int B,
    int L, int n_iters, int skip_n, IDX* __restrict__ out,
    int32_t* __restrict__ n_steps) {
  __shared__ uint8_t staged[lariat::kThreads / kGroup][kChunk];
  const int grp = threadIdx.x / kGroup, g = threadIdx.x % kGroup;
  const int i = blockIdx.x * (lariat::kThreads / kGroup) + grp;
  if (i >= B) return;  // the whole group
  const unsigned gmask = ((1u << kGroup) - 1u)
                         << ((threadIdx.x & 31) & ~(kGroup - 1));
  const lariat::FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const uint8_t* rd = reads + static_cast<long long>(i) * L;
  const int len = lens[i];
  const int s0 = start ? start[i] : 0;
  const int n = min(n_iters, start ? len - s0 : len);
  uint8_t* bases = staged[grp];
  // a step that empties [k, l] leaves l = k - 1 (occ1(l) == occ1(k - 1)),
  // as an N under the emptying rule does, and nothing changes it after
  IDX k = 0, l = f.seq_len;
  int ran = 0;
  bool done = false;
  for (int t0 = 0; t0 < n && !done; t0 += kChunk) {
    for (int j = g; j < kChunk; j += kGroup) {
      const int p = min(max(len - 1 - (t0 + j), 0), L - 1);
      const bool keep = t0 + j < n && (!start || (p >= s0 && p < len));
      bases[j] = keep ? rd[p] : 4;
    }
    __syncwarp(gmask);
    const int m = min(kChunk, n - t0);
    for (int j = 0; j < m; ++j) {
      const int c = bases[j];
      if (c >= 4) {
        if (skip_n) continue;
        l = k - 1;
        done = true;
        break;
      }
      IDX ta, tb;
      lariat::occ1_pair_group<IDX, kGroup>(f, k - 1, l, c, g, gmask, ta, tb);
      const IDX l2c = lariat::l2_at(f, c);
      k = l2c + ta + 1;
      l = l2c + tb;
      ++ran;
      if (k > l) {
        done = true;
        break;
      }
    }
    __syncwarp(gmask);  // the chunk is read before the next overwrites it
  }
  if (g == 0) {
    out[i] = k;
    out[B + i] = l;
    if (n_steps) n_steps[i] = ran;
  }
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
// int32 -> out (2, B) IDX rows k, l (empty when k > l); n_steps (B,) int32
// or null: each read's rank steps.
extern "C" int lariat_exact_match(const uint8_t* reads, const int32_t* start,
                                  const int32_t* lens, const int32_t* fused,
                                  const void* L2, long long primary,
                                  long long seq_len, int idx64, int B, int L,
                                  int n_iters, int skip_n, void* out,
                                  int32_t* n_steps, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int per_block = lariat::kThreads / kGroup;
  const int blocks = (B + per_block - 1) / per_block;
  if (idx64)
    exact_match_kernel<int64_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, start, lens, fused, static_cast<const int64_t*>(L2), primary,
        seq_len, B, L, n_iters, skip_n, static_cast<int64_t*>(out), n_steps);
  else
    exact_match_kernel<int32_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, start, lens, fused, static_cast<const int32_t*>(L2), primary,
        seq_len, B, L, n_iters, skip_n, static_cast<int32_t*>(out), n_steps);
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
