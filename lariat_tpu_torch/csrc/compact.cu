// K9: emission and left-compaction of the per-e minimal starts that K4a's
// planes entry writes (smem.cu).
//
// Replaces the XLA passes of lariat_tpu/ops/smem_device.py:
//   `compact_starts`: the SMEM emission rule over (R, L) planes, then a
//       stable argsort of ~emit a lane and five gathers, to (R, C) slots,
//       C = min(cap, L);
//   `compact_starts_packed`: the same in one int64 matrix
//       [qb | qe | x0 | x1 | s | count | flags].
// Column j of a lane (e = j + 1) is emitted iff valid, start_e < e <=
// end_e, b <= mid, e - b >= min_seed and b(e + 1) > b(e), where an invalid
// or absent next column counts as larger. The stable sort puts the emitted
// columns first, e ascending, then the others, e ascending, and keeps the
// first C: slot k holds the emitted column of rank k while k < count, and
// past it the non-emitted column of rank k - count (the reference's slots
// past the count hold those, so they are written too).
//
// A warp a lane, 32 columns a step: a ballot of the emission bits and a
// popcount prefix give each column its slot, in two passes over the lane
// (the count first, since the non-emitted columns' slots start there). The
// lane's count goes out uncapped; the wrapper derives the overflow flag
// (count > cap) and the packed layout's flags column. Bound on the H100:
// bytes -- b and valid of every column (5 B; pass two rereads them from
// L2), x0, x1 and s of the C columns kept, the slots out.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // lanes a block
constexpr int32_t kBig = 1 << 30;

__device__ __forceinline__ bool emits(const int32_t* b, const bool* valid,
                                      int j, int L, int start_e, int end_e,
                                      int mid, int min_seed) {
  if (j >= L || !valid[j]) return false;
  const int e = j + 1;
  const int32_t bj = b[j];
  const int32_t bn = (j + 1 < L && valid[j + 1]) ? b[j + 1] : kBig;
  return e > start_e && e <= end_e && bj <= mid && e - bj >= min_seed
         && bn > bj;
}

// out (R, C) planes qb/qe int32, x0/x1/s IDX (packed: one int64 row of
// 5C + 2 a lane, columns [qb | qe | x0 | x1 | s | count | flags], flags
// left to the wrapper); counts (R,) int32 uncapped (both layouts)
template <typename IDX, bool kPacked>
__global__ void __launch_bounds__(32 * kWarps) compact_kernel(
    const int32_t* __restrict__ b_v, const IDX* __restrict__ x0_v,
    const IDX* __restrict__ x1_v, const IDX* __restrict__ s_v,
    const bool* __restrict__ valid_v, const int32_t* __restrict__ start_v,
    const int32_t* __restrict__ end_v, const int32_t* __restrict__ mid_v,
    int R, int L, int min_seed, int C, int32_t* __restrict__ qb_o,
    int32_t* __restrict__ qe_o, IDX* __restrict__ x0_o,
    IDX* __restrict__ x1_o, IDX* __restrict__ s_o,
    int64_t* __restrict__ packed, int32_t* __restrict__ counts) {
  const int lane = blockIdx.x * kWarps + static_cast<int>(threadIdx.x) / 32;
  if (lane >= R) return;  // warp-uniform
  const int t = threadIdx.x & 31;
  const unsigned below = (1u << t) - 1u;
  const size_t row = static_cast<size_t>(lane) * L;
  const int32_t* b = b_v + row;
  const bool* valid = valid_v + row;
  const int start_e = start_v[lane], end_e = end_v[lane], mid = mid_v[lane];
  // pass one: the lane's count
  int total = 0;
  for (int j0 = 0; j0 < L; j0 += 32)
    total += __popc(__ballot_sync(
        0xFFFFFFFFu,
        emits(b, valid, j0 + t, L, start_e, end_e, mid, min_seed)));
  // pass two: each column's slot; stop once every slot is settled
  int pre = 0;  // emitted columns before this chunk
  for (int j0 = 0; j0 < L; j0 += 32) {
    if (pre >= C && total + j0 - pre >= C) break;  // warp-uniform
    const int j = j0 + t;
    const bool em = emits(b, valid, j, L, start_e, end_e, mid, min_seed);
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, em);
    const int before = pre + __popc(bal & below);
    const int k = em ? before : total + j - before;
    if (j < L && k < C) {
      const int32_t qb = b[j];
      const IDX x0 = x0_v[row + j], x1 = x1_v[row + j], s = s_v[row + j];
      if constexpr (kPacked) {
        int64_t* o = packed + static_cast<size_t>(lane) * (5 * C + 2);
        o[k] = qb;
        o[C + k] = j + 1;
        o[2 * C + k] = x0;
        o[3 * C + k] = x1;
        o[4 * C + k] = s;
      } else {
        const size_t o = static_cast<size_t>(lane) * C + k;
        qb_o[o] = qb;
        qe_o[o] = j + 1;
        x0_o[o] = x0;
        x1_o[o] = x1;
        s_o[o] = s;
      }
    }
    pre += __popc(bal);
  }
  if (t == 0) {
    counts[lane] = total;
    if constexpr (kPacked)
      packed[static_cast<size_t>(lane) * (5 * C + 2) + 5 * C] = total;
  }
}

template <typename IDX>
int launch(const int32_t* b, const void* x0, const void* x1, const void* s,
           const bool* valid, const int32_t* start_e, const int32_t* end_e,
           const int32_t* mid, int R, int L, int min_seed, int C,
           int32_t* qb, int32_t* qe, void* ox0, void* ox1, void* os,
           int64_t* packed, int32_t* counts, cudaStream_t st) {
  const int blocks = (R + kWarps - 1) / kWarps;
  if (packed != nullptr)
    compact_kernel<IDX, true><<<blocks, 32 * kWarps, 0, st>>>(
        b, static_cast<const IDX*>(x0), static_cast<const IDX*>(x1),
        static_cast<const IDX*>(s), valid, start_e, end_e, mid, R, L,
        min_seed, C, nullptr, nullptr, nullptr, nullptr, nullptr, packed,
        counts);
  else
    compact_kernel<IDX, false><<<blocks, 32 * kWarps, 0, st>>>(
        b, static_cast<const IDX*>(x0), static_cast<const IDX*>(x1),
        static_cast<const IDX*>(s), valid, start_e, end_e, mid, R, L,
        min_seed, C, qb, qe, static_cast<IDX*>(ox0), static_cast<IDX*>(ox1),
        static_cast<IDX*>(os), nullptr, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b (R, L) int32, x0/x1/s (R, L) IDX (idx64 picks int64_t), valid (R, L)
// bool, start_e/end_e/mid (R,) int32 -> counts (R,) int32 and either the
// slots qb, qe (R, C) int32 and x0, x1, s (R, C) IDX (packed null) or the
// packed (R, 5C + 2) int64 matrix (its flags column left to the caller).
extern "C" int lariat_compact_starts(
    const int32_t* b, const void* x0, const void* x1, const void* s,
    const bool* valid, const int32_t* start_e, const int32_t* end_e,
    const int32_t* mid, int idx64, int R, int L, int min_seed, int C,
    int32_t* qb, int32_t* qe, void* ox0, void* ox1, void* os,
    int64_t* packed, int32_t* counts, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch<int64_t>(b, x0, x1, s, valid, start_e, end_e, mid, R, L,
                           min_seed, C, qb, qe, ox0, ox1, os, packed, counts,
                           st);
  return launch<int32_t>(b, x0, x1, s, valid, start_e, end_e, mid, R, L,
                         min_seed, C, qb, qe, ox0, ox1, os, packed, counts,
                         st);
}
