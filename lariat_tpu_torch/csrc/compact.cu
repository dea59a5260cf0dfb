// K9: emission and left-compaction of the per-e minimal starts that K4a's
// planes entry writes (smem.cu).
//
// Replaces the XLA passes of lariat_tpu/ops/smem_device.py:
//   `compact_starts`: the SMEM emission rule over (R, L) planes, then a
//       stable argsort of ~emit a lane and five gathers, to (R, C) slots,
//       C = min(cap, L), and the overflow flag (any count > cap);
//   `compact_starts_packed`: the same in one int64 matrix
//       [qb | qe | x0 | x1 | s | count | flags], flags = done | overflow
//       << 1 on every row.
// Column j of a lane (e = j + 1) is emitted iff valid, start_e < e <=
// end_e, b <= mid, e - b >= min_seed and b(e + 1) > b(e), where an invalid
// or absent next column counts as larger. The stable sort puts the emitted
// columns first, e ascending, then the others, e ascending, and keeps the
// first C: slot k holds the emitted column of rank k while k < count, and
// past it the non-emitted column of rank k - count (the reference's slots
// past the count hold those, so they are written too). Since a count is
// at most L, count > cap iff count > C.
//
// Bound on the H100: bytes -- b and valid of every column (5 B), x0, x1
// and s of the C columns kept, the lanes' ranges, the slots out: 8 MB, 2.4
// us, at 4,096 lanes x 192 with C 32. The design reads each of those bytes
// once and keeps every lane in flight at once:
//  1. A warp a lane stages its b and valid into shared memory with 16-byte
//     loads, all issued before any is stored (one round trip), kWin
//     columns at a time (one window for L <= kWin; a longer lane loops
//     over windows, each staged with the column past its end).
//  2. A thread a column tests the rule on each 32-column chunk, with b and
//     valid of the next column from the next thread (__shfl_down_sync; the
//     chunk's last thread reads the next chunk's first column from shared
//     memory). The chunk's ballot is kept, one word a chunk (in shared
//     memory up to kMaxChunks, past it in a scratch the wrapper gives), and
//     its popcount adds to the lane's count.
//  3. A thread a slot finds its column from the ballots alone (their
//     popcounts, then a binary search in one word), so the count comes
//     before any placement and nothing is reread: one round of loads of
//     the C kept columns' x0, x1 and s (qb from shared memory when the lane
//     fit one window), and stores that are contiguous across the warp.
//  4. The overflow flag is the launch's own. Slots layout: the wrapper's
//     memset zeroes the 0-d flag and a block with an overflowing lane
//     writes 1. Packed layout: each lane writes done into its flags; the
//     memset zeroes a two-word scratch [overflow, ticket] of this call;
//     each block ORs its overflow in, fences and takes a ticket, and the
//     last block, if any lane overflowed, rewrites the flags column as
//     done | 2 (so a call without an overflow has no serial tail). Each
//     call has its own scratch, so two streams never share one.
// Lanes a block, kWarps = 8: a lane is two dependent round trips to device
// memory, so every lane should be resident at once and the SMs evenly
// loaded. At 4,096 lanes on 132 SMs that is 512 blocks, at most 4 (32
// warps, 12 KB of shared memory each) an SM, one wave; 4, 16 or 32 lanes a
// block load the SMs no more evenly (32 warps the most on any SM), while
// fewer lanes a block put more tickets on one counter (4,096 at 1).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // lanes a block
constexpr int kWin = 256;        // columns a warp stages at once
constexpr int kMaxChunks = 32;   // ballots kept in shared memory (L <= 1024)
constexpr int32_t kBig = 1 << 30;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct __align__(16) WarpSmem {
  int32_t b[kWin + 8];   // a window, the column past it, up to 3 of offset
  uint8_t v[kWin + 32];  // the same, up to 15 of offset
  uint32_t bal[kMaxChunks];
};

// A source span of n elements of T cut at 16-byte boundaries: off, the
// elements it lies past one; head, the elements before the first; nvec
// 16-byte words; the elements from tail on after the last.
template <typename T>
struct Span {
  int off, head, nvec, tail;
  __device__ __forceinline__ Span(const T* src, int n) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    off = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15u) /
                           sizeof(T));
    head = off == 0 ? 0 : min(n, kPer - off);
    nvec = (n - head) / kPer;
    tail = head + nvec * kPer;
  }
};

// A warp's loads of a span into registers (the middle in 16-byte words,
// an element a thread before and after it), all issued before any is
// used: one round trip to device memory for the whole window.
template <typename T, int kVec>
__device__ __forceinline__ void stage_load(const T* src, int n,
                                           const Span<T>& sp, int t,
                                           uint4 (&v)[kVec], T& h, T& tl) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src + sp.head);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (t + 32 * i < sp.nvec) v[i] = __ldg(s4 + t + 32 * i);
  if (t < sp.head) h = src[t];
  if (t < n - sp.tail) tl = src[sp.tail + t];
}

// ... and their stores to dst + off (dst 16-byte aligned), element i of the
// span at dst[off + i].
template <typename T, int kVec>
__device__ __forceinline__ void stage_store(T* dst, int n, const Span<T>& sp,
                                            int t, const uint4 (&v)[kVec],
                                            T h, T tl) {
  uint4* d4 = reinterpret_cast<uint4*>(dst + sp.off + sp.head);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    if (t + 32 * i < sp.nvec) d4[t + 32 * i] = v[i];
  if (t < sp.head) dst[sp.off + t] = h;
  if (t < n - sp.tail) dst[sp.off + sp.tail + t] = tl;
}

// 16-byte words a thread stages of a window and the column past it
constexpr int kBVec = ((kWin + 1) / 4 + 31) / 32;
constexpr int kVVec = ((kWin + 1) / 16 + 31) / 32;

// Position of the set bit of rank r (0-based) in w; r < popc(w).
__device__ __forceinline__ int select_bit(unsigned w, int r) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const unsigned lo = w & ((1u << sh) - 1u);
    const int c = __popc(lo);
    if (r >= c) {
      r -= c;
      w >>= sh;
      pos += sh;
    } else {
      w = lo;
    }
  }
  return pos;
}

// out: slots qb/qe (R, C) int32 and x0/x1/s (R, C) IDX, counts (R,) int32
// uncapped, overflow a 0-d bool zeroed by the wrapper's memset; or
// (kPacked) one int64 row of 5C + 2 a lane, [qb | qe | x0 | x1 | s | count
// | flags], with scratch [overflow, ticket] zeroed by the memset. far_bal:
// (R, ceil(L / 32)) ballots when they exceed kMaxChunks, else unused.
template <typename IDX, bool kPacked>
__global__ void __launch_bounds__(32 * kWarps) compact_kernel(
    const int32_t* __restrict__ b_v, const IDX* __restrict__ x0_v,
    const IDX* __restrict__ x1_v, const IDX* __restrict__ s_v,
    const bool* __restrict__ valid_v, const int32_t* __restrict__ start_v,
    const int32_t* __restrict__ end_v, const int32_t* __restrict__ mid_v,
    const bool* __restrict__ done, int R, int L, int min_seed, int C,
    int32_t* __restrict__ qb_o, int32_t* __restrict__ qe_o,
    IDX* __restrict__ x0_o, IDX* __restrict__ x1_o, IDX* __restrict__ s_o,
    int32_t* __restrict__ counts, bool* __restrict__ overflow,
    int64_t* __restrict__ packed, unsigned* __restrict__ scratch,
    unsigned* __restrict__ far_bal) {
  __shared__ WarpSmem sm[kWarps];
  __shared__ int block_ovf;
  __shared__ int64_t last_flags;  // -1 unless this is the last block
  const int w = static_cast<int>(threadIdx.x) / 32;
  const int t = threadIdx.x & 31;
  if (threadIdx.x == 0) block_ovf = 0;
  __syncthreads();
  const int lane = blockIdx.x * kWarps + w;
  if (lane < R) {  // warp-uniform
    WarpSmem& s = sm[w];
    const size_t row = static_cast<size_t>(lane) * L;
    const int32_t* b = b_v + row;
    const uint8_t* valid = reinterpret_cast<const uint8_t*>(valid_v + row);
    const int start_e = start_v[lane], end_e = end_v[lane];
    const int mid = mid_v[lane];
    const int nchunks = (L + 31) / 32;
    unsigned* bal = nchunks <= kMaxChunks
                        ? s.bal
                        : far_bal + static_cast<size_t>(lane) * nchunks;
    int total = 0, boff = 0;
    for (int c0 = 0; c0 < L; c0 += kWin) {
      const int wend = min(kWin, L - c0);    // the window's own columns
      const int n = min(kWin + 1, L - c0);   // and the one past it
      const Span<int32_t> bsp(b + c0, n);
      const Span<uint8_t> vsp(valid + c0, n);
      uint4 rb[kBVec], rv[kVVec];
      int32_t bh = 0, bt = 0;
      uint8_t vh = 0, vt = 0;
      stage_load(b + c0, n, bsp, t, rb, bh, bt);
      stage_load(valid + c0, n, vsp, t, rv, vh, vt);
      __syncwarp();  // the last window's readers are done with it
      stage_store(s.b, n, bsp, t, rb, bh, bt);
      stage_store(s.v, n, vsp, t, rv, vh, vt);
      __syncwarp();
      boff = bsp.off;
      const int voff = vsp.off;
      for (int j0 = 0; j0 < wend; j0 += 32) {
        const int jw = j0 + t;
        const bool in = jw < wend;
        const int32_t bj = in ? s.b[boff + jw] : kBig;
        const bool vj = in && s.v[voff + jw] != 0;
        int32_t bn = __shfl_down_sync(kFull, bj, 1);
        bool vn = __shfl_down_sync(kFull, static_cast<int>(vj), 1) != 0;
        if (t == 31) {
          const bool has = jw + 1 < n;
          bn = has ? s.b[boff + jw + 1] : kBig;
          vn = has && s.v[voff + jw + 1] != 0;
        }
        const int e = c0 + jw + 1;
        const bool em = vj && e > start_e && e <= end_e && bj <= mid &&
                        e - bj >= min_seed && (!vn || bn > bj);
        const unsigned m = __ballot_sync(kFull, em);
        if (t == 0) bal[(c0 + j0) >> 5] = m;
        total += __popc(m);
      }
    }
    __syncwarp();
    if (t == 0) {
      if (counts != nullptr) counts[lane] = total;
      if constexpr (kPacked) {
        int64_t* o = packed + static_cast<size_t>(lane) * (5 * C + 2);
        o[5 * C] = total;
        o[5 * C + 1] = *done ? 1 : 0;  // the last block adds the overflow
      }
      if (total > C) block_ovf = 1;
    }
    // slot k: the emitted column of rank k, else the non-emitted column
    // of rank k - total (k < C <= L, so one exists)
    const unsigned last_mask = (L & 31) ? (1u << (L & 31)) - 1u : kFull;
    for (int k = t; k < C; k += 32) {
      const bool emitted = k < total;
      int r = emitted ? k : k - total;
      int j = 0;
      for (int c = 0; c < nchunks; ++c) {
        unsigned m = bal[c];
        if (!emitted) m = ~m & (c == nchunks - 1 ? last_mask : kFull);
        const int cnt = __popc(m);
        if (r < cnt) {
          j = c * 32 + select_bit(m, r);
          break;
        }
        r -= cnt;
      }
      const int32_t qb = L <= kWin ? s.b[boff + j] : b[j];
      const IDX x0 = x0_v[row + j], x1 = x1_v[row + j], sv = s_v[row + j];
      if constexpr (kPacked) {
        int64_t* o = packed + static_cast<size_t>(lane) * (5 * C + 2);
        o[k] = qb;
        o[C + k] = j + 1;
        o[2 * C + k] = x0;
        o[3 * C + k] = x1;
        o[4 * C + k] = sv;
      } else {
        const size_t o = static_cast<size_t>(lane) * C + k;
        qb_o[o] = qb;
        qe_o[o] = j + 1;
        x0_o[o] = x0;
        x1_o[o] = x1;
        s_o[o] = sv;
      }
    }
  }
  __syncthreads();
  if constexpr (!kPacked) {
    if (threadIdx.x == 0 && block_ovf) *overflow = true;
  } else {
    if (threadIdx.x == 0) {
      if (block_ovf) atomicOr(&scratch[0], 1u);
      __threadfence();
      const bool last = atomicAdd(&scratch[1], 1u) == gridDim.x - 1;
      __threadfence();
      // every lane wrote done; on an overflow the last block rewrites all
      last_flags = last && atomicOr(&scratch[0], 0u) != 0
                       ? (*done ? 3 : 2)
                       : -1;
    }
    __syncthreads();
    if (last_flags >= 0) {
      const size_t stride = 5 * static_cast<size_t>(C) + 2;
      for (int r = threadIdx.x; r < R; r += blockDim.x)
        packed[r * stride + 5 * C + 1] = last_flags;
    }
  }
}

template <typename IDX>
int launch(const int32_t* b, const void* x0, const void* x1, const void* s,
           const bool* valid, const int32_t* start_e, const int32_t* end_e,
           const int32_t* mid, const bool* done, int R, int L, int min_seed,
           int C, int32_t* qb, int32_t* qe, void* ox0, void* ox1, void* os,
           int32_t* counts, bool* overflow, int64_t* packed,
           unsigned* scratch, unsigned* far_bal, cudaStream_t st) {
  const int blocks = (R + kWarps - 1) / kWarps;
  if (scratch != nullptr)
    compact_kernel<IDX, true><<<blocks, 32 * kWarps, 0, st>>>(
        b, static_cast<const IDX*>(x0), static_cast<const IDX*>(x1),
        static_cast<const IDX*>(s), valid, start_e, end_e, mid, done, R, L,
        min_seed, C, nullptr, nullptr, nullptr, nullptr, nullptr, counts,
        nullptr, packed, scratch, far_bal);
  else
    compact_kernel<IDX, false><<<blocks, 32 * kWarps, 0, st>>>(
        b, static_cast<const IDX*>(x0), static_cast<const IDX*>(x1),
        static_cast<const IDX*>(s), valid, start_e, end_e, mid, done, R, L,
        min_seed, C, qb, qe, static_cast<IDX*>(ox0), static_cast<IDX*>(ox1),
        static_cast<IDX*>(os), counts, overflow, nullptr, nullptr, far_bal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b (R, L) int32, x0/x1/s (R, L) IDX (idx64 picks int64_t), valid (R, L)
// bool, start_e/end_e/mid (R,) int32, C = min(cap, L). Slots layout
// (scratch null): qb, qe (R, C) int32, x0, x1, s (R, C) IDX, counts (R,)
// int32 and overflow, a 0-d bool. Packed layout: packed (R, 5C + 2) int64,
// done a 0-d bool, scratch two words; counts and overflow unused. far_bal
// (R * ceil(L / 32),) words when ceil(L / 32) > kMaxChunks, else null.
// One memset (the overflow flag, or the scratch), then the kernel.
extern "C" int lariat_compact_starts(
    const int32_t* b, const void* x0, const void* x1, const void* s,
    const bool* valid, const int32_t* start_e, const int32_t* end_e,
    const int32_t* mid, const bool* done, int idx64, int R, int L,
    int min_seed, int C, int32_t* qb, int32_t* qe, void* ox0, void* ox1,
    void* os, int32_t* counts, bool* overflow, int64_t* packed,
    unsigned* scratch, unsigned* far_bal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the layout is told by the scratch: an empty packed matrix has no data
  cudaError_t rc = scratch != nullptr
                       ? cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned), st)
                       : cudaMemsetAsync(overflow, 0, sizeof(bool), st);
  if (rc != cudaSuccess || R <= 0) return static_cast<int>(rc);
  if (idx64)
    return launch<int64_t>(b, x0, x1, s, valid, start_e, end_e, mid, done, R,
                           L, min_seed, C, qb, qe, ox0, ox1, os, counts,
                           overflow, packed, scratch, far_bal, st);
  return launch<int32_t>(b, x0, x1, s, valid, start_e, end_e, mid, done, R,
                         L, min_seed, C, qb, qe, ox0, ox1, os, counts,
                         overflow, packed, scratch, far_bal, st);
}
