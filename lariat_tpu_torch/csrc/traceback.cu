// K2b: the banded-global backtrack over K2's direction bytes, one warp a
// task walking windows of z staged in shared memory, emitting the packed
// op stream of one reg2aln wave.
//
// Replaces lariat_tpu/ops/sw_global_pallas.py `traceback_ops_fused` (over
// `traceback_ops_device`, an XLA fori_loop walk, packed_layout=False). A
// torch loop of S steps driven from Python would sync the host on every
// step, so on the card the walk is a kernel. Same bit reads as the host
// walker of native/ksw.cpp `ksw_global_traceback`: start at (tlen - 1,
// min(tlen + w, qlen) - 1) with which = 0; the byte read at (i, k) is
// z[b, min(i, Lt - 1), min(k, Lq - 1)]; ops 0 = M, 1 = I, 2 = D in walk
// (reverse-alignment) order, 3 (the reference's 255 & 3) for every step
// after the walk left the matrix; four 2-bit ops per byte, LSB first. Each
// blob row is the S/4 op bytes, then score, i_fin and k_fin as
// little-endian int32 -- the layout native ksw_cigar_from_ops_packed_batch
// consumes.
//
// Bound on the H100: a walk is a chain of dependent one-byte reads of z,
// K2's task-major (B, Lt, Lq) slab (151 MB at a 2,048-task wave, three
// times the L2), so a read from device memory costs a memory latency a
// step. Here a warp (a one-warp block, so a 2,048-task wave spreads over
// every SM) stages a window of 32 rows x kWinCols columns around (i, k) in
// shared memory, one lane a row, with 16-byte cp.async copies; lane 0 walks
// it at shared-memory latency until (i, k) leaves it, and the warp stages
// the window that ends at the new (i, k): about 3.4 windows a task on a
// reg2aln wave. On the H100, windows of 32 columns ran faster than 64 or
// 128, and prefetching the next window (up and to the left) while lane 0
// walks ran slower than staging on demand (PERF.md). Only the window's row
// and column bounds are assumed, never K2's band, so any z walks the same.
// Ops are packed into a shared-memory row, which the warp stores with
// coalesced byte stores. Later work: fuse into K2 so z stays on chip, or
// emit run-length CIGARs on the device.

#include <cstdint>

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;     // window rows, one lane a row
constexpr int kWinCols = 32;  // window columns, a multiple of 16
constexpr int kWin = kRows * kWinCols;

// The window that ends at column ck: the 16-column chunk holding ck is its
// last, so a walk entering at ck has kWinCols - 15 to kWinCols columns to
// its left.
__device__ __forceinline__ int win_c_end(int ck) { return (ck & ~15) + 16; }

// Stage rows [r_end - 32, r_end) x columns [c_end - kWinCols, c_end) of a
// task's z (zb, rows of Lq bytes) into dst, lane l the row r_end - 32 + l:
// 16-byte cp.async copies where the chunk lies in the row and is 16-byte
// aligned (every chunk when Lq % 16 == 0), else byte loads. Rows and
// columns below 0 and columns past Lq are skipped (never walked).
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* zb,
                                      int Lq, int r_end, int c_end,
                                      int lane) {
  const int r = r_end - kRows + lane;
  if (r < 0) return;
  const uint8_t* src = zb + static_cast<size_t>(r) * Lq;
  uint8_t* d = dst + lane * kWinCols;
  const int c0 = c_end - kWinCols;
#pragma unroll
  for (int j = 0; j < kWinCols / 16; ++j) {
    const int c = c0 + 16 * j;  // chunks lie wholly below 0 or above
    if (c < 0) continue;
    if (c + 16 <= Lq
        && (reinterpret_cast<uintptr_t>(src + c) & 15) == 0) {
      __pipeline_memcpy_async(d + 16 * j, src + c, 16);
    } else {
      for (int t = 0; t < 16 && c + t < Lq; ++t) d[16 * j + t] = src[c + t];
    }
  }
}

__device__ __forceinline__ void put_i32(uint8_t* p, int lane, int32_t v) {
  p[lane] = static_cast<uint8_t>(static_cast<uint32_t>(v) >> (8 * lane));
}

__global__ void __launch_bounds__(32) traceback_kernel(
    const uint8_t* __restrict__ z, const int32_t* __restrict__ qlen_v,
    const int32_t* __restrict__ tlen_v, const int32_t* __restrict__ w_v,
    const int32_t* __restrict__ score, int Lt, int Lq, int S,
    uint8_t* __restrict__ blob, int32_t* __restrict__ windows) {
  __shared__ __align__(16) uint8_t win[kWin];
  extern __shared__ uint8_t ops[];  // the S/4 op bytes
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int P = S / 4;
  const uint8_t* zb = z + static_cast<size_t>(b) * Lt * Lq;
  for (int p = lane; p < P; p += 32) ops[p] = 0xFF;
  int i = tlen_v[b] - 1;
  int k = min(i + w_v[b] + 1, qlen_v[b]) - 1;
  int which = 0, s = 0, staged = 0;
  uint32_t acc = 0;
  while (s < S && i >= 0 && k >= 0) {  // warp-uniform
    // the window of rows [ri - 31, ri] whose last 16-column chunk holds ck
    const int r_end = min(i, Lt - 1) + 1;
    const int c_end = win_c_end(min(k, Lq - 1));
    stage(win, zb, Lq, r_end, c_end, lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    ++staged;
    if (lane == 0) {
      const int r0 = r_end - kRows, c0 = c_end - kWinCols;
      for (; s < S && i >= 0 && k >= 0; ++s) {
        const int ri = min(i, Lt - 1), ck = min(k, Lq - 1);
        if (ri < r0 || ck < c0) break;  // left the window
        const int d = win[(ri - r0) * kWinCols + (ck - c0)];
        const int wn = (d >> (which << 1)) & 3;
        const int op = wn == 0 ? 0 : (wn == 1 ? 2 : 1);
        i -= wn == 2 ? 0 : 1;  // an insertion consumes no target row
        k -= wn == 1 ? 0 : 1;  // a deletion consumes no query column
        which = wn;
        acc |= static_cast<uint32_t>(op) << ((s & 3) << 1);
        if ((s & 3) == 3) {
          ops[s >> 2] = static_cast<uint8_t>(acc);
          acc = 0;
        }
      }
    }
    i = __shfl_sync(lariat::kFull, i, 0);
    k = __shfl_sync(lariat::kFull, k, 0);
    s = __shfl_sync(lariat::kFull, s, 0);
    __syncwarp();  // lane 0 is done with the window before it is restaged
  }
  if (lane == 0 && s < S && (s & 3) != 0) {
    // the end markers of the open byte; whole bytes past it stay 0xFF
    for (int t = s; (t & 3) != 0; ++t) acc |= 3u << ((t & 3) << 1);
    ops[s >> 2] = static_cast<uint8_t>(acc);
  }
  __syncwarp();
  uint8_t* row = blob + static_cast<size_t>(b) * (P + 12);
  for (int p = lane; p < P; p += 32) row[p] = ops[p];
  if (lane < 4) {
    put_i32(row + P, lane, score[b]);
    put_i32(row + P + 4, lane, i);
    put_i32(row + P + 8, lane, k);
  }
  if (windows != nullptr && lane == 0) windows[b] = staged;
}

}  // namespace

// z (B, Lt, Lq) uint8 direction bytes from K2; qlen/tlen/w/score (B,)
// int32; blob (B, S/4 + 12) uint8; windows (B,) int32, each task's windows
// staged, or null. Needs S % 4 == 0 and S >= Lt + Lq.
extern "C" int lariat_traceback(const uint8_t* z, const int32_t* qlen,
                                const int32_t* tlen, const int32_t* w,
                                const int32_t* score, int B, int Lt, int Lq,
                                int S, uint8_t* blob, int32_t* windows,
                                void* stream) {
  if (B <= 0) return 0;
  const int smem = S / 4;  // past the static window's 48 KB share: opt in
  if (smem > 48 * 1024 - kWin) {
    const cudaError_t err = lariat::raise_smem_cap(traceback_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traceback_kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      z, qlen, tlen, w, score, Lt, Lq, S, blob, windows);
  return static_cast<int>(cudaGetLastError());
}
