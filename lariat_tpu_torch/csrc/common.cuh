// Shared helpers of the port's DP kernels.
#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

namespace lariat {

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory on the
// current device: raise its cap (cudaFuncAttributeMaxDynamicSharedMemorySize)
// when ``smem`` is above the largest cap set so far, never lower it. The
// cap is one per kernel and device, shared by every host thread: a launch
// asking for more than the cap fails with cudaErrorInvalidValue, so a
// thread that lowered it to its own need would fail a launch of another
// thread in flight with a longer target (the CLI primes on several threads,
// each wave of its own width).
template <typename K>
cudaError_t raise_smem_cap(K kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> caps;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(mu);
  int& cap = caps[{reinterpret_cast<const void*>(kernel), dev}];
  if (smem <= cap) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) cap = smem;
  return err;
}

constexpr int32_t NEG = -0x40000000;
constexpr int kThreads = 128;  // one task per thread, 128-thread blocks

// bwa's uniform scoring matrix: match / mismatch on A,C,G,T; N (code >= 4)
// against anything scores n_sc.
__device__ __forceinline__ int32_t score_sub(int q, int t, int match_sc,
                                             int mismatch_sc, int n_sc) {
  if (q >= 4 || t >= 4) return n_sc;
  return q == t ? match_sc : mismatch_sc;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// ---- the warp-per-task wavefront of K2 and K3 ----------------------------
//
// A task's query columns are striped across the 32 lanes of one warp, C
// consecutive columns a lane, in registers; at step s lane l computes target
// row s - l, and hands the row's running values to lane l + 1 with
// __shfl_up_sync. A query longer than 32 * C runs as several column tiles,
// the row boundary of one tile kept in device memory for the next.

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Warps (tasks) a block: kWarpsPerBlock, fewer when a warp's shared memory
// would pass 200 KB a block (a long target); one at the least, and a launch
// past the card's 227 KB then fails with its CUDA error.
inline int warps_per_block(int smem_warp) {
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && wpb * smem_warp > 200 * 1024) --wpb;
  return wpb;
}

// A query column's substitution scores against target codes 0..3, one
// signed byte each (code 3 in the top byte).
__device__ __forceinline__ uint32_t sub_profile(int qc, int match_sc,
                                                int mismatch_sc, int n_sc) {
  uint32_t p = 0;
#pragma unroll
  for (int tc = 3; tc >= 0; --tc)
    p = (p << 8) | (static_cast<uint32_t>(score_sub(qc, tc, match_sc,
                                                    mismatch_sc, n_sc)) &
                    0xFFu);
  return p;
}

// PRMT selector that picks byte tc (0..4) of {hi:lo} sign-extended to 32
// bits: byte 0 takes byte tc, bytes 1-3 replicate its sign bit.
__device__ __forceinline__ uint32_t sub_selector(int tc) {
  const uint32_t s = static_cast<uint32_t>(tc) | 8u;
  return static_cast<uint32_t>(tc) | (s << 4) | (s << 8) | (s << 12);
}

// One PRMT: the substitution score of a column's profile `prof` against the
// row's target code; `n_word` holds n_sc in its low byte (target code 4).
__device__ __forceinline__ int32_t sub_score(uint32_t prof, uint32_t n_word,
                                             uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(prof), "r"(n_word),
      "r"(sel));
  return static_cast<int32_t>(r);
}

// Zero n bytes at p, 16 bytes a lane-store where p and n allow it.
__device__ __forceinline__ void warp_zero(uint8_t* p, size_t n, int lane) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && (n & 15) == 0) {
    uint4* v = reinterpret_cast<uint4*>(p);
    for (size_t o = lane; o < n / 16; o += 32) v[o] = make_uint4(0, 0, 0, 0);
  } else {
    for (size_t o = lane; o < n; o += 32) p[o] = 0;
  }
}

}  // namespace lariat
