// K8: a window of forward-strand base codes for each task, one thread a
// base: out[b, p] = the code at start[b] + p of the 2-bit pac (16 bases a
// 32-bit word, base 0 in the high bits), or 4 (N) outside [0, l_pac). A
// start may be negative and a window may run past l_pac.
//
// Replaces lariat_tpu/parallel/align_step.py `fetch_window_batch` (an XLA
// gather of whole words, an unpack and 16 selects by the in-word offset),
// bit for bit: for a position inside [0, l_pac) the reference's word
// floor(start / 16) + (offset + p) / 16 is word pos >> 4, and its code the
// field 15 - (pos & 15) of it; past the text it writes 4 whatever it read.
// It reads only the forward strand, where ops/resident.py
// `fetch_fmd_batch` mirrors positions past l_pac onto the reverse one.
//
// Bound on the H100: bytes. A window of W bases reads W / 16 + 1 words
// (one 32-byte sector serves 128 bases) and writes W int32 codes, so the
// writes are nearly all of the traffic; neighbouring threads write
// neighbouring codes and read the same word.

#include <cstdint>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(lariat::kThreads) fetch_window_kernel(
    const int64_t* __restrict__ start, const int32_t* __restrict__ pac,
    long long l_pac, int B, int length, int32_t* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * length) return;
  const long long b = idx / length;
  const long long pos = __ldg(start + b) + (idx - b * length);
  int code = 4;
  if (pos >= 0 && pos < l_pac) {
    const uint32_t w =
        static_cast<uint32_t>(__ldg(pac + (pos >> 4)));
    code = static_cast<int>((w >> (2 * (15 - (pos & 15)))) & 3u);
  }
  out[idx] = code;
}

}  // namespace

// start (B,) int64; pac (ceil(l_pac / 16),) the uint32 words as int32 ->
// out (B, length) int32.
extern "C" int lariat_fetch_window(const int64_t* start, const int32_t* pac,
                                   long long l_pac, int B, int length,
                                   int32_t* out, void* stream) {
  const long long n = static_cast<long long>(B) * length;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + lariat::kThreads - 1) / lariat::kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fetch_window_kernel<<<static_cast<unsigned>(blocks), lariat::kThreads, 0,
                        st>>>(start, pac, l_pac, B, length, out);
  return static_cast<int>(cudaGetLastError());
}
