// K2b: the banded-global backtrack over K2's direction bytes, one task per
// thread, emitting the packed op stream of one reg2aln wave.
//
// Replaces lariat_tpu/ops/sw_global_pallas.py `traceback_ops_fused` (over
// `traceback_ops_device`, an XLA fori_loop walk, packed_layout=False). A
// torch loop of S steps driven from Python would sync the host on every
// step, so on the card the walk is a kernel. Same bit reads as the host
// walker of native/ksw.cpp `ksw_global_traceback`: start at (tlen - 1,
// min(tlen + w, qlen) - 1) with which = 0; ops 0 = M, 1 = I, 2 = D in walk
// (reverse-alignment) order, 3 (the reference's 255 & 3) for every step
// after the walk left the matrix; four 2-bit ops per byte, LSB first. Each
// blob row is the S/4 op bytes, then score, i_fin and k_fin as
// little-endian int32 -- the layout native ksw_cigar_from_ops_packed_batch
// consumes.
//
// Bound on the H100: a dependent chain of single-byte loads (latency); z is
// K2's task-major (B, Lt, Lq). Later work: fuse into K2 so z stays on chip,
// or emit run-length CIGARs on the device.

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ void put_i32(uint8_t* p, int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  p[0] = u & 0xFF; p[1] = (u >> 8) & 0xFF; p[2] = (u >> 16) & 0xFF;
  p[3] = u >> 24;
}

__global__ void traceback_kernel(
    const uint8_t* __restrict__ z, const int32_t* __restrict__ qlen_v,
    const int32_t* __restrict__ tlen_v, const int32_t* __restrict__ w_v,
    const int32_t* __restrict__ score, int B, int Lt, int Lq, int S,
    uint8_t* __restrict__ blob) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int P = S / 4;
  uint8_t* row = blob + (size_t)b * (P + 12);
  const int w = w_v[b];
  int i = tlen_v[b] - 1;
  int k = min(i + w + 1, qlen_v[b]) - 1;
  int which = 0;
  int s = 0;
  uint32_t acc = 0;
  for (; s < S && i >= 0 && k >= 0; ++s) {
    const int ri = min(i, Lt - 1), ck = min(k, Lq - 1);
    const int d = z[((size_t)b * Lt + ri) * Lq + ck];
    const int wn = (d >> (which << 1)) & 3;
    const int op = wn == 0 ? 0 : (wn == 1 ? 2 : 1);
    i -= wn == 2 ? 0 : 1;  // an insertion consumes no target row
    k -= wn == 1 ? 0 : 1;  // a deletion consumes no query column
    which = wn;
    acc |= static_cast<uint32_t>(op) << ((s & 3) << 1);
    if ((s & 3) == 3) {
      row[s >> 2] = static_cast<uint8_t>(acc);
      acc = 0;
    }
  }
  if (s < S) {  // end markers: finish the open byte, then whole bytes
    for (; (s & 3) != 0; ++s) acc |= 3u << ((s & 3) << 1);
    if (acc) row[(s >> 2) - 1] = static_cast<uint8_t>(acc);
    for (int p = s >> 2; p < P; ++p) row[p] = 0xFF;
  }
  put_i32(row + P, score[b]);
  put_i32(row + P + 4, i);
  put_i32(row + P + 8, k);
}

}  // namespace

// z (B, Lt, Lq) uint8 direction bytes from K2; qlen/tlen/w/score (B,)
// int32; blob (B, S/4 + 12) uint8. Needs S % 4 == 0 and S >= Lt + Lq.
extern "C" int lariat_traceback(const uint8_t* z, const int32_t* qlen,
                                const int32_t* tlen, const int32_t* w,
                                const int32_t* score, int B, int Lt, int Lq,
                                int S, uint8_t* blob, void* stream) {
  if (B <= 0) return 0;
  traceback_kernel<<<lariat::blocks_for(B), lariat::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      z, qlen, tlen, w, score, B, Lt, Lq, S, blob);
  return static_cast<int>(cudaGetLastError());
}
