// K6: FM-index rank primitives on the fused occ table, per thread. Shared
// __device__ code of the seeding kernels (smem.cu: K4a-K4c) and the SA walk
// (sa_walk.cu: K5); no launch of its own.
//
// Replaces lariat_tpu/ops/fm_batch.py `occ4_fused_batch` (with
// `_block_counts`), `bwt_extend_dir_batch` / `bwt_extend_batch` and
// `lf_batch`, the XLA gathers every device seeding step runs.
//
// The table is (n_blocks+1, 12) uint32 rows [ckpt 0..3 | 8 bwt words] (16
// 2-bit codes a word, base 0 in the high bits), handed over as int32 and
// read as three 16-byte loads a row. Bound on the H100: each rank is one
// dependent 48-byte gather from a table of n/128 rows (about 1 M rows, 48 MB,
// at 64 Mbp: L2-resident; 50 M rows at hg38: device memory), then 32
// popcounts. The in-block count is the reference's 2-bit XOR trick: a field
// matches code c iff (field ^ c) == 00.
//
// Templated on the index type: int32_t while the doubled text fits, int64_t
// beyond (hg38).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lariat {

template <typename IDX>
struct FMView {
  const uint4* rows;  // 3 uint4 (12 uint32 words) per fused row
  IDX L2[5];
  IDX primary, seq_len;
};

template <typename IDX>
__device__ __forceinline__ FMView<IDX> fm_view(const int32_t* fused,
                                               const IDX* L2,
                                               long long primary,
                                               long long seq_len) {
  FMView<IDX> f;
  f.rows = reinterpret_cast<const uint4*>(fused);
#pragma unroll
  for (int i = 0; i < 5; ++i) f.L2[i] = L2[i];
  f.primary = static_cast<IDX>(primary);
  f.seq_len = static_cast<IDX>(seq_len);
  return f;
}

// L2[i] for a run-time i in 0..4, kept in registers (no local-memory array)
template <typename IDX>
__device__ __forceinline__ IDX l2_at(const FMView<IDX>& f, int i) {
  IDX v = f.L2[0];
#pragma unroll
  for (int d = 1; d < 5; ++d) v = i == d ? f.L2[d] : v;
  return v;
}

__device__ __forceinline__ void load_row(const uint4* rows, long long blk,
                                         uint32_t r[12]) {
  const uint4* p = rows + blk * 3;
  const uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  r[8] = c.x; r[9] = c.y; r[10] = c.z; r[11] = c.w;
}

// low bit of each 2-bit field of w set iff the field equals code c
__device__ __forceinline__ uint32_t field_match(uint32_t w, int c) {
  const uint32_t y = w ^ (static_cast<uint32_t>(c) * 0x55555555u);
  return ~(y | (y >> 1)) & 0x55555555u;
}

// mask of the first n (0..16) bases of a word: its top 2n bits
__device__ __forceinline__ uint32_t keep_mask(int n) {
  return n <= 0 ? 0u : (0xFFFFFFFFu << (32 - 2 * n));
}

template <typename IDX>
__device__ __forceinline__ IDX at_least_one(IDX v) {
  return v < 1 ? IDX(1) : v;
}

// single-base bi-interval of code c (clamped to 0..3)
template <typename IDX>
__device__ __forceinline__ void single_char(const FMView<IDX>& f, int c,
                                            IDX& x0, IDX& x1, IDX& s) {
  const int cc = min(max(c, 0), 3);
  x0 = l2_at(f, cc) + 1;
  x1 = l2_at(f, 3 - cc) + 1;
  s = l2_at(f, cc + 1) - l2_at(f, cc);
}

// occ4: counts of codes 0..3 in BWT rows [0..k]; k < 0 -> 0, k == seq_len
// -> the totals, the sentinel row skipped (k >= primary reads k - 1)
template <typename IDX>
__device__ __forceinline__ void occ4(const FMView<IDX>& f, IDX k,
                                     IDX out[4]) {
  if (k < 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = 0;
    return;
  }
  if (k == f.seq_len) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = f.L2[c + 1] - f.L2[c];
    return;
  }
  IDX kk = k >= f.primary ? k - 1 : k;
  kk = kk < 0 ? IDX(0) : (kk > f.seq_len - 1 ? f.seq_len - 1 : kk);
  const IDX kp = kk + 1;
  uint32_t r[12];
  load_row(f.rows, static_cast<long long>(kp >> 7), r);
  const int rem = static_cast<int>(kp & 127);
  int cnt[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t keep = keep_mask(min(max(rem - 16 * i, 0), 16));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cnt[c] += __popc(field_match(r[4 + i], c) & keep);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = static_cast<IDX>(r[c]) + cnt[c];
}

// bidirectional extension of the bi-interval (x0, x1, s) by read code c
// (0..3): prepended when is_back, else appended (by its complement on the
// reverse side) -> (nx0, nx1, ns)
template <typename IDX>
__device__ __forceinline__ void extend_dir(const FMView<IDX>& f, IDX x0,
                                           IDX x1, IDX s, int c, bool is_back,
                                           IDX& nx0, IDX& nx1, IDX& ns) {
  const IDX qpos = is_back ? x0 : x1;
  const int ce = is_back ? c : 3 - c;
  IDX tk[4], tl[4];
  occ4(f, qpos - 1, tk);
  occ4(f, qpos - 1 + s, tl);
  // other-side start of code ce: other + crosses + sizes of codes > ce
  IDX ot = (is_back ? x1 : x0)
           + ((qpos <= f.primary && qpos + s - 1 >= f.primary) ? 1 : 0);
  IDX st = 0, sz = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const IDX size = tl[d] - tk[d];
    if (d == ce) {
      st = f.L2[d] + 1 + tk[d];
      sz = size;
    }
    if (d > ce) ot += size;
  }
  ns = sz;
  nx0 = is_back ? st : ot;
  nx1 = is_back ? ot : st;
}

// LF mapping of row k (k != primary: the caller maps that row to 0)
template <typename IDX>
__device__ __forceinline__ IDX lf(const FMView<IDX>& f, IDX k) {
  const IDX kx = k > f.primary ? k - 1 : k;
  uint32_t r[12];
  load_row(f.rows, static_cast<long long>(kx >> 7), r);
  const int pos = static_cast<int>(kx & 127);
  uint32_t word = r[4];
#pragma unroll
  for (int i = 1; i < 8; ++i) word = (pos >> 4) == i ? r[4 + i] : word;
  const int c = (word >> ((15 - (pos & 15)) * 2)) & 3;
  uint32_t base = r[0];
#pragma unroll
  for (int d = 1; d < 4; ++d) base = c == d ? r[d] : base;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    cnt += __popc(field_match(r[4 + i], c)
                  & keep_mask(min(max(pos + 1 - 16 * i, 0), 16)));
  return l2_at(f, c) + static_cast<IDX>(base) + cnt;
}

}  // namespace lariat
