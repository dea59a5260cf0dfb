// K6: FM-index rank primitives on the fused occ table: the group rank of
// K4a and K4c (G threads a rank pair), the pair rank of K4b (one thread a
// rank pair, one row fetch when both ranks share a block), K5's `lf` and
// K7's single-code group rank (and `occ1`, its one-thread form). Shared
// __device__ code of the seeding kernels (smem.cu: K4a-K4c), the SA walk
// (sa_walk.cu: K5) and the exact match (exact_match.cu: K7); no launch of
// its own.
//
// Replaces lariat_tpu/ops/fm_batch.py `occ4_fused_batch` (with
// `_block_counts`), `bwt_extend_dir_batch` / `bwt_extend_batch`,
// `lf_batch` and `occ1_batch`, the XLA gathers every device seeding and
// exact-match step runs.
//
// The table is (n_blocks+1, 12) uint32 rows [ckpt 0..3 | 8 bwt words] (16
// 2-bit codes a word, base 0 in the high bits), handed over as int32 and
// read as up to three 16-byte pieces a row. Bound on the H100: each rank is
// one dependent gather of at most 48 bytes from a table of n/128 rows (about
// 1 M rows, 48 MB, at 64 Mbp: L2-resident; 50 M rows at hg38: device
// memory), then up to 32 popcounts. The in-block count is the reference's
// 2-bit XOR trick: a field matches code c iff (field ^ c) == 00.
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

// where the occ4 at k reads: nothing (k < 0: zeros; k == seq_len: the
// totals), else the first rem bases of block blk
template <typename IDX>
__device__ __forceinline__ void rank_at(const FMView<IDX>& f, IDX k,
                                        bool& load, long long& blk,
                                        int& rem) {
  load = k >= 0 && k != f.seq_len;
  IDX kk = k >= f.primary ? k - 1 : k;
  kk = kk < 0 ? IDX(0) : (kk > f.seq_len - 1 ? f.seq_len - 1 : kk);
  const IDX kp = kk + 1;
  blk = static_cast<long long>(kp >> 7);
  rem = static_cast<int>(kp & 127);
}

// the bi-interval (x0, x1, s) extended by read code c (0..3) from the occ4
// counts tk at qpos - 1 and tl at qpos - 1 + s (qpos = x0 when is_back,
// else x1)
template <typename IDX>
__device__ __forceinline__ void extend_from_occ(const FMView<IDX>& f, IDX x0,
                                                IDX x1, IDX s, int c,
                                                bool is_back, const IDX tk[4],
                                                const IDX tl[4], IDX& nx0,
                                                IDX& nx1, IDX& ns) {
  const IDX qpos = is_back ? x0 : x1;
  const int ce = is_back ? c : 3 - c;
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

// ---- the group rank (K4a, K4c) -------------------------------------------
//
// G threads (4, 8 or 16 consecutive lanes of a warp, `gmask`, g their rank
// in the group) compute the two occ4 of one extension together, at ka and
// kb. Every thread loads the checkpoint words of both rows (16 bytes each,
// one address across the group, so one request) and its share of one
// rank's bwt words (the first G/2 threads rank ka, the others kb; 16/G
// words a thread): both rows arrive in one round of loads. When both ranks
// fall in one block the second checkpoint load is skipped and the kb
// threads' words are the ka threads' sectors, so the row is fetched once.
// A thread counts its words for the four codes, a byte a code (a block
// counts at most 127 bases), and __shfl_xor_sync sums the bytes over the
// half and swaps them with the other half. Every thread of the group ends
// with both ranks. Returns the rows fetched (0-2); `need` false fetches
// none (the results are then unused).

template <int WPT>
__device__ __forceinline__ void load_words(const uint4* bwt, int part,
                                           uint32_t w[WPT]) {
  if constexpr (WPT == 4) {
    const uint4 v = __ldg(bwt + part);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (WPT == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(bwt) + part);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(bwt) + part);
  }
}

template <typename IDX, int G>
__device__ __forceinline__ int occ4_pair_group(const FMView<IDX>& f,
                                               bool need, IDX ka, IDX kb,
                                               int g, unsigned gmask,
                                               IDX ta[4], IDX tb[4]) {
  static_assert(G == 4 || G == 8 || G == 16, "a group is 4, 8 or 16 lanes");
  constexpr int H = G / 2;    // threads a rank
  constexpr int WPT = 8 / H;  // bwt words a thread
  bool la, lb;
  long long ba, bb;
  int ra, rb;
  rank_at(f, ka, la, ba, ra);
  rank_at(f, kb, lb, bb, rb);
  la = la && need;
  lb = lb && need;
  const bool same = la && lb && ba == bb;
  const bool on_b = g >= H;
  const int part = g & (H - 1);
  uint4 ca = make_uint4(0, 0, 0, 0), cb = ca;
  uint32_t wv[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) wv[i] = 0;
  if (la) ca = __ldg(f.rows + ba * 3);
  if (lb && !same) cb = __ldg(f.rows + bb * 3);
  if (on_b ? lb : la) load_words<WPT>(f.rows + (on_b ? bb : ba) * 3 + 1,
                                      part, wv);
  if (same) cb = ca;
  const int rem = on_b ? rb : ra;
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const uint32_t keep =
        keep_mask(min(max(rem - 16 * (part * WPT + i), 0), 16));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      packed += static_cast<uint32_t>(__popc(field_match(wv[i], c) & keep))
                << (8 * c);
  }
#pragma unroll
  for (int o = 1; o < H; o <<= 1) packed += __shfl_xor_sync(gmask, packed, o);
  const uint32_t other = __shfl_xor_sync(gmask, packed, H);
  const uint32_t pa = on_b ? other : packed, pb = on_b ? packed : other;
  const uint32_t cka[4] = {ca.x, ca.y, ca.z, ca.w};
  const uint32_t ckb[4] = {cb.x, cb.y, cb.z, cb.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const IDX tot = f.L2[c + 1] - f.L2[c];
    ta[c] = ka < 0 ? IDX(0)
            : (ka == f.seq_len ? tot
                               : static_cast<IDX>(cka[c])
                                     + static_cast<IDX>((pa >> (8 * c)) & 0xFFu));
    tb[c] = kb < 0 ? IDX(0)
            : (kb == f.seq_len ? tot
                               : static_cast<IDX>(ckb[c])
                                     + static_cast<IDX>((pb >> (8 * c)) & 0xFFu));
  }
  return (la ? 1 : 0) + (lb && !same ? 1 : 0);
}

// extend_dir with the group rank; returns the rows fetched
template <typename IDX, int G>
__device__ __forceinline__ int extend_dir_group(const FMView<IDX>& f,
                                                bool need, IDX x0, IDX x1,
                                                IDX s, int c, bool is_back,
                                                int g, unsigned gmask,
                                                IDX& nx0, IDX& nx1, IDX& ns) {
  const IDX qpos = is_back ? x0 : x1;
  IDX tk[4], tl[4];
  const int rows = occ4_pair_group<IDX, G>(f, need, qpos - 1, qpos - 1 + s,
                                           g, gmask, tk, tl);
  extend_from_occ(f, x0, x1, s, c, is_back, tk, tl, nx0, nx1, ns);
  return rows;
}

// ---- the pair rank (K4b) ---------------------------------------------------
//
// One thread computes both occ4 of an extension, at ka and kb. A row's
// checkpoint piece is loaded once when both ranks fall in its block (nearly
// always once an interval is small), and of its two pieces of bwt words
// only those the larger rank's position needs: the first when it counts any
// base, the second only past base 64 (as `lf` does). Both ranks count from
// the same registers, by bit planes (`bit_planes`, `occ4_from`): 12
// popcounts a rank, where counting a code a word takes 32 (the parent
// design's `occ4`) -- on the H100 a popcount issues at a quarter of the
// integer rate, and the popcounts set K4b's pace (PERF.md). Returns the
// rows fetched (0-2).

// the checkpoint of row blk and the bwt pieces that counting its first rem
// bases needs (the others zero)
__device__ __forceinline__ void load_pieces(const uint4* rows, long long blk,
                                            int rem, uint4& ck,
                                            uint32_t w[8]) {
  const uint4* p = rows + blk * 3;
  ck = __ldg(p);
  const uint4 lo = rem > 0 ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
  const uint4 hi = rem > 64 ? __ldg(p + 2) : make_uint4(0, 0, 0, 0);
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

// the bit planes of a row's eight bwt words, two words a plane word: pl[j]
// holds the fields' low bits (word 2j's in the even bits, word 2j + 1's in
// the odd bits), ph[j] their high bits
__device__ __forceinline__ void bit_planes(const uint32_t w[8],
                                           uint32_t pl[4], uint32_t ph[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pl[j] = (w[2 * j] & 0x55555555u) | ((w[2 * j + 1] << 1) & 0xAAAAAAAAu);
    ph[j] = ((w[2 * j] >> 1) & 0x55555555u) | (w[2 * j + 1] & 0xAAAAAAAAu);
  }
}

// a word's top `bits` bits (bits clamped to 0..32)
__device__ __forceinline__ uint32_t top_bits(int bits) {
  return __funnelshift_rc(0u, 0xFFFFFFFFu, static_cast<unsigned>(max(bits, 0)));
}

// occ4 at k from a row's checkpoint and bit planes, counting its first rem
// bases: a plane word's mask keeps the counted fields of both its words,
// then one popcount each counts the low bits (codes 1 and 3), the high bits
// (2 and 3) and both (3); code 0 is the rest of the rem bases
template <typename IDX>
__device__ __forceinline__ void occ4_from(const FMView<IDX>& f, IDX k,
                                          const uint4& ck,
                                          const uint32_t pl[4],
                                          const uint32_t ph[4], int rem,
                                          IDX out[4]) {
  int lo = 0, hi = 0, both = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t m = (top_bits(2 * rem - 64 * j) & 0x55555555u)
                       | (top_bits(2 * rem - 64 * j - 32) & 0xAAAAAAAAu);
    lo += __popc(pl[j] & m);
    hi += __popc(ph[j] & m);
    both += __popc(pl[j] & ph[j] & m);
  }
  const uint32_t base[4] = {ck.x, ck.y, ck.z, ck.w};
  const int add[4] = {rem - lo - hi + both, lo - both, hi - both, both};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const IDX tot = f.L2[c + 1] - f.L2[c];
    out[c] = k < 0 ? IDX(0)
             : (k == f.seq_len ? tot : static_cast<IDX>(base[c]) + add[c]);
  }
}

template <typename IDX>
__device__ __forceinline__ int occ4_pair(const FMView<IDX>& f, IDX ka, IDX kb,
                                         IDX ta[4], IDX tb[4]) {
  bool la, lb;
  long long ba, bb;
  int ra, rb;
  rank_at(f, ka, la, ba, ra);
  rank_at(f, kb, lb, bb, rb);
  const bool same = la && lb && ba == bb;
  uint4 ca = make_uint4(0, 0, 0, 0), cb = ca;
  uint32_t wa[8], wb[8], pla[4], pha[4], plb[4], phb[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) wa[i] = wb[i] = 0;
  if (la) load_pieces(f.rows, ba, same ? max(ra, rb) : ra, ca, wa);
  if (lb && !same) load_pieces(f.rows, bb, rb, cb, wb);
  bit_planes(wa, pla, pha);
  if (same) {
    cb = ca;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      plb[j] = pla[j];
      phb[j] = pha[j];
    }
  } else {
    bit_planes(wb, plb, phb);
  }
  occ4_from(f, ka, ca, pla, pha, ra, ta);
  occ4_from(f, kb, cb, plb, phb, rb, tb);
  return (la ? 1 : 0) + (lb && !same ? 1 : 0);
}

// extend_dir with the pair rank; returns the rows fetched
template <typename IDX>
__device__ __forceinline__ int extend_dir_pair(const FMView<IDX>& f, IDX x0,
                                               IDX x1, IDX s, int c,
                                               bool is_back, IDX& nx0,
                                               IDX& nx1, IDX& ns) {
  const IDX qpos = is_back ? x0 : x1;
  IDX tk[4], tl[4];
  const int rows = occ4_pair(f, qpos - 1, qpos - 1 + s, tk, tl);
  extend_from_occ(f, x0, x1, s, c, is_back, tk, tl, nx0, nx1, ns);
  return rows;
}

// LF mapping of row k (k != primary: the caller maps that row to 0). The
// base at k lies in the row's first piece of bwt words (pos < 64) or its
// second: the second is loaded only when the base lies in it, since no base
// of it is counted otherwise, so half the rows cost two 16-byte loads of
// three. The word and the checkpoint are picked by two-level selects.
template <typename IDX>
__device__ __forceinline__ IDX lf(const FMView<IDX>& f, IDX k) {
  const IDX kx = k > f.primary ? k - 1 : k;
  const uint4* p = f.rows + static_cast<long long>(kx >> 7) * 3;
  const int pos = static_cast<int>(kx & 127);
  const bool high = pos >= 64;
  const uint4 ck = __ldg(p), lo = __ldg(p + 1);
  const uint4 hi = high ? __ldg(p + 2) : make_uint4(0, 0, 0, 0);
  const uint4 v = high ? hi : lo;
  const int wi = (pos >> 4) & 3;
  const uint32_t word = (wi & 2) ? ((wi & 1) ? v.w : v.z)
                                 : ((wi & 1) ? v.y : v.x);
  const int c = (word >> ((15 - (pos & 15)) * 2)) & 3;
  const uint32_t base = (c & 2) ? ((c & 1) ? ck.w : ck.z)
                                : ((c & 1) ? ck.y : ck.x);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    cnt += __popc(field_match(w[i], c)
                  & keep_mask(min(max(pos + 1 - 16 * i, 0), 16)));
  return l2_at(f, c) + static_cast<IDX>(base) + cnt;
}

// ---- the single-code rank (K7) --------------------------------------------
//
// occ1 at k for code c (0..3): the count of c in BWT rows [0..k]
// (sentinel-adjusted), with occ1_batch's edges: k < 0 gives 0, k == seq_len
// the total of c. One checkpoint piece and the bwt pieces the position
// needs (`load_pieces`), then up to 8 popcounts of one code.

// count of code c among the first rem bases of a row's words
__device__ __forceinline__ int count_code(const uint32_t w[8], int rem,
                                          int c) {
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    cnt += __popc(field_match(w[i], c)
                  & keep_mask(min(max(rem - 16 * i, 0), 16)));
  return cnt;
}

// checkpoint word c (0..3) of a row's first piece
__device__ __forceinline__ uint32_t ckpt_of(const uint4& ck, int c) {
  return (c & 2) ? ((c & 1) ? ck.w : ck.z) : ((c & 1) ? ck.y : ck.x);
}

template <typename IDX>
__device__ __forceinline__ IDX occ1_edge(const FMView<IDX>& f, IDX k, int c,
                                         IDX counted) {
  return k < 0 ? IDX(0)
               : (k == f.seq_len ? l2_at(f, c + 1) - l2_at(f, c) : counted);
}

template <typename IDX>
__device__ __forceinline__ IDX occ1(const FMView<IDX>& f, IDX k, int c) {
  bool load;
  long long blk;
  int rem;
  rank_at(f, k, load, blk, rem);
  IDX counted = 0;
  if (load) {
    uint4 ck;
    uint32_t w[8];
    load_pieces(f.rows, blk, rem, ck, w);
    counted = static_cast<IDX>(ckpt_of(ck, c)) + count_code(w, rem, c);
  }
  return occ1_edge(f, k, c, counted);
}

// ---- the single-code group rank (K7) --------------------------------------
//
// G threads (4 or 8 consecutive lanes of a warp, `gmask`, g their rank in
// the group) compute occ1 at ka = k - 1 and kb = l for one code c, as the
// group rank does for occ4: every thread loads checkpoint word c of both
// rows (one address across the group, so one request; the second skipped
// when both ranks share a block), the first G/2 threads load ka's bwt
// words and the others kb's (16/G words a thread, none past the rank's
// position), so both rows arrive in one round of loads; when both share a
// block the kb threads' words are the ka threads' sectors and the row is
// fetched once. A thread counts code c in its words (field_match and one
// popcount a word), __shfl_xor_sync sums the counts over the half and swaps
// them with the other half, and every thread of the group ends with both
// ranks.
template <typename IDX, int G>
__device__ __forceinline__ void occ1_pair_group(const FMView<IDX>& f, IDX ka,
                                                IDX kb, int c, int g,
                                                unsigned gmask, IDX& ta,
                                                IDX& tb) {
  static_assert(G == 4 || G == 8, "a group is 4 or 8 lanes");
  constexpr int H = G / 2;    // threads a rank
  constexpr int WPT = 8 / H;  // bwt words a thread
  bool la, lb;
  long long ba, bb;
  int ra, rb;
  rank_at(f, ka, la, ba, ra);
  rank_at(f, kb, lb, bb, rb);
  const bool same = la && lb && ba == bb;
  const bool on_b = g >= H;
  const int part = g & (H - 1);
  uint32_t cka = 0, ckb = 0;
  uint32_t wv[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) wv[i] = 0;
  if (la) cka = __ldg(reinterpret_cast<const uint32_t*>(f.rows + ba * 3) + c);
  if (lb && !same)
    ckb = __ldg(reinterpret_cast<const uint32_t*>(f.rows + bb * 3) + c);
  const int rem = on_b ? rb : ra;
  if ((on_b ? lb : la) && rem > 16 * WPT * part)
    load_words<WPT>(f.rows + (on_b ? bb : ba) * 3 + 1, part, wv);
  if (same) ckb = cka;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < WPT; ++i)
    cnt += __popc(field_match(wv[i], c)
                  & keep_mask(min(max(rem - 16 * (part * WPT + i), 0), 16)));
#pragma unroll
  for (int o = 1; o < H; o <<= 1) cnt += __shfl_xor_sync(gmask, cnt, o);
  const int other = __shfl_xor_sync(gmask, cnt, H);
  ta = occ1_edge(f, ka, c,
                 static_cast<IDX>(cka) + static_cast<IDX>(on_b ? other : cnt));
  tb = occ1_edge(f, kb, c,
                 static_cast<IDX>(ckb) + static_cast<IDX>(on_b ? cnt : other));
}

}  // namespace lariat
