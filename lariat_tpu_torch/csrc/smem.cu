// K4a-K4c: device SMEM seeding (bwa mem_collect_intv's three rounds), each
// lane running its own state machine to its end.
//
// Replaces the XLA loops of lariat_tpu/ops/smem_device.py:
//   K4a `min_starts_twoptr` (emit_direct=True): the two-pointer minimal-
//       start machine; plateau-end seeds go straight into per-lane slots;
//       its planes entry (emit_direct=False) runs the same machine without
//       the midpoint pruning and writes b(e), x0, x1, s and valid as (R, L)
//       planes, which K9 (compact.cu) turns into slots;
//   K4b `min_starts_kernel`: the exhaustive per-(read, e) backward
//       extension, the fallback on a blown step cap or a slot overflow;
//   K4c `strategy1_kernel` + `_pack_r3`: the round-3 forward-greedy walker.
// The reference's while/fori loops run every lane in lock step until the
// slowest is done; here a lane leaves as soon as it is done. A finished
// lane's transition is the identity, so per-lane loops give the
// reference's outputs lane for lane (K4a's step budget is the reference's
// cap rounded up to whole unrolled iterations; the wrapper passes it).
//
// Bound on the H100: a chain of dependent fused-row gathers (two ranks per
// extension, fm.cuh), no arithmetic bound. A kernel's time is its longest
// lane's chain: transitions x the latency of one.
// K4a runs a group of kTwoptrG threads per lane, so one transition costs
// one round of row loads instead of two and an eighth of the popcounts:
// the group fetches both ranks' rows at once (one row when both ranks fall
// in one block), each thread counts its own words, and __shfl_xor_sync sums
// them (fm.cuh's group rank); every thread of the group then runs the same
// deterministic transition, so nothing is broadcast, and only the group's
// first thread writes. The block's reads are staged in shared memory, so a
// step's only global loads are index rows. Blocks of one warp (4 lanes)
// spread a 4,096-read batch over 1,024 blocks, every SM; on the H100 groups
// of 8 ran faster than groups of 4 or 16, and one-warp blocks than blocks
// of 2 or 4 warps (PERF.md). The lane also
// counts its transitions and the rows it fetched (aux), which bound the
// kernel. K4c walks each read the same way: a group of kS1G threads a read
// on the group rank, one-warp blocks, the reads in shared memory; its walk
// is one step a base, so its time is the longest read's length x the
// latency of one rank round. K4b keeps one thread per lane, since its
// 786,432 lanes of a fallback batch already fill the card, on fm.cuh's pair
// rank: one row fetch an extension when both ranks share a block, only the
// row pieces its positions need.

#include <cstdint>

#include "common.cuh"
#include "fm.cuh"

namespace {

using lariat::FMView;

// ---- K4a ------------------------------------------------------------------
// Slots (kPlanes false): meta (R, cap+3) int32 [qb<<16|qe slots | min(n,
// cap) | lane_done | flags] and big (R, 3*cap) [x0 | x1 | s] arrive zeroed;
// the wrapper fills the flags column from aux (R, 3) = [n (uncapped),
// transitions run, fused rows fetched].
// Planes (kPlanes true, the reference's emit_direct=False): no midpoint
// pruning (mid, min_seed, cap, meta and big unused); every transition that
// settles a column e writes (b, x0, x1, s, valid) at column e - 1 of the
// zeroed (R, L) planes, and aux gets [lane done, transitions run, fused
// rows fetched].
constexpr int kTwoptrG = 8;         // threads a lane
constexpr int kTwoptrThreads = 32;  // a block: one warp, 4 lanes

template <typename IDX>
struct Planes {
  int32_t* b;
  IDX* x0;
  IDX* x1;
  IDX* s;
  bool* valid;
};

template <typename IDX, int G, bool kPlanes>
__global__ void __launch_bounds__(kTwoptrThreads) twoptr_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ start_v,
    const int32_t* __restrict__ end_v, const IDX* __restrict__ min_intv_v,
    const int32_t* __restrict__ mid_v, const int32_t* __restrict__ fused,
    const IDX* __restrict__ L2, long long primary, long long seq_len, int R,
    int L, int budget, int bwd_init, int min_seed, int cap,
    int32_t* __restrict__ meta, IDX* __restrict__ big,
    int32_t* __restrict__ aux, Planes<IDX> pl) {
  extern __shared__ __align__(16) uint8_t qs[];
  constexpr int kLanes = kTwoptrThreads / G;  // lanes a block
  const int lane0 = blockIdx.x * kLanes;
  const int g = threadIdx.x & (G - 1);
  const int lane = lane0 + static_cast<int>(threadIdx.x) / G;
  // the block's reads, staged once
  const int nl = min(kLanes, R - lane0);
  const uint8_t* src = reads + static_cast<size_t>(lane0) * L;
  for (int x = threadIdx.x; x < nl * L; x += blockDim.x) qs[x] = src[x];
  __syncthreads();
  if (lane >= R) return;  // group-uniform
  const unsigned gmask = ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const uint8_t* q = qs + (threadIdx.x / G) * L;
  const int start_e = start_v[lane], end_e = end_v[lane];
  const int mid = kPlanes ? 0 : mid_v[lane];
  const IDX min_intv = lariat::at_least_one(min_intv_v[lane]);
  // state: [b, e) with interval (x0, x1, s); in BWD, the scratch interval
  // (bx0, bx1, bs) of [p, etgt)
  int e, b, p, etgt;
  bool bwd;
  IDX x0 = 1, x1 = 1, s = 0, bx0 = 1, bx1 = 1, bs = 0;
  if (bwd_init) {
    // round-2 reseeds: b(start_e + 1) by a fresh backward scan; an N at
    // start_e leaves the machine empty at start_e + 1
    const int c0 = q[min(max(start_e, 0), L - 1)];
    const bool is_n0 = c0 >= 4;
    e = b = is_n0 ? start_e + 1 : start_e;
    bwd = !is_n0;
    p = start_e;
    etgt = start_e + 1;
    if (!is_n0) lariat::single_char(f, c0, bx0, bx1, bs);
  } else {
    e = b = start_e;
    bwd = false;
    p = etgt = 0;
  }
  int32_t* slots =
      kPlanes ? nullptr : meta + static_cast<size_t>(lane) * (cap + 3);
  IDX* bl = kPlanes ? nullptr : big + static_cast<size_t>(lane) * 3 * cap;
  const size_t prow = static_cast<size_t>(lane) * L;  // the lane's plane row
  // the planes' value at a column an N leaves invalid: the reference ranks
  // every lane, so a lane with no extension to run writes the forward
  // extension of (1, 1, 0) by code 3 (an N, clamped) there
  IDX dn0 = 0, dn1 = 0, dns = 0;
  if constexpr (kPlanes)
    lariat::extend_dir_group<IDX, G>(f, true, IDX(1), IDX(1), IDX(0), 3,
                                     false, g, gmask, dn0, dn1, dns);
  int n = 0, used = 0, rows = 0;
  while (used < budget) {
    const bool fwd_live = !bwd && e + 1 <= end_e;
    const bool bwd_live = bwd && etgt <= end_e;
    if (!fwd_live && !bwd_live) break;
    ++used;
    const int c_f = (e >= 0 && e < L) ? q[e] : 4;
    const int c_b = (p - 1 >= 0 && p - 1 < L) ? q[p - 1] : 4;
    const bool empty = fwd_live && b == e;
    const bool nf = c_f >= 4;
    const bool bwd_free = bwd_live && (p <= 0 || c_b >= 4);
    const bool do_bwd = bwd_live && !bwd_free;
    const bool do_fwd = fwd_live && !empty && !nf;
    const bool need = do_bwd || do_fwd;
    // every transition runs the group rank (loads off when not needed), so
    // the groups of a warp stay converged
    IDX nx0, nx1, ns;
    rows += lariat::extend_dir_group<IDX, G>(
        f, need, do_bwd ? bx0 : x0, do_bwd ? bx1 : x1, do_bwd ? bs : s,
        do_bwd ? c_b : min(c_f, 3), do_bwd, g, gmask, nx0, nx1, ns);
    const bool acc = need && ns >= min_intv;
    IDX sc0, sc1, scs;
    lariat::single_char(f, c_f, sc0, sc1, scs);
    const bool fwd_emit = fwd_live && (empty || nf || acc);
    const bool bwd_exit = bwd_free || (do_bwd && !acc);
    const bool fwd_acc = do_fwd && acc, bwd_acc = do_bwd && acc;
    const bool fresh = empty && !nf;
    int n_e = fwd_emit ? e + 1 : (bwd_exit ? etgt : e);
    const int n_b = (fwd_live && nf) ? e + 1 : (bwd_exit ? p : b);
    const IDX n_x0 = bwd_exit ? bx0 : (fresh ? sc0 : (fwd_acc ? nx0 : x0));
    const IDX n_x1 = bwd_exit ? bx1 : (fresh ? sc1 : (fwd_acc ? nx1 : x1));
    IDX n_s = bwd_exit ? bs
                       : ((fwd_live && nf) ? IDX(0)
                                           : (empty ? scs
                                                    : (fwd_acc ? ns : s)));
    if (empty && nf) n_s = 0;
    const bool enter_bwd = do_fwd && !acc;
    const bool n_bwd = bwd_exit ? false : (bwd || enter_bwd);
    const int n_p = enter_bwd ? e : (bwd_acc ? p - 1 : p);
    const int n_etgt = enter_bwd ? e + 1 : etgt;
    const IDX n_bx0 = enter_bwd ? sc0 : (bwd_acc ? nx0 : bx0);
    const IDX n_bx1 = enter_bwd ? sc1 : (bwd_acc ? nx1 : bx1);
    const IDX n_bs = enter_bwd ? scs : (bwd_acc ? ns : bs);
    if constexpr (kPlanes) {
      // column e - 1 of the e this transition settles: e + 1 forward, etgt
      // on a backward exit; an N leaves it invalid
      const int col = (bwd_exit ? etgt : e + 1) - 1;
      if ((fwd_emit || bwd_exit) && g == 0 && col >= 0 && col < L) {
        pl.b[prow + col] = bwd_exit ? p : b;
        pl.x0[prow + col] =
            bwd_exit ? bx0 : (empty ? sc0 : (need ? nx0 : dn0));
        pl.x1[prow + col] =
            bwd_exit ? bx1 : (empty ? sc1 : (need ? nx1 : dn1));
        pl.s[prow + col] = bwd_exit ? bs : (empty ? scs : (need ? ns : dns));
        pl.valid[prow + col] = !(fwd_live && nf);
      }
    }
    // midpoint pruning: a FWD lane whose b passed mid never emits again
    if (!kPlanes && !n_bwd && n_b > mid) n_e = end_e + 1;
    // a plateau ends when FWD fails, an N breaks it, or the lane reaches
    // end_e: its seed is [b, e), or the new state's at end_e
    const bool em1 = (enter_bwd || (fwd_live && nf)) && b < e;
    const bool em2 = (fwd_emit || bwd_exit) && n_e == end_e && n_b < n_e;
    if (!kPlanes && (em1 || em2)) {
      const int sqb = em2 ? n_b : b, sqe = em2 ? n_e : e;
      if (sqe - sqb >= min_seed && sqb <= mid && sqe > start_e) {
        if (n < cap && g == 0) {
          slots[n] = (sqb << 16) | sqe;
          bl[n] = em2 ? n_x0 : x0;
          bl[cap + n] = em2 ? n_x1 : x1;
          bl[2 * cap + n] = em2 ? n_s : s;
        }
        ++n;
      }
    }
    e = n_e; b = n_b; x0 = n_x0; x1 = n_x1; s = n_s;
    bwd = n_bwd; p = n_p; etgt = n_etgt; bx0 = n_bx0; bx1 = n_bx1; bs = n_bs;
  }
  if (g != 0) return;
  const bool live = bwd ? etgt <= end_e : e + 1 <= end_e;
  if constexpr (kPlanes) {
    aux[3 * lane] = live ? 0 : 1;
  } else {
    slots[cap] = min(n, cap);
    slots[cap + 1] = live ? 0 : 1;
    aux[3 * lane] = n;
  }
  aux[3 * lane + 1] = used;
  aux[3 * lane + 2] = rows;
}

// ---- K4b ------------------------------------------------------------------
// A thread a lane on the pair rank (fm.cuh `extend_dir_pair`: one row fetch
// an extension when both ranks share a block); on the H100 it ran 1.5-2.2x
// faster than a group of 4 or 8 threads a lane on the group rank (PERF.md).
// A lane reads its bases backward from e - 1 through one cached 16-byte
// load of its read (byte loads when L % 16 != 0), so a lane of any
// (read_idx, e) list costs one load a 16 bases. counts (N, 2) int32, when
// given, gets [extensions run, fused rows fetched] a lane.

// base pos (non-increasing from call to call) of read q: through the cached
// 16-byte chunk v holding bases [vb, vb + 16) when vec
__device__ __forceinline__ int read_back(const uint8_t* q, int pos, bool vec,
                                         uint4& v, int& vb) {
  if (!vec) return q[pos];
  if (pos < vb) {
    vb = pos & ~15;
    v = __ldg(reinterpret_cast<const uint4*>(q + vb));
  }
  const int o = pos - vb;
  const uint32_t wd = (o & 8) ? ((o & 4) ? v.w : v.z) : ((o & 4) ? v.y : v.x);
  return (wd >> (8 * (o & 3))) & 0xFF;
}

template <typename IDX>
__global__ void exhaustive_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ read_idx,
    const int32_t* __restrict__ e_v, const IDX* __restrict__ min_intv_v,
    const int32_t* __restrict__ fused, const IDX* __restrict__ L2,
    long long primary, long long seq_len, int N, int L,
    int32_t* __restrict__ b_out, IDX* __restrict__ x0_out,
    IDX* __restrict__ x1_out, IDX* __restrict__ s_out,
    bool* __restrict__ valid_out, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const uint8_t* q = reads + static_cast<size_t>(read_idx[i]) * L;
  const bool vec = (L & 15) == 0
                   && (reinterpret_cast<uintptr_t>(reads) & 15) == 0;
  uint4 v = make_uint4(0, 0, 0, 0);
  int vb = 1 << 30;
  const int e = e_v[i];
  const IDX min_intv = lariat::at_least_one(min_intv_v[i]);
  const int c0 = read_back(q, min(max(e - 1, 0), L - 1), vec, v, vb);
  const bool valid = e >= 1 && c0 < 4;
  IDX x0, x1, s;
  lariat::single_char(f, c0, x0, x1, s);
  int b = valid ? e - 1 : e;
  int ext = 0, rows = 0;
  if (valid) {
    // greedy backward extension until an N, the read start, or the
    // interval size falls below min_intv (the reference stops at L - 1
    // steps, which pos >= 0 already implies)
    for (int pos = e - 2; pos >= 0 && e - 2 - pos < L - 1; --pos) {
      const int c = read_back(q, min(pos, L - 1), vec, v, vb);
      if (c >= 4) break;
      IDX n0, n1, ns;
      rows += lariat::extend_dir_pair(f, x0, x1, s, c, true, n0, n1, ns);
      ++ext;
      if (ns < min_intv) break;
      x0 = n0; x1 = n1; s = ns; b = pos;
    }
  }
  b_out[i] = b;
  x0_out[i] = x0;
  x1_out[i] = x1;
  s_out[i] = s;
  valid_out[i] = valid;
  if (counts != nullptr) {
    counts[2 * i] = ext;
    counts[2 * i + 1] = rows;
  }
}

// ---- K4c ------------------------------------------------------------------
// meta (R, cap+1) int32 [qb<<16|qe slots | n] and big (R, 3*cap) [x0 | x1 |
// s] arrive zeroed. A group of G threads walks one read, as K4a's lanes do:
// every step runs the group rank (loads off at a scan start or an N, where
// no rank is needed), every thread of the group runs the same transition,
// and only the first writes a slot.
constexpr int kS1G = 8;          // threads a read
constexpr int kS1Threads = 32;   // a block: one warp, 4 reads

template <typename IDX>
__global__ void __launch_bounds__(kS1Threads) strategy1_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ fused, const IDX* __restrict__ L2,
    long long primary, long long seq_len, long long max_intv_ll, int R,
    int L, int min_len, int cap, int32_t* __restrict__ meta,
    IDX* __restrict__ big) {
  extern __shared__ __align__(16) uint8_t qs[];
  constexpr int G = kS1G;
  constexpr int kReads = kS1Threads / G;  // reads a block
  const int r0 = blockIdx.x * kReads;
  const int g = threadIdx.x & (G - 1);
  const int r = r0 + static_cast<int>(threadIdx.x) / G;
  // the block's reads, staged once
  const int nr = min(kReads, R - r0);
  const uint8_t* src = reads + static_cast<size_t>(r0) * L;
  for (int x = threadIdx.x; x < nr * L; x += blockDim.x) qs[x] = src[x];
  __syncthreads();
  if (r >= R) return;  // group-uniform
  const unsigned gmask = ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const FMView<IDX> f = lariat::fm_view(fused, L2, primary, seq_len);
  const uint8_t* q = qs + (threadIdx.x / G) * L;
  const int len = min(lens[r], L);
  const IDX max_intv = static_cast<IDX>(max_intv_ll);
  int32_t* mrow = meta + static_cast<size_t>(r) * (cap + 1);
  IDX* brow = big + static_cast<size_t>(r) * 3 * cap;
  // scan start x; interval of q[x..t)
  int x = 0, n = 0;
  IDX x0 = 1, x1 = 1, s = 0;
  for (int t = 0; t < len; ++t) {
    const int c = q[t];
    const bool is_n = c >= 4;        // an N restarts the scan past it
    const bool ext = !is_n && t > x;
    IDX n0, n1, ns;
    lariat::extend_dir_group<IDX, G>(f, ext, x0, x1, s, min(c, 3), false, g,
                                     gmask, n0, n1, ns);
    const bool emit = ext && ns < max_intv && t - x >= min_len && n < cap;
    if (emit && g == 0) {
      mrow[n] = (x << 16) | (t + 1);
      brow[n] = n0;
      brow[cap + n] = n1;
      brow[2 * cap + n] = ns;
    }
    if (t == x && !is_n) {           // scan start: the single-base interval
      lariat::single_char(f, c, x0, x1, s);
    } else if (ext) {
      x0 = n0; x1 = n1; s = ns;
    }
    if (emit) ++n;
    if (is_n || emit) x = t + 1;
  }
  if (g == 0) mrow[cap] = n;
}

// a block's dynamic shared memory past the 48 KB default needs the kernel's
// opt-in; below it (4 reads of L 192: 768 B) no host call is made
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  return smem > 48 * 1024 ? lariat::raise_smem_cap(kernel, smem)
                          : cudaSuccess;
}

template <typename IDX, bool kPlanes>
int launch_twoptr(const uint8_t* reads, const int32_t* start_e,
                  const int32_t* end_e, const void* min_intv,
                  const int32_t* mid, const int32_t* fused, const void* L2,
                  long long primary, long long seq_len, int R, int L,
                  int budget, int bwd_init, int min_seed, int cap,
                  int32_t* meta, void* big, int32_t* aux, Planes<IDX> pl,
                  cudaStream_t st) {
  constexpr int kLanes = kTwoptrThreads / kTwoptrG;
  const int smem = kLanes * L;  // the block's reads
  const cudaError_t err =
      allow_smem(twoptr_kernel<IDX, kTwoptrG, kPlanes>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  twoptr_kernel<IDX, kTwoptrG, kPlanes>
      <<<(R + kLanes - 1) / kLanes, kTwoptrThreads, smem, st>>>(
      reads, start_e, end_e, static_cast<const IDX*>(min_intv), mid, fused,
      static_cast<const IDX*>(L2), primary, seq_len, R, L, budget, bwd_init,
      min_seed, cap, meta, static_cast<IDX*>(big), aux, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename IDX>
int launch_strategy1(const uint8_t* reads, const int32_t* lens,
                     const int32_t* fused, const void* L2, long long primary,
                     long long seq_len, long long max_intv, int R, int L,
                     int min_len, int cap, int32_t* meta, void* big,
                     cudaStream_t st) {
  constexpr int kReads = kS1Threads / kS1G;
  const int smem = kReads * L;  // the block's reads
  const cudaError_t err = allow_smem(strategy1_kernel<IDX>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  strategy1_kernel<IDX>
      <<<(R + kReads - 1) / kReads, kS1Threads, smem, st>>>(
      reads, lens, fused, static_cast<const IDX*>(L2), primary, seq_len,
      max_intv, R, L, min_len, cap, meta, static_cast<IDX*>(big));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// reads (R, L) uint8; start_e/end_e/mid (R,) int32; min_intv (R,) IDX;
// fused (n_blocks+1, 12) int32; L2 (5,) IDX; idx64 picks IDX = int64_t;
// aux (R, 3) int32.
extern "C" int lariat_smem_twoptr(
    const uint8_t* reads, const int32_t* start_e, const int32_t* end_e,
    const void* min_intv, const int32_t* mid, const int32_t* fused,
    const void* L2, long long primary, long long seq_len, int idx64, int R,
    int L, int budget, int bwd_init, int min_seed, int cap, int32_t* meta,
    void* big, int32_t* aux, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_twoptr<int64_t, false>(
        reads, start_e, end_e, min_intv, mid, fused, L2, primary, seq_len, R,
        L, budget, bwd_init, min_seed, cap, meta, big, aux, {}, st);
  return launch_twoptr<int32_t, false>(
      reads, start_e, end_e, min_intv, mid, fused, L2, primary, seq_len, R,
      L, budget, bwd_init, min_seed, cap, meta, big, aux, {}, st);
}

// The planes entry: the same arguments without mid, min_seed, cap, meta
// and big; b (R, L) int32, x0/x1/s (R, L) IDX and valid (R, L) bool arrive
// zeroed; aux (R, 3) int32 gets [lane done, transitions, rows fetched].
extern "C" int lariat_smem_twoptr_planes(
    const uint8_t* reads, const int32_t* start_e, const int32_t* end_e,
    const void* min_intv, const int32_t* fused, const void* L2,
    long long primary, long long seq_len, int idx64, int R, int L,
    int budget, int bwd_init, int32_t* b, void* x0, void* x1, void* s,
    bool* valid, int32_t* aux, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) {
    const Planes<int64_t> pl{b, static_cast<int64_t*>(x0),
                             static_cast<int64_t*>(x1),
                             static_cast<int64_t*>(s), valid};
    return launch_twoptr<int64_t, true>(
        reads, start_e, end_e, min_intv, nullptr, fused, L2, primary,
        seq_len, R, L, budget, bwd_init, 0, 0, nullptr, nullptr, aux, pl,
        st);
  }
  const Planes<int32_t> pl{b, static_cast<int32_t*>(x0),
                           static_cast<int32_t*>(x1),
                           static_cast<int32_t*>(s), valid};
  return launch_twoptr<int32_t, true>(
      reads, start_e, end_e, min_intv, nullptr, fused, L2, primary, seq_len,
      R, L, budget, bwd_init, 0, 0, nullptr, nullptr, aux, pl, st);
}

// N lanes (read_idx[i], e[i], min_intv[i]) -> b (N,) int32, x0/x1/s (N,)
// IDX, valid (N,) bool; counts (N, 2) int32 or null.
extern "C" int lariat_smem_exhaustive(
    const uint8_t* reads, const int32_t* read_idx, const int32_t* e,
    const void* min_intv, const int32_t* fused, const void* L2,
    long long primary, long long seq_len, int idx64, int N, int L,
    int32_t* b, void* x0, void* x1, void* s, bool* valid, int32_t* counts,
    void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = lariat::blocks_for(N);
  if (idx64)
    exhaustive_kernel<int64_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, read_idx, e, static_cast<const int64_t*>(min_intv), fused,
        static_cast<const int64_t*>(L2), primary, seq_len, N, L, b,
        static_cast<int64_t*>(x0), static_cast<int64_t*>(x1),
        static_cast<int64_t*>(s), valid, counts);
  else
    exhaustive_kernel<int32_t><<<blocks, lariat::kThreads, 0, st>>>(
        reads, read_idx, e, static_cast<const int32_t*>(min_intv), fused,
        static_cast<const int32_t*>(L2), primary, seq_len, N, L, b,
        static_cast<int32_t*>(x0), static_cast<int32_t*>(x1),
        static_cast<int32_t*>(s), valid, counts);
  return static_cast<int>(cudaGetLastError());
}

// reads (R, L) uint8, lens (R,) int32 -> meta (R, cap+1) int32, big
// (R, 3*cap) IDX, both zeroed by the caller.
extern "C" int lariat_smem_strategy1(
    const uint8_t* reads, const int32_t* lens, const int32_t* fused,
    const void* L2, long long primary, long long seq_len, long long max_intv,
    int idx64, int R, int L, int min_len, int cap, int32_t* meta, void* big,
    void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64)
    return launch_strategy1<int64_t>(reads, lens, fused, L2, primary,
                                     seq_len, max_intv, R, L, min_len, cap,
                                     meta, big, st);
  return launch_strategy1<int32_t>(reads, lens, fused, L2, primary, seq_len,
                                   max_intv, R, L, min_len, cap, meta, big,
                                   st);
}
