"""K2 (banded ksw_global2) and K2b (its backtrack): the port's plain twins
and wrappers against lariat_tpu's global_batch_pallas (interpret mode),
traceback_ops_fused and the scalar ksw.global_align. Exact: tolerance 0.

K2's z is compared on rows below tlen (in band and out of it): the Pallas
kernel also writes rows past tlen from frozen state, which no walk reads.
"""

import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops import sw_global_pallas
from lariat_tpu_torch.ops import sw_global

from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)

MAT = np.asarray(ksw.fill_score_matrix(1, 4))


def _cases(seed, B=12, Lq=96, Lt=128):
    rng = np.random.default_rng(seed + 70)
    qa = np.zeros((B, Lq), np.int32)
    ta = np.zeros((B, Lt), np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    wv = np.zeros(B, np.int32)
    cases = []
    for i in range(B):
        ql = int(rng.integers(10, Lq + 1))
        ref = rng.integers(0, 4, Lt + 8)
        q = ref[:ql].copy()
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, ql))
            q[p] = (q[p] + 1 + rng.integers(0, 4)) % 5   # N codes too
        tl = min(Lt, max(1, ql + int(rng.integers(-6, 7))))
        t = ref[:tl].copy()
        w = max(abs(ql - tl), int(rng.choice([1, 2, 10, 25, 100])))
        qa[i, :ql] = q
        ta[i, :tl] = t
        qlen[i], tlen[i], wv[i] = ql, tl, w
        cases.append((q, t, w))
    # the session's pad lanes (1-base dummies) and empty lanes
    qlen[-1] = tlen[-1] = wv[-1] = 1
    qlen[-2], tlen[-3] = 0, 0
    return qa, qlen, ta, tlen, wv, cases[:-3]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _compared_z(z, tlen):
    """z with rows at and past tlen zeroed (the compared region)."""
    z = np.array(z)
    for b, tl in enumerate(tlen):
        z[b, max(int(tl), 0):] = 0
    return z


@pytest.mark.parametrize("seed", range(2))
def test_global_twin_matches_pallas_interpret(seed):
    qa, qlen, ta, tlen, wv, _ = _cases(seed)
    want = sw_global_pallas.global_batch_pallas(
        qa, qlen, ta, tlen, MAT, wv, tile_b=8, interpret=True)
    score, z = sw_global.global_batch(*_t(qa, qlen, ta, tlen, wv))
    np.testing.assert_array_equal(score.numpy(), np.asarray(want.score))
    assert tuple(z.shape) == (len(qlen), ta.shape[1], qa.shape[1])
    np.testing.assert_array_equal(_compared_z(z.numpy(), tlen),
                                  _compared_z(np.asarray(want.z), tlen))


@pytest.mark.parametrize("seed", range(2))
def test_traceback_twin_matches_fused(seed):
    """K2b twin's blob == traceback_ops_fused over the Pallas z, in full,
    and its CIGARs == ksw.global_align's."""
    qa, qlen, ta, tlen, wv, cases = _cases(seed + 10)
    S = qa.shape[1] + ta.shape[1]
    res = sw_global_pallas.global_batch_pallas(
        qa, qlen, ta, tlen, MAT, wv, tile_b=8, interpret=True)
    want = np.asarray(sw_global_pallas.traceback_ops_fused(
        res.z, qlen, tlen, wv, res.score, S=S, packed_layout=False))
    ql, tl, w = _t(qlen, tlen, wv)
    score, z = sw_global.global_batch(*_t(qa, qlen, ta, tlen, wv))
    blob = sw_global.traceback_ops_fused(z, ql, tl, w, score, S=S)
    assert blob.dtype == torch.uint8
    np.testing.assert_array_equal(blob.numpy(), want)
    packed, sc, i_fin, k_fin = sw_global.split_traceback_blob(
        blob.numpy(), S)
    got = sw_global.cigars_from_ops_packed(packed, i_fin, k_fin, S)
    assert got is not None, "native packed finisher missing"
    cig, nops = got
    for i, (q, t, wi) in enumerate(cases):
        want_score, want_cigar = ksw.global_align(
            q.astype(np.int64), t.astype(np.int64), MAT, 6, 1, 6, 1, wi)
        n = int(nops[i])
        pairs = list(zip(cig[i, 0:2 * n:2].tolist(),
                         cig[i, 1:2 * n:2].tolist()))
        assert (int(sc[i]), pairs) == (want_score, want_cigar), i


def test_cigars_from_ops_raw_matches_packed():
    qa, qlen, ta, tlen, wv, _ = _cases(3)
    S = qa.shape[1] + ta.shape[1]
    ql, tl, w = _t(qlen, tlen, wv)
    score, z = sw_global.global_batch(*_t(qa, qlen, ta, tlen, wv))
    blob = sw_global.traceback_ops_fused(z, ql, tl, w, score, S=S).numpy()
    packed, _, i_fin, k_fin = sw_global.split_traceback_blob(blob, S)
    ops = np.stack([(packed >> (2 * s)) & 3 for s in range(4)],
                   axis=2).reshape(len(qlen), S)
    ops = np.where(ops == 3, 255, ops).astype(np.uint8)
    raw = sw_global.cigars_from_ops_raw(ops, i_fin, k_fin)
    pk = sw_global.cigars_from_ops_packed(packed, i_fin, k_fin, S)
    np.testing.assert_array_equal(raw[1], pk[1])
    for b, n in enumerate(pk[1]):
        np.testing.assert_array_equal(raw[0][b, :2 * n], pk[0][b, :2 * n])


@pytest.mark.cuda
def test_global_and_traceback_kernels_match_twins(cuda_device):  # noqa: F811
    qa, qlen, ta, tlen, wv, _ = _cases(21, B=300, Lq=192, Lt=384)
    S = qa.shape[1] + ta.shape[1]
    cpu = _t(qa, qlen, ta, tlen, wv)
    ws, wz = sw_global.global_batch(*cpu)
    wblob = sw_global.traceback_ops_fused(wz, cpu[1], cpu[3], cpu[4], ws, S)
    dev = [x.to(cuda_device) for x in cpu]
    gs, gz = sw_global.global_batch(*dev)
    gblob = sw_global.traceback_ops_fused(gz, dev[1], dev[3], dev[4], gs, S)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gs.cpu().numpy(), ws.numpy())
    np.testing.assert_array_equal(gz.cpu().numpy(), wz.numpy())
    np.testing.assert_array_equal(gblob.cpu().numpy(), wblob.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lt", [(192, 80), (48, 64), (448, 300)])
def test_global_kernel_edge_shapes(cuda_device, Lq, Lt):  # noqa: F811
    """The wavefront's edge lanes (qlen 0, tlen 0, w 0, w >= qlen, rows
    past qlen + w, tlen < 32) and its tiled path (Lq 448); K2b on the
    kernel's z."""
    from test_torch_wavefront import _global_case
    cpu = [torch.from_numpy(a) for a in _global_case(Lq + Lt, Lq, Lt)]
    q, qlen, t, tlen, w = cpu
    ws, wz = sw_global.global_batch_plain(*cpu)
    gs, gz = sw_global.global_batch(*(x.to(cuda_device) for x in cpu))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gs.cpu().numpy(), ws.numpy())
    np.testing.assert_array_equal(gz.cpu().numpy(), wz.numpy())
    S = -(-(Lq + Lt) // 4) * 4
    want = sw_global.traceback_ops_fused_plain(wz, qlen, tlen, w, ws, S)
    got = sw_global.traceback_ops_fused(
        gz, *(x.to(cuda_device) for x in (qlen, tlen, w)), gs, S)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ---- K2b's warp schedule (csrc/traceback.cu traceback_kernel), emulated -----

def _kernel_window():
    """kWinCols as csrc/traceback.cu sets it."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(sw_global.__file__), "..",
                            "csrc", "traceback.cu")).read()
    return int(re.search(r"constexpr int kWinCols = (\d+);", src).group(1))


def emulate_traceback_windows(z, qlen, tlen, w, score, S, C):
    """K2b as its warp runs it (traceback.cu traceback_kernel :81-143): a
    window of 32 rows x C columns staged around the clamped (i, k)
    (``stage`` :56: rows [ri - 31, ri], columns ending with the 16-column
    chunk of ck, rows and columns below 0 and columns past Lq left
    unstaged); lane 0 walks it until the clamped (i, k) leaves it, then the
    warp restages; ops packed four a byte into a row prefilled with 0xFF,
    the open byte finished with 3s (:129-133), then score, i_fin, k_fin.
    Returns (blob (B, S//4 + 12) uint8, windows staged (B,) int32);
    asserts that the walk reads only staged bytes."""
    B, Lt, Lq = z.shape
    P = S // 4
    blob = np.zeros((B, P + 12), np.uint8)
    windows = np.zeros(B, np.int32)

    def stage(b, r_end, c_end):
        win = np.full((32, C), -1, np.int64)
        for lane in range(32):
            r = r_end - 32 + lane
            for j in range(C // 16):
                c = c_end - C + 16 * j
                if r >= 0 and c >= 0:
                    hi = min(c + 16, Lq)
                    win[lane, 16 * j:16 * j + hi - c] = z[b, r, c:hi]
        return win

    for b in range(B):
        ops = np.full(P, 0xFF, np.uint8)
        i = int(tlen[b]) - 1
        k = min(i + int(w[b]) + 1, int(qlen[b])) - 1
        which = s = staged = acc = 0
        while s < S and i >= 0 and k >= 0:
            r_end = min(i, Lt - 1) + 1
            c_end = (min(k, Lq - 1) & ~15) + 16
            win = stage(b, r_end, c_end)
            staged += 1
            r0, c0 = r_end - 32, c_end - C
            while s < S and i >= 0 and k >= 0:
                ri, ck = min(i, Lt - 1), min(k, Lq - 1)
                if ri < r0 or ck < c0:
                    break
                d = int(win[ri - r0, ck - c0])
                assert d >= 0, "the walk read a byte no lane staged"
                wn = (d >> (which << 1)) & 3
                op = 0 if wn == 0 else (2 if wn == 1 else 1)
                i -= 0 if wn == 2 else 1
                k -= 0 if wn == 1 else 1
                which = wn
                acc |= op << ((s & 3) << 1)
                if (s & 3) == 3:
                    ops[s >> 2] = acc
                    acc = 0
                s += 1
        if s < S and (s & 3):
            for t in range(s, (s | 3) + 1):
                acc |= 3 << ((t & 3) << 1)
            ops[s >> 2] = acc
        blob[b, :P] = ops
        blob[b, P:] = np.array([score[b], i, k], np.int32).view(np.uint8)
        windows[b] = staged
    return blob, windows


def _walk_cases(seed, Lt, Lq):
    """A wave of K2b tasks: K2's z on _cases' alignments, then random z
    bytes, tlen 0, qlen 0, w 0, tlen > Lt and qlen > Lq (the clamps), and
    whole tasks of insertions (0x22: leaves through k < 0), deletions
    (0x05: leaves through i < 0) and matches (0), each run longer than a
    window -> (z, qlen, tlen, w, score) numpy arrays."""
    rng = np.random.default_rng(seed)
    qa, ql, ta, tl, wv, _ = _cases(seed, B=10, Lq=min(Lq, Lt), Lt=Lt)
    qa = np.pad(qa, ((0, 0), (0, Lq - qa.shape[1])))
    score, z2 = sw_global.global_batch(*_t(qa, ql, ta, tl, wv))
    n = 16
    zr = rng.integers(0, 256, (n, Lt, Lq)).astype(np.uint8)
    qr = rng.integers(1, Lq + 1, n).astype(np.int32)
    tr = rng.integers(1, Lt + 1, n).astype(np.int32)
    wr = rng.integers(0, 40, n).astype(np.int32)
    tr[0], qr[1], wr[2] = 0, 0, 0
    tr[3], qr[4] = Lt + 37, Lq + 9                  # the clamps
    tr[5], qr[5] = Lt + 5, Lq + 40
    for t, byte in ((6, 0x22), (7, 0x05), (8, 0x00), (9, 0x22)):
        zr[t] = byte
        qr[t], tr[t], wr[t] = Lq, Lt, Lq
    qr[9], tr[9] = Lq, 3                            # a long insertion run
    z = np.concatenate([z2.numpy(), zr])
    return (z, np.concatenate([ql, qr]), np.concatenate([tl, tr]),
            np.concatenate([wv, wr]),
            np.concatenate([score.numpy(),
                            rng.integers(-99, 99, n).astype(np.int32)]))


@pytest.mark.parametrize("Lt,Lq", [(80, 176), (70, 150)])
@pytest.mark.parametrize("C", [32, 64, 128])
def test_traceback_windows_emulation(Lt, Lq, C):
    """The window schedule against the twin and the JAX traceback_ops_fused
    (Lq 150: chunks past the row's end and misaligned rows, byte loads);
    S = Lt + Lq exactly; the windows staged."""
    z, ql, tl, wv, sc = _walk_cases(Lt + C, Lt, Lq)
    S = Lt + Lq
    got, windows = emulate_traceback_windows(z, ql, tl, wv, sc, S, C)
    want = sw_global.traceback_ops_fused_plain(*_t(z, ql, tl, wv, sc), S)
    np.testing.assert_array_equal(got, want.numpy())
    jw = np.asarray(sw_global_pallas.traceback_ops_fused(
        z, ql, tl, wv, sc, S=S, packed_layout=False))
    np.testing.assert_array_equal(got, jw)
    _, i_fin, k_fin = (sw_global.split_traceback_blob(got, S)[j]
                       for j in (1, 2, 3))
    n2 = 10                        # the K2 tasks; then the random-z ones
    walks = (tl > 0) & (np.minimum(tl + wv, ql) > 0)
    assert ((windows > 0) == walks).all()
    assert (windows[n2 + 6:n2 + 10] >= 2).all()    # runs past a window
    assert i_fin[n2 + 6] >= 0 and k_fin[n2 + 6] < 0   # insertions: k < 0
    assert i_fin[n2 + 7] < 0 and k_fin[n2 + 7] >= 0   # deletions: i < 0
    assert (i_fin < 0).any() and (k_fin < 0).any()
    # a deletion run: one window a 32 rows
    assert windows[n2 + 7] == -(-Lt // 32)


def test_traceback_window_constant():
    """The kernel's window width is one the emulation runs."""
    assert _kernel_window() in (32, 64, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("Lt,Lq", [(80, 176), (70, 150), (384, 192)])
def test_traceback_kernel_windows(cuda_device, Lt, Lq):  # noqa: F811
    """K2b on random z and the edge tasks against its twin, and its window
    count against the emulation's at the kernel's window."""
    z, ql, tl, wv, sc = _walk_cases(Lt + 5, Lt, Lq)
    S = -(-(Lt + Lq) // 4) * 4
    cpu = _t(z, ql, tl, wv, sc)
    want = sw_global.traceback_ops_fused_plain(*cpu, S)
    windows = torch.full((len(ql),), -1, dtype=torch.int32,
                         device=cuda_device)
    got = sw_global.traceback_ops_fused(*(x.to(cuda_device) for x in cpu),
                                        S, windows=windows)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    _, ew = emulate_traceback_windows(z, ql, tl, wv, sc, S,
                                      _kernel_window())
    np.testing.assert_array_equal(windows.cpu().numpy(), ew)
