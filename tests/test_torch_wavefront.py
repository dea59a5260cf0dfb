"""The lane schedule of K1, K2 and K3 (csrc/sw_extend.cu,
csrc/sw_global.cu, csrc/sw_local.cu) rehearsed on the CPU: a numpy
emulation of one warp -- 32 lanes x C query columns, lane l on target row
s - l at step s, the shfl_up hand-offs, the column tiles with their row
boundaries, K2's ring of z rows, K1's in-order row completion by the last
lane with its voted stop -- held against the plain twins on the edge shapes
(qlen 0, tlen 0, qlen not a multiple of C, tlen < 32, several tiles, w = 0,
w >= qlen, rows past qlen + w, N codes, minsc 0; for K1 also zdrop 0 and
< 0, z-drops at rows 0-3 and while later rows are in flight, h0 <= o_ins +
e_ins). Exact: tolerance 0. C = 6 is K2's and K3's widest; C = 2 makes the
tiled path cheap to reach."""

import numpy as np
import pytest
import torch

from lariat_tpu_torch.ops import sw_batch, sw_extend, sw_global, sw_local

torch.set_num_threads(1)

NEG = -0x40000000
SC = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, match_sc=1, mismatch_sc=-4,
          n_sc=-1)
LANES = np.arange(32)


def _sub(qc, tc, match_sc, mismatch_sc, n_sc):
    return np.where((qc >= 4) | (tc >= 4), n_sc,
                    np.where(qc == tc, match_sc, mismatch_sc))


def _shfl_up(x, edge=0):
    """__shfl_up_sync by one lane, lane 0 then reset to the edge value."""
    return np.concatenate([[edge], x[:-1]])


def emulate_local(q, qlen, t, tlen, minsc, C, o_del, e_del, o_ins, e_ins,
                  match_sc, mismatch_sc, n_sc):
    """One task of K3 as its warp runs it -> (score, te, qe, score2,
    te2)."""
    W = 32 * C
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    max_sc = max(match_sc, 1)
    T = -(-qlen // W) if qlen > 0 else 0
    bnd = np.zeros((max(tlen, 1), 4), np.int64)
    cm = np.zeros(max(tlen, 1), np.int64)
    gmax, te, qe = 0, -1, -1
    for k in range(T):
        last = k == T - 1
        j0 = k * W + LANES * C
        nv = np.clip(qlen - j0, 0, C)
        cols = j0[:, None] + np.arange(C)[None, :]
        qc = np.where(cols < qlen, q[np.minimum(cols, len(q) - 1)], 4)
        H = np.zeros((32, C), np.int64)
        E = np.zeros((32, C), np.int64)
        hl_in, f_in, m_in, a_in = (np.zeros(32, np.int64) for _ in range(4))
        hl_prev = np.zeros(32, np.int64)
        for s in range(tlen + 31):
            i = s - LANES
            if k > 0 and s < tlen:
                hl_in[0], f_in[0], m_in[0], a_in[0] = bnd[s]
            diag0 = hl_prev
            hl_prev = hl_in.copy()
            valid = (i >= 0) & (i < tlen)
            tc = t[np.clip(i, 0, max(tlen - 1, 0))]
            diag, f, m, a = diag0.copy(), f_in.copy(), m_in.copy(), a_in.copy()
            for c in range(C):
                M = diag + _sub(qc[:, c], tc, match_sc, mismatch_sc, n_sc)
                diag = H[:, c].copy()
                h = np.maximum(np.maximum(M, E[:, c]), np.maximum(f, 0))
                e_new = np.maximum(np.maximum(E[:, c] - e_del, h - oe_del), 0)
                f = np.maximum(np.maximum(f - e_ins, h - oe_ins), 0)
                H[:, c] = np.where(valid, h, H[:, c])
                E[:, c] = np.where(valid, e_new, E[:, c])
                up = (c < nv) & (h > m)
                m = np.where(up, h, m)
                a = np.where(up, j0 + c, a)
            ho = np.where(valid, H[:, C - 1], 0)
            fo, mo, ao = (np.where(valid, v, 0) for v in (f, m, a))
            if valid[31]:
                r = i[31]
                if last:
                    cm[r] = m[31]
                    if m[31] > gmax:
                        gmax, te, qe = int(m[31]), int(r), int(a[31])
                else:
                    bnd[r] = (ho[31], fo[31], mo[31], ao[31])
            hl_in, f_in, m_in, a_in = (_shfl_up(v) for v in (ho, fo, mo, ao))
    thr = gmax + max_sc - 1
    run_max, run_idx, best2, te2 = -1, -2, -1, -1
    for i in range(tlen):
        c = int(cm[i]) if T > 0 else 0
        if c < minsc:
            continue
        if run_idx + 1 != i:
            if run_idx >= 0 and abs(run_idx - te) * max_sc > thr \
                    and run_max > best2:
                best2, te2 = run_max, run_idx
            run_max, run_idx = c, i
        elif run_max < c:
            run_max, run_idx = c, i
    if run_idx >= 0 and abs(run_idx - te) * max_sc > thr and run_max > best2:
        best2, te2 = run_max, run_idx
    return (0 if te < 0 else gmax, te, -1 if te < 0 else qe, best2, te2)


def emulate_global(q, qlen, t, tlen, w, Lq, Lt, C, o_del, e_del, o_ins,
                   e_ins, match_sc, mismatch_sc, n_sc):
    """One task of K2 as its warp runs it -> (score, z (Lt, Lq) uint8)."""
    W = 32 * C
    RING = 33
    gapoe_del, gapoe_ins = o_del + e_del, o_ins + e_ins
    z = np.full((Lt, Lq), 77, np.uint8)       # every byte must be written
    ring = np.full((RING, W), 99, np.uint8)
    eh_q = 0 if qlen == 0 else (-(o_ins + e_ins * qlen) if qlen <= w
                                else NEG)
    T = -(-qlen // W) if qlen > 0 else 1
    bnd = np.zeros((max(tlen, 1), 2), np.int64)
    for k in range(T):
        last = k == T - 1
        j0 = k * W + LANES * C
        cols = j0[:, None] + np.arange(C)[None, :]
        qc = np.where(cols < qlen, q[np.minimum(cols, len(q) - 1)], 4)
        eh = np.where(cols == 0, 0, np.where(cols <= w,
                                             -(o_ins + e_ins * cols), NEG))
        ee = np.full((32, C), NEG, np.int64)
        Wk = min(W, Lq - k * W)
        h1_in = np.zeros(32, np.int64)
        f_in = np.full(32, NEG, np.int64)
        for s in range(tlen + 31):
            i = s - LANES
            if k > 0 and s < tlen:
                h1_in[0], f_in[0] = bnd[s]
            valid = (i >= 0) & (i < tlen)
            beg = np.where(i > w, i - w, 0)
            end = np.minimum(i + w + 1, qlen)
            h1_init = np.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
            if k == 0 and valid[0]:
                h1_in[0], f_in[0] = h1_init[0], NEG
            tc = t[np.clip(i, 0, max(tlen - 1, 0))]
            h1, f = h1_in.copy(), f_in.copy()
            d_row = np.zeros((32, C), np.uint8)
            for c in range(C):
                j = j0 + c
                inb = valid & (j >= beg) & (j < end)
                M = eh[:, c] + _sub(qc[:, c], tc, match_sc, mismatch_sc, n_sc)
                e = ee[:, c]
                hm = np.maximum(M, e)
                h = np.maximum(hm, f)
                d = (np.where(hm >= f, np.where(M >= e, 0, 1), 2)
                     | np.where(e - e_del > M - gapoe_del, 4, 0)
                     | np.where(f - e_ins > M - gapoe_ins, 32, 0))
                eh[:, c] = np.where(inb, h1, eh[:, c])
                ee[:, c] = np.where(inb, np.maximum(M - gapoe_del, e - e_del),
                                    ee[:, c])
                f = np.where(inb, np.maximum(M - gapoe_ins, f - e_ins), f)
                h1 = np.where(inb, h, h1)
                d_row[:, c] = np.where(inb, d, 0)
            jh = np.where(beg < end, end, np.where(beg <= qlen, beg, -1))
            for c in range(C):
                eh[:, c] = np.where(valid & (j0 + c == jh), h1, eh[:, c])
                ee[:, c] = np.where(valid & (j0 + c == end), NEG, ee[:, c])
            if last and valid[31] and jh[31] == qlen:
                eh_q = int(h1[31])
            if not last and valid[31]:
                bnd[i[31]] = (h1[31], f[31])
            for ln in np.nonzero(valid)[0]:
                ring[i[ln] % RING, ln * C:(ln + 1) * C] = d_row[ln]
            h1 = np.where(valid, h1, 0)
            f = np.where(valid, f, 0)
            h1_in, f_in = _shfl_up(h1), _shfl_up(f)
            r = s - 31
            if 0 <= r < tlen:
                z[r, k * W:k * W + Wk] = ring[r % RING, :Wk]
    z[tlen:] = 0
    if T * W < Lq:
        z[:tlen, T * W:] = 0
    return eh_q, z


def _codes(rng, n, L, n_frac=0.05):
    x = rng.integers(0, 4, (n, L)).astype(np.uint8)
    x[rng.random((n, L)) < n_frac] = 4
    return x


def _local_case(seed, Lq, Lt, C):
    """Edge lanes first (qlen 0, tlen 0, tlen < 32, qlen not a multiple of
    C, a full tile, minsc 0), then planted random tasks."""
    rng = np.random.default_rng(seed)
    qlen = [0, 17, 0, 5, Lq, C * 32 + 1, Lq - 1, 3, Lq, 1]
    tlen = [Lt, 0, 0, 20, Lt, Lt - 3, 31, 1, 12, Lt]
    minsc = [19, 19, 19, 0, 19, 0, 5, 0, 19, 0]
    while len(qlen) < 24:
        qlen.append(int(rng.integers(1, Lq + 1)))
        tlen.append(int(rng.integers(1, Lt + 1)))
        minsc.append(int(rng.choice([0, 5, 19])))
    qlen = [min(v, Lq) for v in qlen]
    tlen = [min(v, Lt) for v in tlen]
    B = len(qlen)
    q, t = _codes(rng, B, Lq), _codes(rng, B, Lt)
    for b in range(B):      # plant the query: real alignments, second bests
        n = min(qlen[b], tlen[b])
        off = int(rng.integers(0, max(1, tlen[b] - n + 1)))
        t[b, off:off + n] = q[b, :n]
        if tlen[b] > 2 * n + 4 and n:
            t[b, tlen[b] - n:tlen[b]] = q[b, :n]
    return q, np.array(qlen, np.int32), t, np.array(tlen, np.int32), \
        np.array(minsc, np.int32)


@pytest.mark.parametrize("C,Lq,Lt", [(6, 192, 90), (6, 64, 40), (2, 150, 70),
                                    (3, 96, 50), (5, 160, 45)])
def test_local_wavefront_matches_twin(C, Lq, Lt):
    q, qlen, t, tlen, minsc = _local_case(C * Lq + Lt, Lq, Lt, C)
    want = sw_local.local_batch_plain(*(torch.from_numpy(a) for a in (
        q, qlen, t, tlen, minsc)), **SC).numpy()
    for b in range(len(qlen)):
        got = emulate_local(q[b], int(qlen[b]), t[b], int(tlen[b]),
                            int(minsc[b]), C, **SC)
        assert got == tuple(int(v) for v in want[:5, b]), b


def _global_case(seed, Lq, Lt):
    """Edge lanes (qlen 0, tlen 0, w 0, w >= qlen, rows past qlen + w,
    tlen < 32, qlen not a multiple of C), then random banded tasks."""
    rng = np.random.default_rng(seed)
    qlen = [0, 10, 30, 30, 12, Lq, Lq - 5, 7, 40, 1]
    tlen = [20, 0, 30, 35, Lt, Lt, 31, 25, Lt, 5]
    w = [3, 4, 0, 40, 2, 1, 100, 0, 5, 0]
    while len(qlen) < 24:
        ql = int(rng.integers(1, Lq + 1))
        qlen.append(ql)
        tlen.append(int(np.clip(ql + rng.integers(-8, 9), 1, Lt)))
        w.append(int(rng.integers(0, 30)))
    B = len(qlen)
    q, t = _codes(rng, B, Lq), _codes(rng, B, Lt)
    for b in range(B):
        n = min(qlen[b], tlen[b])
        t[b, :n] = q[b, :n]
        mut = rng.random(n) < 0.1
        t[b, :n][mut] = (t[b, :n][mut] + 1) % 4
    return q, np.array(qlen, np.int32), t, np.array(tlen, np.int32), \
        np.array(w, np.int32)


@pytest.mark.parametrize("C,Lq,Lt", [(6, 192, 80), (6, 48, 64), (2, 140, 150),
                                    (3, 96, 70), (5, 160, 60)])
def test_global_wavefront_matches_twin(C, Lq, Lt):
    q, qlen, t, tlen, w = _global_case(C + Lq + Lt, Lq, Lt)
    score, z = sw_global.global_batch_plain(*(torch.from_numpy(a) for a in (
        q, qlen, t, tlen, w)), **SC)
    score, z = score.numpy(), z.numpy()
    for b in range(len(qlen)):
        s, zb = emulate_global(q[b], int(qlen[b]), t[b], int(tlen[b]),
                               int(w[b]), Lq, Lt, C, **SC)
        assert s == int(score[b]), b
        np.testing.assert_array_equal(zb, z[b], err_msg=str(b))


def emulate_extend(q, qlen, t, tlen, w, h0, C, o_del, e_del, o_ins, e_ins,
                   match_sc, mismatch_sc, n_sc, end_bonus, zdrop):
    """One task of K1 as its warp runs it -> ((score, qle, tle, gtle,
    gscore, max_off), each column tile's warp steps, the row that stopped
    it or None)."""
    if qlen <= 0:
        return (h0, 0, 0, 0, h0, 0), [], None
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    max_ins = max(int((qlen * match_sc + end_bonus - o_ins) / e_ins + 1.0), 1)
    max_del = max(int((qlen * match_sc + end_bonus - o_del) / e_del + 1.0), 1)
    w = min(w, max_ins, max_del)
    r_empty = 0 if w < 0 else qlen + w
    n_rows = min(tlen, r_empty)
    W = 32 * C
    best = dict(score=h0, i=-1, j=-1, ie=-1, g=-1, off=0)
    stop_row, steps = None, []
    T = -(-qlen // W) if n_rows > 0 else 0
    bnd = np.zeros((max(n_rows, 1), 4), np.int64)
    for k in range(T):
        last = k == T - 1
        j0 = k * W + LANES * C
        cols = j0[:, None] + np.arange(C)[None, :]
        qc = np.where(cols < qlen, q[np.minimum(cols, len(q) - 1)], 4)
        eh = np.where(cols == 0, h0, np.maximum(h0 - oe_ins - (cols - 1)
                                                * e_ins, 0)).astype(np.int64)
        ee = np.zeros((32, C), np.int64)
        h1_in, f_in, m_in = (np.zeros(32, np.int64) for _ in range(3))
        mj_in = np.full(32, -1, np.int64)
        steps.append(0)
        for s in range(n_rows + 31):
            steps[-1] += 1
            i = s - LANES
            if k > 0 and s < n_rows:
                h1_in[0], f_in[0], m_in[0], mj_in[0] = bnd[s]
            valid = (i >= 0) & (i < n_rows)
            beg = np.where(i > w, i - w, 0)
            end = np.minimum(i + w + 1, qlen)
            if k == 0 and valid[0]:
                h1_in[0] = max(h0 - (o_del + e_del * (i[0] + 1)), 0) \
                    if beg[0] == 0 else 0
                f_in[0], m_in[0], mj_in[0] = 0, 0, -1
            tc = t[np.clip(i, 0, max(n_rows - 1, 0))]
            h1, f, m, mj = h1_in.copy(), f_in.copy(), m_in.copy(), mj_in.copy()
            for c in range(C):
                j = j0 + c
                inb = valid & (j >= beg) & (j < end)
                at_end = valid & (j == end)
                Mr = eh[:, c]
                M = np.where(Mr != 0, Mr + _sub(qc[:, c], tc, match_sc,
                                                mismatch_sc, n_sc), 0)
                e = ee[:, c]
                h = np.maximum(np.maximum(M, e), f)
                eh[:, c] = np.where(inb | at_end, h1, eh[:, c])
                ee[:, c] = np.where(inb, np.maximum(np.maximum(
                    M - oe_del, e - e_del), 0), np.where(at_end, 0, e))
                later = inb & (h >= m)
                mj = np.where(later, j, mj)
                m = np.where(inb, np.maximum(h, m), m)
                f = np.where(inb, np.maximum(np.maximum(M - oe_ins,
                                                        f - e_ins), 0), f)
                h1 = np.where(inb, h, h1)
            stop = False
            if valid[31]:
                r = int(i[31])
                if not last:
                    bnd[r] = (h1[31], f[31], m[31], mj[31])
                else:
                    hl, ml, mjl = int(h1[31]), int(m[31]), int(mj[31])
                    if end[31] == qlen and best["g"] < hl:
                        best["ie"], best["g"] = r, hl
                    if ml == 0:
                        stop = True
                    elif ml > best["score"]:
                        best.update(score=ml, i=r, j=mjl,
                                    off=max(best["off"], abs(mjl - r)))
                    else:
                        di, dj = r - best["i"], mjl - best["j"]
                        gap = (di - dj) * e_del if di > dj else \
                            (dj - di) * e_ins
                        stop = best["score"] - ml - gap > zdrop
                    if stop:
                        stop_row = r
            h1_in, f_in, m_in = (_shfl_up(np.where(valid, v, 0))
                                 for v in (h1, f, m))
            mj_in = _shfl_up(np.where(valid, mj, -1), -1)
            if stop:
                break
    if stop_row is None and n_rows < tlen:
        beg = r_empty - w if r_empty > w else 0
        if beg == qlen and best["g"] < 0:
            best["ie"], best["g"] = r_empty, 0
    out = (best["score"], best["j"] + 1, best["i"] + 1, best["ie"] + 1,
           best["g"], best["off"])
    return out, steps, stop_row


def _extend_case(seed, Lq, Lt, C):
    """Edge lanes first (qlen 0, tlen 0, tlen < 32, qlen not a multiple of
    C, w 0, w >= qlen, rows past qlen + w, junk targets that z-drop within
    a few rows, h0 <= o_ins + e_ins, several tiles; a negative w, whose
    empty row 0 has beg == qlen: the gscore-0 case), then planted random
    tasks; N codes throughout."""
    rng = np.random.default_rng(seed)
    qlen = [0, 17, 12, 6 * C + 1, Lq, 30, 20, 9, 40, Lq - 3, 25, 1, 33, 50,
            4, 5]
    tlen = [Lt, 0, 20, Lt, Lt, Lt, Lt, 31, Lt, Lt, Lt, Lt, Lt, Lt, 10, 10]
    w = [10, 5, 3, 0, 100, 40, 2, 9, 4, 7, 100, 0, 12, 8, -4, -2]
    h0 = [30, 10, 7, 5, 40, 60, 25, 2, 30, 20, 90, 7, 15, 45, 20, 20]
    junk = {5, 10}        # targets unrelated to the query
    while len(qlen) < 22:
        ql = int(rng.integers(1, Lq + 1))
        qlen.append(ql)
        tlen.append(int(rng.integers(1, Lt + 1)))
        w.append(int(rng.integers(0, 60)))
        h0.append(int(rng.integers(0, 80)))
    qlen = [min(v, Lq) for v in qlen]
    tlen = [min(v, Lt) for v in tlen]
    B = len(qlen)
    q, t = _codes(rng, B, Lq), _codes(rng, B, Lt)
    for b in range(B):
        if b in junk:
            continue
        n = min(qlen[b], tlen[b])
        t[b, :n] = q[b, :n]
        mut = rng.random(n) < 0.08
        t[b, :n][mut] = (t[b, :n][mut] + 1) % 4
    return q, t, *(np.array(v, np.int32) for v in (qlen, tlen, w, h0))


EXT = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, match_sc=1, mismatch_sc=-4,
           n_sc=-1, end_bonus=5)


@pytest.mark.parametrize("C,Lq,Lt,zdrop", [
    (6, 192, 90, 100), (6, 64, 70, 5), (6, 100, 60, 0), (6, 80, 50, -1),
    (6, 260, 50, 100), (2, 150, 70, 100), (2, 140, 60, 3)])
def test_extend_wavefront_matches_twin(C, Lq, Lt, zdrop):
    q, t, qlen, tlen, w, h0 = _extend_case(C * Lq + Lt + zdrop, Lq, Lt, C)
    mat = sw_extend.score_matrix(1, -4, -1)
    want, rows = sw_batch.extend_batch(
        *(torch.from_numpy(a) for a in (q, qlen, t, tlen)), mat,
        torch.from_numpy(w), torch.from_numpy(h0), o_del=6, e_del=1,
        o_ins=6, e_ins=1, end_bonus=5, zdrop=zdrop, packed=True,
        rows_run=True)
    want, rows = want.numpy(), rows.numpy()
    stops = 0
    for b in range(len(qlen)):
        got, steps, stop_row = emulate_extend(
            q[b], int(qlen[b]), t[b], int(tlen[b]), int(w[b]), int(h0[b]),
            C, zdrop=zdrop, **EXT)
        assert got == tuple(int(v) for v in want[:, b]), b
        if stop_row is not None:
            # a stop at row r: r + 32 steps of the last tile, and it is the
            # twin's last row
            stops += 1
            assert steps[-1] == stop_row + 32 and rows[b] == stop_row + 1, b
    assert stops, "no task stopped early"
