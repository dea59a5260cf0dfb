"""The lane schedule of K2 and K3 (csrc/sw_global.cu, csrc/sw_local.cu)
rehearsed on the CPU: a numpy emulation of one warp -- 32 lanes x C query
columns, lane l on target row s - l at step s, the shfl_up hand-offs, the
column tiles with their row boundaries, and K2's ring of z rows -- held
against the plain twins on the edge shapes (qlen 0, tlen 0, qlen not a
multiple of C, tlen < 32, several tiles, w = 0, w >= qlen, rows past
qlen + w, N codes, minsc 0). Exact: tolerance 0. C = 6 is the kernels'; C =
2 makes the tiled path cheap to reach."""

import numpy as np
import pytest
import torch

from lariat_tpu_torch.ops import sw_global, sw_local

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
