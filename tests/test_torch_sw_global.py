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
