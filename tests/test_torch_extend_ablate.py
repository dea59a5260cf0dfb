"""T1 (the seed-extension ablation): the port's plain twin against the JAX
tool's Pallas kernel (tools/extend_ablate.py ``make_kernel``, run in
interpret mode over 128-lane chunks as ``run_variant`` runs it); a numpy
emulation of the kernel's warp (K1's wavefront body, copied into
csrc/extend_ablate.cu, with T1's row completion and switches) against both, at one tile and past
256 query columns; and the kernel wrapper against the twin on the card.
Exact int32: tolerance 0."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lariat_tpu_torch.ops import extend_ablate
from test_torch_wavefront import LANES, _shfl_up, _sub

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LQ, LT = 256, 64, 96
ROWS_LT = LT // 2          # the rows_288 variant's cut, at this size
WIDE_LQ = 300              # past one tile of 256 query columns


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tool():
    """tools/extend_ablate.py, loaded by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "extend_ablate_tool", os.path.join(REPO, "tools", "extend_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variant(name, Lt=LT):
    half, kw = extend_ablate.VARIANTS[name]
    return (Lt // 2 if half else Lt), kw


def _inputs(seed=3, n=B, Lq=LQ, Lt=LT):
    """Planted queries (2% substitutions, N codes) and edge lanes: qlen 0,
    tlen 0, qlen > tlen, tlen > the rows variant's Lt, a negative h0, a
    negative w (row 0's band empty, once with beg == qlen: gscore 0)."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(1, Lq + 1, n).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(-8, 40, n), Lt).clip(1)
    q = rng.integers(0, 4, (n, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (n, Lt)).astype(np.int32)
    for b in range(n):
        m = int(min(qlen[b], tlen[b]))
        off = int(rng.integers(0, max(1, int(tlen[b]) - m + 1)))
        t[b, off:off + m] = q[b, :m]
    mut = rng.random((n, Lt)) < 0.02
    t[mut] = (t[mut] + 1) % 4
    q[rng.random((n, Lq)) < 0.01] = 4
    t[rng.random((n, Lt)) < 0.01] = 4
    params = np.zeros((n, 8), np.int32)
    params[:, 0] = qlen
    params[:, 1] = tlen
    params[:, 2] = rng.choice([3, 12, 40, 100], n)
    params[:, 3] = rng.integers(5, 60, n)
    params[0:4, 0] = 0                          # qlen 0
    params[4:8, 1] = 0                          # tlen 0
    params[8:12, 0], params[8:12, 1] = 40, 10   # qlen > tlen
    params[12:20, 1] = Lt                       # tlen > the rows variant's
    params[12:20, 0] = Lq
    params[20:22, 3] = -3                       # h0 < 0: Lq - 1 argmax
    params[22, 2] = -2                          # w < 0: row 0 empty
    params[23, 0], params[23, 2] = 5, -5        # ... at beg == qlen
    return q, t, params


def _pallas(q, t, params, Lt, **kw):
    """make_kernel in interpret mode over 128-lane chunks (run_variant's
    loop, which has no interpret switch)."""
    call = jax.jit(pl.pallas_call(
        _tool().make_kernel(Lt, **kw),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        scratch_shapes=[pltpu.VMEM((q.shape[1] + 1, 128), jnp.int32)] * 2,
        interpret=True))
    return np.concatenate(
        [np.asarray(call(q[c:c + 128].T, t[c:c + 128, :Lt].T,
                         params[c:c + 128].T))
         for c in range(0, len(q), 128)], axis=1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def emulate_ablate(q, t, qlen, tlen, w, h0, Lt, cummax=True, trow=True,
                   writeback=True):
    """One task of T1 as its warp runs it (csrc/extend_ablate.cu
    ``extend_dp``): C columns a lane picked as the kernel picks them,
    the tiles past 256 columns with their row boundaries, the (h1, f, m,
    mj) hand-offs, T1's completion by the last lane and the voted stop ->
    (the task's 8 outputs, its warp steps)."""
    s = extend_ablate.SCORING
    o_del, e_del, o_ins, e_ins = s["o_del"], s["e_del"], s["o_ins"], s["e_ins"]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    sc = (s["match_sc"], s["mismatch_sc"], s["n_sc"])
    Lq = len(q)
    if qlen <= 0 or tlen <= 0:
        return (0, h0, -1, -1, -1, -1, 0, 0), 0
    ncols = min(qlen, Lq)
    r_stop = 0 if w < 0 else ncols + w
    n_rows = min(tlen, Lt, r_stop + 1)
    C = min(-(-ncols // 32), 8)
    W = 32 * C
    T = -(-ncols // W)
    best = dict(score=h0, i=-1, j=-1, ie=-1, g=-1)
    bnd = np.zeros((n_rows, 4), np.int64)
    steps = 0

    def complete(r, beg, h1, m, mj):
        end = min(r + w + 1, qlen)
        nonempty = beg < end
        h_last = h1 if nonempty and end <= ncols else 0
        if (end == qlen if nonempty else beg == qlen) and best["g"] < h_last:
            best["g"], best["ie"] = h_last, r
        if m == 0:
            mj = Lq - 1
        improved = m > best["score"]
        di, dj = r - best["i"], mj - best["j"]
        gap = (di - dj) * e_del if di > dj else (dj - di) * e_ins
        zcond = best["score"] - m - gap > s["zdrop"]
        if improved:
            best.update(score=m, i=r, j=mj)
        return m == 0 or (not improved and zcond)

    for k in range(T):
        last = k == T - 1
        j0 = k * W + LANES * C
        cols = j0[:, None] + np.arange(C)[None, :]
        qc = np.where(cols < ncols, q[np.minimum(cols, Lq - 1)], 4)
        eh = np.where(cols == 0, h0, np.maximum(
            h0 - oe_ins - (cols - 1) * e_ins, 0)).astype(np.int64)
        ee = np.zeros((32, C), np.int64)
        h1_in, f_in, m_in = (np.zeros(32, np.int64) for _ in range(3))
        mj_in = np.full(32, -1, np.int64)
        for st in range(n_rows + 31):
            i = st - LANES
            if k > 0 and st < n_rows:
                h1_in[0], f_in[0], m_in[0], mj_in[0] = bnd[st]
            valid = (i >= 0) & (i < n_rows)
            beg = np.where(i > w, i - w, 0)
            end = np.minimum(i + w + 1, ncols)
            if k == 0 and valid[0]:
                h1_in[0] = max(h0 - (o_del + e_del * (i[0] + 1)), 0) \
                    if beg[0] == 0 else 0
                f_in[0], m_in[0], mj_in[0] = 0, 0, -1
            tc = t[np.clip(i, 0, n_rows - 1)] if trow else t[0]
            h1, f, m, mj = h1_in.copy(), f_in.copy(), m_in.copy(), mj_in.copy()
            for c in range(C):
                j = j0 + c
                inb = valid & (j >= beg) & (j < end)
                Mr = eh[:, c]
                M = np.where(Mr != 0, Mr + _sub(qc[:, c], tc, *sc), 0)
                e = ee[:, c]
                if writeback:      # the band's cells, then column end
                    upd = inb
                    at_end = valid & (j == end)
                    h = np.maximum(np.maximum(M, e), f)
                    eh[:, c] = np.where(inb | at_end, h1, Mr)
                    ee[:, c] = np.where(inb, np.maximum(np.maximum(
                        M - oe_del, e - e_del), 0), np.where(at_end, 0, e))
                else:              # every column of a running row
                    upd = valid
                    M = np.where(inb, M, 0)
                    h = np.where(inb, np.maximum(np.maximum(M, e), f), 0)
                    eh[:, c] = np.where(valid, np.where(
                        (j > beg) & (j <= end), h1, 0), Mr)
                    ee[:, c] = np.where(valid, np.maximum(np.maximum(
                        M - oe_del, e - e_del), 0), e)
                later = upd & (h >= m)
                mj = np.where(later, j, mj)
                m = np.where(upd, np.maximum(h, m), m)
                fn = np.maximum(M - oe_ins, f - e_ins) if cummax else \
                    M - oe_ins
                f = np.where(upd, np.maximum(fn, 0), f)
                h1 = np.where(inb, h, h1)
            stop = False
            if valid[31]:
                r = int(i[31])
                if not last:
                    bnd[r] = (h1[31], f[31], m[31], mj[31])
                else:
                    stop = complete(r, int(beg[31]), int(h1[31]),
                                    int(m[31]), int(mj[31]))
            h1_in, f_in, m_in = (_shfl_up(np.where(valid, v, 0))
                                 for v in (h1, f, m))
            mj_in = _shfl_up(np.where(valid, mj, -1), -1)
            if stop:
                steps += st + 1
                return (0, best["score"], best["i"], best["j"], best["ie"],
                        best["g"], 0, 0), steps
        steps += n_rows + 31
    return (int(n_rows < tlen), best["score"], best["i"], best["j"],
            best["ie"], best["g"], 0, 0), steps


def _emulate_all(q, t, params, Lt, **kw):
    """emulate_ablate over a batch -> ((8, B) outputs, (B,) warp steps)."""
    res = [emulate_ablate(q[b], t[b], *(int(v) for v in params[b, :4]), Lt,
                          **kw) for b in range(len(q))]
    return (np.array([r[0] for r in res], np.int64).T,
            np.array([r[1] for r in res]))


@pytest.mark.parametrize("name", list(extend_ablate.VARIANTS))
def test_twin_matches_pallas_interpret(name):
    q, t, params = _inputs()
    Lt, kw = _variant(name)
    want = _pallas(q, t, params, Lt, **kw)
    got = extend_ablate.run_variant_plain(*_t(q, t, params), Lt, **kw)
    assert got.shape == (8, B) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "rows_288":    # lanes that never died and outran Lt
        assert got[0].sum() > 0


@pytest.mark.parametrize("name", ["baseline", "no_writeback"])
def test_twin_matches_pallas_interpret_past_one_tile(name):
    """Lq 300: the width where the kernel's body runs two column tiles."""
    q, t, params = _inputs(5, n=128, Lq=WIDE_LQ, Lt=64)
    Lt, kw = _variant(name, 64)
    want = _pallas(q, t, params, Lt, **kw)
    got = extend_ablate.run_variant_plain(*_t(q, t, params), Lt, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(extend_ablate.VARIANTS))
@pytest.mark.parametrize("Lq,n,seed", [(LQ, 96, 7), (WIDE_LQ, 40, 8)])
def test_warp_emulation_matches_twin(name, Lq, n, seed):
    """The kernel's schedule (emulate_ablate) against the twin, one tile
    and two; a stop at row r ends the last tile after r + 32 steps, and a
    task that never stops runs every tile's n_rows + 31 steps."""
    q, t, params = _inputs(seed, n=n, Lq=Lq, Lt=LT)
    Lt, kw = _variant(name)
    want = extend_ablate.run_variant_plain(*_t(q, t, params), Lt, **kw)
    got, steps = _emulate_all(q, t, params, Lt, **kw)
    np.testing.assert_array_equal(got, want.numpy())
    ql, tl = params[:, 0], params[:, 1]
    live = (ql > 0) & (tl > 0)
    assert (steps[~live] == 0).all()
    assert (steps[live] >= 32).all()
    if name == "rows_288":
        assert (got[0] == 1).any()    # lanes Lt cut, still alive


def test_run_variant_refuses_past_1023_columns():
    q, t, params = _t(*_inputs(n=24, Lq=1024, Lt=40))
    with pytest.raises(ValueError, match="1023"):
        extend_ablate.run_variant(q, t, params, 40)
    got = extend_ablate.run_variant(q[:, :1023].contiguous(), t, params, 40)
    assert got.shape == (8, 24)
    with pytest.raises(ValueError):
        extend_ablate.run_variant(q[:, :0], t, params, 40)


def test_every_ablation_differs_from_baseline():
    args = _t(*_inputs())
    base = extend_ablate.run_variant(*args, LT)
    for name in extend_ablate.VARIANTS:
        if name != "baseline":
            Lt, kw = _variant(name)
            got = extend_ablate.run_variant(*args, Lt, **kw)
            assert (got != base).any(dim=0).sum() > 0, name


def test_wrapper_routes_cpu_to_twin_and_rejects_the_rest():
    q, t, params = _t(*_inputs())
    got = extend_ablate.run_variant(q[:37], t[:37], params[:37], LT,
                                    cummax=False)
    want = extend_ablate.run_variant_plain(q[:37], t[:37], params[:37], LT,
                                           cummax=False)
    assert got.shape == (8, 37)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        extend_ablate.run_variant(q.numpy(), t, params, LT)
    with pytest.raises(ValueError):
        extend_ablate.run_variant(q.to("meta"), t, params, LT)
    with pytest.raises(ValueError):
        extend_ablate.run_variant(q, t[:, :10], params, LT)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(extend_ablate.VARIANTS))
@pytest.mark.parametrize("Lq", [LQ, WIDE_LQ, extend_ablate.MAX_LQ])
def test_kernel_matches_twin(name, Lq, cuda_device):
    q, t, params = _t(*_inputs(11, Lq=Lq))
    Lt, kw = _variant(name)
    want = extend_ablate.run_variant(q, t, params, Lt, **kw)
    got = extend_ablate.run_variant(*(x.to(cuda_device)
                                      for x in (q, t, params)), Lt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["baseline", "no_writeback", "minimal"])
@pytest.mark.parametrize("Lq", [LQ, WIDE_LQ])
def test_kernel_counts_its_steps(name, Lq, cuda_device):
    """The kernel's own step count (``steps=``) equals the emulated
    schedule's, task by task."""
    q, t, params = _inputs(12, n=64, Lq=Lq)
    Lt, kw = _variant(name)
    st = torch.full((64,), -1, dtype=torch.int32, device=cuda_device)
    got = extend_ablate.run_variant(*(x.to(cuda_device)
                                      for x in _t(q, t, params)), Lt,
                                    steps=st, **kw)
    torch.cuda.synchronize()
    want, want_steps = _emulate_all(q, t, params, Lt, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(st.cpu().numpy(), want_steps)
