"""The port's device seeding against lariat_tpu's (ops/smem_device.py and
parallel/align_step.py, XLA on the CPU) and the native C++ seeder: the
twins of K4a (two-pointer machine), K4b (exhaustive fallback), K4c
(strategy-1 walker + pack) and K5 (SA walk), and the whole
collect_seeds_rbegs_device on messy, segdup-heavy and low-complexity reads,
with the straggler split, the exhaustive fallback, slot overflow and int64
indices forced. Integer outputs: tolerance 0. The ``cuda`` cases hold each
kernel against its twin on the card."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.align.engine import encode_read
from lariat_tpu.config import AlignerConfig
from lariat_tpu.index import native_ops
from lariat_tpu.ops import fm_batch as jfm
from lariat_tpu.ops import smem_device as jsd
from lariat_tpu.parallel import align_step as jas
from lariat_tpu_torch.ops import fm_batch as tfm
from lariat_tpu_torch.ops import smem_device as tsd
from lariat_tpu_torch.parallel import align_step as tas

from lariat_tpu.index import fmindex
from test_rfa import dup_genome  # noqa: F401
from test_smem_device import _messy_reads
from test_torch_fm_batch import emulate_group_rank, emulate_pair_rank
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)

L = 192


def _low_complexity(genome):
    return [encode_read(b"A" * 151), encode_read(b"AT" * 75),
            encode_read(b"ACG" * 50), encode_read((b"A" * 30 + b"N") * 4),
            encode_read(genome[100:151] + b"A" * 40)]


def _segdup(genome, rng):
    """Reads inside the duplicated segment [2000:3000] (multi-occurrence
    seeds) and across its edges (round 2 re-seeds them and emits)."""
    out = []
    for _ in range(30):
        pos = 2000 + int(rng.integers(0, 900))
        out.append(encode_read(genome[pos:pos + int(rng.integers(60, 152))]))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for pos in (1950, 2900, 41950, 42900):
        seg = genome[pos:pos + 150]
        out += [encode_read(seg), encode_read(seg.translate(comp)[::-1])]
    return out


def _corpus(name, genome):
    if name == "messy":
        return _messy_reads(genome, np.random.default_rng(77))
    if name == "segdup":
        return _segdup(genome, np.random.default_rng(78))
    return _low_complexity(genome)


def _batch(reads, R=128):
    rmat = np.full((R, L), 4, np.uint8)
    lens = np.zeros(R, np.int32)
    for i, r in enumerate(reads):
        rmat[i, :len(r)] = r
        lens[i] = len(r)
    return rmat, lens


@pytest.fixture(scope="module")
def idx(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    jdfm = jfm.DeviceFMIndex.from_host(fm)
    fmd = tfm.DeviceFMIndex.from_host(fm, "cpu")
    fmd64 = tfm.DeviceFMIndex.from_numpy(
        np.asarray(jdfm.fused), fm.L2.astype(np.int64), fm.primary,
        fm.seq_len, "cpu")
    return fm, genome, jdfm, fmd, fmd64


def _twoptr_inputs(rmat, lens, bwd_init, seed=3):
    R = len(lens)
    rng = np.random.default_rng(seed)
    if not bwd_init:
        return (np.zeros(R, np.int32), np.ones(R, np.int64),
                np.full(R, L + 2, np.int32))
    mid = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
    return mid, rng.integers(1, 6, R).astype(np.int64), mid.copy()


# (bwd_init, max_steps, cap): round 1 at its phase-A budget, round 2 at
# its, a budget small enough to leave stragglers, and caps small enough to
# overflow
TWOPTR_CASES = [(False, 3 * L, 32), (True, 4 * L, 16), (False, 24, 32),
                (True, 30, 16), (False, 8 * L, 2), (True, 32 * L, 1)]


@pytest.mark.parametrize("bwd_init,max_steps,cap", TWOPTR_CASES)
def test_twoptr_twin_matches_jax(idx, bwd_init, max_steps, cap):
    fm, genome, jdfm, fmd, _ = idx
    reads = (_messy_reads(genome, np.random.default_rng(5), n=40)
             + _low_complexity(genome) + _segdup(genome,
                                                 np.random.default_rng(6)))
    rmat, lens = _batch(reads)
    start, mi, mid = _twoptr_inputs(rmat, lens, bwd_init)
    want = jsd.min_starts_twoptr(
        jdfm, jnp.asarray(rmat), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mi), L, max_steps=max_steps, bwd_init=bwd_init,
        emit_direct=True, min_seed=19, cap=cap, mid=jnp.asarray(mid))
    got = tsd.min_starts_twoptr(
        fmd, torch.from_numpy(rmat), torch.from_numpy(start),
        torch.from_numpy(lens), torch.from_numpy(mi), L,
        max_steps=max_steps, bwd_init=bwd_init, min_seed=19, cap=cap,
        mid=torch.from_numpy(mid))
    wmeta, wbig = (np.asarray(a) for a in want)
    gmeta, gbig = (a.numpy() for a in got[:2])
    # flags bits 2+ are the reference's transition count: equal too
    np.testing.assert_array_equal(gmeta, wmeta)
    np.testing.assert_array_equal(gbig, wbig)
    assert gbig.dtype == np.int32
    flags = int(gmeta[0, -1]) & 3
    if max_steps < 64:
        assert not flags & 1, "the small budget left no straggler"
    if cap <= 2 and not bwd_init:
        assert flags & 2, "the small cap did not overflow"


def test_exhaustive_twin_matches_jax(idx):
    fm, genome, jdfm, fmd, _ = idx
    reads = _messy_reads(genome, np.random.default_rng(8), n=20) + \
        _low_complexity(genome)
    rmat, lens = _batch(reads, R=len(reads))
    R = len(reads)
    ri = np.repeat(np.arange(R), L).astype(np.int32)
    e = np.tile(np.arange(0, L), R).astype(np.int32)      # e = 0 included
    mi = np.random.default_rng(9).integers(1, 5, R * L).astype(np.int64)
    want = jsd.min_starts_kernel(jdfm, jnp.asarray(rmat), jnp.asarray(ri),
                                 jnp.asarray(e), jnp.asarray(mi), L)
    got = tsd.min_starts_kernel(fmd, torch.from_numpy(rmat),
                                torch.from_numpy(ri), torch.from_numpy(e),
                                torch.from_numpy(mi), L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def emulate_exhaustive(fmd, rmat, ri, e, mi, L):
    """K4b's lanes as the kernel runs them (smem.cu `exhaustive_kernel`
    :200-247, one thread a lane on fm.cuh's pair rank; `read_back` :187),
    in lock step as the twin
    steps: each lane's bases read backward from e - 1 through a cached
    16-byte chunk of its read (``read_back``), its extensions run (the one
    that ends the walk included) and the fused rows its pair ranks fetch
    (``emulate_pair_rank``) -> (b, x0, x1, s, valid, counts (N, 2) int32
    [extensions, rows], 16-byte read chunks loaded a lane)."""
    fused = fmd.fused.numpy()
    L2 = fmd.L2.numpy().astype(np.int64)
    q = rmat[ri.astype(np.int64)].astype(np.int64)
    e = e.astype(np.int64)
    n = len(e)
    lanes = np.arange(n)
    vb = np.full(n, 1 << 30)
    chunks = np.zeros(n, np.int64)

    def read_back(pos, on):
        # a chunk load where the lane's base leaves its cached chunk
        load = on & (pos < vb)
        chunks[load] += 1
        vb[load] = pos[load] & ~15
        return q[lanes, np.clip(pos, 0, L - 1)]

    c0 = read_back(np.clip(e - 1, 0, L - 1), np.ones(n, bool))
    valid = (e >= 1) & (c0 < 4)
    cc = np.clip(c0, 0, 3)
    x0, x1, s = L2[cc] + 1, L2[3 - cc] + 1, L2[cc + 1] - L2[cc]
    b = np.where(valid, e - 1, e)
    ext = np.zeros(n, np.int64)
    rows = np.zeros(n, np.int64)
    alive = valid.copy()
    for t in range(L - 1):
        pos = e - 2 - t
        alive &= pos >= 0
        c = read_back(np.minimum(pos, L - 1), alive)
        can = alive & (c < 4)
        if not can.any():
            break
        _, _, r, _ = emulate_pair_rank(fused, L2, fmd.primary, fmd.seq_len,
                                       x0 - 1, x0 - 1 + s)
        T = torch.from_numpy
        n0, n1, ns = (v.numpy().astype(np.int64) for v in
                      tfm.bwt_extend_dir_batch(
                          fmd, T(np.where(can, x0, 1)),
                          T(np.where(can, x1, 1)), T(np.where(can, s, 0)),
                          T(np.clip(c, 0, 3)), T(np.ones(n, bool))))
        ext += can
        rows += np.where(can, r, 0)
        acc = can & (ns >= np.maximum(mi, 1))
        x0, x1, s = (np.where(acc, a, o) for a, o in ((n0, x0), (n1, x1),
                                                      (ns, s)))
        b = np.where(acc, pos, b)
        alive = acc
    counts = np.stack([ext, rows], axis=1).astype(np.int32)
    return b, x0, x1, s, valid, counts, chunks


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exhaustive_pair_schedule(idx, dt):
    """K4b's schedule (pair rank, cached read chunks) against the twin on
    messy and low-complexity reads, e = 0..L - 1, min_intv 1-4 and lanes
    in a shuffled (read_idx, e) order, as round 2's fallback passes them:
    the extensions and rows the kernel will count; one row fetch an
    extension wherever both ranks share a block."""
    fm, genome, _, fmd32, fmd64 = idx
    fmd = fmd32 if dt == "int32" else fmd64
    reads = _messy_reads(genome, np.random.default_rng(8), n=20) + \
        _low_complexity(genome)
    rmat, _ = _batch(reads, R=len(reads))
    R = len(reads)
    rng = np.random.default_rng(10)
    order = rng.permutation(R * L)
    ri = np.repeat(np.arange(R), L).astype(np.int32)[order]
    e = np.tile(np.arange(0, L), R).astype(np.int32)[order]
    mi = rng.integers(1, 5, R * L).astype(np.int64)
    *got, counts, chunks = emulate_exhaustive(fmd, rmat, ri, e, mi, L)
    want = tsd.min_starts_kernel_plain(fmd, torch.from_numpy(rmat),
                                       torch.from_numpy(ri),
                                       torch.from_numpy(e),
                                       torch.from_numpy(mi), L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    ext, rows = counts[:, 0].astype(np.int64), counts[:, 1]
    assert (rows <= 2 * ext).all() and rows.sum() < 1.5 * ext.sum()
    assert ext.max() >= 100 and (chunks <= 1 + (e + 15) // 16).all()


def test_strategy1_twin_and_pack_match_jax(idx):
    fm, genome, jdfm, fmd, _ = idx
    reads = _messy_reads(genome, np.random.default_rng(10)) + \
        _low_complexity(genome)
    rmat, lens = _batch(reads)
    cap3 = L // 19 + 2
    want = jsd.strategy1_kernel(jdfm, jnp.asarray(rmat), jnp.asarray(lens),
                                20, L, 19, cap3)
    got = tsd.strategy1_plain(fmd, torch.from_numpy(rmat),
                              torch.from_numpy(lens), 20, L, 19, cap3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) > 0
    wpk = jsd._pack_r3(*want)
    gpk = tsd.strategy1(fmd, torch.from_numpy(rmat), torch.from_numpy(lens),
                        20, L, 19, cap3)
    for g, w in zip(gpk, wpk):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tsd.pack_r3(*got), wpk):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _s1_edges(genome):
    """Reads at K4c's edges: an N at the scan start, runs of Ns (a scan
    restarted right after an emission or before the end), a read of length
    0, reads shorter than min_len (19) or just at it, all-N, and repeats
    (segdup) that emit at every step past min_len."""
    g = genome
    return [encode_read(b"N" + g[300:450]), encode_read(b"NN" + g[900:1000]),
            encode_read(g[1200:1240] + b"NNNNN" + g[1300:1360] + b"N" * 12
                        + g[1400:1430]),
            encode_read(g[5000:5100] + b"N"), encode_read(b""),
            encode_read(g[700:710]), encode_read(g[720:739]),
            encode_read(g[760:780]), encode_read(b"N" * 60),
            encode_read((g[6000:6019] + b"N") * 7),
            encode_read(g[2100:2251]), encode_read(g[42100:42251])]


def _s1_inputs(genome):
    return _batch(_s1_edges(genome)
                  + _messy_reads(genome, np.random.default_rng(10), n=40)
                  + _low_complexity(genome))


def emulate_strategy1(fmd, rmat, lens, max_intv, min_len, cap, G):
    """K4c's group schedule in numpy: every thread of a read's group keeps
    its own state and runs the same transition on its own counts from the
    group rank (``emulate_group_rank``, loads off where the step needs no
    rank), and only thread 0 writes a slot. The threads' ranks and states
    must agree at every step. Returns strategy1_plain's tuple."""
    fused = fmd.fused.numpy()
    L2 = fmd.L2.numpy().astype(np.int64)
    primary, seq_len = fmd.primary, fmd.seq_len
    R, Lr = rmat.shape
    lens = np.minimum(lens.astype(np.int64), Lr)
    ar = np.arange(R)
    one, zero = np.ones(R, np.int64), np.zeros(R, np.int64)
    st = [dict(x=zero, n=zero, x0=one, x1=one, s=zero) for _ in range(G)]
    out = np.zeros((5, R, cap), np.int64)
    for t in range(Lr):
        live = t < lens
        c = rmat[:, t].astype(np.int64)
        is_n = c >= 4
        cc = np.minimum(c, 3)
        ce = 3 - cc                         # forward: the complement
        a = st[0]
        ext = live & ~is_n & (t > a["x"])
        for b in st[1:]:
            np.testing.assert_array_equal(t > b["x"], t > a["x"])
        ka, kb = a["x1"] - 1, a["x1"] - 1 + a["s"]
        outs, _ = emulate_group_rank(fused, L2, primary, seq_len, ka, kb, G,
                                     need=ext, per_thread=True)
        for g, b in enumerate(st):
            tk, tl = outs[g]
            sizes = tl - tk
            qpos = b["x1"]
            ot = b["x0"] + ((qpos <= primary)
                            & (qpos + b["s"] - 1 >= primary))
            ot = ot + np.where(np.arange(4)[None, :] > ce[:, None], sizes,
                               0).sum(1)
            n1 = L2[ce] + 1 + tk[ar, ce]
            ns = sizes[ar, ce]
            emit = (ext & (ns < max_intv) & (t - b["x"] >= min_len)
                    & (b["n"] < cap))
            if g == 0:
                ri, k = ar[emit], b["n"][emit]
                for j, v in enumerate((b["x"], np.full(R, t + 1), ot, n1,
                                       ns)):
                    out[j, ri, k] = v[emit]
            fresh = live & (t == b["x"]) & ~is_n
            b["x0"] = np.where(fresh, L2[cc] + 1, np.where(ext, ot, b["x0"]))
            b["x1"] = np.where(fresh, L2[3 - cc] + 1,
                               np.where(ext, n1, b["x1"]))
            b["s"] = np.where(fresh, L2[cc + 1] - L2[cc],
                              np.where(ext, ns, b["s"]))
            b["n"] = b["n"] + emit
            b["x"] = np.where(live & (is_n | emit), t + 1, b["x"])
        for b in st[1:]:
            for key in a:
                np.testing.assert_array_equal(b[key], a[key])
    dt = fmd.idx_dtype
    return (torch.from_numpy(st[0]["n"]).to(torch.int32),
            *(torch.from_numpy(out[j]).to(torch.int32) for j in (0, 1)),
            *(torch.from_numpy(out[j]).to(dt) for j in (2, 3, 4)))


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("G", [4, 8, 16])
def test_strategy1_group_schedule(idx, dt, G):
    """K4c's group schedule against strategy1_plain and the JAX
    strategy1_kernel on the edge reads, at the collect's cap (L // 19 + 2)
    and at caps of 1 and 2, which reads reach."""
    fm, genome, jdfm, fmd32, fmd64 = idx
    fmd = fmd32 if dt == "int32" else fmd64
    rmat, lens = _s1_inputs(genome)
    for cap in (L // 19 + 2, 2, 1):
        want = jsd.strategy1_kernel(jdfm, jnp.asarray(rmat),
                                    jnp.asarray(lens), 20, L, 19, cap)
        plain = tsd.strategy1_plain(fmd, torch.from_numpy(rmat),
                                    torch.from_numpy(lens), 20, L, 19, cap)
        got = emulate_strategy1(fmd, rmat, lens, 20, 19, cap, G)
        for g, p, w in zip(got, plain, want):
            assert g.dtype == p.dtype
            assert torch.equal(g, p)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n = got[0].numpy()
        assert n[:len(_s1_edges(genome))].any()
        if cap <= 2:
            assert (n == cap).any(), "no read reached the cap"
        else:
            assert n.max() < cap
    assert lens[4] == 0 and got[0][4] == 0


def _native(fm, reads, opt):
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    assert want is not None, "native seeding unavailable"
    return want


def _assert_same(got, want):
    (g_m, g_r), (w_m, w_r) = got, want
    assert len(g_m) == len(w_m) and len(g_r) == len(w_r)
    for i in range(len(w_m)):
        np.testing.assert_array_equal(
            g_m[i], np.asarray(w_m[i]).reshape(-1, 5), err_msg=f"mems {i}")
        np.testing.assert_array_equal(g_r[i], np.asarray(w_r[i]),
                                      err_msg=f"rbegs {i}")


def _port_collect(fm, fmd, reads, opt):
    dg = tas.DeviceGenome.from_host(fm, fmd)
    return tsd.collect_seeds_rbegs_device(fmd, dg, fm, reads, opt)


@pytest.mark.parametrize("corpus", ["messy", "segdup", "low_complexity"])
def test_collect_matches_native_and_jax(idx, corpus):
    fm, genome, jdfm, fmd, fmd64 = idx
    opt = AlignerConfig()
    reads = _corpus(corpus, genome)
    want = _native(fm, reads, opt)
    got = _port_collect(fm, fmd, reads, opt)
    _assert_same(got, want)
    assert sum(len(m) for m in got[0]) > 0
    jgot = jsd.collect_seeds_rbegs_device(
        jdfm, jas.DeviceGenome.from_host(fm), fm, reads, opt)
    _assert_same(got, jgot)
    _assert_same(_port_collect(fm, fmd64, reads, opt), want)
    assert tsd.collect_seeds_device(fmd, fm, reads, opt) == [
        [tuple(int(v) for v in row) for row in np.asarray(m).reshape(-1, 5)]
        for m in want[0]]


def test_forced_straggler_split(idx, monkeypatch):
    """Tiny phase-A budgets send (almost) every lane to the narrow rerun;
    the spliced result still equals the native C++."""
    fm, genome, _, fmd, fmd64 = idx
    opt = AlignerConfig()
    reads = _messy_reads(genome, np.random.default_rng(123), n=40)
    want = _native(fm, reads, opt)
    orig = tsd.min_starts_twoptr
    calls = {"n": 0, "rerun": 0}

    def clamped(*a, **kw):
        calls["n"] += 1
        if kw.get("max_steps", 0) in (3 * L, 4 * L):
            kw["max_steps"] = 24      # phase A of rounds 1 and 2
        else:
            calls["rerun"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tsd, "min_starts_twoptr", clamped)
    for f in (fmd, fmd64):
        _assert_same(_port_collect(fm, f, reads, opt), want)
    assert calls["rerun"] >= 2 and calls["n"] >= 6


def _trace_lines(text):
    """The [seedtrace] lines of ``text``: a timed line by its tag, the
    straggler and round-2 lines whole."""
    out = []
    for line in text.splitlines():
        if line.startswith("[seedtrace] "):
            m = re.fullmatch(r"\[seedtrace\] (.+?) +-?[0-9.]+ms", line)
            out.append(m.group(1) if m else line)
    return out


def _clamp_phase_a(monkeypatch, mod, counts):
    """Phase A of rounds 1 and 2 at 24 transitions in ``mod``'s collect:
    (almost) every lane goes to the straggler rerun."""
    orig = mod.min_starts_twoptr

    def clamped(*a, **kw):
        if kw.get("max_steps", 0) in (3 * L, 4 * L):
            kw["max_steps"] = 24
        else:
            counts["rerun"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(mod, "min_starts_twoptr", clamped)


@pytest.mark.parametrize("split", ["plain", "stragglers"])
def test_seed_trace_matches_jax(idx, monkeypatch, capsys, split):
    """LARIAT_SEED_TRACE: the port's collect prints the reference's
    [seedtrace] tags in the reference's order, the straggler and round-2
    lines equal; with the knob off neither prints a line."""
    fm, genome, jdfm, fmd, _ = idx
    opt = AlignerConfig()
    reads = _messy_reads(genome, np.random.default_rng(125), n=30)
    counts = {"rerun": 0}
    if split == "stragglers":
        for mod in (tsd, jsd):
            _clamp_phase_a(monkeypatch, mod, counts)
    jdg = jas.DeviceGenome.from_host(fm)
    for mod in (tsd, jsd):
        monkeypatch.setattr(mod, "SEED_TRACE", False)
    capsys.readouterr()
    want = jsd.collect_seeds_rbegs_device(jdfm, jdg, fm, reads, opt)
    got = _port_collect(fm, fmd, reads, opt)
    assert "[seedtrace]" not in capsys.readouterr().out
    _assert_same(got, want)
    for mod in (tsd, jsd):
        monkeypatch.setattr(mod, "SEED_TRACE", True)
    jsd.collect_seeds_device(jdfm, fm, reads, opt)
    jtags = _trace_lines(capsys.readouterr().out)
    assert tsd.collect_seeds_device(fmd, fm, reads, opt) == [
        [tuple(int(v) for v in row) for row in np.asarray(m).reshape(-1, 5)]
        for m in want[0]]
    tags = _trace_lines(capsys.readouterr().out)
    assert tags == jtags
    assert [t for t in tags if not t.startswith("[")] == [
        "r1+r3 dispatch", "r1 pack dl", "r1 assembly", "r2", "r3 assembly",
        "merge+sort"]
    lanes = [t for t in tags if t.startswith("[seedtrace] r2 lanes=")]
    strag = [t for t in tags if t.startswith("[seedtrace] stragglers ")]
    assert len(lanes) == 1
    if split == "stragglers":
        assert counts["rerun"] >= 4 and len(strag) == 2
    else:
        assert not strag
    jsd.collect_seeds_rbegs_device(jdfm, jdg, fm, reads, opt)
    jtags = _trace_lines(capsys.readouterr().out)
    _port_collect(fm, fmd, reads, opt)
    tags = _trace_lines(capsys.readouterr().out)
    assert tags == jtags and tags[-2:] == ["rbeg schedule", "sa walk"]


def test_forced_exhaustive_fallback(idx, monkeypatch):
    """Every two-pointer call reports a blown step cap (no lane done): the
    straggler rerun fails too, and both rounds fall back to K4b with host
    emission from its full planes."""
    fm, genome, _, fmd, fmd64 = idx
    opt = AlignerConfig()
    reads = (_messy_reads(genome, np.random.default_rng(124), n=30)
             + _low_complexity(genome))
    want = _native(fm, reads, opt)
    orig_twoptr, orig_exh = tsd.min_starts_twoptr, tsd.min_starts_kernel
    calls = {"exh": 0}

    def blown(*a, **kw):
        meta, big, aux = orig_twoptr(*a, **kw)
        cap = kw["cap"]
        meta[:, cap + 1] = 0
        meta[:, cap + 2] &= ~1
        return meta, big, aux

    def exh(*a, **kw):
        calls["exh"] += 1
        return orig_exh(*a, **kw)

    monkeypatch.setattr(tsd, "min_starts_twoptr", blown)
    monkeypatch.setattr(tsd, "min_starts_kernel", exh)
    for f in (fmd, fmd64):
        _assert_same(_port_collect(fm, f, reads, opt), want)
    assert calls["exh"] == 4       # rounds 1 and 2, both indices


@pytest.mark.parametrize("cap1,cap2", [(1, 16), (32, 0)])
def test_forced_slot_overflow(idx, monkeypatch, cap1, cap2):
    """A slot cap too small for round 1 (1 slot), or for round 2 (none):
    the round overflows, the exhaustive fallback serves it, and the result
    still equals the native C++."""
    fm, genome, _, fmd, _ = idx
    opt = AlignerConfig()
    reads = (_corpus("messy", genome) + _corpus("segdup", genome)
             + _low_complexity(genome))
    want = _native(fm, reads, opt)
    monkeypatch.setattr(tsd, "CAP1", cap1)
    monkeypatch.setattr(tsd, "CAP2", cap2)
    orig = tsd.min_starts_kernel
    calls = {"exh": 0}

    def exh(*a, **kw):
        calls["exh"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tsd, "min_starts_kernel", exh)
    _assert_same(_port_collect(fm, fmd, reads, opt), want)
    assert calls["exh"] == 1


@pytest.fixture(scope="module")
def fm24(dup_genome, tmp_path_factory):  # noqa: F811
    """The dup genome's index with a non-power-of-two SA sampling."""
    _, genome = dup_genome
    fasta = tmp_path_factory.mktemp("sa24") / "dup24.fa"
    fasta.write_text(">chrT\n" + genome.decode() + "\n")
    return fmindex.build_index(str(fasta), sa_intv=24)


def _lookup_rows(fm, n=700, seed=5):
    rows = np.random.default_rng(seed).integers(0, fm.seq_len,
                                                n).astype(np.int64)
    rows[:3] = [fm.primary, fm.primary - 1, fm.primary + 1]
    return rows


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_sa_lookup_batch_host_matches_scalar(idx, fm24, dt, monkeypatch):
    """The one-launch lookup against the scalar fm.sa_lookup and the JAX
    two-phase sa_lookup_batch_host, on the dup genome's index (sa_intv 32)
    and on one built with sa_intv 24; the rows include walks longer than
    64 steps, and the lookup calls K5 once."""
    fm, _, jdfm, fmd, fmd64 = idx
    calls = []
    orig = tas.sa_walk_chunk

    def counted(*a, **kw):
        calls.append(a[4] if len(a) > 4 else kw["max_steps"])
        return orig(*a, **kw)

    monkeypatch.setattr(tas, "sa_walk_chunk", counted)
    for f_host in (fm, fm24):
        f = tfm.DeviceFMIndex.from_host(f_host, "cpu")
        if dt == "int64":
            f = tfm.DeviceFMIndex(f.fused, f.L2.long(), f.primary, f.seq_len)
        dg = tas.DeviceGenome.from_host(f_host, f)
        rows = _lookup_rows(f_host)
        calls.clear()
        got = tas.sa_lookup_batch_host(dg, f_host, rows)
        assert calls == [tas.LOOKUP_STEPS]
        want = np.array([f_host.sa_lookup(int(r)) for r in rows], np.int64)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jas.sa_lookup_batch_host(
            jas.DeviceGenome.from_host(f_host), f_host, rows))
        steps = orig(dg, torch.from_numpy(rows).to(f.idx_dtype),
                     torch.zeros(len(rows), dtype=f.idx_dtype),
                     torch.zeros(len(rows), dtype=torch.bool), 512)[1]
        assert int(steps.max()) > 64 and int((steps > 64).sum()) >= 10
    assert fm24.sa_intv == 24 and fm.sa_intv == 32
    # one chunk against the JAX walk
    rng = np.random.default_rng(5)
    rows = rng.integers(0, fm.seq_len, 700)
    rows[:3] = [fm.primary, fm.primary - 1, fm.primary + 1]
    k = rows[:256].astype(np.int32)
    steps = rng.integers(0, 3, 256).astype(np.int32)
    done = rng.random(256) < 0.1
    f = fmd if dt == "int32" else fmd64
    dg = tas.DeviceGenome.from_host(fm, f)
    w = jas.sa_walk_chunk(jas.DeviceGenome.from_host(fm), jnp.asarray(k),
                          jnp.asarray(steps), jnp.asarray(done), 7)
    g = orig(dg, torch.from_numpy(k).to(f.idx_dtype),
             torch.from_numpy(steps).to(f.idx_dtype), torch.from_numpy(done),
             7)
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the kernels against their twins on the card --------------------------


def _cuda_index(fm, dev, dt):
    L2 = fm.L2.astype(np.int64 if dt == "int64" else np.int32)
    return tfm.DeviceFMIndex.from_numpy(tfm.fused_table(fm), L2, fm.primary,
                                        fm.seq_len, dev)


def _both(fn, dev):
    """fn(device) on the card (kernel) and on the CPU (twin), synced."""
    got = fn(dev)
    torch.cuda.synchronize()
    return got, fn(torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,max_steps,cap", TWOPTR_CASES)
def test_twoptr_kernel_matches_twin(idx, cuda_device, dt, bwd_init,  # noqa: F811
                                    max_steps, cap):
    fm, genome, *_ = idx
    reads = (_messy_reads(genome, np.random.default_rng(5), n=40)
             + _low_complexity(genome))
    rmat, lens = _batch(reads)
    start, mi, mid = _twoptr_inputs(rmat, lens, bwd_init)

    def run(dev):
        f = _cuda_index(fm, dev, dt)
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return tsd.min_starts_twoptr(
            f, put(rmat), put(start), put(lens), put(mi), L,
            max_steps=max_steps, bwd_init=bwd_init, min_seed=19, cap=cap,
            mid=put(mid))

    # meta, big, and aux: seeds, transitions and rows fetched per lane
    got, want = _both(run, cuda_device)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exhaustive_kernel_matches_twin(idx, cuda_device, dt):  # noqa: F811
    """K4b against its twin, and its per-lane counters (extensions, rows
    fetched) against ``emulate_exhaustive``."""
    fm, genome, _, fmd32, fmd64 = idx
    reads = _messy_reads(genome, np.random.default_rng(8), n=20) + \
        _low_complexity(genome)
    rmat, _ = _batch(reads, R=len(reads))
    R = len(reads)
    ri = np.repeat(np.arange(R), L).astype(np.int32)
    e = np.tile(np.arange(0, L), R).astype(np.int32)
    mi = np.random.default_rng(9).integers(1, 5, R * L).astype(np.int64)
    counts = torch.full((R * L, 2), -1, dtype=torch.int32,
                        device=cuda_device)

    def run(dev):
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return tsd.min_starts_kernel(
            _cuda_index(fm, dev, dt), put(rmat), put(ri), put(e), put(mi), L,
            counts=counts if dev.type == "cuda" else None)

    got, want = _both(run, cuda_device)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    *_, want_counts, _ = emulate_exhaustive(
        fmd32 if dt == "int32" else fmd64, rmat, ri, e, mi, L)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_strategy1_kernel_matches_twin(idx, cuda_device, dt):  # noqa: F811
    fm, genome, *_ = idx
    rmat, lens = _batch(_messy_reads(genome, np.random.default_rng(10))
                        + _low_complexity(genome))

    def run(dev):
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return tsd.strategy1(_cuda_index(fm, dev, dt), put(rmat), put(lens),
                             20, L, 19, L // 19 + 2)

    got, want = _both(run, cuda_device)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_sa_walk_kernel_matches_twin(idx, cuda_device, dt):  # noqa: F811
    fm = idx[0]
    rng = np.random.default_rng(12)
    k = rng.integers(0, fm.seq_len, 4096)
    k[:3] = [fm.primary, fm.primary - 1, fm.primary + 1]
    steps = rng.integers(0, 3, 4096)
    done = rng.random(4096) < 0.1

    def run(dev):
        g = tas.DeviceGenome.from_host(fm, _cuda_index(fm, dev, dt))
        tdt = g.fmd.idx_dtype
        return tas.sa_walk_chunk(g, torch.from_numpy(k).to(dev, tdt),
                                 torch.from_numpy(steps).to(dev, tdt),
                                 torch.from_numpy(done).to(dev), 64)

    got, want = _both(run, cuda_device)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("cap", [L // 19 + 2, 2, 1])
def test_strategy1_kernel_edges(idx, cuda_device, dt, cap):  # noqa: F811
    """K4c's group kernel against its twin on the edge reads (Ns at the scan
    start and in runs, length 0, shorter than min_len) and at caps that
    reads reach."""
    fm, genome, *_ = idx
    rmat, lens = _s1_inputs(genome)

    def run(dev):
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        return tsd.strategy1(_cuda_index(fm, dev, dt), put(rmat), put(lens),
                             20, L, 19, cap)

    got, want = _both(run, cuda_device)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_sa_lookup_kernel_one_launch(idx, fm24, cuda_device,  # noqa: F811
                                     dt):
    """The lookup on the card: one K5 launch, positions equal to the
    scalar fm.sa_lookup at sa_intv 32 (the mask) and 24 (the remainder),
    walks past 64 steps logged; and K5 against its twin on LF's edge rows
    (primary +- 1, k & 127 in {0, 127}, k & 15 in {0, 15})."""
    from lariat_tpu_torch.ops import _build
    for f_host in (idx[0], fm24):
        g = tas.DeviceGenome.from_host(f_host,
                                       _cuda_index(f_host, cuda_device, dt))
        rows = _lookup_rows(f_host, n=5000)
        before = _build.launches()["sa_walk"]
        got = tas.sa_lookup_batch_host(g, f_host, rows)
        assert _build.launches()["sa_walk"] == before + 1
        want = np.array([f_host.sa_lookup(int(r)) for r in rows], np.int64)
        np.testing.assert_array_equal(got, want)
        (log,) = g.walks
        assert log["rows"] == 8192 and log["max_steps"] == 512
        assert log["longest"] > 64 and log["past_64"] > 0
        blk = np.random.default_rng(4).integers(0, f_host.seq_len // 128,
                                                64) * 128
        p = f_host.primary
        k = np.concatenate([[p - 1, p + 1, p - 2, p + 2], blk, blk + 127,
                            blk + 15, blk + 16, blk + 63, blk + 64])
        k = k[(k >= 0) & (k < f_host.seq_len)]

        def run(dev):
            gg = tas.DeviceGenome.from_host(f_host,
                                            _cuda_index(f_host, dev, dt))
            tdt = gg.fmd.idx_dtype
            z = torch.zeros(len(k), dtype=tdt, device=dev)
            return tas.sa_walk_chunk(gg, torch.from_numpy(k).to(dev, tdt), z,
                                     z.bool(), 512)

        got, want = _both(run, cuda_device)
        assert torch.equal(got.cpu(), want)


def test_twins_count_rank_rows(idx):
    """The rows the seeding twins count for their bounds, on unchanged
    outputs: K4a's per lane (aux column 2) at most two a transition; the
    distinct rows that K4a's, K4b's, K4c's and K5's twins mark, at most
    the rows fetched and at most the table."""
    fm, genome, _, fmd, _ = idx
    reads = _messy_reads(genome, np.random.default_rng(7), n=12)
    rmat, lens = _batch(reads)
    start, mi, mid = _twoptr_inputs(rmat, lens, False)
    t = torch.from_numpy

    def marked(fn, *a, **kw):
        touched = torch.zeros(fmd.fused.shape[0], dtype=torch.bool)
        out = fn(*a, touched=touched, **kw)
        for x, y in zip(out, fn(*a, **kw)):
            assert torch.equal(x, y)
        n = int(touched.sum())
        assert 0 < n <= fmd.fused.shape[0]
        return out, n

    (meta, big, aux), n4a = marked(
        tsd.min_starts_twoptr_plain, fmd, t(rmat), t(start), t(lens),
        t(mi).to(fmd.idx_dtype), t(mid), L, tsd._budget(3 * L), False, 19, 32)
    n, used, rows = (aux[:, k].long() for k in range(3))
    assert bool((rows <= 2 * used).all()) and n4a <= int(rows.sum())
    R = len(lens)
    ri = t(np.repeat(np.arange(R), L).astype(np.int32))
    ee = t(np.tile(np.arange(1, L + 1), R).astype(np.int32))
    ones = t(np.ones(R * L, np.int64))
    marked(tsd.min_starts_kernel_plain, fmd, t(rmat), ri, ee, ones, L)
    marked(tsd.strategy1_plain, fmd, t(rmat), t(lens), 20, L, 19, 8)
    g = tas.DeviceGenome.from_host(fm, fmd)
    k = t(np.random.default_rng(5).integers(0, fm.seq_len, 256))
    zero = torch.zeros(256, dtype=torch.long)
    (_, steps, _), n5 = marked(tas.sa_walk_chunk_plain, g, k, zero,
                               torch.zeros(256, dtype=torch.bool), 64)
    assert n5 <= int(steps.sum())
