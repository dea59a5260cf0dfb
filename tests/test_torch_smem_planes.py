"""K4a's planes entry and K9 (the compaction) against lariat_tpu's
``min_starts_twoptr(emit_direct=False)``, ``compact_starts`` and
``compact_starts_packed`` (XLA on the CPU): the planes twin on messy,
segdup and low-complexity reads in int32 and int64 indices, both
``bwd_init`` modes, with a budget that leaves lanes undone; the compaction
twins on those planes at round-1 and round-2 mids, ``min_seed`` 0 and 19,
and a cap that overflows. Integer outputs: tolerance 0. Also the JAX
package's own cross-check: its compaction of the planes equals its direct
slots at round 1. The ``cuda`` cases hold both kernels against their twins
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.ops import smem_device as jsd
from lariat_tpu_torch.ops import smem_device as tsd

from test_rfa import dup_genome  # noqa: F401
from test_smem_device import _messy_reads
from test_torch_smem_device import (L, _batch, _low_complexity, _segdup,
                                    idx)  # noqa: F401
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)


def _reads(genome):
    return (_messy_reads(genome, np.random.default_rng(15), n=40)
            + _low_complexity(genome)
            + _segdup(genome, np.random.default_rng(16)))


def _lanes(lens, bwd_init, seed=4):
    """(start_e, min_intv, mid) a lane: round 1 from 0 with min_intv 1 and
    mid L + 2; round 2 from a mid inside the read, min_intv 1-5."""
    R = len(lens)
    if not bwd_init:
        return (np.zeros(R, np.int32), np.ones(R, np.int64),
                np.full(R, L + 2, np.int32))
    rng = np.random.default_rng(seed)
    mid = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
    return mid, rng.integers(1, 6, R).astype(np.int64), mid.copy()


def _jax_planes(jdfm, rmat, start, lens, mi, max_steps, bwd_init):
    return jsd.min_starts_twoptr(
        jdfm, jnp.asarray(rmat), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mi), L, max_steps=max_steps, bwd_init=bwd_init)


def _port_planes(fmd, rmat, start, lens, mi, max_steps, bwd_init):
    return tsd.min_starts_twoptr_planes(
        fmd, torch.from_numpy(rmat), torch.from_numpy(start),
        torch.from_numpy(lens), torch.from_numpy(mi), L,
        max_steps=max_steps, bwd_init=bwd_init)


# (bwd_init, max_steps): each round at the reference's default budget
# (8L), round 2 at the collect's 32L, and budgets that leave lanes undone
PLANES_CASES = [(False, 0), (True, 32 * L), (False, 40), (True, 24)]


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,max_steps", PLANES_CASES)
def test_planes_twin_matches_jax(idx, dt, bwd_init, max_steps):  # noqa: F811
    fm, genome, jdfm, fmd, fmd64 = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, _ = _lanes(lens, bwd_init)
    want = _jax_planes(jdfm, rmat, start, lens, mi, max_steps, bwd_init)
    got = _port_planes(fmd if dt == "int32" else fmd64, rmat, start, lens,
                       mi, max_steps, bwd_init)
    for name, w, g in zip(("b", "x0", "x1", "s", "valid", "done"), want,
                          got[:6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[1].dtype == (torch.int32 if dt == "int32" else torch.int64)
    done = bool(np.asarray(want[5]))
    assert done == (max_steps in (0, 32 * L))   # the small budgets cut
    aux = got[6].numpy()
    assert bool(aux[:, 0].all()) == done
    assert aux[:, 1].max() <= tsd._budget(max_steps or 8 * L)


def _compact_inputs(idx, bwd_init):
    fm, genome, jdfm, fmd, fmd64 = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, mid = _lanes(lens, bwd_init)
    planes = _jax_planes(jdfm, rmat, start, lens, mi, 32 * L, bwd_init)
    return planes, start, lens, mid


# (bwd_init, min_seed, cap): round-1 mids (L + 2) and round-2 mids below
# L, min_seed 0 and 19, the collect's caps, and caps that overflow
COMPACT_CASES = [(False, 19, 32), (False, 0, 32), (True, 19, 16),
                 (True, 0, 16), (False, 0, 2), (True, 0, 1)]


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,min_seed,cap", COMPACT_CASES)
def test_compact_twins_match_jax(idx, dt, bwd_init, min_seed, cap):  # noqa: F811
    planes, start, lens, mid = _compact_inputs(idx, bwd_init)
    b, x0, x1, s, valid, done = planes
    want = jsd.compact_starts(b, x0, x1, s, valid, jnp.asarray(start),
                              jnp.asarray(lens), jnp.asarray(mid),
                              min_seed, cap)
    wpk = jsd.compact_starts_packed(b, x0, x1, s, valid, jnp.asarray(start),
                                    jnp.asarray(lens), jnp.asarray(mid),
                                    done, min_seed, cap)
    tdt = torch.int32 if dt == "int32" else torch.int64
    tb, tx0, tx1, ts, tv = (torch.from_numpy(np.array(a)) for a in planes[:5])
    tx0, tx1, ts = (v.to(tdt) for v in (tx0, tx1, ts))
    args = (tb, tx0, tx1, ts, tv, torch.from_numpy(start),
            torch.from_numpy(lens), torch.from_numpy(mid))
    got = tsd.compact_starts(*args, min_seed, cap)
    for name, w, g in zip(("qb", "qe", "x0", "x1", "s", "counts",
                           "overflow"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[2].dtype == tdt
    gpk = tsd.compact_starts_packed(*args, torch.tensor(bool(done)),
                                    min_seed, cap)
    np.testing.assert_array_equal(gpk.numpy(), np.asarray(wpk))
    if cap < 16:
        assert bool(np.asarray(want[6]))    # the small caps overflow


def test_jax_compaction_equals_direct_slots_at_round_1(idx):  # noqa: F811
    """The reference's two paths agree at round 1 (mid L + 2, where the
    direct path's midpoint pruning never fires): compact_starts of its
    planes holds the direct slots of min_starts_twoptr(emit_direct=True),
    lane for lane."""
    fm, genome, jdfm, _, _ = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, mid = _lanes(lens, False)
    cap = 32
    planes = _jax_planes(jdfm, rmat, start, lens, mi, 8 * L, False)
    qb, qe, x0, x1, s, counts, ovf = (np.asarray(a) for a in
                                      jsd.compact_starts(
        *planes[:5], jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mid), 19, cap))
    meta, big = (np.asarray(a) for a in jsd.min_starts_twoptr(
        jdfm, jnp.asarray(rmat), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mi), L, max_steps=8 * L, emit_direct=True, min_seed=19,
        cap=cap, mid=jnp.asarray(mid)))
    assert bool(np.asarray(planes[5])) and not bool(ovf)
    assert int(meta[0, -1]) & 3 == 1
    np.testing.assert_array_equal(meta[:, cap], counts)
    k = np.arange(cap)[None, :] < counts[:, None]
    np.testing.assert_array_equal(np.where(k, meta[:, :cap] >> 16, 0),
                                  np.where(k, qb, 0))
    np.testing.assert_array_equal(np.where(k, meta[:, :cap] & 0xFFFF, 0),
                                  np.where(k, qe, 0))
    for j, v in enumerate((x0, x1, s)):
        np.testing.assert_array_equal(
            np.where(k, big[:, j * cap:(j + 1) * cap], 0), np.where(k, v, 0))
    assert counts.sum() > 50


def _cuda_fmd(fm, dev, dt):
    from lariat_tpu_torch.ops import fm_batch as tfm
    f = tfm.DeviceFMIndex.from_host(fm, dev)
    if dt == "int64":
        f = tfm.DeviceFMIndex(f.fused, f.L2.long(), f.primary, f.seq_len)
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,max_steps", PLANES_CASES)
def test_planes_kernel_matches_twin(idx, cuda_device, dt, bwd_init,  # noqa: F811
                                    max_steps):
    fm, genome = idx[:2]
    rmat, lens = _batch(_reads(genome))
    start, mi, _ = _lanes(lens, bwd_init)
    f = _cuda_fmd(fm, cuda_device, dt)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (rmat, start, lens, mi)]
    got = tsd.min_starts_twoptr_planes(f, *args, L, max_steps=max_steps,
                                       bwd_init=bwd_init)
    want = tsd.min_starts_twoptr_plain(
        f, *args[:4], None, L, tsd._budget(max_steps or 8 * L), bwd_init, 0,
        0, planes=True)
    torch.cuda.synchronize()
    for g, w in zip(got[:5] + got[6:], want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,min_seed,cap", COMPACT_CASES)
def test_compact_kernel_matches_twin(idx, cuda_device, dt, bwd_init,  # noqa: F811
                                     min_seed, cap):
    planes, start, lens, mid = _compact_inputs(idx, bwd_init)
    tdt = torch.int32 if dt == "int32" else torch.int64
    tb, tx0, tx1, ts, tv = (torch.from_numpy(np.array(a)).to(cuda_device)
                            for a in planes[:5])
    args = (tb, tx0.to(tdt), tx1.to(tdt), ts.to(tdt), tv,
            *(torch.from_numpy(a).to(cuda_device) for a in (start, lens,
                                                            mid)))
    got = tsd.compact_starts(*args, min_seed, cap)
    want = tsd.compact_starts_plain(*args, min_seed, cap)
    done = torch.tensor(bool(np.asarray(planes[5])), device=cuda_device)
    gpk = tsd.compact_starts_packed(*args, done, min_seed, cap)
    wpk = tsd.compact_starts_packed_plain(*args, done, min_seed, cap)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    assert torch.equal(gpk.cpu(), wpk.cpu())
