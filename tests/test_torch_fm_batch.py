"""The port's device FM index and its rank twins against lariat_tpu's
(ops/fm_batch.py, XLA on the CPU): the fused table, the index built from
the JAX index's arrays, and occ4 / bidirectional extension / LF on 4,096
rows with the edges (k = -1, k = seq_len, rows around primary, intervals
that cross it), with int32 and int64 indices. Integer outputs: tolerance
0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.ops import fm_batch as jfm
from lariat_tpu_torch.ops import fm_batch as tfm

from test_rfa import dup_genome  # noqa: F401

torch.set_num_threads(1)


def _indices(jdfm, dtype):
    fused, L2 = np.asarray(jdfm.fused), np.asarray(jdfm.L2)
    return tfm.DeviceFMIndex.from_numpy(fused, L2.astype(dtype),
                                        int(jdfm.primary), int(jdfm.seq_len),
                                        "cpu")


@pytest.fixture
def indices(dup_genome):  # noqa: F811
    fm, _ = dup_genome
    jdfm = jfm.DeviceFMIndex.from_host(fm)
    return fm, jdfm, {dt.__name__: _indices(jdfm, dt)
                      for dt in (np.int32, np.int64)}


def test_fused_table_and_from_host(indices):
    fm, jdfm, idx = indices
    ref = np.asarray(jfm._fused_table(fm))
    assert ref.dtype == np.uint32
    np.testing.assert_array_equal(tfm.fused_table(fm), ref)
    host = tfm.DeviceFMIndex.from_host(fm, "cpu")
    via = idx["int32"]
    assert host.idx_dtype == via.idx_dtype == torch.int32
    assert (host.primary, host.seq_len) == (via.primary, via.seq_len) == (
        fm.primary, fm.seq_len)
    assert torch.equal(host.fused, via.fused)
    assert torch.equal(host.L2, via.L2)
    np.testing.assert_array_equal(host.fused.numpy().view(np.uint32), ref)
    assert idx["int64"].idx_dtype == torch.int64


def _rows(fm, rng, n=4096):
    """Row indices in [-1, seq_len] with the edges planted."""
    k = rng.integers(-1, fm.seq_len + 1, n).astype(np.int64)
    edges = [-1, 0, 1, fm.seq_len - 1, fm.seq_len,
             *range(fm.primary - 3, fm.primary + 4), 127, 128, 129]
    k[:len(edges)] = edges
    return k


def _intervals(fm, rng, n=4096):
    """(x0, x1, s, c): query-side rows qpos in [1, seq_len] with sizes that
    keep qpos - 1 + s <= seq_len; some cross primary."""
    x0 = rng.integers(1, fm.seq_len + 1, n).astype(np.int64)
    x1 = rng.integers(1, fm.seq_len + 1, n).astype(np.int64)
    s = (rng.random(n) ** 4 * (fm.seq_len + 1 - np.maximum(x0, x1))
         ).astype(np.int64)
    m = 64
    x0[:m] = x1[:m] = fm.primary - rng.integers(0, 40, m)
    s[:m] = rng.integers(0, 80, m)
    s[m:m + 8] = 0
    c = rng.integers(0, 4, n).astype(np.int32)
    return x0, x1, s, c


def _j(a, jdfm):
    return jnp.asarray(a.astype(np.asarray(jdfm.L2).dtype))


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_occ4_and_lf_match_jax(indices, dt):
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(11)
    k = _rows(fm, rng)
    want = np.asarray(jfm.occ4_fused_batch(jdfm, _j(k, jdfm)))
    got = tfm.occ4_fused_batch(fmd, torch.from_numpy(k))
    assert got.dtype == fmd.idx_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # LF on every row but primary (callers mask it), against the host index
    kl = k[(k >= 0) & (k < fm.seq_len) & (k != fm.primary)]
    want = np.asarray(jfm.lf_batch(jdfm, _j(kl, jdfm)))
    got = tfm.lf_batch(fmd, torch.from_numpy(kl)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:50], [fm.lf(int(v)) for v in kl[:50]])


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_bwt_extend_matches_jax(indices, dt):
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(12)
    x0, x1, s, c = _intervals(fm, rng)
    for is_back in (True, False):
        want = jfm.bwt_extend_batch(jdfm, _j(x0, jdfm), _j(x1, jdfm),
                                    _j(s, jdfm), is_back)
        got = tfm.bwt_extend_batch(fmd, torch.from_numpy(x0),
                                   torch.from_numpy(x1), torch.from_numpy(s),
                                   is_back)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = rng.random(len(c)) < 0.5
    want = jfm.bwt_extend_dir_batch(jdfm, _j(x0, jdfm), _j(x1, jdfm),
                                    _j(s, jdfm), jnp.asarray(c),
                                    jnp.asarray(back))
    got = tfm.bwt_extend_dir_batch(fmd, torch.from_numpy(x0),
                                   torch.from_numpy(x1), torch.from_numpy(s),
                                   torch.from_numpy(c),
                                   torch.from_numpy(back))
    for g, w in zip(got, want):
        assert g.dtype == fmd.idx_dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
