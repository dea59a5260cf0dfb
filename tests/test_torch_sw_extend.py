"""K1 (banded ksw_extend2): the port's plain twin and kernel wrapper against
the JAX package -- sw_batch.extend_batch, the Pallas kernel (v1 and v2, in
interpret mode) and the scalar ksw.extend. Exact int32: tolerance 0."""

import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops import sw_batch as jax_sw_batch
from lariat_tpu.ops import sw_extend_pallas
from lariat_tpu_torch.ops import sw_batch, sw_extend

torch.set_num_threads(1)

MAT = np.asarray(ksw.fill_score_matrix(1, 4))
ROWS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fuzz(seed, B=12, Lq=96, Lt=160):
    """tests/test_sw_pallas.py's shapes: planted targets, qlen = 0 and
    tlen = 0 lanes, N codes in some queries."""
    rng = np.random.default_rng(seed + 300)
    qa = rng.integers(0, 4, (B, Lq)).astype(np.int32)
    ta = np.zeros((B, Lt), np.int32)
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(0, Lt + 1, B).astype(np.int32)
    qlen[0], tlen[1] = 0, 0
    for i in range(B):
        n = min(int(qlen[i]), int(tlen[i]))
        ta[i, :n] = qa[i, :n]
        extra = int(tlen[i]) - n
        if extra > 0:
            ta[i, n:n + extra] = rng.integers(0, 4, extra)
        for _ in range(int(rng.integers(0, 4))):
            if tlen[i]:
                p = int(rng.integers(0, tlen[i]))
                ta[i, p] = (ta[i, p] + 1) % 4
    for i in range(2, B, 3):          # N codes
        qa[i, rng.integers(0, Lq, 3)] = 4
        ta[i, rng.integers(0, Lt, 2)] = 4
    h0 = rng.integers(10, 60, B).astype(np.int32)
    w = rng.choice([5, 40, 100], B).astype(np.int32)
    return qa, qlen, ta, tlen, w, h0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", range(3))
def test_extend_twin_matches_jax_batch(seed):
    qa, qlen, ta, tlen, w, h0 = _fuzz(seed)
    want = jax_sw_batch.extend_batch(qa, qlen, ta, tlen, MAT, w, h0)
    got = sw_batch.extend_batch(*_t(qa, qlen, ta, tlen, MAT, w, h0))
    for f in ROWS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("v2", [False, True])
def test_extend_wrapper_matches_pallas_interpret(v2, monkeypatch):
    if v2:
        monkeypatch.setenv("LARIAT_EXTEND_V2", "1")
    qa, qlen, ta, tlen, w, h0 = _fuzz(7)
    want = np.asarray(sw_extend_pallas.extend_batch_pallas(
        qa, qlen, ta, tlen, MAT, w, h0, tile_b=8, interpret=True,
        packed=True))
    q, ql, t, tl, wt, h = _t(qa, qlen, ta, tlen, w, h0)
    got = sw_extend.extend_batch(q, ql, t, tl, wt, h)
    assert got.shape == (8, len(qlen)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_extend_twin_matches_scalar_ksw():
    qa, qlen, ta, tlen, w, h0 = _fuzz(11)
    got = sw_batch.extend_batch(*_t(qa, qlen, ta, tlen, MAT, w, h0),
                                end_bonus=5, zdrop=100)
    for i in range(len(qlen)):
        r = ksw.extend(qa[i, :qlen[i]], ta[i, :tlen[i]], MAT, 6, 1, 6, 1,
                       int(w[i]), 5, 100, int(h0[i]))
        assert [int(getattr(got, f)[i]) for f in ROWS] == \
            [getattr(r, f) for f in ROWS], i


def test_adjust_w_truncates_toward_zero():
    qlen = torch.tensor([0, 1, 7, 150], dtype=torch.int32)
    w = torch.full((4,), 100, dtype=torch.int32)
    got = sw_batch._adjust_w(qlen, w, 1, 5, 6, 1, 6, 1)
    want = jax_sw_batch._adjust_w(np.asarray(qlen), np.asarray(w), 1, 5, 6,
                                  1, 6, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.cuda
def test_extend_kernel_matches_twin(cuda_device):
    qa, qlen, ta, tlen, w, h0 = _fuzz(5, B=300, Lq=192, Lt=576)
    cpu = _t(qa, qlen, ta, tlen, w, h0)
    want = sw_extend.extend_batch(*cpu)
    got = sw_extend.extend_batch(*(x.to(cuda_device) for x in cpu))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lt,zdrop", [(192, 576, 100), (448, 320, 100),
                                         (96, 120, 5), (96, 120, 0),
                                         (160, 200, -1)])
def test_extend_kernel_edge_shapes(cuda_device, Lq, Lt, zdrop):
    """The warp-per-task kernel on the wavefront emulation's edge shapes
    (tests/test_torch_wavefront.py), Lq 448 running two column tiles."""
    from test_torch_wavefront import _extend_case
    q, t, qlen, tlen, w, h0 = _extend_case(Lq + Lt + zdrop, Lq, Lt, 6)
    cpu = _t(q, qlen, t, tlen, w, h0)
    want = sw_extend.extend_batch(*cpu, zdrop=zdrop)
    got = sw_extend.extend_batch(*(x.to(cuda_device) for x in cpu),
                                 zdrop=zdrop)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("entry", ["tiles", "descriptors"])
def test_extend_steps_need_the_kernel(entry):
    """The warp steps are the kernel's own count: a CPU call (the twin)
    given a steps output raises."""
    qa, qlen, ta, tlen, w, h0 = _fuzz(3)
    steps = torch.zeros(len(qlen), dtype=torch.int32)
    with pytest.raises(ValueError, match="counted by the kernel"):
        if entry == "tiles":
            sw_extend.extend_batch(*_t(qa, qlen, ta, tlen, w, h0),
                                   steps=steps)
        else:
            B = len(qlen)
            desc = np.zeros((B, 9), np.int32)
            desc[:, 3], desc[:, 6], desc[:, 7], desc[:, 8] = qlen, tlen, h0, w
            desc[:, 2] = desc[:, 5] = 1
            sw_extend.extend_desc(
                torch.from_numpy(qa.astype(np.uint8)),
                torch.zeros(16, dtype=torch.int32), 256,
                torch.from_numpy(desc), qa.shape[1], ta.shape[1], steps=steps)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lt,zdrop", [(192, 576, 100), (448, 320, 100),
                                         (96, 120, 0), (160, 200, -1)])
def test_extend_kernel_counts_its_steps(cuda_device, Lq, Lt, zdrop):
    """The kernel's step count equals the wavefront emulation's, task by
    task, at the kernel's C (the fewest columns a lane that cover qlen, at
    most 8; Lq 448 runs two tiles)."""
    from test_torch_wavefront import EXT, _extend_case, emulate_extend
    q, t, qlen, tlen, w, h0 = _extend_case(Lq + Lt + zdrop, Lq, Lt, 6)
    steps = torch.full((len(qlen),), -1, dtype=torch.int32,
                       device=cuda_device)
    sw_extend.extend_batch(*(x.to(cuda_device)
                             for x in _t(q, qlen, t, tlen, w, h0)),
                           zdrop=zdrop, steps=steps)
    want = [sum(emulate_extend(
        q[b], int(qlen[b]), t[b], int(tlen[b]), int(w[b]), int(h0[b]),
        min(max((int(qlen[b]) + 31) // 32, 1), 8), zdrop=zdrop, **EXT)[1])
        for b in range(len(qlen))]
    assert steps.cpu().tolist() == want
