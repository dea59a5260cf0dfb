"""K3 (forward local SW for mate rescue): the port's plain twin, two-pass
wrapper and local_align_batch against lariat_tpu's local_two_pass_pallas
(interpret mode), ksw.local_align per task, and ksw.local_align_batch's XLA
backend. Exact: tolerance 0."""

import dataclasses

import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops.sw_local_pallas import local_two_pass_pallas
from lariat_tpu_torch.align import ksw as tksw
from lariat_tpu_torch.ops import sw_local

from test_sw_local import _pad_batch, _rand_tasks
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)

MAT = ksw.fill_score_matrix(1, 4)


def _batch(seed, n=40, qmax=96, tmax=160):
    rng = np.random.default_rng(seed)
    tasks = (_rand_tasks(rng, n, qmax, tmax)
             + _rand_tasks(rng, n // 4, qmax, tmax, mutate=False))
    q, qlen, t, tlen = _pad_batch(tasks, qmax, tmax)
    minsc = np.full(len(tasks), 19, np.int32)
    minsc[::7] = 1 << 30        # the pad lanes' threshold
    minsc[1] = 0                # every column enters the second-best scan
    return tasks, q, qlen, t, tlen, minsc


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [3, 4])
def test_two_pass_twin_matches_pallas_interpret(seed):
    _, q, qlen, t, tlen, minsc = _batch(seed)
    want = np.asarray(local_two_pass_pallas(
        q, qlen, t, tlen, minsc, match_sc=1, mismatch_sc=-4, n_sc=-1,
        tile_b=8, interpret=True))
    got = sw_local.local_two_pass(*_t(q, qlen, t, tlen, minsc),
                                  match_sc=1, mismatch_sc=-4, n_sc=-1)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_twin_matches_scalar_local_align():
    tasks, q, qlen, t, tlen, _ = _batch(8)
    minsc = np.full(len(tasks), 19, np.int32)
    got = sw_local.local_batch(*_t(q, qlen, t, tlen, minsc)).numpy()
    for i, (qi, ti) in enumerate(tasks):
        ref = ksw._local_core(qi, ti, MAT, 6, 1, 6, 1, 19, 1 << 30)
        if ref[1] < 0:
            ref = (0, -1, -1, -1, -1)
        assert tuple(got[:5, i]) == tuple(ref), i


def test_local_align_batch_matches_reference():
    rng = np.random.default_rng(7)
    tasks = _rand_tasks(rng, 60) + _rand_tasks(rng, 15, mutate=False)
    e = np.zeros(0, np.int64)
    tasks += [(e, tasks[0][1]), (tasks[0][0], e)]
    got = tksw.local_align_batch(tasks, MAT, 6, 1, 6, 1, 19, device="cpu")
    from lariat_tpu.align.ksw import local_align_batch
    want = local_align_batch(tasks, MAT, 6, 1, 6, 1, 19, backend="xla")
    # the port's LocalResult is its own copy of the class: compare fields
    got = [dataclasses.astuple(g) for g in got]
    assert got == [dataclasses.astuple(w) for w in want]
    for (qi, ti), g in zip(tasks, got):
        assert g == dataclasses.astuple(
            ksw.local_align(qi, ti, MAT, 6, 1, 6, 1, 19))


@pytest.mark.cuda
def test_local_kernel_matches_twin(cuda_device):  # noqa: F811
    _, q, qlen, t, tlen, minsc = _batch(9, n=240, qmax=192, tmax=704)
    cpu = _t(q, qlen, t, tlen, minsc)
    want = sw_local.local_two_pass(*cpu)
    got = sw_local.local_two_pass(*(x.to(cuda_device) for x in cpu))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lt", [(192, 90), (64, 40), (448, 200)])
def test_local_kernel_edge_shapes(cuda_device, Lq, Lt):  # noqa: F811
    """The wavefront's edge lanes (qlen 0, tlen 0, tlen < 32, qlen not a
    multiple of 6, minsc 0, N codes) and its tiled path (Lq 448)."""
    from test_torch_wavefront import _local_case
    cpu = [torch.from_numpy(a) for a in _local_case(Lq + Lt, Lq, Lt, 6)]
    want = sw_local.local_two_pass(*cpu)
    got = sw_local.local_two_pass(*(x.to(cuda_device) for x in cpu))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
