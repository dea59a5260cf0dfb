"""T1 (the seed-extension ablation): the port's plain twin against the JAX
tool's Pallas kernel (tools/extend_ablate.py ``make_kernel``, run in
interpret mode over 128-lane chunks as ``run_variant`` runs it), and the
kernel wrapper against the twin on the card. Exact int32: tolerance 0."""

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

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LQ, LT = 256, 64, 96
ROWS_LT = LT // 2          # the rows_288 variant's cut, at this size


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


def _variant(name):
    half, kw = extend_ablate.VARIANTS[name]
    return (ROWS_LT if half else LT), kw


def _inputs(seed=3):
    """Planted queries (2% substitutions, N codes) and edge lanes: qlen 0,
    tlen 0, qlen > tlen, tlen > the rows variant's Lt, a negative h0."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(1, LQ + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(-8, 40, B), LT).clip(1)
    q = rng.integers(0, 4, (B, LQ)).astype(np.int32)
    t = rng.integers(0, 4, (B, LT)).astype(np.int32)
    for b in range(B):
        n = int(min(qlen[b], tlen[b]))
        off = int(rng.integers(0, max(1, int(tlen[b]) - n + 1)))
        t[b, off:off + n] = q[b, :n]
    mut = rng.random((B, LT)) < 0.02
    t[mut] = (t[mut] + 1) % 4
    q[rng.random((B, LQ)) < 0.01] = 4
    t[rng.random((B, LT)) < 0.01] = 4
    params = np.zeros((B, 8), np.int32)
    params[:, 0] = qlen
    params[:, 1] = tlen
    params[:, 2] = rng.choice([3, 12, 40, 100], B)
    params[:, 3] = rng.integers(5, 60, B)
    params[0:4, 0] = 0                          # qlen 0
    params[4:8, 1] = 0                          # tlen 0
    params[8:12, 0], params[8:12, 1] = 40, 10   # qlen > tlen
    params[12:20, 1] = LT                       # tlen > ROWS_LT
    params[12:20, 0] = LQ
    params[20:22, 3] = -3                       # h0 < 0: Lq - 1 argmax
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
def test_kernel_matches_twin(name, cuda_device):
    q, t, params = _t(*_inputs(11))
    Lt, kw = _variant(name)
    want = extend_ablate.run_variant(q, t, params, Lt, **kw)
    got = extend_ablate.run_variant(*(x.to(cuda_device)
                                      for x in (q, t, params)), Lt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
