"""PyTorch port: the Riccati kernels as registered operators
(``hilo_mpc_tpu_torch::riccati_lq`` and ``::riccati_lq_wide``,
ops/cuda_kernels.py). On the CPU each operator runs its plain version:
``torch.library.opcheck`` holds its schema, fake kernel and dispatch, its
outputs equal ``riccati_lq_reference`` and the JAX package's ``solve_lq``
(1e-12, float64), the live LQ step (``make_lq_solver``) runs it, and the
plain version is registered for the CPU alone (a tensor elsewhere never
reaches it). The kernels themselves: tests/test_torch_card_utils.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu.ops.riccati import solve_lq as jax_solve_lq
from hilo_mpc_tpu_torch.ops import cuda_kernels as ck
from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver

from test_torch_riccati import lq_problem

REG = 1e-8
OPS = [("riccati_lq", (2, 1)), ("riccati_lq", (8, 4)), ("riccati_lq_wide", (9, 2))]


def _args(nx, nu, dtype, free, Bt=4, N=5, seed=0):
    arrs = [torch.as_tensor(a, dtype=dtype) for a in lq_problem(Bt, N, nx, nu, seed)]
    if free:
        arrs[-1] = None
    return arrs


def _call(name, args):
    if name == "riccati_lq":
        return ck.riccati_lq_op(*args, REG)
    return ck.riccati_lq_wide_op(*args, REG, 0)


@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,size", OPS)
def test_opcheck(name, size, dtype, free):
    op = ck.riccati_lq_op if name == "riccati_lq" else ck.riccati_lq_wide_op
    extra = (REG,) if name == "riccati_lq" else (REG, 0)
    torch.library.opcheck(op, (*_args(*size, dtype, free), *extra))


@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("name,size", OPS)
def test_op_matches_reference_and_jax(name, size, free):
    args = _args(*size, torch.float64, free)
    out = _call(name, args)
    ref = ck.riccati_lq_reference(*args, reg=REG)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-12
    if not free:
        j = jax.vmap(lambda *a: jax_solve_lq(*a, reg=REG))(
            *[jnp.asarray(a.numpy()) for a in args])
        for a, b in zip(out, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert ck.riccati_lq_cuda.launches == 0 and ck.riccati_lq_wide_cuda.launches == 0


def test_live_lq_step_runs_the_operator():
    """``make_lq_solver`` broadcasts the blocks and calls the operator: its
    profile names the op, once per call, and the result equals the
    reference on the dense blocks."""
    from torch.profiler import ProfilerActivity, profile
    args = _args(2, 1, torch.float64, False)
    shared = list(args)
    shared[8] = args[8][0]              # P_term shared by the batch
    solve = make_lq_solver(REG)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = solve(*shared)
    calls = [e for e in prof.key_averages() if e.key == "hilo_mpc_tpu_torch::riccati_lq"]
    assert sum(e.count for e in calls) == 1
    ref = ck.riccati_lq_reference(*args, reg=REG)
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= 1e-12


def test_plain_version_is_registered_for_the_cpu_only(monkeypatch):
    """The dispatcher picks by device: tensors on another device (here
    meta, the fake kernel) never reach the plain version."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ck, "riccati_lq_reference", refuse)
    meta = [a.to("meta") for a in _args(2, 1, torch.float32, False)]
    out = ck.riccati_lq_cuda(*meta)
    assert out[0].device.type == "meta" and out[0].shape == (4, 6, 2)
    out = ck.riccati_lq_wide_cuda(*meta)
    assert out[3].shape == (4, 5, 1, 2)
    with pytest.raises(AssertionError, match="plain version ran"):
        ck.riccati_lq_cuda(*_args(2, 1, torch.float32, False))
