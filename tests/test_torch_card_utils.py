"""PyTorch port on the card: the Riccati operators, the exported solve and
the registry's whole-solve route (``cuda``-marked; they skip without a
card). This file imports no JAX: it holds the card against the port's
plain versions; the CPU tests against the JAX package are
tests/test_torch_riccati_op.py, tests/test_torch_aot.py and
tests/test_torch_registry.py."""
import zipfile

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import NMPC, clear_trace_registry, trace_registry_stats
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import cuda_kernels as ck

F64 = torch.float64


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _lq(Bt, N, nx, nu, dtype, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((Bt, N, nx, nx))
    B = 0.3 * rng.standard_normal((Bt, N, nx, nu))
    Q = np.tile(np.eye(nx), (Bt, N, 1, 1))
    S = 0.1 * rng.standard_normal((Bt, N, nu, nx))
    R = np.tile(0.5 * np.eye(nu), (Bt, N, 1, 1))
    rest = [rng.standard_normal((Bt, N, nx)), rng.standard_normal((Bt, N, nu)),
            0.1 * rng.standard_normal((Bt, N, nx)), np.tile(np.eye(nx), (Bt, 1, 1)),
            rng.standard_normal((Bt, nx)), rng.standard_normal((Bt, nx))]
    return [torch.as_tensor(a, dtype=dtype) for a in (A, B, Q, S, R, *rest)]


@pytest.mark.cuda
@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("nx,nu", [(2, 1), (9, 2)])
def test_riccati_operator_on_card_matches_plain(nx, nu, free):
    """The operator launches the kernel on CUDA tensors (its count), agrees
    with the plain version on the CPU copies (1e-10, float64), and passes
    opcheck there."""
    _need_card()
    cpu = _lq(300, 12, nx, nu, F64)
    if free:
        cpu[-1] = None
    card = [None if a is None else a.cuda() for a in cpu]
    wrapper = ck.riccati_lq_cuda if ck.riccati_lq_tiled_fits(nx, nu) else ck.riccati_lq_wide_cuda
    n0 = wrapper.launches
    out = wrapper(*card)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    for a, b in zip(out, ck.riccati_lq_reference(*cpu, reg=1e-8)):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 1e-10
    op = ck.riccati_lq_op if wrapper is ck.riccati_lq_cuda else ck.riccati_lq_wide_op
    extra = (1e-8,) if op is ck.riccati_lq_op else (1e-8, 0)
    torch.library.opcheck(op, (*card, *extra))


def _flagship(device, **opts):
    """chip_smoke.py's flagship controller in float64."""
    n = NMPC(cstr_schaffner_and_zeitz())
    n.horizon = 20
    n.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    n.quad_stage_cost.add_inputs(weights=0.1)
    n.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    n.set_parameters([1.0] * 6)
    return n.setup(options={"dt": 0.1, "tol": 1e-4, "max_iter": 25, "convexify": False,
                            "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False,
                            **opts}, device=device, dtype=F64)


def _x0s(B, seed=0):
    return np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(seed).standard_normal((B, 2))


@pytest.mark.cuda
def test_exported_solve_on_card_names_the_operator(tmp_path):
    """The flagship's solve exported on the card (float64, B=256): the
    iteration's graph holds the Riccati operator, and the reloaded solve
    gives the live solve's U to 1e-10."""
    _need_card()
    from hilo_mpc_tpu_torch.utils.aot import export_nmpc_solver, load_function
    n = _flagship("cuda")
    args = n.prepare_batch(_x0s(256))
    path = export_nmpc_solver(n, str(tmp_path / "solver.zip"), batch=256)
    with zipfile.ZipFile(path) as z, zipfile.ZipFile(z.open("step.pt2")) as step:
        text = b"".join(step.read(m) for m in step.namelist() if m.endswith(".json"))
    assert b"hilo_mpc_tpu_torch.riccati_lq" in text
    n0 = ck.riccati_lq_cuda.launches
    X, U, conv, _ = load_function(path)(*args)
    assert ck.riccati_lq_cuda.launches - n0 == n._ip_opts.max_iter
    live = n.solve_batch_fn()(*args)
    assert float((U - live.U).abs().max()) <= 1e-10 and bool(conv.all())


@pytest.mark.cuda
def test_registry_shares_the_whole_solve_launch_on_card():
    """Two pallas_full controllers of one configuration: one entry, one
    prepared launch (the loaded entry point), the same U to the bit."""
    _need_card()
    clear_trace_registry()
    a, b = _flagship("cuda", pallas_full=True), _flagship("cuda", pallas_full=True)
    x = _x0s(1024)
    ua = a.solve_batch_fn()(*a.prepare_batch(x)).U
    ub = b.solve_batch_fn()(*b.prepare_batch(x)).U
    assert trace_registry_stats()["entries"] == 1
    assert a._wip["launch"] is b._wip["launch"] and len(a._wip["launch"]) == 1
    assert torch.equal(ua, ub)
    clear_trace_registry()
