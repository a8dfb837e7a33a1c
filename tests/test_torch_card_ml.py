"""PyTorch port on the card: discrete inputs' candidate batch on the Riccati
kernel, and the hybrid physics + ANN CSTR through the whole-solve kernel
(``cuda``-marked; they skip without a card). This file imports no JAX: it
holds the card against the CPU and against the plain PyTorch versions; the
CPU tests against the JAX package are tests/test_torch_minlp.py and
tests/test_torch_hybrid.py."""
import warnings

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import ANN, NMPC, Dense, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

F64 = torch.float64
LEVELS = [-1.0, 0.0, 1.0]
# pure Newton steps at the flagship's tolerance, as the whole-solve kernel
# takes them
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 25,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def di_controller(device):
    """tests/test_minlp.py's double integrator and controller, float64."""
    m = Model()
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1))
    m.setup(dt=0.2, device=device, dtype=F64)
    c = NMPC(m)
    c.horizon = 12
    c.quad_stage_cost.add_states(["p", "v"], weights=[10.0, 1.0], ref=[1.0, 0.0])
    c.quad_stage_cost.add_inputs("u", weights=0.1)
    c.quad_terminal_cost.add_states(["p", "v"], weights=[50.0, 5.0], ref=[1.0, 0.0])
    c.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    c.set_discrete_inputs("u", levels=LEVELS)
    return c.setup(options={"tol": 1e-6}, device=device, dtype=F64)


@pytest.mark.cuda
def test_candidate_batch_is_one_solve_on_the_riccati_kernel():
    """On the card the candidate batch runs on the Riccati kernel; card
    against CPU over five closed-loop steps, the same picks and moves."""
    _need_card()
    card, cpu = di_controller("cuda"), di_controller("cpu")
    x = np.zeros(2)
    for _ in range(5):
        riccati_lq_cuda.launches = 0
        u = card.optimize(x)
        assert riccati_lq_cuda.launches > 0
        assert cpu.optimize(x)[0] == u[0]
        assert card.stats["mi_pick"] == cpu.stats["mi_pick"]
        x = np.array([x[0] + 0.2 * x[1] + 0.02 * u[0], x[1] + 0.2 * u[0]])


def fixed_ann():
    """Golden hybrid_ann's frozen 2-8-1 tanh network for E
    (tests/golden_configs.py:_fixed_ann): weights 0.3·N(0,1) and biases
    0.1·N(0,1) from default_rng(42), the output bias shifted by 1.0."""
    ann = ANN(["x_1", "x_2"], ["E"]).add_layers([Dense(8, activation="tanh")])
    ann.setup(normalize=False, device="cpu", dtype=F64)
    rng = np.random.default_rng(42)
    params = [{"W": 0.3 * rng.standard_normal(tuple(p["W"].shape)),
               "b": 0.1 * rng.standard_normal(tuple(p["b"].shape))} for p in ann._params]
    params[-1]["b"] = params[-1]["b"] + 1.0
    ann._params = params
    return ann


def hybrid_nmpc(options, dtype):
    nmpc = NMPC(cstr_schaffner_and_zeitz() + fixed_ann())
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 5)
    return nmpc.setup(options=options, device="cuda", dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hybrid_through_the_whole_solve_kernel_on_card(dtype):
    """Phase 15(a) in small: the hybrid CSTR (N=20, B=1024) through
    pallas_full is one whole-solve launch and no Riccati launch, with no
    warning; the problem's instance in ``dtype`` against its plain version
    (float64 equal iterations and U to 1e-9, float32 5e-4) and the general
    path (the Riccati kernel, 5e-4)."""
    _need_card()
    dt = getattr(torch, dtype)
    whole = hybrid_nmpc({**KERNEL_OPTS, "pallas_full": True}, dt)
    general = hybrid_nmpc(KERNEL_OPTS, dt)
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(0).standard_normal((1024, 2))
    args = whole.prepare_batch(x0s)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = whole.solve_batch_fn()
    n_full, n_ric = W.solve_ocp_full_cuda.launches, riccati_lq_cuda.launches
    k = fn(*args)
    assert (W.solve_ocp_full_cuda.launches - n_full, riccati_lq_cuda.launches - n_ric) \
        == (1, 0)
    g = general.solve_batch_fn()(*args)
    assert riccati_lq_cuda.launches > n_ric
    # the route runs the float32 instance (the JAX kernel's precision); the
    # problem's instance in this dtype is held to the plain version
    k = W.WholeIPLaunch(whole._wip["problem"], whole._dims, dt, args[0].device)(
        *args, whole._mu_cold)
    r = W.solve_ocp_full_reference(whole._funcs, whole._dims, whole._bounds, *args,
                                   whole._ip_opts)
    torch.cuda.synchronize()
    both = k.converged & r.converged & g.converged
    assert float(both.float().mean()) >= 0.97
    if dt == torch.float64:
        assert torch.equal(k.iterations, r.iterations)
        assert float((k.U - r.U).abs().max()) <= 1e-9
    else:
        assert float((k.U - r.U).abs()[both].max()) <= 5e-4
    assert float((k.U - g.U).abs()[both].max()) <= 5e-4
