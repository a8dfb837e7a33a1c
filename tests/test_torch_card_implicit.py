"""PyTorch port on the card: the whole-solve kernel with an emitted implicit
step (``cuda``-marked; they skip without a card). The CSTR of
tests/test_torch_whole_ip_implicit.py under each implicit method (DSL
route) and golden dae_colloc's model under collocation, RK4 with its stage
Newton and a discrete map (traced route, tests/test_torch_whole_ip_dae.py),
each build against its plain version: float64 equal iterations and U to
1e-9, float32 U to 5e-4 on the jointly converged scenarios, one launch;
``pallas_full`` on the card takes the problem in one launch and no Riccati
launch. This file imports no JAX; the CPU tests against the JAX kernel
are in those two files."""
import warnings

import numpy as np
import pytest
import torch

from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

F64 = torch.float64
# pure Newton steps at the flagship's tolerance, as the whole-solve kernel
# takes them
KERNEL_OPTS = {"dt": 0.1, "tol": 1e-4, "max_iter": 25, "convexify": False,
               "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False}
DAE_ALPHA = 0.05
CSTR = {
    "radau2": {"integration_method": "collocation", "degree": 2},
    "legendre3": {"integration_method": "collocation", "degree": 3,
                  "collocation_scheme": "legendre"},
    "irk": {"integration_method": "irk", "degree": 2},
    "cvodes": {"integration_method": "cvodes", "substeps": 2},
}
DAE = {
    "collocation": {"integration_method": "collocation", "degree": 3},
    "rk4_stage_newton": {"integration_method": "rk4", "substeps": 2},
    "discrete": {"integration_method": "discrete", "substeps": 2},
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")


def cstr(options, dtype, device="cuda", N=20):
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={**KERNEL_OPTS, **options}, device=device, dtype=dtype)
    return nmpc


def dae(options, dtype, device="cuda", N=12):
    """golden_configs.build_dae_colloc's model and cost at pure Newton."""
    m = Model(name="dae", discrete=options["integration_method"] == "discrete")
    m.set_dynamical_states("x")
    m.set_algebraic_states("z")
    m.set_inputs("u")
    if m.discrete:
        m.set_dynamical_equations(lambda x, z, u: x + 0.1 * (-x + z + u))
    else:
        m.set_dynamical_equations(lambda x, z, u: -x + z + u)
    m.set_algebraic_equations(lambda x, z: z - 0.5 * x - DAE_ALPHA * z ** 2)
    nmpc = NMPC(m)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0], ref=[0.5])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    nmpc.setup(options={**KERNEL_OPTS, **options}, device=device, dtype=dtype)
    return nmpc


def _x0s(kind, B):
    rng = np.random.default_rng(0)
    if kind == "cstr":
        return np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))
    return 0.1 + 0.2 * rng.standard_normal((B, 1))


CASES = {**{f"cstr_{k}": (cstr, v) for k, v in CSTR.items()},
         **{f"dae_{k}": (dae, v) for k, v in DAE.items()}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_implicit_kernel_matches_plain_on_card(case, dtype):
    _need_card()
    build, options = CASES[case]
    dt = getattr(torch, dtype)
    tn = build(options, dt)
    args = tn.prepare_batch(_x0s(case.split("_")[0], 1024))
    n0 = W.solve_ocp_full_cuda.launches
    k = W.solve_ocp_full_cuda(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    r = W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *args,
                                   tn._ip_opts)
    torch.cuda.synchronize()
    assert W.solve_ocp_full_cuda.launches == n0 + 1
    both = k.converged & r.converged
    assert bool(both.float().mean() >= 0.97)
    if dt == F64:
        assert torch.equal(k.iterations, r.iterations)
        torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    else:
        torch.testing.assert_close(k.U[both], r.U[both], rtol=0, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cstr_radau2", "dae_collocation"])
def test_pallas_full_takes_implicit_steps_on_card(case):
    """NMPC(pallas_full=True) on the card: no warning, one whole-solve launch
    and no Riccati launch per solve."""
    _need_card()
    build, options = CASES[case]
    tn = build({**options, "pallas_full": True}, torch.float32)
    args = tn.prepare_batch(_x0s(case.split("_")[0], 4096))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    n_full, n_ric = W.solve_ocp_full_cuda.launches, riccati_lq_cuda.launches
    sol = fn(*args)
    torch.cuda.synchronize()
    assert W.solve_ocp_full_cuda.launches == n_full + 1
    assert riccati_lq_cuda.launches == n_ric
    assert bool(sol.converged.float().mean() >= 0.97)
