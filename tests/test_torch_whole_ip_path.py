"""PyTorch port: the whole-solve kernel on path following with an implicit
integrator step (CPU).

The problem is the Schaffner & Zeitz CSTR under Radau collocation of degree
2 with a path parameter (``create_path_variable(0, 2, speed_ref=1,
speed_weight=1)``): the traced route (ops/codegen_fx.py) traces the model's
own equations, wraps them in the emitted collocation step
(ops/codegen_cuda.py:_emit_dyn, csrc/implicit.cuh) and emits the path state
th_{k+1} = th_k + h·u_pf around it, as control/nmpc.py's ``dyn`` builds it.

- the gate: pallas_full takes it with no warning, the whole-solve path's
  plain version bit for bit on the CPU, no Riccati launch;
- the host build against the plain version in float64: equal iterations,
  U/X to 1e-9;
- the plain version against JAX's general path (vmapped ``solve_ocp``) at
  the same pure-Newton options: equal iterations, U/X to 1e-8.
The DAE model of tests/test_torch_whole_ip_dae.py takes the same route
(its ``path_parameter`` gate case); chip_smoke.py runs this problem at
B=131072 (phase 1, whole_ip_path_implicit, and phase 11(b)).
"""
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.ops.ip_solver as jip
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64
N, B = 4, 4
OPTS = {"dt": 0.1, "tol": 1e-8, "max_iter": 30, "convexify": False,
        "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False,
        "integration_method": "collocation", "degree": 2}


def path_nmpc(cls, model, options=None, **setup_kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.create_path_variable(0, 2, speed_ref=1, speed_weight=1)
    nmpc.setup(options={**OPTS, **(options or {})}, **setup_kw)
    return nmpc


def x0s():
    return np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(5).standard_normal((B, 2))


@pytest.fixture(scope="module")
def path():
    tn = path_nmpc(NMPC, cstr_schaffner_and_zeitz(), {"pallas_full": True},
                   device=CPU, dtype=F64)
    args = tn.prepare_batch(x0s())
    plain = W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *args,
                                       tn._ip_opts)
    return tn, args, plain


def test_gate_takes_path_following_on_collocation(path):
    tn, args, plain = path
    assert (tn._dims.nx, tn._dims.nu) == (3, 2) and tn._path_following
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is not None and why is None, why
    assert "codegen_fx.py" in problem.text and "implicit.cuh" in problem.text
    assert "out[2] = xs[2] + h * us[1];" in problem.text
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"]
    for a, b in zip(fn(*args), plain):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric


def test_host_kernel_matches_plain_f64(path):
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")
    tn, args, r = path
    k = W.solve_ocp_full_host(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)
    # the path advanced: th_N > 0 with u_pf near its speed reference
    assert bool((r.X[:, -1, 2] > 0.05).all())


def test_plain_matches_jax_general_path(path):
    tn, _, _ = path
    jn = path_nmpc(JaxNMPC, jax_cstr())
    args = jn.prepare_batch(x0s())
    jsol = jax.jit(jax.vmap(lambda th, x0, Xi, Ui: jip.solve_ocp(
        jn._funcs, jn._dims, jn._bounds, th, x0, Xi, Ui, options=jn._ip_opts,
        fix_x0=True)))(*args)
    targs = to_torch(args, device=CPU)
    sol = to_numpy(W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *targs,
                                              tn._ip_opts))
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_array_equal(sol.converged, np.asarray(jsol.converged))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol.X, np.asarray(jsol.X), rtol=0, atol=1e-8)
