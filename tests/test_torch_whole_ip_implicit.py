"""PyTorch port: the whole-solve interior point on implicit integrator steps,
emitted from the equation DSL (ops/codegen_cuda.py:_emit_step,
csrc/implicit.cuh), on the CSTR of tests/test_pallas_ip.py (CPU).

- The float32 host build (the kernel's own code) of Radau collocation d=2
  against the JAX kernel ``solve_ocp_pallas_full`` in interpret mode, whose
  ``dyn`` runs the Newton through ``lax.custom_root`` (N=4, B=3, one call
  for the module): equal iterations, U/X to 5e-4, objective rtol 1e-4.
- Collocation (Radau and Gauss-Legendre), ``irk`` and ``cvodes``: the
  float64 host build against the plain version (``solve_ocp_full_reference``):
  equal iterations, U/X to 1e-9; the emitted step's F and [A | B] against
  ``torch.func.jacfwd`` of the port's ``dyn`` (the implicit function
  theorem's derivatives) to 1e-10.
- The gate: ``pallas_full`` takes every method of ``IMPLICIT_METHODS``
  without a warning and without a Riccati launch, and declines a Newton
  above ``NEWTON_MAX`` naming it; schemes of one degree share one build.
The card tests of these builds are tests/test_torch_card_implicit.py.
"""
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.core.integrators import IMPLICIT_METHODS
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.ops.codegen_cuda import NEWTON_MAX
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
# the option set of tests/test_pallas_ip.py:_flagship
KERNEL_OPTS = {"dt": 0.1, "tol": 1e-4, "max_iter": 10, "convexify": False,
               "n_linesearch": 1, "mu_init": 1e-2, "mehrotra": False}
RADAU2 = {"integration_method": "collocation", "degree": 2}
METHODS = {
    "radau2": RADAU2,
    "legendre2": {**RADAU2, "collocation_scheme": "legendre"},
    "irk": {"integration_method": "irk", "degree": 2},
    # Radau of degree max(d, 3), two substeps
    "cvodes": {"integration_method": "cvodes", "substeps": 2},
}


def _nmpc(cls, model, N, options, **setup_kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={**KERNEL_OPTS, **options}, **setup_kw)
    return nmpc


def _port(N, options, dtype=F64, device=CPU):
    return _nmpc(NMPC, cstr_schaffner_and_zeitz(), N, options, device=device,
                 dtype=dtype)


def _x0s(B, seed):
    rng = np.random.default_rng(seed)
    return np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((B, 2))


def _plain(nmpc, args):
    return W.solve_ocp_full_reference(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                      nmpc._ip_opts)


def _host(nmpc, args):
    return W.solve_ocp_full_host(nmpc._funcs, nmpc._dims, nmpc._bounds, *args,
                                 nmpc._ip_opts)


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


@pytest.fixture(scope="module")
def pallas_radau():
    """The JAX kernel in interpret mode on the collocation CSTR (N=4, B=3)."""
    jn = _nmpc(JaxNMPC, jax_cstr(), 4, RADAU2)
    args = jn.prepare_batch(_x0s(3, 0))
    sol = solve_ocp_pallas_full(jn._funcs, jn._dims, jn._bounds, *args,
                                options=jn._ip_opts, tile_b=8)
    return to_torch(args, device=CPU), jax.tree.map(np.asarray, sol)


def test_host_kernel_matches_pallas_interpret(pallas_radau):
    """The kernel's code with the emitted collocation step, float32, against
    the JAX kernel, which runs the same Newton through custom_root."""
    _need_cxx()
    args, jsol = pallas_radau
    tn = _port(4, RADAU2, dtype=torch.float32)
    sol = to_numpy(_host(tn, [a.float() for a in args]))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, rtol=0, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, rtol=0, atol=5e-4)
    np.testing.assert_allclose(sol.objective, jsol.objective, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(METHODS))
def test_host_kernel_matches_plain_f64(case):
    """The emitted step's Newton (LU with partial pivoting above 3 unknowns)
    inside the kernel's solve against the plain version."""
    _need_cxx()
    tn = _port(5, METHODS[case])
    args = tn.prepare_batch(_x0s(5, 1))
    k, r = _host(tn, args), _plain(tn, args)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations)
    assert torch.equal(k.converged, r.converged) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", sorted(METHODS))
def test_dual_pass_is_the_implicit_derivative(case):
    """F and [A | B] of the emitted step (the Newton on plain values, one
    tangent correction over the dual type) against jacfwd of the port's
    dyn, whose newton_solve gives the implicit function theorem's
    derivatives."""
    _need_cxx()
    tn = _port(3, METHODS[case])
    rng = np.random.default_rng(7)
    R = 6
    xs = torch.as_tensor(np.array([0.25, 0.15]) + 0.1 * rng.standard_normal((R, 2)))
    us = torch.as_tensor(rng.uniform(-1.0, 1.0, (R, 1)))
    th = torch.as_tensor(np.tile(np.r_[0.3, 0.1, [1.0] * 6], (R, 1)))
    F, AB = W.dyn_lin_host(tn._funcs, tn._dims, tn._bounds, xs, us, th)
    dyn = tn._funcs.dyn
    JA, JB = vmap(jacfwd(dyn, argnums=(0, 1)))(xs, us, th)
    torch.testing.assert_close(F, dyn(xs, us, th), rtol=0, atol=1e-10)
    torch.testing.assert_close(AB[..., :2], JA, rtol=0, atol=1e-10)
    torch.testing.assert_close(AB[..., 2:], JB, rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", IMPLICIT_METHODS)
def test_gate_takes_implicit_methods(method):
    """pallas_full on every implicit method: no warning, the whole-solve path
    (its plain version on CPU tensors, bit for bit), no Riccati launch."""
    tn = _port(3, {"integration_method": method, "degree": 2, "pallas_full": True})
    args = tn.prepare_batch(_x0s(2, 2))
    n_ric = riccati_lq_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = tn.solve_batch_fn()
    assert tn._wip["eligible"] and '#include "implicit.cuh"' in tn._wip["problem"].text
    for a, b in zip(fn(*args), _plain(tn, args)):
        assert torch.equal(a, b)
    assert riccati_lq_cuda.launches == n_ric


def test_gate_declines_newton_above_cap():
    """Radau of degree 9 on two states: a Newton of 18 unknowns."""
    tn = _port(4, {"integration_method": "collocation", "degree": 9,
                   "pallas_full": True})
    assert 9 * 2 > NEWTON_MAX
    problem, why = W.whole_ip_gate(tn._funcs, tn._dims, tn._bounds, tn._ip_opts, True)
    assert problem is None and "a Newton of 18 unknowns" in why
    args = tn.prepare_batch(_x0s(2, 3))
    with pytest.warns(UserWarning, match="NEWTON_MAX"):
        fn = tn.solve_batch_fn()
    for a, b in zip(fn(*args), _port(4, {"integration_method": "collocation",
                                         "degree": 9}).solve_batch_fn()(*args)):
        assert torch.equal(a, b)


def test_schemes_share_one_build():
    """The collocation matrices, the nodes and z0 are numbers: Radau and
    Gauss-Legendre of one degree are one build; the degree is structure."""
    def problem(options):
        tn = _port(4, options)
        return W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, 8, tn._ip_opts)

    a, b = problem(RADAU2), problem(METHODS["legendre2"])
    assert a.text == b.text and not np.array_equal(a.prm, b.prm)
    assert problem({**RADAU2, "degree": 3}).text != a.text
    rk4 = problem({"integration_method": "rk4"})
    assert a.flops > 3 * rk4.flops            # the Newton counts in the bound
