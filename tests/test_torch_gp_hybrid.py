"""PyTorch port: hybrid physics + GP models against the JAX package (CPU,
float64): a GP's and a GPArray's posterior means substituted for model
parameters (utils/interop.py:gp_from, model_from(learned=)), simulated to
1e-12; the GP hybrid CSTR through the whole-solve kernel's traced route
(the mean m(x) + k(x, X)·α emitted as C++, its numbers in prm): the gate
takes it, the emitted derivatives against torch.func, the host build
against the plain version and the plain version against the JAX general
path (1e-10, equal iterations); a GP policy in SimpleControlLoop. The
card's checks are in tests/test_torch_card_gp.py."""
import shutil
import warnings

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from golden_configs import CSTR_P, CSTR_REF
from hilo_mpc_tpu import GP as JaxGP
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import SimpleControlLoop as JaxLoop
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ml.gp.gp import GPArray as JaxGPArray
from hilo_mpc_tpu.ml.hybrid import substitute_from as jax_substitute
from hilo_mpc_tpu_torch import NMPC, SimpleControlLoop
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.utils.interop import gp_from, model_from, to_numpy, to_torch

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-8, "max_iter": 40,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def jax_gp(label="E", inference="exact", n=12, seed=5):
    """A GP of a CSTR parameter from the states (an exact SE GP, or FITC)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([0.0, 0.0], [0.6, 0.4], (n, 2))
    y = 1.0 + 0.1 * np.sin(4.0 * X[:, 0]) - 0.05 * X[:, 1]
    gp = JaxGP(["x_1", "x_2"], [label], noise_variance=0.01, inference=inference,
               inference_options={"n_inducing": 5} if inference == "fitc" else None)
    gp.set_training_data(X, y)
    return gp.setup()


def jax_array():
    arr = JaxGPArray(2)
    arr[0], arr[1] = jax_gp("E"), jax_gp("g", seed=6)
    return arr


@pytest.mark.parametrize("learned", ["exact", "fitc", "array"])
def test_substitution_matches_jax(learned):
    """The CSTR with E (and for the array also g) the GP posterior mean:
    simulated 5 steps from three states, to 1e-12 against JAX."""
    src = jax_array() if learned == "array" else jax_gp(inference=learned)
    jm = jax_cstr()
    jax_substitute(jm, src)
    tm = model_from(jax_cstr(), learned=src)
    assert tm.parameters == jm.parameters and tm._ode_origin == "callable"
    jm.setup(dt=0.1, integration_method="rk4")
    jm._dtype = np.float64
    tm.setup(dt=0.1, device=CPU, dtype=F64)
    p = [1.0] * len(jm.parameters)
    for x0 in ([0.2, 0.1], [0.4, 0.3], [0.1, 0.05]):
        ref = np.asarray(jm.simulate(x0=x0, u=[[0.3]], p=p, steps=5, store=False)["x"])
        out = tm.simulate(x0=x0, u=[[0.3]], p=p, steps=5, store=False)["x"]
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def test_gp_plus_model_and_composition_errors():
    tg = gp_from(jax_gp(), device=CPU)
    base = cstr_schaffner_and_zeitz()
    hybrid = base + tg
    assert base.n_p == 6 and hybrid.n_p == 5 and "E" not in hybrid.parameters
    with pytest.raises(TypeError, match="cannot compose"):
        base + jax_gp()      # a JAX GP must be carried across first
    bad = gp_from(jax_gp(label="nope"), device=CPU)
    with pytest.raises(ValueError, match="not model parameters"):
        base.substitute_from(bad)


def port_nmpc(options, horizon=6):
    nmpc = NMPC(cstr_schaffner_and_zeitz() + gp_from(jax_gp(), device=CPU))
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P[:5])
    return nmpc.setup(options=options, device=CPU, dtype=F64)


@pytest.fixture(scope="module")
def kernel_nmpc():
    return port_nmpc({**KERNEL_OPTS, "pallas_full": True})


def _x0s(B, seed):
    return np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(seed).standard_normal((B, 2))


def test_whole_solve_takes_the_gp_hybrid(kernel_nmpc):
    """The gate takes the GP hybrid through the trace with no warning; the
    emitted text holds the kernel's exp, and the GP's weights α and training
    inputs are numbers in prm."""
    f, d, b, o = (kernel_nmpc._funcs, kernel_nmpc._dims, kernel_nmpc._bounds,
                  kernel_nmpc._ip_opts)
    problem, why = W.whole_ip_gate(f, d, b, o, True)
    assert problem is not None and why is None
    assert "codegen_fx.py" in problem.text and "hm::m_exp" in problem.text
    gp = gp_from(jax_gp(), device=CPU)
    prm = np.asarray(problem.prm)
    assert np.isin(gp._mean_weights()[1].numpy(), prm).all()
    assert np.isin(gp.X_train.ravel(), prm).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        kernel_nmpc.solve_batch_fn()


def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


def test_emitted_gp_hybrid_derivatives_match_torch_func(kernel_nmpc):
    """F and [A | B] of the emitted step (the GP mean inside RK4's four
    stages) against torch.func, float64, 1e-12."""
    _need_cxx()
    f, d, b = kernel_nmpc._funcs, kernel_nmpc._dims, kernel_nmpc._bounds
    rng = np.random.default_rng(3)
    R = 4
    xs = torch.as_tensor(rng.uniform(0.0, 0.5, (R, 2)))
    us = torch.as_tensor(rng.uniform(-2.0, 2.0, (R, 1)))
    th = kernel_nmpc._tensor(kernel_nmpc._assemble_theta(None, None))[0].expand(R, -1)
    F, AB = W.dyn_lin_host(f, d, b, xs, us, th)
    for r in range(R):
        def dyn(z):
            return f.dyn(z[None, :2], z[None, 2:], th[r:r + 1])[0]
        z = torch.cat([xs[r], us[r]])
        torch.testing.assert_close(F[r], dyn(z), rtol=0, atol=1e-12)
        torch.testing.assert_close(AB[r], jacfwd(dyn)(z), rtol=0, atol=1e-12)


def test_host_kernel_and_plain_match_jax_general_path(kernel_nmpc):
    """The kernel's own per-scenario code (host build) against its plain
    version (equal iterations, 1e-12), and the plain version against the
    JAX general path under the same pure Newton options from the same
    prepared inputs (equal iterations, U to 1e-10)."""
    _need_cxx()
    jm = jax_cstr()
    jax_substitute(jm, jax_gp())
    jn = JaxNMPC(jm)
    jn.horizon = 6
    jn.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    jn.quad_stage_cost.add_inputs(weights=0.1)
    jn.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    jn.set_parameters(CSTR_P[:5])
    jn.setup(options=KERNEL_OPTS)
    x0s = _x0s(4, 2)
    j_args = jn.prepare_batch(x0s)
    t_args = kernel_nmpc.prepare_batch(x0s)
    for a, b in zip(to_numpy(t_args), j_args):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)
    js = jn.solve_batch_fn()(*j_args)
    n = kernel_nmpc
    args = to_torch(j_args, device=CPU, dtype=F64)
    ts = n.solve_batch_fn()(*args)
    assert bool(ts.converged.all())
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.U.numpy(), np.asarray(js.U), rtol=0, atol=1e-10)
    k = W.solve_ocp_full_host(n._funcs, n._dims, n._bounds, *args, n._ip_opts)
    assert torch.equal(k.iterations, ts.iterations)
    torch.testing.assert_close(k.U, ts.U, rtol=0, atol=1e-12)


def test_gp_policy_in_simple_control_loop():
    """A GP as a controller (``predict`` on the plant state: its posterior
    mean) closes the loop as in the JAX package: 4 steps, states to 1e-12."""
    src = JaxGP(["x_1", "x_2"], ["u"], noise_variance=0.01)
    rng = np.random.default_rng(2)
    X = rng.uniform([0.0, 0.0], [0.6, 0.4], (10, 2))
    src.set_training_data(X, -0.5 * (X[:, 0] - 0.3) - 0.2 * (X[:, 1] - 0.18))
    src.setup()
    out = []
    for jx in (True, False):
        plant = jax_cstr() if jx else cstr_schaffner_and_zeitz()
        if jx:
            plant.setup(dt=0.1, integration_method="rk4")
            plant._dtype = np.float64
        else:
            plant.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
        plant.set_initial_conditions([0.25, 0.12])
        plant.set_initial_parameter_values(CSTR_P)
        loop = (JaxLoop if jx else SimpleControlLoop)(
            plant, src if jx else gp_from(src, device=CPU))
        loop.run(4)
        out.append(np.asarray(loop.solution["x"]))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-12)
