"""PyTorch port: hybrid physics + ANN models against the JAX package (CPU,
float64): ``substitute_from`` and ``+``, golden ``hybrid_ann`` through the
general path, and the hybrid CSTR through the whole-solve kernel's traced
route (the network's products and tanh written as C++, its weights in
prm): the emitted derivatives against ``torch.func``, the host build of
the kernel against its plain version, and the plain version against the
JAX general path. The card's checks are in tests/test_torch_card_ml.py."""
import os
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from golden_configs import CSTR_P, CSTR_REF, _fixed_ann
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ml import nn as jnn
from hilo_mpc_tpu.ml.hybrid import substitute_from as jax_substitute
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.utils.interop import (ann_from, gp_from, model_from, to_numpy,
                                             to_torch)

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hybrid_ann.npz")
# pure Newton steps, as the whole-solve kernel takes them
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-8, "max_iter": 40,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def bio(jx):
    """tests/test_ml.py's bioreactor, a model given as a callable."""
    m = (JaxModel if jx else Model)(name="bio")
    m.set_dynamical_states(["Xc", "S"])
    m.set_inputs(["D"])
    m.set_parameters(["Sf", "mu"])
    if jx:
        m.set_dynamical_equations(
            lambda x, u, p: jnp.array([p[1] * x[0] - u[0] * x[0],
                                       -2 * p[1] * x[0] - u[0] * (x[1] - p[0])]))
    else:
        m.set_dynamical_equations(
            lambda x, u, p: torch.stack([p[..., 1] * x[..., 0] - u[..., 0] * x[..., 0],
                                         -2 * p[..., 1] * x[..., 0]
                                         - u[..., 0] * (x[..., 1] - p[..., 0])], -1))
    return m


def jax_net(features, labels, seed=0):
    ann = jnn.ArtificialNeuralNetwork(features, labels, seed=seed)
    ann.add_layers([jnn.Dense(6, "tanh")])
    ann.setup(normalize=False)
    rng = np.random.default_rng(seed + 10)
    ann._params = [{"W": 0.4 * rng.standard_normal(np.shape(p["W"])),
                    "b": 0.1 * rng.standard_normal(np.shape(p["b"]))}
                   for p in ann._params]
    ann._scaler_mean, ann._scaler_scale = rng.normal(size=len(features)), np.full(
        len(features), 1.7)
    return ann


@pytest.mark.parametrize("features, labels", [
    (["S"], ["mu"]), (["Xc", "D", "t"], ["mu"]), (["S", "Sf"], ["mu"]),
    (["Xc", "S"], ["Sf", "mu"])], ids=["state", "input_and_time", "kept_parameter",
                                       "every_parameter"])
def test_substitute_matches_jax(features, labels):
    """The hybrid model simulated by both packages, the same network (weights
    and feature scalers carried across): states to 1e-12 over 6 steps, a
    batch of 3 in the port against JAX one by one."""
    ja = jax_net(features, labels)
    jm, tm = bio(True), bio(False)
    jax_substitute(jm, ja)
    tm.substitute_from(ann_from(ja, device=CPU))
    kept = [p for p in ("Sf", "mu") if p not in labels]
    assert tm.parameters == jm.parameters == kept
    assert tm._equations_src is None and tm._ode_origin == "callable"
    jm.setup(dt=0.1)
    jm._dtype = jnp.float64
    tm.setup(dt=0.1, device=CPU, dtype=F64)
    p = [10.0] if kept else None
    x0s = np.array([[0.1, 2.0], [0.3, 1.0], [0.2, 4.0]])
    U = 0.05 + 0.02 * np.arange(6)[:, None]
    out = tm.simulate(x0=x0s, u=np.tile(U, (3, 1, 1)), p=p, steps=6)
    for b, x0 in enumerate(x0s):
        ref = np.asarray(jm.simulate(x0=x0, u=U, p=p, steps=6, store=False)["x"])
        np.testing.assert_allclose(out["x"][b], ref, rtol=0, atol=1e-12)


def test_add_returns_a_new_model():
    """``base + ann`` leaves ``base`` as it was: its parameters and its own
    closures."""
    ann = ann_from(jax_net(["S"], ["mu"]), device=CPU)
    base = bio(False)
    hybrid = base + ann
    assert base.n_p == 2 and hybrid.n_p == 1 and hybrid.name == "bio_hybrid"
    base.setup(dt=0.1, device=CPU, dtype=F64)
    hybrid.setup(dt=0.1, device=CPU, dtype=F64)
    x = base.simulate(x0=[0.1, 2.0], u=[[0.05]], p=[10.0, 0.3], steps=1)["x"][-1]
    np.testing.assert_allclose(x[0], 0.1 + 0.1 * (0.3 - 0.05) * 0.1, atol=2e-3)
    assert np.all(np.isfinite(hybrid.simulate(x0=[0.1, 2.0], u=[[0.05]], p=[10.0],
                                              steps=1)["x"]))


def test_composition_errors():
    ann = ann_from(jax_net(["S"], ["not_a_param"]), device=CPU)
    with pytest.raises(ValueError, match="not model parameters"):
        bio(False).substitute_from(ann)
    ann = ann_from(jax_net(["nope"], ["mu"]), device=CPU)
    with pytest.raises(ValueError, match="not a model variable"):
        bio(False).substitute_from(ann)
    from hilo_mpc_tpu import GP
    # a port GP (carried across) substitutes; a JAX GP itself does not
    # compose with a port model
    gp = GP(["S"], ["mu"])
    gp.set_training_data(np.linspace(0.0, 4.0, 5), 0.3 + 0.01 * np.arange(5))
    assert bio(False).substitute_from(gp_from(gp, device=CPU)).n_p == 1
    with pytest.raises(RuntimeError, match="set_training_data"):
        bio(False).substitute_from(gp_from(GP(["S"], ["mu"]), device=CPU))
    with pytest.raises(TypeError, match="cannot compose"):
        bio(False).substitute_from(GP(["S"], ["mu"]))
    with pytest.raises(TypeError, match="cannot compose"):
        bio(False) + object()


def port_hybrid_nmpc(horizon=15, options=None, device=CPU, dtype=F64, ann=None):
    """The port's twin of golden_configs.build_hybrid_ann (the golden's fixed
    2-8-1 tanh network for E)."""
    ann = ann if ann is not None else ann_from(_fixed_ann(), device=CPU)
    nmpc = NMPC(cstr_schaffner_and_zeitz() + ann)
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P[:5])
    opts = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-9, "max_iter": 80}
    return nmpc.setup(options={**opts, **(options or {})}, device=device, dtype=dtype)


def test_golden_hybrid_ann_replay():
    """tests/golden/hybrid_ann.npz through the port's optimize (general
    path, float64): max|u - u_gold| < 1e-4 at every step."""
    data = np.load(GOLDEN)
    nmpc = port_hybrid_nmpc()
    devs = []
    for k in range(data["U_gold"].shape[0]):
        u = nmpc.optimize(data["X_meas"][k])
        assert nmpc.stats["converged"]
        devs.append(float(np.abs(u - data["U_gold"][k]).max()))
    assert len(devs) >= 20 and max(devs) < 1e-4, devs


def test_model_from_carries_a_hybrid_model():
    jm = jax_cstr()
    ja = _fixed_ann()
    tm = model_from(jm, learned=ja)
    assert tm.n_p == 5 and "E" not in tm.parameters
    jax_substitute(jm, ja)
    assert tm.parameters == jm.parameters
    with pytest.raises(ValueError, match="learned="):
        model_from(jm)
    jm.setup(dt=0.1, integration_method="rk4")
    jm._dtype = jnp.float64
    tm.setup(dt=0.1, device=CPU, dtype=F64)
    ref = np.asarray(jm.simulate(x0=[0.2, 0.1], u=[[0.3]], p=CSTR_P[:5], steps=3,
                                 store=False)["x"])
    out = tm.simulate(x0=[0.2, 0.1], u=[[0.3]], p=CSTR_P[:5], steps=3, store=False)
    np.testing.assert_allclose(out["x"], ref, rtol=0, atol=1e-12)


# -- the whole-solve kernel's traced route ------------------------------------------

def _need_cxx():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")


@pytest.fixture(scope="module")
def kernel_nmpc():
    return port_hybrid_nmpc(horizon=8, options={**KERNEL_OPTS, "pallas_full": True})


def test_whole_solve_takes_the_hybrid(kernel_nmpc):
    """The gate takes the hybrid model through the trace, with no warning;
    the emitted text holds the network (tanh) and its weights are numbers
    in prm."""
    f, d, b, o = (kernel_nmpc._funcs, kernel_nmpc._dims, kernel_nmpc._bounds,
                  kernel_nmpc._ip_opts)
    problem, why = W.whole_ip_gate(f, d, b, o, True)
    assert problem is not None and why is None
    assert "codegen_fx.py" in problem.text and "hm::m_tanh" in problem.text
    weights = np.concatenate([np.ravel(p[k].detach().numpy())
                              for p in ann_from(_fixed_ann(), device=CPU)._params
                              for k in ("W", "b")])
    assert np.isin(weights, np.asarray(problem.prm)).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        kernel_nmpc.solve_batch_fn()
    # a float32 controller that already ran (its weights cast once and kept)
    # still traces the network's own float64 numbers, so the problem's
    # float64 instance solves the float64 problem
    c32 = port_hybrid_nmpc(horizon=8, options=KERNEL_OPTS, dtype=torch.float32)
    c32.optimize_batch(_x0s(2, 0))
    p32, _ = W.whole_ip_gate(c32._funcs, c32._dims, c32._bounds, c32._ip_opts, True)
    assert p32.text == problem.text and np.isin(weights, np.asarray(p32.prm)).all()


def test_emitted_hybrid_derivatives_match_torch_func(kernel_nmpc):
    """F and [A | B] of the emitted hybrid step (the network inside RK4's
    four stages) against torch.func, float64, 1e-12."""
    _need_cxx()
    f, d, b = kernel_nmpc._funcs, kernel_nmpc._dims, kernel_nmpc._bounds
    rng = np.random.default_rng(3)
    R = 6
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


def _x0s(B, seed):
    return np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(seed).standard_normal((B, 2))


def test_host_kernel_matches_plain(kernel_nmpc):
    """The kernel's own per-scenario code (host build) against its plain
    version on the hybrid: equal iterations, U and X to 1e-12."""
    _need_cxx()
    n = kernel_nmpc
    args = n.prepare_batch(_x0s(4, 1))
    k = W.solve_ocp_full_host(n._funcs, n._dims, n._bounds, *args, n._ip_opts)
    r = W.solve_ocp_full_reference(n._funcs, n._dims, n._bounds, *args, n._ip_opts)
    assert bool(r.converged.all()) and torch.equal(k.iterations, r.iterations)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-12)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-12)


def test_plain_whole_solve_matches_jax_general_path(kernel_nmpc):
    """The port's pallas_full route on CPU tensors (the kernel's plain
    version) against the JAX general path under the same pure Newton
    options, from the same prepared inputs: equal iterations, U to 1e-10."""
    ja = _fixed_ann()
    jm = jax_cstr()
    jax_substitute(jm, ja)
    jn = JaxNMPC(jm)
    jn.horizon = 8
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
    ts = kernel_nmpc.solve_batch_fn()(*to_torch(j_args, device=CPU, dtype=F64))
    assert bool(ts.converged.all())
    np.testing.assert_array_equal(ts.iterations.numpy(), np.asarray(js.iterations))
    np.testing.assert_allclose(ts.U.numpy(), np.asarray(js.U), rtol=0, atol=1e-10)
