"""PyTorch port: stochastic MPC without chance rows through the whole-solve
kernel (CPU).

The surrogate (control/smpc.py: [mu; vec(P)] with the GP's mean and
variance) is traced by ops/codegen_fx.py: the GP variance's right-sided
triangular solve is emitted as a substitution, one statement per element,
and the mean step's Jacobian, a ``jvp`` inside ``dyn``, is flattened by
``make_fx`` into plain ops that the kernel's own dual pass differentiates.
tests/test_torch_smpc_solve.py's controller (N=4, a 12-point GP on x1,
|u| <= 2, no chance rows), float64:

- the host build against the plain version: equal iterations, U/X to 1e-9;
- the plain version against JAX's general path (vmapped ``solve_ocp``,
  the GP carried across) at the same pure-Newton options: equal
  iterations, U/X to 1e-8;
- in float32 the gate takes the surrogate of a float32 GP and declines
  that of a float64 GP, which predicts in float64 (a cast down to float32
  in the trace that a float32 build cannot compute);
- the emitted text is the same before and after ``prepare_batch`` ran the
  surrogate (the disturbance matrix's device copy that call keeps is not
  read by the trace), so one build serves a controller whatever ran first.
tests/test_torch_smpc_solve.py holds the gate (no warning, the plain
version's bits, no Riccati launch); chip_smoke.py builds golden
smpc_chance's 25-point surrogate (phase 1, whole_ip_smpc, and phase 16(a)).
"""
import shutil

import jax
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.ops.ip_solver as jip
from hilo_mpc_tpu import SMPC as JaxSMPC
from hilo_mpc_tpu_torch import SMPC
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.utils.interop import gp_from, to_numpy, to_torch
from test_torch_smpc import gps, models

torch.set_num_threads(1)
CPU, F64 = "cpu", torch.float64
OPTS = {"dt": 0.1, "convexify": False, "n_linesearch": 1, "mehrotra": False,
        "tol": 1e-8, "max_iter": 40}
X0S = np.concatenate([[[0.3, 0.0], [0.1, -0.1], [0.5, 0.1]],
                      np.tile([1e-4, 0.0, 0.0, 1e-4], (3, 1))], 1)


def smpc(cls, model, gp, **setup_kw):
    s = cls(model, gps={"x2": gp}, dt=0.1)
    s.horizon = 4
    s.quad_stage_cost.add_states(names=["x1", "x2"], weights=[5.0, 1.0], ref=[0.85, 0.0])
    s.quad_stage_cost.add_inputs(weights=0.05)
    s.set_box_constraints(u_lb=[-2.0], u_ub=[2.0])
    s.setup(options=OPTS, **setup_kw)
    return s


@pytest.fixture(scope="module")
def twins():
    jm, tm = models()
    jg, tg = gps()
    return smpc(JaxSMPC, jm, jg), smpc(SMPC, tm, tg, device=CPU, dtype=F64)


def test_host_kernel_matches_plain_f64(twins):
    """The emitted surrogate (its 12 x 12 variance solve, the mean step's
    flattened Jacobian) in the kernel's per-scenario solve."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler on PATH")
    _, t = twins
    args = t.prepare_batch(X0S)
    problem = W.whole_ip_problem(t._funcs, t._dims, t._bounds, args[0].shape[2],
                                 t._ip_opts)
    assert "codegen_fx.py" in problem.text
    k = W.solve_ocp_full_host(t._funcs, t._dims, t._bounds, *args, t._ip_opts)
    r = W.solve_ocp_full_reference(t._funcs, t._dims, t._bounds, *args, t._ip_opts)
    assert bool(r.converged.all())
    assert torch.equal(k.iterations, r.iterations) and torch.equal(k.status, r.status)
    torch.testing.assert_close(k.U, r.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(k.X, r.X, rtol=0, atol=1e-9)


def test_plain_matches_jax_general_path(twins):
    j, t = twins
    args = j.prepare_batch(X0S)
    jsol = jax.jit(jax.vmap(lambda th, x0, Xi, Ui: jip.solve_ocp(
        j._funcs, j._dims, j._bounds, th, x0, Xi, Ui, options=j._ip_opts,
        fix_x0=True)))(*args)
    targs = to_torch(args, device=CPU)
    sol = to_numpy(W.solve_ocp_full_reference(t._funcs, t._dims, t._bounds, *targs,
                                              t._ip_opts))
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_array_equal(sol.converged, np.asarray(jsol.converged))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol.X, np.asarray(jsol.X), rtol=0, atol=1e-8)


def test_gate_takes_the_float32_surrogate_of_a_float32_gp():
    """A float32 controller: with a float32 GP the surrogate traces in
    float32 and the gate takes it; a float64 GP predicts in float64
    (ml/gp/gp.py:predict_fn), so the trace casts the GP's answer down to
    float32, which a float32 build cannot compute, and the gate declines it
    naming the cast."""
    for gp_dtype, taken in ((torch.float32, True), (torch.float64, False)):
        _, tm = models()
        jg, _ = gps()
        t = smpc(SMPC, tm, gp_from(jg, device=CPU, dtype=gp_dtype), device=CPU,
                 dtype=torch.float32)
        problem, why = W.whole_ip_gate(t._funcs, t._dims, t._bounds, t._ip_opts, True)
        assert (problem is not None) is taken, why
        if not taken:
            assert "_to_copy" in why and "torch.float32" in why, why


def test_emitted_text_does_not_depend_on_earlier_calls():
    _, tm = models()
    jg, _ = gps()
    t = smpc(SMPC, tm, gp_from(jg, device=CPU, dtype=torch.float32), device=CPU,
             dtype=torch.float32)
    before, _ = W.whole_ip_gate(t._funcs, t._dims, t._bounds, t._ip_opts, True)
    t.prepare_batch(X0S)
    after, _ = W.whole_ip_gate(t._funcs, t._dims, t._bounds, t._ip_opts, True)
    assert after.text == before.text
    np.testing.assert_array_equal(after.prm, before.prm)
