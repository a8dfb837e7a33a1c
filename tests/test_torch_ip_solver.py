"""PyTorch port: batch-first interior point against the JAX solver (CPU, f64).

The same inputs, made with numpy (or by the JAX package's own prepare_batch),
go through ``hilo_mpc_tpu.ops.ip_solver`` and ``hilo_mpc_tpu_torch.ops.ip_solver``.
Tolerances: U and X to 1e-6, equal convergence flags and status codes, and
iteration counts within one (a last-digit difference can move a barrier
update or a line-search decision by one iteration).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hilo_mpc_tpu.ops.ip_solver as jip
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC as TorchNMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz as torch_cstr
from hilo_mpc_tpu_torch.ops import ip_solver as tip
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def assert_same_solution(tsol, jsol, tol=1e-6):
    t = to_numpy(tsol)
    np.testing.assert_allclose(t.U, np.asarray(jsol.U), rtol=0, atol=tol)
    np.testing.assert_allclose(t.X, np.asarray(jsol.X), rtol=0, atol=tol)
    np.testing.assert_array_equal(t.converged, np.asarray(jsol.converged))
    np.testing.assert_array_equal(t.status, np.asarray(jsol.status))
    assert np.abs(t.iterations - np.asarray(jsol.iterations)).max() <= 1


# -- double integrator (tests/test_pallas_kernels.py:122-158) -----------------

DT = 0.2
AM = np.array([[1.0, DT], [0.0, 1.0]])
BM = np.array([[0.5 * DT ** 2], [DT]])
QM = np.diag([1.0, 0.1])
RM = np.array([[0.05]])


def _di_problem(bounded, pinned=False):
    NX, NU, N = 2, 1, 6
    jfuncs = jip.OCPFunctions(
        dyn=lambda x, u, th: jnp.asarray(AM) @ x + jnp.asarray(BM) @ u,
        stage_cost=lambda x, u, th: x @ jnp.asarray(QM) @ x + u @ jnp.asarray(RM) @ u,
        term_cost=lambda x, th: 5.0 * (x @ jnp.asarray(QM) @ x))
    Am, Bm, Qm, Rm = (torch.as_tensor(a) for a in (AM, BM, QM, RM))
    tfuncs = tip.OCPFunctions(
        dyn=lambda x, u, th: x @ Am.T + u @ Bm.T,
        stage_cost=lambda x, u, th: ((x @ Qm) * x).sum(-1) + ((u @ Rm) * u).sum(-1),
        term_cost=lambda x, th: 5.0 * ((x @ Qm) * x).sum(-1))
    lim = 0.7 if bounded else np.inf
    bnd = (np.full((N + 1, NX), -np.inf), np.full((N + 1, NX), np.inf),
           np.full((N, NU), -lim), np.full((N, NU), lim))
    if pinned:
        # lbu == ubu: controls 2 and 3 are fixed values, not barrier rows
        bnd[2][2:4] = bnd[3][2:4] = 0.1
    x0s = np.array([[1.5, 0.0], [1.0, 0.3], [-1.0, 0.2], [0.5, -0.5]])
    args = (np.zeros((4, N + 1, 2)), x0s, np.tile(x0s[:, None, :], (1, N + 1, 1)),
            np.zeros((4, N, NU)))
    return (jfuncs, tfuncs, jip.OCPDims(nx=NX, nu=NU, N=N),
            tip.OCPDims(nx=NX, nu=NU, N=N), bnd, args)


@pytest.mark.parametrize("bounded,pinned", [(True, False), (False, False),
                                            (True, True)])
def test_double_integrator_matches_jax(bounded, pinned):
    jfuncs, tfuncs, jdims, tdims, bnd, args = _di_problem(bounded, pinned)
    # jitted: one compile of the batched solve instead of an eager dispatch
    jsol = jax.jit(lambda b, *a: jip.solve_ocp_batched(
        jfuncs, jdims, b, *a, jip.IPOptions(max_iter=40, tol=1e-6)))(
        jip.OCPBounds(*map(jnp.asarray, bnd)), *map(jnp.asarray, args))
    tbnd = (tip.OCPBounds(*to_torch(bnd, device=CPU)) if bounded
            else tip.default_bounds(tdims, dtype=F64, device=CPU))
    tsol = tip.solve_ocp(tfuncs, tdims, tbnd, *to_torch(args, device=CPU),
                         tip.IPOptions(max_iter=40, tol=1e-6))
    assert bool(tsol.converged.all())
    if pinned:
        np.testing.assert_allclose(tsol.U[:, 2:4].numpy(), 0.1, atol=1e-5)
    assert_same_solution(tsol, jsol)
    np.testing.assert_allclose(tsol.objective.numpy(), np.asarray(jsol.objective),
                               rtol=1e-8, atol=1e-10)


# -- the CSTR NMPC problem functions ------------------------------------------

FLAGSHIP = {"tol": 1e-4, "max_iter": 25, "convexify": False, "n_linesearch": 1,
            "mu_init": 1e-2, "mehrotra": False}
DEFAULTS = {"tol": 1e-9, "max_iter": 80}   # Mehrotra, convexify, 10-candidate search
# With the state bound active and mu at its floor tol/10, the condensed KKT
# system amplifies f64 roundoff to ~1e-9 in U: below a 1e-8 tolerance XLA and
# PyTorch then stop at different iterations (ROADMAP.md §C), so this case
# stops where both still agree to roundoff.
STATE_BOUNDS = {"tol": 1e-8, "max_iter": 80}


def _cstr(cls, model, options, state_bounds=False, **kw):
    nmpc = cls(model)
    nmpc.horizon = 20
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-0.5], u_ub=[0.5])
    if state_bounds:
        # x_1 <= 0.28 is active at the setpoint (x_1 = 0.3); scaled solver
        # coordinates exercise the scaling of states, inputs and bounds
        nmpc.set_box_constraints(x_lb=[0.0, -1.0], x_ub=[0.28, 1.0])
        nmpc.set_scaling(x_scaling=[0.5, 0.2], u_scaling=2.0)
    nmpc.set_parameters([1.0] * 6)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", **options}, **kw)
    return nmpc


@pytest.fixture(scope="module", params=["flagship", "defaults", "state_bounds"])
def cstr_pair(request):
    opts = {"flagship": FLAGSHIP, "defaults": DEFAULTS,
            "state_bounds": STATE_BOUNDS}[request.param]
    sb = request.param == "state_bounds"
    jn = _cstr(JaxNMPC, jax_cstr(), opts, state_bounds=sb)
    # the TPU layout knobs of the flagship set are accepted and have no effect
    extra = ({"riccati_unroll": 20, "pallas_riccati": True}
             if request.param == "flagship" else {})
    tn = _cstr(TorchNMPC, torch_cstr(), {**opts, **extra}, state_bounds=sb,
               device=CPU, dtype=F64)
    rng = np.random.default_rng(5)
    # the second scenario starts far enough out that the input bound is
    # active; every start keeps the state bound feasible
    x0s = np.array([[0.2, 0.1], [0.05, 0.0], [0.25, 0.15],
                    [0.15, 0.12] if sb else [0.3, 0.3]]) \
        + 0.01 * rng.standard_normal((4, 2))
    args = jn.prepare_batch(x0s)
    jsol = jn.solve_batch_fn()(*args)
    return jn, tn, args, jsol


def test_cstr_cold_matches_jax(cstr_pair):
    jn, tn, args, jsol = cstr_pair
    tsol = tn.solve_batch_fn()(*to_torch(args, device=CPU))
    assert bool(tsol.converged.all())
    u_max = 0.5 / np.asarray(tn._u_scaling)        # the u bound in solver units
    assert np.abs(to_numpy(tsol.U)).max() > u_max - 1e-4   # a bound is active
    assert_same_solution(tsol, jsol)


def test_cstr_warm_matches_jax(cstr_pair):
    """Warm start (shifted previous solution, barrier min(mu_init, 1e-3))."""
    jn, tn, args, jsol = cstr_pair
    X, U = np.asarray(jsol.X), np.asarray(jsol.U)
    Xw = np.concatenate([X[:, 1:], X[:, -1:]], axis=1)
    Xw[:, 0] = np.asarray(args[1])
    Uw = np.concatenate([U[:, 1:], U[:, -1:]], axis=1)
    warm_args = (np.asarray(args[0]), np.asarray(args[1]), Xw, Uw)
    jw = jn.solve_batch_fn(warm=True)(*map(jnp.asarray, warm_args))
    tw = tn.solve_batch_fn(warm=True)(*to_torch(warm_args, device=CPU))
    assert_same_solution(tw, jw)


def test_ip_options_mirror_jax():
    """Same option fields and defaults as the JAX IPOptions."""
    assert dataclasses.asdict(tip.IPOptions()) == dataclasses.asdict(jip.IPOptions())


def test_solve_ocp_ignores_pallas_full():
    """As in the JAX package, solve_ocp does not read pallas_full: only
    NMPC.solve_batch_fn routes to the whole-solve kernel."""
    _, tfuncs, _, tdims, bnd, args = _di_problem(True)
    bounds = tip.OCPBounds(*to_torch(bnd, device=CPU))
    sols = [tip.solve_ocp(tfuncs, tdims, bounds, *to_torch(args, device=CPU),
                          tip.IPOptions(pallas_full=flag)) for flag in (False, True)]
    for a, b in zip(*sols):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", [tip.default_bounds, to_torch])
def test_helpers_default_to_cuda(fn):
    """default_bounds and to_torch target the card unless the caller passes
    device="cpu", like every entry point of the port."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False)])
def test_solve_ocp_restores_the_tf32_settings(flags):
    """solve_ocp turns TF32 off for its own products only: both flags hold
    the caller's values afterwards (the reference scopes "highest" precision
    to the solve, hilo_mpc_tpu/ops/ip_solver.py:250-255)."""
    _, tfuncs, _, tdims, bnd, args = _di_problem(True)
    bounds = tip.OCPBounds(*to_torch(bnd, device=CPU))
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    try:
        sol = tip.solve_ocp(tfuncs, tdims, bounds, *to_torch(args, device=CPU))
        assert bool(sol.converged.all())
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_solve_ocp_restores_tf32_when_it_raises():
    _, tfuncs, _, tdims, bnd, args = _di_problem(True)
    bounds = tip.OCPBounds(*to_torch(bnd, device=CPU))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        def broken(reg):
            raise RuntimeError("no LQ step")
        with pytest.raises(RuntimeError, match="no LQ step"):
            tip.solve_ocp(tfuncs, tdims, bounds, *to_torch(args, device=CPU),
                          lq_solver=broken)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_solve_ocp_default_lq_step_is_make_lq_solver():
    from hilo_mpc_tpu_torch.ops.riccati import make_lq_solver
    assert inspect.signature(tip.solve_ocp).parameters["lq_solver"].default \
        is make_lq_solver
