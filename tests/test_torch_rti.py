"""PyTorch port: real-time iteration (prepare / feedback) and its batched
form against the JAX package (CPU, float64).

- the first-stage gain K0 against JAX's to 1e-10 (standard, Δu-augmented,
  scaled);
- 15-step RTI loops (full-solve prepare, single Gauss-Newton iteration,
  Δu) whose applied moves match JAX's to 1e-9, with equal iterations;
- batched RTI, its Δu form and a warm fleet loop against JAX;
- the gain against finite-difference NLP sensitivities
  (tests/test_rti.py:211), the feedback's linearity and clipping, and the
  validation errors of tests/test_rti.py:335-410.
One float64 plant steps every loop of both packages, so only the
controllers differ.
"""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
P_CSTR = [1.0] * 6
X_EQ = [0.3, 0.18055]


def _nmpc(jx, N=8, du=False, scaled=False, bounds=None, device=CPU, **opts):
    nmpc = (JaxNMPC if jx else NMPC)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=X_EQ)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    if du:
        nmpc.quad_stage_cost.add_inputs_change(weights=0.5)
    nmpc.set_box_constraints(**(bounds or dict(u_lb=[-5.0], u_ub=[5.0])))
    if scaled:
        nmpc.set_scaling(x_scaling=[0.5, 0.2], u_scaling=2.0)
    nmpc.set_parameters(P_CSTR)
    nmpc.setup(options={"dt": 0.1, **opts},
               **({} if jx else dict(device=device, dtype=F64)))
    return nmpc


def _plant():
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    return plant


def _step(plant, x, u):
    return plant.simulate(x0=np.asarray(x)[None], u=np.asarray(u)[None, None], p=P_CSTR,
                          steps=1)["x"][0, -1]


GAIN_CASES = {"standard": {}, "du": dict(du=True), "scaled": dict(scaled=True)}


@pytest.mark.parametrize("case", sorted(GAIN_CASES))
def test_gain_matches_jax(case):
    kw = GAIN_CASES[case]
    jn, tn = _nmpc(True, **kw), _nmpc(False, **kw)
    x = np.array([0.25, 0.12])
    sj, st = jn.rti_prepare(x_pred=x), tn.rti_prepare(x_pred=x)
    assert st["iterations"] == sj["iterations"] and st["mode"] == "rti"
    assert tn._rti["K0"].shape == jn._rti["K0"].shape
    np.testing.assert_allclose(tn._rti["K0"], jn._rti["K0"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn._rti["U"], jn._rti["U"], atol=1e-10)
    for k in ("x", "u", "t"):
        np.testing.assert_allclose(tn.last_prediction[k], jn.last_prediction[k],
                                   atol=1e-10)


def test_batched_gain_is_per_scenario():
    """rti_gain over a batch equals the gain of each scenario alone."""
    tn = _nmpc(False)
    x0s = np.array(X_EQ) + 0.05 * np.random.default_rng(0).standard_normal((4, 2))
    args = tn.prepare_batch(x0s)
    sol = tn.solve_batch_fn()(*args)
    K = tn.rti_gain(sol.X, sol.U, args[0])
    for b in range(4):
        Kb = tn.rti_gain(sol.X[b:b + 1], sol.U[b:b + 1], args[0][b:b + 1])
        np.testing.assert_allclose(K[b].numpy(), Kb[0].numpy(), atol=1e-14)


LOOP_CASES = {"full": {}, "gn1": dict(gn=1), "gn2": dict(gn=2), "du": dict(du=True),
              "du_gn1": dict(du=True, gn=1)}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_rti_loop_matches_jax(case):
    kw = dict(LOOP_CASES[case])
    gn = kw.pop("gn", None)
    plant = _plant()
    runs = []
    for jx in (True, False):
        nmpc = _nmpc(jx, **kw)
        nmpc.rti_gn_iterations = gn
        x = np.array([0.2, 0.1])
        nmpc.rti_prepare(x_pred=x)
        us, its = [], []
        for _ in range(15):
            u = nmpc.rti_feedback(x)
            us.append(u)
            its.append(nmpc.stats["iterations"])
            x = _step(plant, x, u)
            nmpc.rti_prepare()
        runs.append((np.array(us), its, x))
    (uj, ij, xj), (ut, it, xt) = runs
    assert it == ij
    if gn:
        assert set(it) == {gn}
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-9)
    assert np.linalg.norm(xt - X_EQ) < 2e-2


def test_gn_prepare_mode_and_iterations():
    tn = _nmpc(False)
    tn.rti_gn_iterations = 1
    st = tn.rti_prepare(x_pred=[0.2, 0.1])
    assert st["mode"] == "rti-gn" and st["iterations"] == 1
    opts = tn._rti_gn_options()
    assert (opts.max_iter, opts.early_exit, opts.mu_init, opts.record_iterates) == \
        (1, False, 1e-3, False)


def test_rti_tracks_like_full_solve():
    """tests/test_rti.py's closed-loop bar: RTI and full solves reach the
    equilibrium and stay within 2e-2 of each other; the feedback phase is
    solver-free."""
    plant = _plant()
    full, rti = _nmpc(False), _nmpc(False)
    x = xr = np.array([0.2, 0.1])
    rti.rti_prepare(x_pred=xr)
    xs_f, xs_r, fb = [x], [xr], []
    for _ in range(25):
        x = _step(plant, x, full.optimize(x))
        u = rti.rti_feedback(xr)
        fb.append(rti.stats["t_feedback"])
        xr = _step(plant, xr, u)
        rti.rti_prepare()
        xs_f.append(x)
        xs_r.append(xr)
    xs_f, xs_r = np.array(xs_f), np.array(xs_r)
    assert np.linalg.norm(xs_f[-1] - X_EQ) < 5e-3
    assert np.linalg.norm(xs_r[-1] - X_EQ) < 5e-3
    assert np.max(np.abs(xs_r - xs_f)) < 2e-2
    assert np.median(fb) < 0.05 and rti.stats["phase"] == "rti"


def test_feedback_is_linear_and_clipped():
    tn = _nmpc(False)
    x = np.array([0.25, 0.12])
    tn.rti_prepare(x_pred=x)
    K0, U0 = tn._rti["K0"].copy(), tn._rti["U"][0].copy()
    dx = np.array([1e-3, -2e-3])
    np.testing.assert_allclose(tn.rti_feedback(x + dx), U0 + K0 @ dx, atol=1e-12)
    tn.rti_prepare(x_pred=x)
    u = tn.rti_feedback(x + np.array([5.0, -5.0]))
    assert -5.0 - 1e-12 <= u[0] <= 5.0 + 1e-12


def test_du_feedback_respects_both_bound_sets():
    bounds = dict(u_lb=[-0.5], u_ub=[0.5], du_lb=[-0.1], du_ub=[0.1])
    us = []
    for jx in (True, False):
        n = _nmpc(jx, N=6, du=True, bounds=bounds)
        n.rti_prepare(x_pred=[0.25, 0.12])
        u_prev = n._u_old.copy()
        u = n.rti_feedback(np.array([0.25, 0.12]) + 5.0)
        assert abs(u[0] - u_prev[0]) <= 0.1 + 1e-10
        assert -0.5 - 1e-10 <= u[0] <= 0.5 + 1e-10
        # the clip is folded back into Δu for the pending propagation
        pend = n._rti_pending
        np.testing.assert_allclose(pend["xs0"][2] + pend["U"][0, 0], u[0], atol=1e-12)
        us.append(u)
    np.testing.assert_allclose(us[1], us[0], atol=1e-10)


def test_solution_series_records_rti_steps():
    tn = _nmpc(False)
    tn.rti_prepare(x_pred=[0.2, 0.1])
    tn.rti_feedback([0.2, 0.1])
    assert tn.solution.n_samples == 1 and tn._time == pytest.approx(0.1)
    assert np.asarray(tn.solution["stats"]).shape == (4, 1)
    with pytest.raises(RuntimeError, match="rti_prepare"):
        tn.rti_feedback([0.2, 0.1])


def test_gain_is_the_solution_sensitivity():
    """tests/test_rti.py:211: away from active constraints K0 is the
    Gauss-Newton ∂u0*/∂x0: the dominant entry to 1e-2 relative, the row to
    2e-2 against central differences of full solves."""
    opts = dict(N=10, tol=1e-9, max_iter=60)
    nmpc = _nmpc(False, **opts)
    x = np.array([0.27, 0.15])
    nmpc.rti_prepare(x_pred=x)
    K0 = nmpc._rti["K0"].copy()
    h = 1e-5
    fd = np.zeros((1, 2))
    for j in range(2):
        e = np.zeros(2)
        e[j] = h
        up = _nmpc(False, **opts).optimize(x + e)
        um = _nmpc(False, **opts).optimize(x - e)
        fd[:, j] = (up - um) / (2 * h)
    j_dom = int(np.argmax(np.abs(fd[0])))
    np.testing.assert_allclose(K0[0, j_dom], fd[0, j_dom], rtol=1e-2)
    np.testing.assert_allclose(K0, fd, atol=2e-2)


# -- batched RTI -----------------------------------------------------------------------

@pytest.mark.parametrize("du", [False, True])
def test_batched_rti_matches_jax(du):
    B = 6
    rng = np.random.default_rng(3)
    x_pred = np.array([0.25, 0.12]) + 0.02 * rng.standard_normal((B, 2))
    dx = 1e-3 * rng.standard_normal((B, 2))
    u_prev = 0.05 * rng.standard_normal((B, 1)) if du else None
    outs = []
    for jx in (True, False):
        n = _nmpc(jx, du=du)
        d = n.rti_prepare_batch(x_pred, u_prev=u_prev)
        outs.append((d, n.rti_feedback_batch(x_pred + dx)))
    (dj, uj), (dt, ut) = outs
    assert isinstance(ut, np.ndarray) and ut.shape == (B, 1)
    assert set(dt) == {"xs_pred", "U", "K0", "converged"}
    assert all(isinstance(v, np.ndarray) for v in dt.values())
    np.testing.assert_allclose(dt["K0"], dj["K0"], atol=1e-10)
    np.testing.assert_array_equal(dt["converged"], dj["converged"])
    np.testing.assert_allclose(ut, uj, atol=1e-9)


def test_batched_feedback_matches_scalar_rti():
    B = 4
    rng = np.random.default_rng(0)
    x_pred = np.array([0.25, 0.12]) + 0.02 * rng.standard_normal((B, 2))
    dx = 1e-3 * rng.standard_normal((B, 2))
    batched = _nmpc(False)
    batched.rti_prepare_batch(x_pred)
    U0 = batched.rti_feedback_batch(x_pred + dx)
    for i in range(B):
        scalar = _nmpc(False)
        scalar.rti_prepare(x_pred=x_pred[i])
        np.testing.assert_allclose(U0[i], scalar.rti_feedback(x_pred[i] + dx[i]),
                                   atol=1e-6)


@pytest.mark.parametrize("du", [False, True])
def test_warm_fleet_loop_matches_jax(du):
    """Eight steps of warm batched RTI on a fleet (each scenario shifted
    from its own solution; under Δu each carries its applied input)."""
    B = 5
    rng = np.random.default_rng(2)
    X0 = np.array([0.2, 0.1]) + 0.03 * rng.standard_normal((B, 2))
    bounds = (dict(u_lb=[-5.0], u_ub=[5.0], du_lb=[-0.04], du_ub=[0.04]) if du
              else None)
    plant = _plant()
    runs = []
    for jx in (True, False):
        n = _nmpc(jx, du=du, bounds=bounds)
        X = X0.copy()
        n.rti_prepare_batch(X)
        Us = []
        for _ in range(8):
            U = n.rti_feedback_batch(X)
            Us.append(U)
            X = plant.simulate(x0=X, u=U[:, None, :], p=P_CSTR, steps=1)["x"][:, -1, :]
            n.rti_prepare_batch(X, warm=True)
        runs.append((np.array(Us), X))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-9)
    if du:
        assert np.max(np.abs(np.diff(runs[1][0], axis=0))) <= 0.04 + 1e-9


@pytest.mark.parametrize("du", [False, True])
def test_batched_gn_prepare_is_the_scalar_gn_prepare(du):
    """rti_gn_iterations = 1 in the batched prepare (the JAX package's
    batched prepare ignores the option): each scenario's solution and gain
    equal a scalar controller's one-iteration prepare, cold and then warm
    from the shifted solution."""
    B = 3
    rng = np.random.default_rng(4)
    X = np.array([0.2, 0.1]) + 0.03 * rng.standard_normal((B, 2))
    u_prev = np.zeros((B, 1)) if du else None
    batched = _nmpc(False, du=du)
    batched.rti_gn_iterations = 1
    scalars = [_nmpc(False, du=du) for _ in range(B)]
    for s in scalars:
        s.rti_gn_iterations = 1
    for warm in (False, True):
        d = batched.rti_prepare_batch(X, warm=warm, u_prev=u_prev)
        for i, s in enumerate(scalars):
            st = s.rti_prepare(x_pred=X[i])
            assert st["mode"] == "rti-gn" and st["iterations"] == 1
            np.testing.assert_allclose(d["U"][i], s._rti["U"], rtol=0, atol=1e-10)
            np.testing.assert_allclose(d["K0"][i], s._rti["K0"], rtol=0, atol=1e-10)
        X = X + 0.01


def test_batched_feedback_clips_and_checks():
    n = _nmpc(False)
    x_pred = np.tile([0.25, 0.12], (3, 1))
    with pytest.raises(RuntimeError, match="rti_prepare_batch"):
        n.rti_feedback_batch(x_pred)
    n.rti_prepare_batch(x_pred)
    with pytest.raises(ValueError, match="scenarios"):
        n.rti_feedback_batch(np.zeros((2, 2)))
    U0 = n.rti_feedback_batch(x_pred + 10.0)
    assert np.all(U0 >= -5.0 - 1e-12) and np.all(U0 <= 5.0 + 1e-12)


# -- validation ------------------------------------------------------------------------

def _path_following(jx):
    n = (JaxNMPC if jx else NMPC)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    n.horizon = 5
    n.create_path_variable()
    n.quad_stage_cost.add_states(
        weights=[10.0, 10.0], path_following=True,
        path_fn=(lambda th: np.asarray(X_EQ)) if jx else
        (lambda th: torch.tensor(X_EQ, dtype=th.dtype).expand(th.shape + (2,))))
    n.quad_stage_cost.add_inputs(weights=0.1)
    n.set_parameters(P_CSTR)
    n.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
    return n


def _unset():
    n = NMPC(cstr_schaffner_and_zeitz())
    n.horizon = 5
    return n


VALIDATION = {
    "first_prepare_needs_x_pred": (lambda: _nmpc(False).rti_prepare(), RuntimeError,
                                   "x_pred"),
    "prepare_before_setup": (lambda: _unset().rti_prepare(x_pred=[0.2, 0.1]),
                             RuntimeError, "setup"),
    "batch_prepare_before_setup": (lambda: _unset().rti_prepare_batch([[0.2, 0.1]]),
                                   RuntimeError, "setup"),
    "wrong_x_pred_size": (lambda: _nmpc(False).rti_prepare(x_pred=[0.2, 0.1, 0.3]),
                          ValueError, "entries"),
    "feedback_before_prepare": (lambda: _nmpc(False).rti_feedback([0.2, 0.1]),
                                RuntimeError, "rti_prepare"),
    "path_following_batched": (
        lambda: _path_following(False).rti_prepare_batch(np.tile([0.2, 0.1], (3, 1))),
        NotImplementedError, "batched RTI"),
    "path_following": (lambda: _path_following(False).rti_prepare(x_pred=[0.2, 0.1]),
                       NotImplementedError, "RTI mode"),
    "u_prev_without_du": (lambda: _nmpc(False).rti_prepare_batch([[0.2, 0.1]],
                                                                 u_prev=[[0.0]]),
                          ValueError, "u_prev"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors(case):
    fn, exc, match = VALIDATION[case]
    with pytest.raises(exc, match=match):
        fn()


def test_wrong_feedback_size():
    n = _nmpc(False)
    n.rti_prepare(x_pred=[0.2, 0.1])
    with pytest.raises(ValueError, match="entries"):
        n.rti_feedback([0.2])


def test_path_following_rejected_by_jax_too():
    with pytest.raises(NotImplementedError, match="batched RTI"):
        _path_following(True).rti_prepare_batch(np.tile([0.2, 0.1], (3, 1)))


# -- on the card -----------------------------------------------------------------------

@pytest.mark.cuda
def test_batched_rti_on_the_card():
    """Each prepare launches the Riccati kernel; the card's moves against
    the CPU's in float64."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x_pred = np.array([0.25, 0.12]) + 0.02 * np.random.default_rng(5).standard_normal(
        (256, 2))
    outs = []
    for device in (CPU, "cuda"):
        n = _nmpc(False, device=device)
        riccati_lq_cuda.launches = 0
        n.rti_prepare_batch(x_pred)
        if device == "cuda":
            assert riccati_lq_cuda.launches > 0
        outs.append(n.rti_feedback_batch(x_pred + 1e-3))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-9)
