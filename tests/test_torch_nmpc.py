"""PyTorch port: the NMPC entry points against the JAX package and the golden
closed-loop fixture (CPU, f64)."""
import os

import numpy as np
import pytest
import torch

from golden_configs import CSTR_P, CSTR_REF, build_cstr_tracking
import inspect

from hilo_mpc_tpu_torch import LMPC, LQR, NMPC, Model
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.utils.interop import to_numpy

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cstr_tracking.npz")


def port_cstr_tracking(options=None, horizon=20, **setup_kw):
    """The port's twin of golden_configs.build_cstr_tracking."""
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = horizon
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P)
    opts = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-9, "max_iter": 80}
    nmpc.setup(options={**opts, **(options or {})},
               **{"device": CPU, "dtype": F64, **setup_kw})
    return nmpc


@pytest.mark.parametrize("guess", ["auto", "constant"])
def test_prepare_batch_matches_jax(guess):
    jn, _ = build_cstr_tracking()
    jn._guess_mode = guess
    tn = port_cstr_tracking({"initial_guess": guess})
    rng = np.random.default_rng(3)
    x0s = np.array([0.2, 0.1]) + 0.05 * rng.standard_normal((8, 2))
    j = jn.prepare_batch(x0s)
    t = to_numpy(tn.prepare_batch(x0s))
    for a, b in zip(t, j):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12)


def test_golden_replay():
    """tests/golden/cstr_tracking.npz through the port's optimize: the
    BASELINE acceptance max|u - u_gold| < 1e-4 over every closed-loop step
    (tests/test_golden_parity.py:40-54)."""
    data = np.load(GOLDEN)
    nmpc = port_cstr_tracking()
    X_meas, U_gold = data["X_meas"], data["U_gold"]
    assert U_gold.shape[0] >= 20
    devs = []
    for k in range(U_gold.shape[0]):
        u = nmpc.optimize(X_meas[k])
        assert nmpc.stats["converged"] and nmpc.stats["status"] == 0
        devs.append(np.abs(u - U_gold[k]).max())
    assert max(devs) < 1e-4, devs
    assert nmpc.solution["u"].shape == (1, U_gold.shape[0])
    assert nmpc.solution["stats"].shape == (4, U_gold.shape[0])


def test_optimize_batch_and_multistart():
    nmpc = port_cstr_tracking({"tol": 1e-8})
    x0s = np.array([[0.2, 0.1], [0.25, 0.12], [0.15, 0.05]])
    u0, sol = nmpc.optimize_batch(x0s)
    assert u0.shape == (3, 1) and bool(sol.converged.all())
    for i, x0 in enumerate(x0s):
        single = port_cstr_tracking({"tol": 1e-8})
        u_multi = single.optimize(x0, runs=3, seed=1)
        np.testing.assert_allclose(u_multi, u0[i], atol=1e-6)


def test_runtime_reference():
    """A trajectory-tracking term takes its reference per solve through theta."""
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 10
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], trajectory_tracking=True)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters(CSTR_P)
    nmpc.setup(options={"dt": 0.1, "tol": 1e-8}, device=CPU, dtype=F64)
    with pytest.raises(ValueError, match="runtime reference"):
        nmpc.optimize([0.2, 0.1])
    u_dict = nmpc.optimize([0.2, 0.1], ref_sc={"x_1": 0.3, "x_2": 0.18055})
    fixed = port_cstr_tracking({"tol": 1e-8}, horizon=10)
    np.testing.assert_allclose(u_dict, fixed.optimize([0.2, 0.1]), atol=1e-6)


def test_unknown_option_raises():
    with pytest.raises(ValueError, match="unknown options"):
        port_cstr_tracking({"max_iters": 5})


def test_entry_point_order_is_enforced():
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    with pytest.raises(ValueError, match="horizon"):
        nmpc.setup(options={"dt": 0.1}, device=CPU)
    nmpc.horizon = 5
    with pytest.raises(RuntimeError):
        nmpc.optimize([0.2, 0.1])
    with pytest.raises(RuntimeError):
        nmpc.prepare_batch([[0.2, 0.1]])


# features of later slices, each with the JAX package's refusal it now
# raises (discrete inputs: no levels and no finite input bounds, so no
# lattice; ported since, they no longer raise NotImplementedError)
OUT_OF_SLICE = {
    "discrete_inputs": (lambda n: n.set_discrete_inputs("u").setup(
        options={"dt": 0.1}, device=CPU), ValueError, "finite"),
}


@pytest.mark.parametrize("feature", sorted(OUT_OF_SLICE))
def test_out_of_slice_features_raise(feature):
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 5
    call, error, match = OUT_OF_SLICE[feature]
    with pytest.raises(error, match=match):
        call(nmpc)


def _control_horizon(n):
    n.control_horizon = 3


# the augmented formulations (Δu, path following, minimum time), which
# raised before they were ported: each now sets up and solves, with the
# solver dimensions of the JAX rule (hilo_mpc_tpu/control/nmpc.py:384-405)
PORTED_FEATURES = {
    "inputs_change": (lambda n: n.quad_stage_cost.add_inputs_change(weights=1.0), (3, 1)),
    "path_following": (lambda n: n.quad_stage_cost.add_states(path_following=True),
                       (3, 2)),
    "du_bounds": (lambda n: n.set_box_constraints(du_lb=[-0.1], du_ub=[0.1]), (3, 1)),
    "control_horizon": (_control_horizon, (3, 1)),
    "path_variable": (lambda n: n.create_path_variable(), (3, 2)),
    "min_time": (lambda n: n.minimize_final_time(dt_min=0.05, dt_max=0.2), (3, 2)),
}


@pytest.mark.parametrize("feature", sorted(PORTED_FEATURES))
def test_ported_features_set_up_and_solve(feature):
    configure, dims = PORTED_FEATURES[feature]
    nmpc = NMPC(cstr_schaffner_and_zeitz())
    nmpc.horizon = 5
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_REF)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(CSTR_P)
    configure(nmpc)
    nmpc.setup(options={"dt": 0.1}, device=CPU, dtype=torch.float64)
    assert (nmpc._dims.nx, nmpc._dims.nu) == dims
    u = nmpc.optimize([0.2, 0.1])
    assert u.shape == (1,) and np.isfinite(u).all()
    assert nmpc.return_prediction()["u"].shape == (5, 1)


def _double_integrator():
    return Model(discrete=True).set_state_space(A=[[1.0, 0.1], [0.0, 1.0]],
                                                B=[[0.005], [0.1]])


def _entry(kind):
    """An object of each entry point, ready for setup() with no device."""
    if kind == "Model":
        return cstr_schaffner_and_zeitz()
    if kind == "NMPC":
        nmpc = NMPC(cstr_schaffner_and_zeitz())
        nmpc.horizon = 5
        nmpc.set_parameters(CSTR_P)
        return nmpc
    ctrl = (LMPC if kind == "LMPC" else LQR)(_double_integrator())
    ctrl.horizon = 5
    return ctrl


SETUP_KW = {"Model": dict(dt=0.1), "NMPC": dict(options={"dt": 0.1}),
            "LMPC": dict(options={"dt": 0.1}), "LQR": dict(dt=0.1)}
ENTRY_POINTS = sorted(SETUP_KW)


@pytest.mark.parametrize("kind", ENTRY_POINTS)
def test_setup_defaults_to_cuda(kind, monkeypatch):
    """setup() without a device targets the card."""
    obj = _entry(kind)
    assert inspect.signature(obj.setup).parameters["device"].default == "cuda"
    if kind == "Model":
        # with a card reported, the model is built for it (setup allocates
        # nothing, so this runs here)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert obj.setup(**SETUP_KW[kind]).device == torch.device("cuda")


@pytest.mark.parametrize("kind", ENTRY_POINTS)
def test_setup_without_a_card_raises(kind):
    """With no card, setup() with no device is an error, never a silent run
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: setup() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry(kind).setup(**SETUP_KW[kind])
