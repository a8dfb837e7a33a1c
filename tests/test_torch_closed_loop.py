"""PyTorch port: the batched closed loops (parallel/closed_loop.py),
SimpleControlLoop and the OCP against the JAX package (CPU, float64).

- The three fused loops (NMPC alone, with a Δu controller, with EKF, UKF and
  MHE feedback) with noise off against JAX's ``fused_closed_loop*_fn``:
  X, U and X_est to 1e-8 (the UKF's 1e6 sigma weights amplify summation
  order, ROADMAP §C) with equal per-step iteration counts and convergence.
- Noise on: one generator seed gives the same bits twice, another seed
  other values, and the JAX tests' bars hold (tests/test_parallel.py:
  final error < 3e-2 or 5e-2, converged share > 0.95, estimate error
  < 2e-2 or 3e-2); a noise std without a generator raises.
- SimpleControlLoop with NMPC + EKF, in RTI mode, with a PID and with a
  callable, against the JAX loop; its refusals; the OCP against JAX.
JAX's plants are set up in float64 here (its models default to float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import EKF as JaxEKF
from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import OCP as JaxOCP
from hilo_mpc_tpu import PID as JaxPID
from hilo_mpc_tpu import SimpleControlLoop as JaxLoop
from hilo_mpc_tpu.estimation import UnscentedKalmanFilter as JaxUKF
from hilo_mpc_tpu.estimation.mhe import MovingHorizonEstimator as JaxMHE
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.parallel import (fused_closed_loop_ekf_fn as jax_ekf_loop,
                                   fused_closed_loop_fn as jax_loop,
                                   fused_closed_loop_mhe_fn as jax_mhe_loop)
from hilo_mpc_tpu_torch import EKF, MHE, NMPC, OCP, UKF, Model, SimpleControlLoop
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.parallel import (ClosedLoopEKFResult, ClosedLoopMHEResult,
                                         ClosedLoopResult, fused_closed_loop_ekf_fn,
                                         fused_closed_loop_fn, fused_closed_loop_mhe_fn)
from hilo_mpc_tpu_torch.utils.interop import pid_from

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
P = [1.0] * 6
X_EQ = np.array([0.3, 0.18055])
KW = dict(device=CPU, dtype=F64)


def _nmpc(jx, N=8, du=False):
    n = (JaxNMPC if jx else NMPC)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    n.horizon = N
    n.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
    n.quad_stage_cost.add_inputs(weights=0.1)
    if du:
        n.quad_stage_cost.add_inputs_change(weights=0.5)
        n.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    n.set_parameters(P)
    n.setup(options={"dt": 0.1}, **({} if jx else KW))
    return n


def _plant(jx):
    p = jax_cstr() if jx else cstr_schaffner_and_zeitz()
    if jx:
        p._dtype = jnp.float64
        p.setup(dt=0.1, integration_method="rk4")
    else:
        p.setup(dt=0.1, integration_method="rk4", **KW)
    return p


def _filter(jx, kind):
    cls = {("ekf", True): JaxEKF, ("ekf", False): EKF,
           ("ukf", True): JaxUKF, ("ukf", False): UKF}[(kind, jx)]
    f = cls(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    f.Q = 1e-4 * np.eye(2)
    f.R = np.array([[1e-4]])
    f.set_initial_parameter_values(P)
    f.setup(dt=0.1, **({} if jx else KW))
    return f


def _mhe(jx):
    m = (JaxMHE if jx else MHE)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    m.horizon = 6
    m.Q, m.R = 1e-2 * np.eye(2), np.array([[1e-2]])
    m.P0 = 0.1 * np.eye(2)
    m.set_initial_parameter_values(P)
    m.setup(dt=0.1, options={"tol": 1e-6, "max_iter": 25}, **({} if jx else KW))
    return m


def _x0s(B, seed, spread=0.04):
    return np.array([0.2, 0.1]) + spread * np.random.default_rng(seed).standard_normal((B, 2))


def _mhe_windows(B, seed=2, Nw=6):
    """Measurement windows from a short true rollout (tests/test_parallel.py)."""
    rng = np.random.default_rng(seed)
    plant = _plant(False)
    x0 = _x0s(B, seed, 0.02)
    Ys, Us = np.zeros((B, Nw + 1, 1)), np.zeros((B, Nw + 1, 1))
    Xk = x0.copy()
    for k in range(Nw + 1):
        Ys[:, k, 0] = Xk[:, 1] + 0.002 * rng.standard_normal(B)
        if k < Nw:
            Xk = plant.simulate(x0=Xk, u=np.zeros((1, 1)), p=P, steps=1)["x"][:, -1, :]
    return Xk, Ys, Us, x0


# the loops, noise off; each case: (build(jx) -> run function, inputs)
def _loop_case(name):
    if name in ("nmpc", "nmpc_du"):
        def build(jx):
            return (jax_loop if jx else fused_closed_loop_fn)(
                _nmpc(jx, du=name == "nmpc_du"), _plant(jx), steps=12, plant_p=np.array(P))
        return build, (_x0s(5, 0),)
    if name in ("ekf", "ukf"):
        def build(jx):
            return (jax_ekf_loop if jx else fused_closed_loop_ekf_fn)(
                _nmpc(jx), _plant(jx), _filter(jx, name), steps=10, plant_p=np.array(P))
        x0 = _x0s(4, 1, 0.03)
        return build, (x0, x0 + 0.01, 0.05 * np.eye(2))

    def build(jx):
        return (jax_mhe_loop if jx else fused_closed_loop_mhe_fn)(
            _nmpc(jx), _plant(jx), _mhe(jx), steps=8, plant_p=np.array(P))
    return build, _mhe_windows(3)


LOOPS = ["ekf", "mhe", "nmpc", "nmpc_du", "ukf"]


@pytest.fixture(scope="module", params=LOOPS)
def loop_pair(request):
    build, inputs = _loop_case(request.param)
    jres = jax.tree.map(np.asarray, build(True)(*inputs))
    tres = build(False)(*inputs)
    return request.param, jres, tres


def test_fused_loop_matches_jax(loop_pair):
    name, jres, tres = loop_pair
    expect = {"nmpc": ClosedLoopResult, "nmpc_du": ClosedLoopResult,
              "ekf": ClosedLoopEKFResult, "ukf": ClosedLoopEKFResult,
              "mhe": ClosedLoopMHEResult}[name]
    assert type(tres) is expect
    assert tres._fields[:len(jres._fields)] == jres._fields
    for f in tres._fields[len(jres._fields):]:
        # the MHE result's iteration counts, which JAX's result lacks
        it = getattr(tres, f)
        assert it.shape == tres.converged.shape and not it.is_floating_point(), f
        assert int(it.min()) >= 1 and int(it.max()) <= 100, f
    for f in jres._fields:
        a, b = getattr(tres, f).numpy(), getattr(jres, f)
        assert a.shape == b.shape, f
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8, err_msg=f)


def test_fused_loop_reaches_the_setpoint(loop_pair):
    """tests/test_parallel.py's bars, noise off."""
    name, _, tres = loop_pair
    err = np.linalg.norm(tres.X[:, -1].numpy() - X_EQ, axis=1)
    assert err.max() < (3e-2 if name in ("nmpc", "nmpc_du", "ekf") else 5e-2)
    assert float(tres.converged.double().mean()) > 0.95
    if name == "mhe":
        assert float(tres.mhe_converged.double().mean()) > 0.9


# -- noise on ----------------------------------------------------------------------------

def _noisy(name):
    if name == "process":
        run = fused_closed_loop_fn(_nmpc(False), _plant(False), steps=10,
                                   plant_p=np.array(P),
                                   process_noise_std=np.array([0.01, 0.01]))
        return lambda g: run(np.tile([0.2, 0.1], (4, 1)), generator=g)
    if name in ("ekf", "ukf"):
        run = fused_closed_loop_ekf_fn(
            _nmpc(False), _plant(False), _filter(False, name),
            steps=20 if name == "ekf" else 15, plant_p=np.array(P),
            meas_noise_std=np.array([0.005 if name == "ekf" else 0.003]))
        x0 = _x0s(5 if name == "ekf" else 3, 1, 0.03)
        x_est0 = x0 + (0.02 * np.random.default_rng(7).standard_normal(x0.shape)
                       if name == "ekf" else 0.01)
        return lambda g: run(x0, x_est0, 0.05 * np.eye(2), generator=g)
    run = fused_closed_loop_mhe_fn(_nmpc(False), _plant(False), _mhe(False), steps=15,
                                   plant_p=np.array(P), meas_noise_std=np.array([0.002]))
    inputs = _mhe_windows(4)
    return lambda g: run(*inputs, generator=g)


@pytest.mark.parametrize("name", ["ekf", "mhe", "process", "ukf"])
def test_noise_is_seeded_and_meets_the_bars(name):
    run = _noisy(name)

    def gen(seed):
        return torch.Generator(CPU).manual_seed(seed)

    a, b, c = run(gen(0)), run(gen(0)), run(gen(1))
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.X, c.X)
    X = a.X.numpy()
    if name == "process":
        # noise tells identical starts apart
        assert np.std(X[:, -1, 0]) > 1e-4
        return
    err = np.linalg.norm(X[:, -1] - X_EQ, axis=1)
    assert err.max() < (3e-2 if name == "ekf" else 5e-2)
    assert float(a.converged.double().mean()) > 0.95
    if name in ("ekf", "mhe"):
        est_err = np.abs(a.X_est[:, -1].numpy() - X[:, -1]).max()
        assert est_err < (2e-2 if name == "ekf" else 3e-2)
    if name == "mhe":
        assert float(a.mhe_converged.double().mean()) > 0.9


@pytest.mark.parametrize("name", ["ekf", "mhe", "process"])
def test_noise_without_generator_raises(name):
    with pytest.raises(ValueError, match="generator"):
        _noisy(name)(None)


def test_loop_refusals():
    plant = _plant(False)
    unset = NMPC(cstr_schaffner_and_zeitz())
    unset.horizon = 5
    with pytest.raises(RuntimeError, match="nmpc must be set up"):
        fused_closed_loop_fn(unset, plant, steps=2)
    with pytest.raises(ValueError, match="plant_p"):
        fused_closed_loop_fn(_nmpc(False), plant, steps=2)
    with pytest.raises(RuntimeError, match="plant model must be set up"):
        fused_closed_loop_fn(_nmpc(False), cstr_schaffner_and_zeitz(), steps=2)
    m = MHE(cstr_schaffner_and_zeitz())
    m.horizon = 4
    m.set_initial_parameter_values(P)
    m.set_estimated_parameters(["E"], guess=[1.0])
    m.setup(dt=0.1, **KW)
    with pytest.raises(NotImplementedError, match="estimated parameters"):
        fused_closed_loop_mhe_fn(_nmpc(False), plant, m, steps=2, plant_p=np.array(P))


# -- SimpleControlLoop -------------------------------------------------------------------

def _ekf_observer(jx):
    f = (JaxEKF if jx else EKF)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    f.Q, f.R = 1e-6, 1e-5
    f.set_initial_parameter_values(P)
    f.setup(dt=0.1, **({} if jx else KW))
    f.set_initial_guess([0.2, 0.1], P0=np.eye(2) * 0.01)
    return f


@pytest.mark.parametrize("mode", ["nmpc_ekf", "rti", "rti_ekf", "rti_two_runs"])
def test_simple_control_loop_matches_jax(mode):
    sols = []
    for jx in (True, False):
        plant = _plant(jx)
        plant.set_initial_conditions([0.2, 0.1])
        plant.set_initial_parameter_values(P)
        observer = _ekf_observer(jx) if mode in ("nmpc_ekf", "rti_ekf") else None
        loop = (JaxLoop if jx else SimpleControlLoop)(plant, _nmpc(jx, N=10), observer)
        rti = mode != "nmpc_ekf"
        sol = loop.run(8 if mode == "rti_two_runs" else 15, rti=rti)
        if mode == "rti_two_runs":
            # the second run prepares again at the state it observes
            sol = loop.run(7, rti=True)
        sols.append(sol)
    for k in ("x", "u", "y", "t"):
        a, b = np.asarray(sols[1][k]), np.asarray(sols[0][k])
        assert a.shape == b.shape == ((15,) if k == "t" else (a.shape[0], 15))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=k)
    assert np.linalg.norm(np.asarray(sols[1]["x:f"]).ravel() - X_EQ) < 2e-2


def _first_order(jx):
    """x+ = x + 0.1 (-x + u), discrete (tests/test_control_loop.py)."""
    m = (JaxModel if jx else Model)(discrete=True)
    m.set_dynamical_states("x")
    m.set_inputs("u")
    if jx:
        m.set_dynamical_equations(lambda x, u: x + 0.1 * (-x + u[0]))
        m._dtype = jnp.float64
        m.setup(dt=0.1)
    else:
        m.set_dynamical_equations(lambda x, u: x + 0.1 * (-x + u))
        m.setup(dt=0.1, **KW)
    m.set_initial_conditions([0.0])
    return m


def test_loop_with_pid_matches_jax():
    """A PI controller through the loop (its optimize is call), removing
    the offset; pid_from carries the JAX PID across."""
    runs = []
    for jx in (True, False):
        pid = JaxPID(k_p=1.0, t_i=0.5)
        pid.setup(dt=0.1)
        pid.set_point = [2.0]
        loop = (JaxLoop if jx else SimpleControlLoop)(
            _first_order(jx), pid if jx else pid_from(pid))
        runs.append(np.asarray(loop.run(300)["x"]))
    np.testing.assert_allclose(runs[1], runs[0], atol=1e-12)
    np.testing.assert_allclose(runs[1][:, -1], [2.0], atol=1e-2)


def test_loop_with_callable_and_refusals():
    plant = _plant(False)
    plant.set_initial_conditions([0.2, 0.1])
    plant.set_initial_parameter_values(P)
    loop = SimpleControlLoop(plant, lambda x: np.array([0.1 * (0.3 - x[0])]))
    sol = loop.run(3)
    assert sol.n_samples == 3
    with pytest.raises(TypeError, match="rti"):
        loop.run(2, rti=True)
    # without bokeh its live plot is refused before a step is taken; the
    # matplotlib live figure and the loop's plot draw (Agg)
    with pytest.raises(ImportError, match="bokeh"):
        loop.run(2, live_plot="bokeh")
    assert sol.n_samples == 3
    import matplotlib
    matplotlib.use("Agg")
    assert loop.run(2, live_plot=True).n_samples == 5
    fig = loop.plot(kinds=["x", "u"])
    assert [ax.get_ylabel() for ax in fig.axes] == plant.dynamical_states + plant.inputs

    class Policy:
        """A trained policy (ported since): ``predict`` of the whole state."""
        def predict(self, X):
            assert np.asarray(X).shape == (1, 2)
            return np.full((1, 1), 0.25)
    assert SimpleControlLoop(plant, Policy()).run(1)["u"][0, -1] == 0.25
    with pytest.raises(RuntimeError, match="set up"):
        SimpleControlLoop(cstr_schaffner_and_zeitz(), lambda x: np.zeros(1))


def test_ocp_matches_jax():
    """Solve once, then the control sequence step by step; reset solves again."""
    seqs = []
    for jx in (True, False):
        ocp = (JaxOCP if jx else OCP)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
        ocp.horizon = 10
        ocp.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
        ocp.quad_stage_cost.add_inputs(weights=0.1)
        ocp.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
        ocp.set_parameters(P)
        ocp.setup(options={"dt": 0.1}, **({} if jx else KW))
        us = [np.asarray(ocp.optimize([0.2, 0.1])) for _ in range(12)]
        ocp.reset()
        us.append(np.asarray(ocp.optimize([0.25, 0.15])))
        seqs.append(np.array(us))
    assert seqs[1].shape == (13, 1)
    np.testing.assert_array_equal(seqs[1][9], seqs[1][11])   # held after the horizon
    np.testing.assert_allclose(seqs[1], seqs[0], atol=1e-9)


# -- on the card -------------------------------------------------------------------------

@pytest.mark.cuda
def test_fused_loop_on_the_card():
    """The NMPC loop on the card against the CPU (float64): two Riccati
    launches (Mehrotra's predictor and corrector, on in the NMPC defaults)
    per iteration of each step's slowest scenario."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda
    x0 = _x0s(64, 3)

    def run(device):
        return fused_closed_loop_fn(_nmpc_on(device), _plant_on(device), steps=6,
                                    plant_p=np.array(P))(x0)
    riccati_lq_cuda.launches = 0
    card = run("cuda")
    assert riccati_lq_cuda.launches == 2 * int(card.iterations.max(dim=0).values.sum())
    cpu = run(CPU)
    np.testing.assert_allclose(card.X.cpu().numpy(), cpu.X.numpy(), atol=1e-9)
    np.testing.assert_array_equal(card.iterations.cpu().numpy(), cpu.iterations.numpy())


@pytest.mark.cuda
def test_mhe_loop_on_the_card():
    """The MHE loop on the card against the CPU (float64): every window
    solve's Newton steps are launches of the Riccati kernel's free-x0 mode,
    none of the wide variant and no plain sweep."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hilo_mpc_tpu_torch.ops.cuda_kernels import riccati_lq_cuda, riccati_lq_wide_cuda

    def run(device):
        m = MHE(cstr_schaffner_and_zeitz())
        m.horizon = 6
        m.Q, m.R, m.P0 = 1e-2 * np.eye(2), np.array([[1e-2]]), 0.1 * np.eye(2)
        m.set_initial_parameter_values(P)
        m.setup(dt=0.1, options={"tol": 1e-6, "max_iter": 25}, device=device, dtype=F64)
        return fused_closed_loop_mhe_fn(_nmpc_on(device), _plant_on(device), m, steps=4,
                                        plant_p=np.array(P))(*_mhe_windows(16)), m
    riccati_lq_cuda.free_x0_launches = riccati_lq_wide_cuda.launches = 0
    card, m = run("cuda")
    per_iter = 2 if m._ip_opts.mehrotra else 1
    assert riccati_lq_cuda.free_x0_launches == per_iter * int(
        card.mhe_iterations.max(dim=0).values.sum())
    assert riccati_lq_wide_cuda.launches == 0
    cpu, _ = run(CPU)
    for f in ("X", "X_est", "U"):
        np.testing.assert_allclose(getattr(card, f).cpu().numpy(), getattr(cpu, f).numpy(),
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(card.mhe_iterations.cpu().numpy(),
                                  cpu.mhe_iterations.numpy())


def _nmpc_on(device):
    n = NMPC(cstr_schaffner_and_zeitz())
    n.horizon = 8
    n.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=list(X_EQ))
    n.quad_stage_cost.add_inputs(weights=0.1)
    n.set_parameters(P)
    n.setup(options={"dt": 0.1}, device=device, dtype=F64)
    return n


def _plant_on(device):
    p = cstr_schaffner_and_zeitz()
    p.setup(dt=0.1, integration_method="rk4", device=device, dtype=F64)
    return p
