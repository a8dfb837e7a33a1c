"""PyTorch port: time-varying parameters, varying references and
time-varying weights of NMPC against the JAX package (CPU, float64).

- theta's parameter rows equal JAX's ``_assemble_p_rows`` exactly: the
  stored table as a dict or an array, its wrap-around at the closed-loop
  step count, ``tvp=`` given as one row, a short table (padded with its
  last row) or a full one, and ``cp`` for all or only the constant
  parameters;
- ``optimize`` in a closed loop and ``optimize_batch`` with tvp to 1e-9;
- the varying-reference and time-varying-weight cases of
  tests/test_nmpc_reference_matrix.py (TestVaryingReference,
  TestTimeVaryingWeights) against JAX and their behavioural bars;
- a tvp controller through ``pallas_full``: the whole-solve gate takes it
  (the emitted problem reads p per stage from theta), and its plain version
  agrees with the JAX kernel in interpret mode within 5e-4, with equal
  iterations; on the card the kernel against the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import Model as JaxModel
from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu import SimpleControlLoop as JaxLoop
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu.ops.pallas_ip import solve_ocp_pallas_full
from hilo_mpc_tpu_torch import NMPC, Model, SimpleControlLoop
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.ops import whole_ip as W
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
P_CSTR = [1.0] * 6
# E follows a seeded sequence of 40 values (the last parameter of the CSTR)
E_SEQ = 1.0 + 0.1 * np.sin(np.linspace(0.0, 6.0, 40)) \
    + 0.02 * np.random.default_rng(11).standard_normal(40)
KERNEL_OPTS = {"dt": 0.1, "integration_method": "rk4", "tol": 1e-4, "max_iter": 10,
               "convexify": False, "n_linesearch": 1, "mu_init": 1e-2,
               "mehrotra": False}


def _tvp_cstr(cls, model, options=None, N=8, names=("E",), values=None, **kw):
    nmpc = cls(model)
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=[0.3, 0.18055])
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_box_constraints(u_lb=[-5.0], u_ub=[5.0])
    nmpc.set_parameters(P_CSTR)
    nmpc.set_time_varying_parameters(list(names), values)
    nmpc.setup(options={"dt": 0.1, "integration_method": "rk4", "tol": 1e-10,
                        "max_iter": 60, **(options or {})}, **kw)
    return nmpc


def _pair(options=None, **kw):
    return (_tvp_cstr(JaxNMPC, jax_cstr(), options, **kw),
            _tvp_cstr(NMPC, cstr_schaffner_and_zeitz(), options, device=CPU, dtype=F64,
                      **kw))


# -- theta's parameter rows ----------------------------------------------------------

ROW_CASES = {
    "dict_table": dict(names=("E",), values={"E": E_SEQ}, args=(None, None, 8, 0)),
    "array_table": dict(names=("g", "E"), values=np.stack([0.9 + 0 * E_SEQ, E_SEQ], 1),
                        args=(None, None, 8, 3)),
    "transposed_table": dict(names=("g", "E"), values=np.stack([E_SEQ[:9], E_SEQ[9:18]]),
                             args=(None, None, 8, 2)),
    "dict_unequal_lengths": dict(names=("g", "E"), values={"g": [0.8, 0.9], "E": E_SEQ[:5]},
                                 args=(None, None, 8, 1)),
    "wrap_around": dict(names=("E",), values={"E": E_SEQ}, args=(None, None, 8, 36)),
    "tvp_one_row": dict(names=("E",), values={"E": E_SEQ}, args=(None, [1.3], 8, 5)),
    "tvp_short_table": dict(names=("E",), values=None, args=(None, [[1.1], [1.2], [1.4]], 8, 0)),
    "tvp_full_table": dict(names=("E",), values=None,
                           args=(None, E_SEQ[:12, None], 8, 0)),
    "cp_all": dict(names=("E",), values={"E": E_SEQ}, args=([1.1] * 6, None, 8, 4)),
    "cp_constant_only": dict(names=("E",), values={"E": E_SEQ},
                             args=([1.1, 1.2, 0.9, 1.0, 0.95], None, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_parameter_rows_match_jax(case):
    c = ROW_CASES[case]
    jn, tn = _pair(names=c["names"], values=c["values"])
    np.testing.assert_array_equal(tn._assemble_p_rows(*c["args"]),
                                  jn._assemble_p_rows(*c["args"]))


def test_theta_follows_the_step_count():
    """The whole theta at the current closed-loop step (t, dt, p rows)."""
    jn, tn = _pair(values={"E": E_SEQ})
    for n in (jn, tn):
        n._step_count, n._time = 37, 3.7
    np.testing.assert_array_equal(tn._assemble_theta(None, None),
                                  jn._assemble_theta(None, None, None))


def test_tvp_errors_match_jax():
    for cls, model, kw in ((JaxNMPC, jax_cstr(), {}),
                           (NMPC, cstr_schaffner_and_zeitz(), dict(device=CPU))):
        n = cls(model)
        with pytest.raises(ValueError, match="not a model parameter"):
            n.set_time_varying_parameters(["nope"])
        nm = _tvp_cstr(cls, model, **kw)          # declared, no values
        with pytest.raises(ValueError, match="no values"):
            nm.optimize([0.2, 0.1])
        with pytest.raises(ValueError, match="cp has"):
            nm.optimize([0.2, 0.1], cp=[1.0, 1.0], tvp=[1.0])


# -- solves with time-varying parameters -----------------------------------------------

def test_closed_loop_optimize_matches_jax():
    """Ten steps: the stored table read at each step (the horizon wraps
    past the table's end on the last steps)."""
    jn, tn = _pair(values={"E": E_SEQ[:14]})
    # one float64 plant steps both loops, so only the controllers differ
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    xj = xt = np.array([0.2, 0.1])
    for k in range(10):
        uj, ut = jn.optimize(xj), tn.optimize(xt)
        assert tn.stats["converged"]
        assert tn.stats["iterations"] == jn.stats["iterations"]
        np.testing.assert_allclose(ut, uj, atol=1e-9)
        p = np.array(P_CSTR[:5] + [E_SEQ[k]])
        xj = plant.simulate(x0=xj[None], u=uj[None, None], p=p, steps=1)["x"][0, -1]
        xt = plant.simulate(x0=xt[None], u=ut[None, None], p=p, steps=1)["x"][0, -1]


@pytest.mark.parametrize("tvp", ["table", "one_row", "short"])
def test_optimize_batch_with_tvp_matches_jax(tvp):
    jn, tn = _pair(values={"E": E_SEQ})
    arg = {"table": None, "one_row": [1.25], "short": E_SEQ[:4, None]}[tvp]
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(4).standard_normal((5, 2))
    uj, sj = jn.optimize_batch(x0s, tvp=arg)
    ut, st = tn.optimize_batch(x0s, tvp=arg)
    np.testing.assert_allclose(ut, uj, atol=1e-9)
    np.testing.assert_array_equal(st.iterations.numpy(), np.asarray(sj.iterations))
    # the prepared theta carries the rows
    np.testing.assert_allclose(to_numpy(tn.prepare_batch(x0s, tvp=arg))[0],
                               np.asarray(jn.prepare_batch(x0s, tvp=arg)[0]), atol=0)


def test_tvp_changes_the_answer():
    _, tn = _pair(values={"E": E_SEQ})
    u_lo = tn.optimize_batch([[0.2, 0.1]], tvp=[0.8])[0]
    u_hi = tn.optimize_batch([[0.2, 0.1]], tvp=[1.2])[0]
    assert np.abs(u_lo - u_hi).max() > 1e-3


# -- the varying-reference and time-varying-weight cases ---------------------------------

M = 5.0
X0 = np.zeros(4)


def _point_mass(jx):
    # the JAX plant in float64 too (its models default to float32)
    m = JaxModel(name="pm", dtype=jnp.float64) if jx else Model(name="pm")
    m.set_dynamical_states(["x", "vx", "y", "vy"])
    m.set_inputs(["Fx", "Fy"])
    if jx:
        m.set_dynamical_equations(lambda x, u: jnp.array([x[1], u[0] / M, x[3], u[1] / M]))
        m.setup(dt=0.1)
    else:
        m.set_dynamical_equations(lambda x, u: torch.stack(
            [x[..., 1], u[..., 0] / M, x[..., 3], u[..., 1] / M], dim=-1))
        m.setup(dt=0.1, device=CPU, dtype=F64)
    return m


def _tracking(jx):
    nmpc = (JaxNMPC if jx else NMPC)(_point_mass(jx))
    nmpc.horizon = 10
    nmpc.quad_stage_cost.add_states(names=["x", "y"], weights=[10, 10],
                                    trajectory_tracking=True)
    nmpc.quad_terminal_cost.add_states(names=["x", "y"], weights=[10, 10],
                                       trajectory_tracking=True)
    nmpc.quad_stage_cost.add_inputs(weights=[0.01, 0.01])
    nmpc.set_box_constraints(u_lb=[-50.0, -50.0], u_ub=[50.0, 50.0])
    nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
    return nmpc


def test_vr_1_setpoint_change_in_loop_matches_jax():
    runs = {}
    for jx in (True, False):
        plant = _point_mass(jx)
        plant.set_initial_conditions(x0=X0)
        loop = (JaxLoop if jx else SimpleControlLoop)(plant, _tracking(jx))
        loop.run(8, ref_sc={"x": 1, "y": 2}, ref_tc={"x": 1, "y": 2})
        x_mid = np.asarray(plant.solution["x:f"]).copy()
        loop.run(8, ref_sc={"x": 2, "y": 1}, ref_tc={"x": 2, "y": 1})
        runs[jx] = (x_mid, np.asarray(loop.solution["u"]), np.asarray(plant.solution["x:f"]))
    x_mid, u, x_end = runs[False]
    assert x_mid[0] > 0.05 and x_mid[2] > 0.1
    assert x_end[0] > x_mid[0]
    for a, b in zip(runs[False], runs[True]):
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("case", ["dict", "timeseries"])
def test_runtime_reference_optimize_matches_jax(case):
    ref_sc = ({"x": 1.0, "y": 0.0} if case == "dict"
              else {"x": np.linspace(0.0, 1.0, 40), "y": 0.0})
    us = []
    for jx in (True, False):
        nmpc = _tracking(jx)
        us.append(nmpc.optimize(X0, ref_sc=ref_sc, ref_tc={"x": 1.0, "y": 0.0}))
        assert nmpc.stats["converged"]
    np.testing.assert_allclose(us[1], us[0], atol=1e-9)
    if case == "dict":
        assert float(us[1][0]) > 0.1


@pytest.mark.parametrize("case,exc,match", [
    ("short", ValueError, "data points"), ("unknown", ValueError, "unknown variable"),
    ("not_dict", TypeError, "ref_sc"), ("missing", ValueError, "runtime reference")])
def test_runtime_reference_errors(case, exc, match):
    nmpc = _tracking(False)
    kw = {"short": dict(ref_sc={"x": np.zeros(5), "y": 0.0}, ref_tc={"x": 0.0, "y": 0.0}),
          "unknown": dict(ref_sc={"nope": 1.0, "x": 0.0, "y": 0.0},
                          ref_tc={"x": 0.0, "y": 0.0}),
          "not_dict": dict(ref_sc=[1.0, 2.0]), "missing": {}}[case]
    with pytest.raises(exc, match=match):
        nmpc.optimize(X0, **kw)


def _weights_model(jx):
    m = (JaxModel if jx else Model)(name="pmw")
    m.set_dynamical_states(["x", "vx", "y", "vy"])
    m.set_inputs(["Fx", "Fy"])
    m.set_parameters(["w_x", "w_y"])
    if jx:
        m.set_dynamical_equations(
            lambda x, u, p: jnp.array([x[1], u[0] / M, x[3], u[1] / M]))
        m.setup(dt=0.1)
    else:
        m.set_dynamical_equations(lambda x, u, p: torch.stack(
            [x[..., 1], u[..., 0] / M, x[..., 3], u[..., 1] / M], dim=-1))
        m.setup(dt=0.1, device=CPU, dtype=F64)
    return m


def _weights_nmpc(jx):
    nmpc = (JaxNMPC if jx else NMPC)(_weights_model(jx))
    nmpc.horizon = 15
    if jx:
        nmpc.stage_cost.cost = lambda x, u, p, t: p[0] * x[0] ** 2 + p[1] * x[2] ** 2
    else:
        nmpc.stage_cost.cost = (lambda x, u, p, t: p[..., 0] * x[..., 0] ** 2
                                + p[..., 1] * x[..., 2] ** 2)
    nmpc.quad_stage_cost.add_inputs(weights=[0.1, 0.1])
    nmpc.set_box_constraints(u_lb=[-20.0, -20.0], u_ub=[20.0, 20.0])
    nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
    return nmpc


def test_time_varying_weights_match_jax():
    x0 = np.array([1.0, 0.0, 1.0, 0.0])
    out = {}
    for jx in (True, False):
        u_a = _weights_nmpc(jx).optimize(x0, cp=[10.0, 0.0])
        u_b = _weights_nmpc(jx).optimize(x0, cp=[0.0, 10.0])
        out[jx] = (np.ravel(u_a), np.ravel(u_b))
    u_a, u_b = out[False]
    assert abs(u_a[0]) > 5 * abs(u_a[1])
    assert abs(u_b[1]) > 5 * abs(u_b[0])
    for a, b in zip(out[False], out[True]):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_weights_as_time_varying_parameters():
    """The same weights as tvp rows: the weight on x for the first half of
    the horizon, on y for the second, against JAX."""
    tvp = np.array([[10.0, 0.0]] * 8 + [[0.0, 10.0]] * 8)
    us = []
    for jx in (True, False):
        nmpc = (JaxNMPC if jx else NMPC)(_weights_model(jx))
        nmpc.horizon = 15
        nmpc.stage_cost.cost = (
            (lambda x, u, p, t: p[0] * x[0] ** 2 + p[1] * x[2] ** 2) if jx else
            (lambda x, u, p, t: p[..., 0] * x[..., 0] ** 2 + p[..., 1] * x[..., 2] ** 2))
        nmpc.quad_stage_cost.add_inputs(weights=[0.1, 0.1])
        nmpc.set_time_varying_parameters(["w_x", "w_y"], tvp)
        nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=CPU, dtype=F64)))
        us.append(np.ravel(nmpc.optimize(np.array([1.0, 0.0, 1.0, 0.0]))))
    np.testing.assert_allclose(us[1], us[0], atol=1e-9)


# -- the whole-solve route ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tvp_kernel_case():
    """The JAX kernel in interpret mode on a tvp CSTR, 7 scenarios, N=5."""
    jn = _tvp_cstr(JaxNMPC, jax_cstr(), {**KERNEL_OPTS, "pallas_full": True}, N=5,
                   values={"E": E_SEQ})
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(0).standard_normal((7, 2))
    args = jn.prepare_batch(x0s)
    sol = solve_ocp_pallas_full(jn._funcs, jn._dims, jn._bounds, *args,
                                options=jn._ip_opts, tile_b=8)
    return x0s, to_torch(args, device=CPU), jax.tree.map(np.asarray, sol)


def test_whole_solve_gate_takes_tvp(tvp_kernel_case):
    """The emitted problem reads p per stage from theta, so a tvp
    controller is eligible, and its rows vary along the horizon."""
    _, args, _ = tvp_kernel_case
    tn = _tvp_cstr(NMPC, cstr_schaffner_and_zeitz(), {**KERNEL_OPTS, "pallas_full": True},
                   N=5, values={"E": E_SEQ}, device=CPU, dtype=F64)
    assert tn._whole_ip_cache()["eligible"]
    assert len(set(args[0][0, :, 2 + 5].tolist())) == 6
    text = W.whole_ip_problem(tn._funcs, tn._dims, tn._bounds, args[0].shape[2],
                              tn._ip_opts).text
    assert "const T* p = th + 2;" in text


def test_tvp_plain_version_matches_pallas_interpret(tvp_kernel_case):
    x0s, args, jsol = tvp_kernel_case
    tn = _tvp_cstr(NMPC, cstr_schaffner_and_zeitz(), {**KERNEL_OPTS, "pallas_full": True},
                   N=5, values={"E": E_SEQ}, device=CPU, dtype=F64)
    sol = to_numpy(tn.solve_batch_fn()(*args))
    assert jsol.converged.all() and sol.converged.all()
    np.testing.assert_array_equal(sol.iterations, jsol.iterations)
    np.testing.assert_allclose(sol.U, jsol.U, atol=5e-4)
    np.testing.assert_allclose(sol.X, jsol.X, atol=5e-4)
    # the tvp rows matter: the same problem with E held at 1 answers otherwise
    const = args[0].clone()
    const[:, :, 2 + 5] = 1.0
    other = to_numpy(tn.solve_batch_fn()(const, *args[1:]))
    assert np.abs(other.U - sol.U).max() > 1e-3


@pytest.mark.cuda
def test_tvp_whole_solve_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hilo_mpc_tpu_torch.ops.whole_ip import solve_ocp_full_cuda
    x0s = np.array([0.2, 0.1]) + 0.05 * np.random.default_rng(1).standard_normal((256, 2))
    tn = _tvp_cstr(NMPC, cstr_schaffner_and_zeitz(), {**KERNEL_OPTS, "pallas_full": True},
                   N=10, values={"E": E_SEQ}, device="cuda", dtype=torch.float32)
    args = tn.prepare_batch(x0s)
    solve_ocp_full_cuda.launches = 0
    sol = tn.solve_batch_fn()(*args)
    assert solve_ocp_full_cuda.launches == 1
    # the plain version on the same card
    ref = W.solve_ocp_full_reference(tn._funcs, tn._dims, tn._bounds, *args, tn._ip_opts)
    both = (sol.converged & ref.converged).cpu().numpy()
    assert both.mean() > 0.95
    np.testing.assert_allclose(sol.U.cpu().numpy()[both], ref.U.cpu().numpy()[both],
                               atol=5e-4)
