"""PyTorch port: discrete (mixed-integer) inputs against the JAX package
(tests/test_minlp.py's problems; CPU, float64) and per-scenario input bounds
in ``solve_ocp``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hilo_mpc_tpu import NMPC as JNMPC
from hilo_mpc_tpu import Model as JModel
from hilo_mpc_tpu_torch import NMPC, Model
from hilo_mpc_tpu_torch.ops.ip_solver import OCPBounds, solve_ocp

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
LEVELS = [-1.0, 0.0, 1.0]


def jax_di(dt=0.2):
    m = JModel()
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: jnp.array([x[1], u[0]]))
    m.setup(dt=dt)
    return m


def port_di(dt=0.2):
    m = Model()
    m.set_dynamical_states(["p", "v"])
    m.set_inputs("u")
    m.set_dynamical_equations(lambda x, u: torch.stack([x[..., 1], u[..., 0]], -1))
    m.setup(dt=dt, device=CPU, dtype=F64)
    return m


def controller(cls, m, levels, N=12, **opts):
    """tests/test_minlp.py:make_controller, on either package."""
    c = cls(m)
    c.horizon = N
    c.quad_stage_cost.add_states(["p", "v"], weights=[10.0, 1.0], ref=[1.0, 0.0])
    c.quad_stage_cost.add_inputs("u", weights=0.1)
    c.quad_terminal_cost.add_states(["p", "v"], weights=[50.0, 5.0], ref=[1.0, 0.0])
    c.set_box_constraints(u_lb=min(levels), u_ub=max(levels))
    c.set_discrete_inputs("u", levels=levels)
    kw = dict(device=CPU, dtype=F64) if cls is NMPC else {}
    c.setup(options={"tol": 1e-6, **opts}, **kw)
    return c


@pytest.mark.parametrize("mode", ["heuristic", "exact"])
def test_candidates_equal_jax(mode):
    """The same relaxed U gives the same candidate array, ties included:
    relaxed values on a level and on a midpoint between two levels."""
    N, levels = (12, LEVELS) if mode == "heuristic" else (5, [0.0, 1.0])
    j = controller(JNMPC, jax_di(), levels, N=N)
    t = controller(NMPC, port_di(), levels, N=N)
    assert (j._mi["cand_enum"] is None) == (mode == "heuristic")
    rng = np.random.default_rng(7)
    for U in (rng.uniform(-1, 1, (N, 1)), np.full((N, 1), 0.5),
              np.round(rng.uniform(-1, 1, (N, 1)) * 2) / 2):
        cj, ct = j._mi_candidates(U), t._mi_candidates(U)
        assert ct.shape == cj.shape and np.array_equal(ct, cj)
    for a, b in zip(t._mi["levels"], j._mi["levels"]):
        assert np.array_equal(a, b)


def test_closed_loop_matches_jax():
    """tests/test_minlp.py's 25-step loop: the same pick at every step, U and
    X of the picked candidate within 1e-8 of JAX, every move on a level, and
    the set point reached."""
    plant = jax_di()
    j = controller(JNMPC, jax_di(), LEVELS)
    t = controller(NMPC, port_di(), LEVELS)
    x = np.zeros(2)
    for k in range(25):
        uj, ut = j.optimize(x), t.optimize(x)
        assert t.stats["mi_pick"] == j.stats["mi_pick"], (k, j.stats, t.stats)
        for key in ("mi_candidates", "mi_feasible"):
            assert t.stats[key] == j.stats[key], (k, key)
        assert abs(t.stats["mi_gap"] - j.stats["mi_gap"]) < 1e-8
        assert t.stats["mi_gap"] >= -1e-8 and t.stats["converged"]
        np.testing.assert_allclose(t._warm[1], j._warm[1], rtol=0, atol=1e-8)
        np.testing.assert_allclose(t._warm[0], j._warm[0], rtol=0, atol=1e-8)
        np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
        assert min(abs(ut[0] - lv) for lv in LEVELS) < 1e-12
        x = np.asarray(plant.simulate(x0=x, u=uj.reshape(1, -1), steps=1,
                                      store=False)["x"][-1], dtype=float).ravel()
    np.testing.assert_allclose(x, [1.0, 0.0], atol=1e-4)


def test_integer_lattice_from_bounds():
    c = NMPC(port_di())
    c.horizon = 8
    c.quad_stage_cost.add_states(["p", "v"], weights=[10.0, 1.0], ref=[1.0, 0.0])
    c.quad_stage_cost.add_inputs("u", weights=0.1)
    c.set_box_constraints(u_lb=-2, u_ub=2)
    c.set_discrete_inputs("u")
    c.setup(device=CPU, dtype=F64)
    np.testing.assert_allclose(c._mi["levels"][0], [-2, -1, 0, 1, 2])
    np.testing.assert_allclose(c._bounds.lbu.numpy(), -2.0)
    u = c.optimize([0.0, 0.0])
    assert abs(u[0] - round(u[0])) < 1e-12


def test_levels_filtered_by_bounds():
    c = NMPC(port_di())
    c.horizon = 5
    c.quad_stage_cost.add_states("p", weights=1.0, ref=1.0)
    c.set_box_constraints(u_lb=0.0, u_ub=1.0)
    c.set_discrete_inputs("u", levels=[-1.0, 0.0, 1.0, 2.0])
    c.setup(device=CPU, dtype=F64)
    np.testing.assert_allclose(c._mi["levels"][0], [0.0, 1.0])


def test_on_off_thermostat():
    """An on/off actuator holds a band around a set point no steady state
    reaches (tests/test_minlp.py's relay case and bars)."""
    m = Model()
    m.set_dynamical_states("T")
    m.set_inputs("q")
    m.set_dynamical_equations(lambda x, u: -x + 2.0 * u)
    m.setup(dt=0.25, device=CPU, dtype=F64)
    c = NMPC(m)
    c.horizon = 10
    c.quad_stage_cost.add_states("T", weights=10.0, ref=0.5)
    c.set_box_constraints(u_lb=0, u_ub=1)
    c.set_discrete_inputs("q", levels=[0.0, 1.0])
    c.setup(device=CPU, dtype=F64)
    x = np.array([0.0])
    traj = []
    for _ in range(20):
        u = c.optimize(x)
        assert u[0] in (0.0, 1.0)
        x = m.simulate(x0=x, u=u.reshape(1, -1), steps=1, store=False)["x"][-1]
        traj.append(float(x[0]))
    assert 0.3 < np.mean(traj[10:]) < 0.8
    assert max(traj[10:]) < 1.0


def _du_case(c):
    c.horizon = 8
    c.quad_stage_cost.add_states("p", weights=1.0, ref=1.0)
    c.quad_stage_cost.add_inputs_change("u", weights=0.1)
    c.set_box_constraints(u_lb=-1, u_ub=1)
    c.set_discrete_inputs("u", levels=[-1.0, 1.0])
    c.setup(device=CPU, dtype=F64)


def _finite_case(c):
    c.horizon = 5
    c.quad_stage_cost.add_states("p", weights=1.0, ref=1.0)
    c.set_discrete_inputs("u")
    c.setup(device=CPU, dtype=F64)


@pytest.mark.parametrize("case, match", [
    (_du_case, "Δu"),
    (lambda c: c.set_discrete_inputs("nope", levels=[0, 1]), "unknown input"),
    (lambda c: c.set_discrete_inputs("u", levels=[1.0]), "levels"),
    (_finite_case, "finite"),
], ids=["du", "unknown_input", "too_few_levels", "lattice_needs_finite_bounds"])
def test_validation_errors(case, match):
    with pytest.raises(ValueError, match=match):
        case(NMPC(port_di()))


def test_rti_refuses_discrete_inputs():
    c = controller(NMPC, port_di(), LEVELS, N=5)
    with pytest.raises(NotImplementedError, match="discrete"):
        c.rti_prepare(x_pred=[0.0, 0.0])
    with pytest.raises(NotImplementedError, match="discrete"):
        c.rti_prepare_batch(np.zeros((2, 2)))


def test_batch_entry_points_give_the_relaxed_solution():
    """As in JAX, the batch entry points never consult the discrete inputs:
    they solve the relaxed problem (ROADMAP §C)."""
    c = controller(NMPC, port_di(), LEVELS, N=6)
    relaxed = NMPC(port_di())
    relaxed.horizon = 6
    relaxed.quad_stage_cost.add_states(["p", "v"], weights=[10.0, 1.0], ref=[1.0, 0.0])
    relaxed.quad_stage_cost.add_inputs("u", weights=0.1)
    relaxed.quad_terminal_cost.add_states(["p", "v"], weights=[50.0, 5.0],
                                          ref=[1.0, 0.0])
    relaxed.set_box_constraints(u_lb=-1.0, u_ub=1.0)
    relaxed.setup(options={"tol": 1e-6}, device=CPU, dtype=F64)
    x0s = np.array([[0.0, 0.0], [0.9, 0.1], [0.5, -0.3]])
    (u0, sol), (u_rel, sol_rel) = c.optimize_batch(x0s), relaxed.optimize_batch(x0s)
    assert bool(sol.converged.all())
    assert np.array_equal(u0, u_rel) and torch.equal(sol.U, sol_rel.U)
    assert np.abs(u0 - np.round(u0)).max() > 1e-3    # off the levels


def test_per_scenario_input_bounds():
    """lbu/ubu (B, N, nu): a batch of copies of one problem with different
    pins is the single solves, and copies of the shared bounds give the
    shared bounds' bits."""
    c = controller(NMPC, port_di(), LEVELS, N=6)
    theta = c._tensor(c._assemble_theta(None, None))
    xs0 = c._tensor([0.1, -0.2])
    B, N = 4, 6
    rng = np.random.default_rng(0)
    lbu = np.broadcast_to(c._bounds_np.lbu, (B, N, 1)).copy()
    ubu = lbu.copy() + 2.0
    for b in range(1, B):                 # scenario 0 keeps the relaxed box
        pins = rng.choice(N, size=b, replace=False)
        lbu[b, pins, 0] = ubu[b, pins, 0] = rng.choice(LEVELS, size=b)
    U0 = c._tensor(np.zeros((B, N, 1)))
    X0 = c._rollout_guess(xs0.expand(B, -1), theta, U0)
    args = (theta.expand(B, -1, -1), xs0.expand(B, -1), X0, U0)
    bnd = OCPBounds(c._bounds.lbx, c._bounds.ubx, c._tensor(lbu), c._tensor(ubu))
    batch = solve_ocp(c._funcs, c._dims, bnd, *args, options=c._ip_opts)
    assert bool(batch.converged.all())
    for b in range(B):
        one = OCPBounds(c._bounds.lbx, c._bounds.ubx, c._tensor(lbu[b]),
                        c._tensor(ubu[b]))
        single = solve_ocp(c._funcs, c._dims, one, *[a[b:b + 1] for a in args],
                           options=c._ip_opts)
        assert int(single.iterations[0]) == int(batch.iterations[b])
        for name in ("X", "U", "objective"):
            np.testing.assert_allclose(getattr(batch, name)[b].numpy(),
                                       getattr(single, name)[0].numpy(),
                                       rtol=0, atol=1e-12)
    shared = solve_ocp(c._funcs, c._dims, c._bounds, *args, options=c._ip_opts)
    copies = OCPBounds(c._bounds.lbx, c._bounds.ubx,
                       c._bounds.lbu.expand(B, -1, -1), c._bounds.ubu.expand(B, -1, -1))
    again = solve_ocp(c._funcs, c._dims, copies, *args, options=c._ip_opts)
    for a, b in zip(shared, again):
        assert torch.equal(a, b)
