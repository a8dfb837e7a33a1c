"""PyTorch port: the NMPC controller with soft state bounds and generic
stage and terminal constraints against the JAX package (CPU, float64).

The twins of tests/test_nmpc.py:136-161 (a soft state bound, a hard custom
stage constraint, a two-sided terminal constraint) and a CSTR N=15 with the
terminal equality x_N[0] = 0.3 (the augmented-Lagrangian path): the JAX
controller's prepared batch through both controllers' ``solve_batch_fn``
(NMPC defaults: Mehrotra, convexify, ten line-search candidates), U and X to
1e-10 with the same iteration counts; then each constraint held on the
port's own ``optimize``, and the soft bound in closed loop. ``cuda``: the
same controllers on the card against the CPU.
"""
import numpy as np
import pytest
import torch

from hilo_mpc_tpu import NMPC as JaxNMPC
from hilo_mpc_tpu.library import cstr_schaffner_and_zeitz as jax_cstr
from hilo_mpc_tpu_torch import NMPC
from hilo_mpc_tpu_torch.library import cstr_schaffner_and_zeitz
from hilo_mpc_tpu_torch.utils.interop import to_numpy, to_torch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
CSTR_EQ = [0.3, 0.18055]
CSTR_X0 = [0.2, 0.1]


def _first(jx):
    return (lambda x: x[0]) if jx else (lambda x: x[..., 0])


# name: (horizon, box bounds, constraints added to a controller of either
# package: f(nmpc, jax?))
CASES = {
    "soft_state_bound": (15, dict(x_ub=[0.25, 1.0], x_soft=True, soft_weight=1e3),
                         lambda n, jx: None),
    "hard_custom_stage": (10, None, lambda n, jx: n.add_stage_constraint(
        (lambda x, u: x[1] + 0.5 * u[0]) if jx else
        (lambda x, u: x[..., 1] + 0.5 * u[..., 0]), ub=0.5, n=1)),
    "terminal_two_sided": (15, None, lambda n, jx: n.add_terminal_constraint(
        _first(jx), lb=0.25, ub=0.35, n=1)),
    "terminal_equality": (15, None, lambda n, jx: n.add_terminal_constraint(
        _first(jx), lb=0.3, ub=0.3, n=1)),
}


def _controller(case, jx, device=CPU):
    N, box, add = CASES[case]
    nmpc = (JaxNMPC if jx else NMPC)(jax_cstr() if jx else cstr_schaffner_and_zeitz())
    nmpc.horizon = N
    nmpc.quad_stage_cost.add_states(weights=[10.0, 10.0], ref=CSTR_EQ)
    nmpc.quad_stage_cost.add_inputs(weights=0.1)
    nmpc.set_parameters([1.0] * 6)
    if box:
        nmpc.set_box_constraints(**box)
    add(nmpc, jx)
    nmpc.setup(options={"dt": 0.1}, **({} if jx else dict(device=device, dtype=F64)))
    return nmpc


@pytest.fixture(scope="module", params=sorted(CASES))
def twin(request):
    """(case, port controller, the JAX batch, the JAX solution)."""
    jn = _controller(request.param, True)
    x0s = np.array(CSTR_X0) + 0.02 * np.random.default_rng(1).standard_normal((3, 2))
    args = jn.prepare_batch(x0s)
    jsol = jn.solve_batch_fn()(*args)
    return (request.param, _controller(request.param, False),
            tuple(np.asarray(a) for a in args), jsol)


def test_batch_matches_jax(twin):
    case, tn, args, jsol = twin
    dims = {"soft_state_bound": (0, 0, 0, 0), "hard_custom_stage": (1, 0, 0, 0),
            "terminal_two_sided": (0, 2, 0, 0), "terminal_equality": (0, 0, 0, 1)}
    d = tn._dims
    assert (d.n_h, d.n_hN, d.n_e, d.n_eN) == dims[case]
    sol = to_numpy(tn.solve_batch_fn()(*to_torch(args, device=CPU)))
    assert sol.converged.all() and np.asarray(jsol.converged).all()
    np.testing.assert_array_equal(sol.iterations, np.asarray(jsol.iterations))
    np.testing.assert_allclose(sol.U, np.asarray(jsol.U), rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol.X, np.asarray(jsol.X), rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol.objective, np.asarray(jsol.objective), rtol=1e-10)


def test_optimize_holds_the_constraint(twin):
    """tests/test_nmpc.py:146-161 on the port: each constraint holds on the
    predicted trajectory of one optimize call."""
    case, tn, _, _ = twin
    tn._warm = None
    tn.optimize(CSTR_X0)
    assert tn.stats["converged"]
    X, U = tn.last_prediction["x"], tn.last_prediction["u"]
    if case == "hard_custom_stage":
        assert np.all(X[1:-1, 1] + 0.5 * U[1:, 0] <= 0.5 + 1e-6)
    elif case == "terminal_two_sided":
        assert 0.25 - 1e-6 <= X[-1, 0] <= 0.35 + 1e-6
    elif case == "terminal_equality":
        assert abs(X[-1, 0] - 0.3) <= 1e-6
    else:
        # the penalty lets x_1 pass 0.25 only by a little on its way to 0.3
        assert X[1:, 0].max() < 0.3


def test_soft_state_bound_closed_loop():
    """tests/test_nmpc.py:137-142: in closed loop the soft bound pulls x_1
    below the reference equilibrium."""
    nmpc = _controller("soft_state_bound", False)
    plant = cstr_schaffner_and_zeitz()
    plant.setup(dt=0.1, integration_method="rk4", device=CPU, dtype=F64)
    plant.set_initial_conditions(CSTR_X0)
    plant.set_initial_parameter_values([1.0] * 6)
    x = np.array(CSTR_X0)
    for _ in range(20):
        u = nmpc.optimize(x)
        assert nmpc.stats["converged"]
        x = plant.simulate(u=u, steps=1)["x"][-1]
    assert x[0] < 0.27


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_constrained_controller_on_card(case):
    """The controller on the card (the Riccati kernel in every Newton step)
    against the same controller on the CPU, float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    x0s = np.array(CSTR_X0) + 0.02 * np.random.default_rng(1).standard_normal((16, 2))
    sols = []
    for dev in (CPU, "cuda"):
        tn = _controller(case, False, device=dev)
        sols.append(tn.solve_batch_fn()(*tn.prepare_batch(x0s)))
    c, k = sols
    assert torch.equal(c.iterations, k.iterations.cpu())
    torch.testing.assert_close(k.U.cpu(), c.U, rtol=0, atol=1e-9)
